# coding: utf-8
"""Mesh and sharding helpers for the trajectory ensemble.

The ensemble is embarrassingly parallel during propagation (no
cross-trajectory coupling until the final Monte-Carlo reduction — SURVEY
P1-P3), so the parallel layout is one mesh axis `traj` over all chips with
every per-trajectory array sharded along its leading axis and every constant
parameter pack replicated. Under jit, the per-step `jnp.sum` reductions of
the observables lower to `psum` collectives automatically (GSPMD; NCCL
between GPUs); there is nothing to manage by hand. The mesh is 1-D: the
cards of one host are joined all to all.

The reference has no distributed layer at all (single CUDA device,
reference cli.py:119-126); this module is the equivalent the
capability map calls for (SURVEY §2.2 P5).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["ensemble_mesh", "shard_ensemble", "replicate", "pad_to_multiple"]


def ensemble_mesh(devices=None) -> Mesh:
    """A 1D mesh with all (or the given) devices on the `traj` axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), axis_names=("traj",))


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n."""
    return ((n + k - 1) // k) * k


def shard_ensemble(tree, mesh: Mesh):
    """Place every array of a per-trajectory pytree with the leading axis
    sharded over the `traj` mesh axis. Leading dimensions must be divisible
    by the mesh size (the samplers round the trajectory count up)."""
    def place(x):
        spec = P("traj", *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(place, tree)


def replicate(tree, mesh: Mesh):
    """Replicate a constant parameter pack across the mesh."""
    def place(x):
        return jax.device_put(x, NamedSharding(mesh, P()))

    return jax.tree.map(place, tree)
