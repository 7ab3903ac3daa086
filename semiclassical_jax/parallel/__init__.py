# coding: utf-8
"""Multi-chip ensemble parallelism over a jax.sharding.Mesh."""

from semiclassical_jax.parallel.mesh import (
    ensemble_mesh,
    shard_ensemble,
    replicate,
)

__all__ = ["ensemble_mesh", "shard_ensemble", "replicate"]
