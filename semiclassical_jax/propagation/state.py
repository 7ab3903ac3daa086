# coding: utf-8
"""Scan-carried state pytrees.

The reference packs (q, p, Mqq, Mqp, Mpq, Mpp, S) into one flat
(4 d^2 + 2 d + 1, n) tensor so its generic RK4 can treat the solution as a
vector (reference propagators.py:321-376). In JAX, `tree_map` gives the same
genericity over a structured pytree for free, so the state keeps its natural
shapes — with the trajectory axis *leading* so every monodromy product is a
batched matmul.
"""

from __future__ import annotations

import jax.numpy as jnp

from semiclassical_jax.pytree import pytree_dataclass

__all__ = ["TrajState", "SignTracker"]


@pytree_dataclass
class TrajState:
    """Classical trajectories plus monodromy (stability) matrices and action.

    q, p : (n, d)          positions / momenta
    Mqq, Mqp, Mpq, Mpp : (n, d, d) — or (n, d) in the *diagonal
        representation* — monodromy blocks  M_ab = d a(t) / d b(0)
    S : (n,)               classical action integral of (T - V)

    Diagonal representation: for a separable potential the Hessian is
    diagonal at every geometry, so the monodromy equations decouple per
    mode — a monodromy that starts diagonal (the identity initial
    condition) stays EXACTLY diagonal for all time. Storing only the
    diagonals shrinks the state d-fold and removes the entire monodromy
    bandwidth cost from the step; consumers detect the representation by
    `Mqq.ndim == 2`. The reference always carries the dense (d, d) blocks
    (propagators.py:321-376).
    """

    q: jnp.ndarray
    p: jnp.ndarray
    Mqq: jnp.ndarray
    Mqp: jnp.ndarray
    Mpq: jnp.ndarray
    Mpp: jnp.ndarray
    S: jnp.ndarray
    # compensated-f32 mode ("comp32"): q/p are f32 and qc/pc carry the
    # Neumaier accumulation residuals (true value = q + qc), giving
    # f64-quality trajectory accumulation with f32 arithmetic. None in the
    # plain modes.
    qc: jnp.ndarray | None = None
    pc: jnp.ndarray | None = None

    @property
    def diag_monodromy(self):
        return self.Mqq.ndim == 2

    @property
    def compensated(self):
        return self.qc is not None

    def dense_monodromy(self):
        """The four blocks as dense (n, d, d) arrays (expanding the
        diagonal representation if active)."""
        if not self.diag_monodromy:
            return self.Mqq, self.Mqp, self.Mpq, self.Mpp
        eye = jnp.eye(self.Mqq.shape[1], dtype=self.Mqq.dtype)[None]
        return (self.Mqq[:, :, None] * eye, self.Mqp[:, :, None] * eye,
                self.Mpq[:, :, None] * eye, self.Mpp[:, :, None] * eye)

    @staticmethod
    def initial(q, p, dtype=None, mono_dtype=None, diag_monodromy=False,
                compensated=False):
        """Monodromy = identity, action = 0 (reference propagators.py:589-603).

        `dtype` sets the trajectory (q, p, S) precision, `mono_dtype` the
        monodromy-block precision (defaults to `dtype`). The mixed mode
        (f64 trajectories + f32 monodromy) keeps the chaotic classical
        dynamics at full precision while the heavy (n, d, d) matmul chain
        runs in f32. `diag_monodromy` selects the diagonal
        representation (valid only for separable potentials — see the
        class docstring). `compensated` selects the comp32 mode: q/p are
        split into f32 value + f32 residual (ignoring `dtype`), and the
        action S stays f64 — give q/p at f64 so the split captures the
        full-precision sample.
        """
        if compensated:
            q64 = q.astype(jnp.float64)
            p64 = p.astype(jnp.float64)
            q = q64.astype(jnp.float32)
            p = p64.astype(jnp.float32)
            qc = (q64 - q.astype(jnp.float64)).astype(jnp.float32)
            pc = (p64 - p.astype(jnp.float64)).astype(jnp.float32)
            S = jnp.zeros((q.shape[0],), dtype=jnp.float64)
        else:
            if dtype is not None:
                q = q.astype(dtype)
                p = p.astype(dtype)
            qc = pc = None
            S = jnp.zeros((q.shape[0],), dtype=q.dtype)
        if mono_dtype is None:
            mono_dtype = q.dtype
        n, d = q.shape
        if diag_monodromy:
            eye = jnp.ones((n, d), dtype=mono_dtype)
            zeros = jnp.zeros((n, d), dtype=mono_dtype)
        else:
            eye = jnp.broadcast_to(jnp.eye(d, dtype=mono_dtype), (n, d, d))
            zeros = jnp.zeros((n, d, d), dtype=mono_dtype)
        return TrajState(
            q=q, p=p,
            Mqq=eye, Mqp=zeros, Mpq=zeros, Mpp=eye,
            S=S, qc=qc, pc=pc,
        )


@pytree_dataclass
class SignTracker:
    """Branch-cut tracking state for sqrt(z(t)) along the propagation.

    sqrt has a branch cut on the negative real axis; to keep sqrt(z(t))
    continuous in time the sign flips whenever z crosses the cut
    (reference propagators.py:1006-1066). `previous` holds z(t - dt),
    `signs` the accumulated +-1 per trajectory.
    """

    previous: jnp.ndarray  # (n,) complex  z at the previous evaluation
    signs: jnp.ndarray     # (n,) real     accumulated sign of sqrt

    @staticmethod
    def fresh(z):
        return SignTracker(previous=z, signs=jnp.ones(z.shape, dtype=z.real.dtype))

    def update(self, z):
        """Advance the tracker to the new value z(t); returns the new tracker.

        The crossing condition (Re z1 < 0) & (Re z2 < 0) & (Im z1 Im z2 < 0)
        is elementwise (reference propagators.py:1045-1047).
        """
        z1, z2 = self.previous, z
        cond = (z1.real < 0) & (z2.real < 0) & (z1.imag * z2.imag < 0)
        signs = jnp.where(cond, -self.signs, self.signs)
        return SignTracker(previous=z, signs=signs)
