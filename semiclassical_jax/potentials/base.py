# coding: utf-8
"""Structured Hessian operators for the monodromy equations of motion.

The equations of motion contract the local Hessian with the monodromy blocks
(dM_pq/dt = -H M_qq, dM_pp/dt = -H M_qp; reference propagators.py:342-357).
For separable potentials the Hessian is diagonal and the contraction is an
elementwise scale; for molecular potentials it is a batched (n, d, d)
matmul.
"""

from __future__ import annotations

import jax.numpy as jnp

from semiclassical_jax.pytree import pytree_dataclass


@pytree_dataclass
class DiagHessian:
    """Diagonal Hessian batch, stored as (n, d)."""

    diag: jnp.ndarray

    def matmul(self, M: jnp.ndarray) -> jnp.ndarray:
        """H @ M for monodromy blocks M of shape (n, d, d), or (n, d) in
        the diagonal-monodromy representation (result keeps M's dtype —
        the monodromy precision is a deliberate choice)."""
        h = self.diag.astype(M.dtype)
        return h * M if M.ndim == 2 else h[:, :, None] * M

    def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
        """H @ v for a batch of vectors v of shape (n, d)."""
        return self.diag.astype(v.dtype) * v

    def dense(self) -> jnp.ndarray:
        n, d = self.diag.shape
        return self.diag[:, :, None] * jnp.eye(d, dtype=self.diag.dtype)[None]


@pytree_dataclass
class DenseHessian:
    """Dense Hessian batch, stored as (n, d, d)."""

    mat: jnp.ndarray

    def matmul(self, M: jnp.ndarray) -> jnp.ndarray:
        return jnp.einsum("nag,ngb->nab", self.mat.astype(M.dtype), M)

    def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
        return jnp.einsum("nag,ng->na", self.mat.astype(v.dtype), v)

    def dense(self) -> jnp.ndarray:
        return self.mat


@pytree_dataclass
class ConstHessian:
    """Geometry-independent Hessian (harmonic molecular PES), stored (d, d).

    Shared across the batch — the monodromy product is a plain matmul with a
    broadcast left operand, which XLA keeps as one constant operand.
    """

    mat: jnp.ndarray

    def matmul(self, M: jnp.ndarray) -> jnp.ndarray:
        return jnp.einsum("ag,ngb->nab", self.mat.astype(M.dtype), M)

    def matvec(self, v: jnp.ndarray) -> jnp.ndarray:
        return v @ self.mat.astype(v.dtype).T

    def dense(self) -> jnp.ndarray:
        return self.mat[None]
