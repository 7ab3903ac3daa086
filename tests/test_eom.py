# coding: utf-8
"""RK4 monodromy integration: the DiagHessian analytic fast path must agree
with the generic dense-Hessian pair recurrence (reference propagators.py:
342-357 always runs the dense contraction; here separable potentials take a
per-row 2x2 linear-map shortcut that must be numerically equivalent)."""

import jax.numpy as jnp
import numpy as np
import pytest

from semiclassical_jax.potentials.base import DenseHessian, DiagHessian
from semiclassical_jax.propagation.eom import rk4_step
from semiclassical_jax.propagation.state import TrajState


class _SeparableQuartic:
    """V = sum_i (w_i^2/2) q_i^2 + (a_i/4) q_i^4 — diagonal Hessian."""

    def __init__(self, w, a, dense):
        self.w = jnp.asarray(w)
        self.a = jnp.asarray(a)
        self.dense = dense

    def masses(self):
        return jnp.ones_like(self.w)

    def local_expansion(self, q):
        v = jnp.sum(0.5 * self.w**2 * q**2 + 0.25 * self.a * q**4, axis=1)
        grad = self.w**2 * q + self.a * q**3
        hdiag = self.w**2 + 3.0 * self.a * q**2
        if self.dense:
            d = q.shape[1]
            return v, grad, DenseHessian(
                mat=hdiag[:, :, None] * jnp.eye(d, dtype=q.dtype)[None])
        return v, grad, DiagHessian(diag=hdiag)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_diag_fast_path_matches_dense_pair(dtype):
    rng = np.random.default_rng(7)
    n, d = 16, 5
    w = rng.uniform(0.5, 2.0, size=d)
    a = rng.uniform(0.01, 0.1, size=d)

    state = TrajState(
        q=jnp.asarray(rng.normal(size=(n, d)), dtype=jnp.float64),
        p=jnp.asarray(rng.normal(size=(n, d)), dtype=jnp.float64),
        Mqq=jnp.asarray(rng.normal(size=(n, d, d)), dtype=dtype),
        Mqp=jnp.asarray(rng.normal(size=(n, d, d)), dtype=dtype),
        Mpq=jnp.asarray(rng.normal(size=(n, d, d)), dtype=dtype),
        Mpp=jnp.asarray(rng.normal(size=(n, d, d)), dtype=dtype),
        S=jnp.zeros(n, dtype=jnp.float64),
    )
    dt = 0.05

    fast, e_fast = rk4_step(state, _SeparableQuartic(w, a, dense=False), dt)
    ref, e_ref = rk4_step(state, _SeparableQuartic(w, a, dense=True), dt)

    tol = 1e-13 if dtype == jnp.float64 else 2e-6
    for leaf in ("q", "p", "S", "Mqq", "Mqp", "Mpq", "Mpp"):
        np.testing.assert_allclose(
            np.asarray(getattr(fast, leaf)), np.asarray(getattr(ref, leaf)),
            rtol=tol, atol=tol, err_msg=leaf)
    np.testing.assert_allclose(float(e_fast), float(e_ref), rtol=1e-12)


def test_diag_fast_path_multistep_stability():
    """100 steps of the separable model: the analytic-map path must keep
    the symplectic invariant Mqq Mpp^T - Mqp Mpq^T = 1 to integrator
    accuracy (same invariant the dense path preserves)."""
    rng = np.random.default_rng(3)
    n, d = 8, 4
    w = rng.uniform(0.5, 2.0, size=d)
    a = np.full(d, 0.05)
    pot = _SeparableQuartic(w, a, dense=False)

    eye = jnp.eye(d, dtype=jnp.float64)[None].repeat(n, axis=0)
    state = TrajState(
        q=jnp.asarray(rng.normal(size=(n, d)) * 0.3, dtype=jnp.float64),
        p=jnp.asarray(rng.normal(size=(n, d)) * 0.3, dtype=jnp.float64),
        Mqq=eye, Mpp=eye,
        Mqp=jnp.zeros((n, d, d), dtype=jnp.float64),
        Mpq=jnp.zeros((n, d, d), dtype=jnp.float64),
        S=jnp.zeros(n, dtype=jnp.float64),
    )
    for _ in range(100):
        state, _ = rk4_step(state, pot, 0.02)
    sympl = (np.asarray(state.Mqq) @ np.swapaxes(np.asarray(state.Mpp), 1, 2)
             - np.asarray(state.Mqp) @ np.swapaxes(np.asarray(state.Mpq), 1, 2))
    np.testing.assert_allclose(sympl, np.eye(d)[None].repeat(n, axis=0),
                               atol=1e-8)
