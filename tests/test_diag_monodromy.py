# coding: utf-8
"""Diagonal monodromy representation (separable potentials).

For a separable potential the Hessian is diagonal at every geometry, so a
monodromy that starts at the identity stays exactly diagonal; the (n, d)
representation must reproduce the dense (n, d, d) propagation bit-for-bit
(up to fp reassociation). The reference always carries dense blocks
(propagators.py:321-376) — this is a framework-side exact optimization.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest

from semiclassical_jax.potentials import MorsePotential
from semiclassical_jax.propagation import (HermanKlukPropagator,
                                           WaltonManolopoulosPropagator)
from semiclassical_jax.propagation.state import TrajState


def _as_setup(d=4, seed=11):
    rng = np.random.default_rng(seed)
    omega = rng.uniform(500.0, 2500.0, size=d) / 219474.63
    S = rng.uniform(0.05, 0.3, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    chi = np.full(d, 0.02)
    pot = MorsePotential.create(omega, chi, nac)
    dQ = np.sqrt(2.0 * S / omega)
    Gamma = np.diag(omega)
    return pot, dQ, Gamma


def _run_both(prop, pot, dt, nt):
    """Propagate once with the auto-selected diagonal representation and
    once with a dense state rebuilt from the same sampled phase points."""
    assert prop.state.diag_monodromy, "separable potential must auto-select"
    qi, pi = prop.state.q, prop.state.p
    snap = (prop.state, copy.copy(prop.trackers), prop.t)

    c_diag, k_diag = prop.propagate(pot, dt, nt, check_energy=False)
    state_diag = prop.state

    prop.state, prop.trackers, prop.t = snap
    prop.state = TrajState.initial(qi, pi, dtype=prop.traj_dtype,
                                   mono_dtype=prop.dtype,
                                   diag_monodromy=False)
    prop.trackers = prop._make_trackers(prop.state)
    c_dense, k_dense = prop.propagate(pot, dt, nt, check_energy=False)
    return (c_diag, k_diag, state_diag), (c_dense, k_dense, prop.state)


@pytest.mark.parametrize("diag_gamma", [True, False])
def test_hk_diag_vs_dense(diag_gamma):
    pot, dQ, Gamma = _as_setup()
    if not diag_gamma:
        # couple the width so the factor matrices are non-diagonal: the
        # diagonal-monodromy path must then still go through the dense
        # prefactor determinant
        d = Gamma.shape[0]
        mix = 0.1 * np.min(np.diag(Gamma))
        Gamma = Gamma + mix * (np.ones((d, d)) - np.eye(d))

    prop = HermanKlukPropagator(Gamma, Gamma)
    prop.initial_conditions(dQ, np.zeros_like(dQ), Gamma, ntraj=128, key=3,
                            potential=pot)
    assert prop.params.factors_diag == diag_gamma

    (c1, k1, s1), (c2, k2, s2) = _run_both(prop, pot, dt=1.0, nt=25)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(k1), np.asarray(k2),
                               rtol=1e-9, atol=1e-12)
    # final monodromy blocks agree after expanding the diagonals
    for a, b in zip(s1.dense_monodromy(), (s2.Mqq, s2.Mqp, s2.Mpq, s2.Mpp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-9, atol=1e-11)


def test_wm_diag_vs_dense():
    pot, dQ, Gamma = _as_setup(seed=5)
    prop = WaltonManolopoulosPropagator(Gamma, Gamma, 800.0, 800.0)
    prop.initial_conditions(dQ, np.zeros_like(dQ), Gamma, ntraj=96, key=7,
                            potential=pot)
    (c1, k1, _), (c2, k2, _) = _run_both(prop, pot, dt=1.0, nt=15)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(k1), np.asarray(k2),
                               rtol=1e-8, atol=1e-11)


def test_wm_diagnostics_diag_state():
    """norm()/coefficients() route through wm_derived (the tensor path) —
    it must accept the diagonal representation too."""
    pot, dQ, Gamma = _as_setup(seed=9)
    prop = WaltonManolopoulosPropagator(Gamma, Gamma, 800.0, 800.0)
    prop.initial_conditions(dQ, np.zeros_like(dQ), Gamma, ntraj=64, key=1,
                            potential=pot)
    assert prop.state.diag_monodromy
    for _ in range(3):
        prop.step(pot, 1.0)
    v = np.asarray(prop.coefficients())
    assert np.isfinite(v).all()
    n = prop.norm()
    assert np.isfinite(n) and n > 0.0


def test_monodromy_matrices_dense_api():
    pot, dQ, Gamma = _as_setup(seed=2)
    prop = HermanKlukPropagator(Gamma, Gamma)
    prop.initial_conditions(dQ, np.zeros_like(dQ), Gamma, ntraj=32, key=0,
                            potential=pot)
    Mqq, Mqp, Mpq, Mpp = prop.monodromy_matrices()
    n, d = prop.state.q.shape
    assert Mqq.shape == (n, d, d)
    np.testing.assert_allclose(np.asarray(Mqq),
                               np.eye(d)[None].repeat(n, axis=0))
    np.testing.assert_allclose(np.asarray(Mqp), 0.0)
