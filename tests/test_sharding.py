# coding: utf-8
"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

The SURVEY test plan calls for identical-results tests across shardings
(1 chip vs mesh) — no fake backends, the same physics on both layouts.
"""

import numpy as np
import jax

from semiclassical_jax.parallel import ensemble_mesh
from semiclassical_jax.potentials import MorsePotential, NonHarmonicPotential
from semiclassical_jax.propagation import (
    HermanKlukPropagator,
    WaltonManolopoulosPropagator,
)


def _correlations(prop_cls, kwargs, mesh, key=7):
    pot = NonHarmonicPotential.create()
    Gi = np.array([[2 * 2.5]])
    G0 = np.array([[1.0]])
    prop = prop_cls(Gi, Gi, **kwargs)
    prop.initial_conditions(np.array([7.3]), np.array([0.0]), G0,
                            ntraj=4096, key=key, potential=pot, mesh=mesh)
    return prop.propagate(pot, 0.02, 25, energy0_es=0.5)


def test_hk_sharded_matches_single_device():
    assert len(jax.devices()) == 8, "tests expect 8 virtual devices"
    mesh = ensemble_mesh()
    c1, k1 = _correlations(HermanKlukPropagator, {}, None)
    c8, k8 = _correlations(HermanKlukPropagator, {}, mesh)
    np.testing.assert_allclose(c8, c1, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(k8, k1, rtol=1e-12, atol=1e-14)


def test_wm_sharded_matches_single_device():
    mesh = ensemble_mesh()
    kwargs = dict(alpha=100.0, beta=100.0)
    c1, k1 = _correlations(WaltonManolopoulosPropagator, kwargs, None)
    c8, k8 = _correlations(WaltonManolopoulosPropagator, kwargs, mesh)
    np.testing.assert_allclose(c8, c1, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(k8, k1, rtol=1e-10, atol=1e-12)


def test_sharded_rank_deficient():
    """6-mode model with 2 zero-frequency modes (singular Gamma, rank 4 —
    the molecular translations/rotations situation): the zero-mode
    U-projection machinery (sampling, prefactor, observables) must give
    identical results on the 8-device mesh and on one device, and must
    equal the 4-mode full-rank system the singular one embeds
    (reference zero-mode handling propagators.py:496-498,994,1246-1250)."""
    rng = np.random.default_rng(1)
    omega4 = rng.uniform(0.005, 0.02, size=4)
    nac4 = rng.uniform(-1.0, 1.0, size=4)
    q04 = rng.uniform(0.5, 1.5, size=4)

    def run(omega, nac, q0, mesh, prop_cls=HermanKlukPropagator, **kwargs):
        d = omega.shape[0]
        pot = MorsePotential.create(omega, np.full(d, 0.02), nac)
        Gamma = np.diag(omega)
        prop = prop_cls(Gamma, Gamma, **kwargs)
        prop.initial_conditions(q0, np.zeros(d), Gamma, ntraj=2048, key=11,
                                potential=pot, mesh=mesh)
        return prop.propagate(pot, 1.0, 10, energy0_es=0.01)

    # zero modes appended at the end (eigh orders ascending, so the
    # non-zero subspace keeps the same internal ordering in both systems)
    omega6 = np.concatenate([omega4, [0.0, 0.0]])
    nac6 = np.concatenate([nac4, [0.0, 0.0]])
    q06 = np.concatenate([q04, [0.0, 0.0]])

    mesh = ensemble_mesh()
    c1, k1 = run(omega6, nac6, q06, None)
    c8, k8 = run(omega6, nac6, q06, mesh)
    np.testing.assert_allclose(c8, c1, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(k8, k1, rtol=1e-10, atol=1e-12)
    # normalisation survives the rank-deficient sampling under SPMD
    assert abs(c8[0] - 1.0) < 1e-3

    # embedding invariance: padding with zero modes changes nothing
    c4, k4 = run(omega4, nac4, q04, mesh)
    np.testing.assert_allclose(c8, c4, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(k8, k4, rtol=1e-9, atol=1e-11)

    # WM on the same singular-Gamma configuration, sharded vs single
    kwargs = dict(alpha=200.0, beta=200.0)
    cw1, kw1 = run(omega6, nac6, q06, None,
                   prop_cls=WaltonManolopoulosPropagator, **kwargs)
    cw8, kw8 = run(omega6, nac6, q06, mesh,
                   prop_cls=WaltonManolopoulosPropagator, **kwargs)
    np.testing.assert_allclose(cw8, cw1, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(kw8, kw1, rtol=1e-9, atol=1e-11)


def test_sharded_multimode():
    """5-mode full-rank Morse: sharded and single-device runs must agree."""
    rng = np.random.default_rng(0)
    omega = rng.uniform(0.005, 0.02, size=5)
    chi = np.full(5, 0.02)
    nac = rng.uniform(-1.0, 1.0, size=5)
    pot = MorsePotential.create(omega, chi, nac)
    Gamma = np.diag(omega)
    q0 = rng.uniform(0.5, 1.5, size=5)
    p0 = np.zeros(5)

    mesh = ensemble_mesh()
    results = []
    for m in (None, mesh):
        prop = HermanKlukPropagator(Gamma, Gamma)
        prop.initial_conditions(q0, p0, Gamma, ntraj=2048, key=3,
                                potential=pot, mesh=m)
        results.append(prop.propagate(pot, 1.0, 10, energy0_es=0.01))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-10)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-10)


def test_non_divisible_ntraj_rounds_up_with_true_weights():
    """ntraj % n_devices != 0. The sampler rounds the
    count UP to a mesh multiple with REAL extra samples (not zero
    padding), so the MC weight convention 1/(n P (2 pi hbar)^d)
    (reference propagators.py:555) uses the true, rounded n — the
    sharded run must equal the unsharded run at that rounded count
    exactly, and C(0) must stay normalised."""
    pot = NonHarmonicPotential.create()
    Gi = np.array([[2 * 2.5]])
    G0 = np.array([[1.0]])
    mesh = ensemble_mesh()

    prop8 = HermanKlukPropagator(Gi, Gi)
    prop8.initial_conditions(np.array([7.3]), np.array([0.0]), G0,
                             ntraj=1001, key=13, potential=pot, mesh=mesh)
    assert prop8.ntraj == 1008  # rounded up to the 8-device multiple
    c8, k8 = prop8.propagate(pot, 0.02, 25, energy0_es=0.5)

    prop1 = HermanKlukPropagator(Gi, Gi)
    prop1.initial_conditions(np.array([7.3]), np.array([0.0]), G0,
                             ntraj=1008, key=13, potential=pot)
    c1, k1 = prop1.propagate(pot, 0.02, 25, energy0_es=0.5)

    np.testing.assert_allclose(c8, c1, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(k8, k1, rtol=1e-12, atol=1e-14)
    assert abs(c8[0] - 1.0) < 5e-2  # MC normalisation at the true n
