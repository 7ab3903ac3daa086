# coding: utf-8
"""The WM scan fast path (scalar bilinear forms through Y = iAb^T P, no
(n, d, d) tensors) must reproduce the full-tensor `wm_derived` evaluation
exactly — including on rank-deficient width matrices (zero modes)."""

import numpy as np
import pytest
import jax.numpy as jnp

from semiclassical_jax.potentials import MorsePotential
from semiclassical_jax.propagation import WaltonManolopoulosPropagator
from semiclassical_jax.propagation.wm import (
    wm_derived,
    wm_observables,
    wm_scan_derived,
    wm_scan_observables,
)
from semiclassical_jax.units import hbar


def _setup(with_zero_modes):
    rng = np.random.default_rng(7)
    omega4 = rng.uniform(0.005, 0.02, size=4)
    nac4 = rng.uniform(-1.0, 1.0, size=4)
    q04 = rng.uniform(0.5, 1.5, size=4)
    if with_zero_modes:
        omega = np.concatenate([omega4, [0.0, 0.0]])
        nac = np.concatenate([nac4, [0.0, 0.0]])
        q0 = np.concatenate([q04, [0.0, 0.0]])
    else:
        omega, nac, q0 = omega4, nac4, q04
    d = omega.shape[0]
    pot = MorsePotential.create(omega, np.full(d, 0.02), nac)
    Gamma = np.diag(omega)
    prop = WaltonManolopoulosPropagator(Gamma, Gamma, 250.0, 400.0)
    prop.initial_conditions(q0, np.zeros(d), Gamma, ntraj=256, key=5,
                            potential=pot)
    # advance a few steps so the monodromy is far from the identity
    prop.propagate(pot, 1.0, 7, energy0_es=0.01)
    return prop, pot


@pytest.mark.parametrize("with_zero_modes", [False, True])
def test_scan_derived_matches_full_tensors(with_zero_modes):
    prop, pot = _setup(with_zero_modes)
    params, bc, state = prop.params, prop._bc, prop.state

    full = wm_derived(params, bc, state)
    fast = wm_scan_derived(params, bc, state, pot)

    np.testing.assert_allclose(np.asarray(fast.detA), np.asarray(full.detA),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(fast.detM), np.asarray(full.detM),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.asarray(fast.gamma), np.asarray(full.gamma),
                               rtol=1e-9, atol=1e-12)

    # scalar forms recomputed from the full tensors
    q0 = np.asarray(params.hk.q0)
    dq = q0[None, :] - np.asarray(bc.base.qi)
    dQ = q0[None, :] - np.asarray(state.q)
    Rqq, RQQ, RqQ = (np.asarray(full.Rqq), np.asarray(full.RQQ),
                     np.asarray(full.RqQ))
    Pq, PQ = np.asarray(full.Pq), np.asarray(full.PQ)
    np.testing.assert_allclose(np.asarray(fast.rqq),
                               np.einsum("ni,nij,nj->n", dq, Rqq, dq),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(fast.rQQ),
                               np.einsum("ni,nij,nj->n", dQ, RQQ, dQ),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(fast.rqQ),
                               np.einsum("ni,nij,nj->n", dq, RqQ, dQ),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(fast.Pq_dq),
                               np.einsum("ni,ni->n", Pq, dq),
                               rtol=1e-8, atol=1e-11)
    np.testing.assert_allclose(np.asarray(fast.PQ_dQ),
                               np.einsum("ni,ni->n", PQ, dQ),
                               rtol=1e-8, atol=1e-11)


@pytest.mark.parametrize("with_zero_modes", [False, True])
def test_scan_observables_match_full(with_zero_modes):
    prop, pot = _setup(with_zero_modes)
    params, bc, state = prop.params, prop._bc, prop.state
    c = prop.semiclassical_prefactor()

    full = wm_derived(params, bc, state)
    prop.trackers["detA"] = prop.trackers["detA"].update(full.detA)
    prop.trackers["detM"] = prop.trackers["detM"].update(full.detM)
    sA = prop.trackers["detA"].signs
    sM = prop.trackers["detM"].signs

    cauto_full, kic_full = wm_observables(params, bc, state, full, c,
                                          sA, sM, pot)
    fast = wm_scan_derived(params, bc, state, pot)
    cauto_fast, kic_fast = wm_scan_observables(params, bc, state, fast, c,
                                               sA, sM)
    assert abs(complex(cauto_fast) - complex(cauto_full)) < 1e-10
    assert abs(complex(kic_fast) - complex(kic_full)) < 1e-10 * max(
        1.0, abs(complex(kic_full)))


def test_diag_path_matches_generic():
    """The per-mode 2x2 path (scan_diag, WMDiagConsts) must agree with the
    generic projected-2r evaluation field by field: the basis change U is
    orthogonal and the balancing is det-preserving, so the only differences
    are rounding."""
    from semiclassical_jax.pytree import replace

    prop, pot = _setup(with_zero_modes=False)
    params, bc, state = prop.params, prop._bc, prop.state
    assert params.scan_diag and state.diag_monodromy

    fast_diag = wm_scan_derived(params, bc, state, pot)
    generic = wm_scan_derived(replace(params, scan_diag=False),
                              bc, state, pot)
    for field in ("detA", "detM", "gamma", "rqq", "rQQ", "rqQ",
                  "Pq_dq", "PQ_dQ", "kfac"):
        np.testing.assert_allclose(
            np.asarray(getattr(fast_diag, field)),
            np.asarray(getattr(generic, field)),
            rtol=1e-9, atol=1e-12, err_msg=field)


def test_diag_path_full_scan_equivalence():
    """End to end: the jitted WM scan with the diag path produces the same
    correlation functions as the generic fast path over a time horizon long
    enough to cross sqrt branch cuts."""
    from semiclassical_jax.pytree import replace

    rng = np.random.default_rng(11)
    d = 6
    omega = rng.uniform(0.005, 0.02, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    q0 = rng.uniform(0.5, 1.5, size=d)
    pot = MorsePotential.create(omega, np.full(d, 0.02), nac)
    Gamma = np.diag(omega)

    results = {}
    for label, force_generic in (("diag", False), ("generic", True)):
        prop = WaltonManolopoulosPropagator(Gamma, Gamma, 250.0, 400.0)
        prop.initial_conditions(q0, np.zeros(d), Gamma, ntraj=512, key=3,
                                potential=pot)
        if force_generic:
            prop.params = replace(prop.params, scan_diag=False)
        assert prop.params.scan_diag is (not force_generic)
        cauto, kic = prop.propagate(pot, 1.0, 60, energy0_es=0.01)
        results[label] = (np.asarray(cauto), np.asarray(kic))

    np.testing.assert_allclose(results["diag"][0], results["generic"][0],
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(results["diag"][1], results["generic"][1],
                               rtol=1e-9, atol=1e-12)
