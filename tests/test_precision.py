# coding: utf-8
"""float32/complex64 propagation vs float64 reference.

The accelerator default precision modes run the scan in f32/c64 (with f64
host-side scalar factors and normalised MC weights).
This gate checks that the reduced-precision correlations stay within a
fraction of the Monte-Carlo noise floor of the f64 result on a multi-mode
anharmonic model.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from semiclassical_jax.potentials import MorsePotential
from semiclassical_jax.propagation import (
    HermanKlukPropagator,
    WaltonManolopoulosPropagator,
)


def _run(prop_cls, kwargs, dtype, traj_dtype=None):
    rng = np.random.default_rng(0)
    d = 12
    omega = rng.uniform(300.0, 2500.0, size=d) / 219474.63
    chi = np.full(d, 0.02)
    nac = rng.uniform(-1.0, 1.0, size=d)
    S = rng.uniform(0.02, 0.3, size=d)
    pot = MorsePotential.create(omega, chi, nac, dtype=dtype)
    Gamma = np.diag(omega)
    q0 = np.sqrt(2 * S / omega)

    prop = prop_cls(Gamma, Gamma, dtype=dtype, traj_dtype=traj_dtype,
                    **kwargs)
    prop.initial_conditions(q0, np.zeros(d), Gamma, ntraj=4096, key=11,
                            potential=pot)
    # ~500 a.u. of propagation, production-like step
    return prop.propagate(pot, 2.0, 100, energy0_es=float(omega.sum() / 2),
                          check_energy=False)


@pytest.mark.parametrize("prop_cls,kwargs", [
    (HermanKlukPropagator, {}),
    (WaltonManolopoulosPropagator, {"alpha": 500.0, "beta": 500.0}),
])
def test_f32_matches_f64(prop_cls, kwargs):
    c64_c, c64_k = _run(prop_cls, kwargs, jnp.float64)
    c32_c, c32_k = _run(prop_cls, kwargs, jnp.float32)
    # identical sample stream is not guaranteed across dtypes (the normal
    # draws differ in dtype), but with the same key jax.random produces the
    # same underlying bits -> same trajectories up to rounding
    err_c = np.abs(c32_c - c64_c).max() / max(np.abs(c64_c).max(), 1e-30)
    err_k = np.abs(c32_k - c64_k).max() / max(np.abs(c64_k).max(), 1e-30)
    # f32 trajectory rounding is amplified by the anharmonic dynamics
    # (trajectory-level chaos); after 100 steps the ensemble-level deviation
    # is a few percent at this batch size — same order as the Monte-Carlo
    # statistical error. Production accuracy on the GPU uses the mixed mode
    # (f64 trajectories + f32 monodromy/complex algebra).
    assert err_c < 5e-2, err_c
    assert err_k < 1e-1, err_k


@pytest.mark.parametrize("prop_cls,kwargs", [
    (HermanKlukPropagator, {}),
    (WaltonManolopoulosPropagator, {"alpha": 500.0, "beta": 500.0}),
])
def test_mixed_matches_f64(prop_cls, kwargs):
    """Mixed mode (f64 trajectories + f32 monodromy/complex) must track the
    full-f64 result far more tightly than pure f32 — the classical chaos
    lives in (q, p), which stay f64."""
    c64_c, c64_k = _run(prop_cls, kwargs, jnp.float64)
    cm_c, cm_k = _run(prop_cls, kwargs, jnp.float32, traj_dtype=jnp.float64)
    err_c = np.abs(cm_c - c64_c).max() / max(np.abs(c64_c).max(), 1e-30)
    err_k = np.abs(cm_k - c64_k).max() / max(np.abs(c64_k).max(), 1e-30)
    assert err_c < 1e-4, err_c
    assert err_k < 1e-3, err_k


def test_wm_mixed_many_modes():
    """Regression: the WM M-matrix determinant underflows complex64 beyond
    ~15 modes unless scaled (det(M'/2pi) ~ 1e-180 at 60 modes); the scaled
    formulation (WMParams.m_scale / m_log_det) must keep the production
    observables finite and within the mixed-precision envelope of f64."""
    rng = np.random.default_rng(42)
    d = 60
    omega = rng.uniform(200.0, 3000.0, size=d) / 219474.63
    S = rng.uniform(0.01, 0.3, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    chi = np.full(d, 0.02)
    pot = MorsePotential.create(omega, chi, nac, dtype=jnp.float64)
    dQ = np.sqrt(2.0 * S / omega)
    Gamma = np.diag(omega)

    def run(dtype, traj_dtype):
        prop = WaltonManolopoulosPropagator(
            Gamma, Gamma, alpha=10000.0, beta=10000.0,
            dtype=dtype, traj_dtype=traj_dtype)
        prop.initial_conditions(dQ, np.zeros(d), Gamma, ntraj=128, key=0,
                                potential=pot)
        c, k = prop.propagate(pot, 0.25, 5, check_energy=False)
        return np.asarray(c), np.asarray(k)

    cm, km = run(jnp.float32, jnp.float64)
    assert np.isfinite(cm).all() and np.isfinite(km).all()
    assert abs(cm[0] - 1.0) < 1e-2  # MC estimate at small ntraj
    c64, k64 = run(jnp.float64, None)
    assert np.abs(cm - c64).max() < 1e-3 * np.abs(c64).max()


@pytest.mark.slow
def test_wm_diagnostics_many_modes_mixed():
    """The WM diagnostics (norm / wavefunction / coefficients) at the
    60-mode flagship scale in MIXED precision: the per-trajectory
    coefficient magnitude is ~1e-41 there (underflows complex64 — the
    round-2 known gap), so the log-magnitude representation must carry
    them. Gate: mixed-mode values agree with the full-f64 evaluation of
    the same ensemble to ~1e-3 relative."""
    rng = np.random.default_rng(42)
    d = 60
    omega = rng.uniform(200.0, 3000.0, size=d) / 219474.63
    S = rng.uniform(0.01, 0.3, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    chi = np.full(d, 0.02)
    pot = MorsePotential.create(omega, chi, nac, dtype=jnp.float64)
    dQ = np.sqrt(2.0 * S / omega)
    Gamma = np.diag(omega)
    x_grid = dQ[None, :] * np.linspace(0.0, 1.2, 5)[:, None]  # (5, d)

    def run(dtype, traj_dtype):
        prop = WaltonManolopoulosPropagator(
            Gamma, Gamma, alpha=10000.0, beta=10000.0,
            dtype=dtype, traj_dtype=traj_dtype)
        prop.initial_conditions(dQ, np.zeros(d), Gamma, ntraj=96, key=0,
                                potential=pot)
        prop.propagate(pot, 0.25, 3, check_energy=False)
        lr, li = prop.log_coefficients()
        return prop.norm(), prop.wavefunction(jnp.asarray(x_grid)), lr, li

    norm_m, psi_m, lr_m, li_m = run(jnp.float32, jnp.float64)
    norm_64, psi_64, lr_64, li_64 = run(jnp.float64, None)

    # the f64 values are finite and nonzero; mixed must reproduce them
    assert np.isfinite(norm_64) and norm_64 > 0.0
    assert np.isfinite(norm_m) and norm_m > 0.0
    assert abs(norm_m - norm_64) < 2e-3 * norm_64
    assert np.isfinite(psi_m).all()
    assert np.abs(psi_m - psi_64).max() < 2e-3 * np.abs(psi_64).max()
    # the linear-scale pipeline is range-dead here: every pairwise norm
    # term conj(v_m) v_n (exp(lr_m + lr_n) ~ 1e-55) and the wavefunction
    # values themselves (~1e-38 and below on this grid) underflow f32
    assert 2.0 * lr_64.max() < np.log(1e-38)
    assert 0.0 < np.abs(psi_64).min() < 1e-38
    assert np.isfinite(lr_m).all()
    assert np.abs(lr_m - lr_64).max() < 1e-2
    # phases agree mod 2 pi
    dphi = (li_m - li_64 + np.pi) % (2 * np.pi) - np.pi
    assert np.abs(dphi).max() < 1e-2
