# coding: utf-8
"""GPU tier (``SEMI_GPU_TESTS=1 python -m pytest tests/ -q -m gpu``, or
``python chip_smoke.py``, which runs them in its own process).

These re-verify the numerics contract on the card: the batched linear
algebra against LAPACK at production widths, the mixed-precision C(0)
invariant, a production-length HK scan, the WM paths and the exact Morse
integrator. Everything else in the suite runs on the CPU backend
(conftest.py); these tests are skipped there.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def _random_well_conditioned(rng, n, m):
    return (np.eye(m)
            + 0.3 * (rng.standard_normal((n, m, m))
                     + 1j * rng.standard_normal((n, m, m))) / np.sqrt(m)
            ).astype(np.complex64)


def test_batched_linalg_vs_lapack_on_chip():
    """The production batched det (HK prefactor width) and blocked det +
    solve (WM A-matrix width) against host complex128 LAPACK, complex64,
    through the implementation `auto` picks on this backend."""
    from semiclassical_jax import linalg

    rng = np.random.default_rng(0)
    A = _random_well_conditioned(rng, 4096, 45)
    det = np.asarray(jax.jit(linalg.batched_det)(jnp.asarray(A)))
    ref = np.linalg.det(A[:512].astype(np.complex128))
    assert np.abs(det[:512] - ref).max() / np.abs(ref).max() < 1e-4

    A = _random_well_conditioned(rng, 1024, 90)
    B = (rng.standard_normal((1024, 90, 45))
         + 1j * rng.standard_normal((1024, 90, 45))).astype(np.complex64)
    h = 45
    det, Y = jax.jit(linalg.batched_det_solve_blocks)(
        *(jnp.asarray(x) for x in (A[:, :h, :h], A[:, :h, h:], A[:, h:, :h],
                                   A[:, h:, h:], B[:, :h], B[:, h:])))
    A128 = A[:256].astype(np.complex128)
    ref_det = np.linalg.det(A128)
    assert (np.abs(np.asarray(det)[:256] - ref_det).max()
            / np.abs(ref_det).max() < 1e-4)
    assert np.abs(np.asarray(Y)[:256] - np.linalg.solve(A128, B[:256])
                  ).max() < 1e-4


def _as60(ntraj, integrator="rk4"):
    from semiclassical_jax.potentials import MorsePotential
    from semiclassical_jax.propagation import HermanKlukPropagator

    rng = np.random.default_rng(42)
    d = 60
    omega = rng.uniform(200.0, 3000.0, size=d) / 219474.63
    S = rng.uniform(0.01, 0.3, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    pot = MorsePotential.create(omega, np.full(d, 0.02), nac,
                                dtype=jnp.float64)
    dQ = np.sqrt(2.0 * S / omega)
    Gamma = np.diag(omega)
    prop = HermanKlukPropagator(Gamma, Gamma, dtype=jnp.float32,
                                traj_dtype=jnp.float64,
                                integrator=integrator)
    prop.initial_conditions(dQ, np.zeros(d), Gamma, ntraj=ntraj, key=0,
                            potential=pot)
    return prop, pot


def test_mixed_precision_c0_on_chip():
    """C(0) = 1 to 1e-3 in the mixed mode — the canary for reduced-
    precision (TF32) matmuls and batched-det regressions."""
    prop, pot = _as60(4096)
    cauto, kic = prop.propagate(pot, 0.25, 2, check_energy=False)
    assert abs(cauto[0] - 1.0) < 1e-3
    assert np.isfinite(cauto).all() and np.isfinite(kic).all()


@pytest.mark.slow
def test_hk_100_step_scan_on_chip():
    """A production-length chunked scan (100 steps) stays finite, keeps
    |C| <= ~1, and conserves the ensemble energy on chip."""
    prop, pot = _as60(4096)
    cauto, kic = prop.propagate(pot, 0.25, 100, chunk=50,
                                check_energy=False)
    assert np.isfinite(cauto).all() and np.isfinite(kic).all()
    assert abs(cauto[0] - 1.0) < 1e-3
    assert np.abs(cauto).max() < 1.5  # normalized autocorrelation


def test_wm_mixed_step_on_chip():
    """One WM fast-path step at 60 modes on hardware: C(0) ~ 1 and the
    determinant trackers stay finite."""
    from semiclassical_jax.potentials import MorsePotential
    from semiclassical_jax.propagation import WaltonManolopoulosPropagator

    rng = np.random.default_rng(42)
    d = 60
    omega = rng.uniform(200.0, 3000.0, size=d) / 219474.63
    S = rng.uniform(0.01, 0.3, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    pot = MorsePotential.create(omega, np.full(d, 0.02), nac,
                                dtype=jnp.float64)
    dQ = np.sqrt(2.0 * S / omega)
    Gamma = np.diag(omega)
    prop = WaltonManolopoulosPropagator(Gamma, Gamma, 10000.0, 10000.0,
                                        dtype=jnp.float32,
                                        traj_dtype=jnp.float64)
    prop.initial_conditions(dQ, np.zeros(d), Gamma, ntraj=2048, key=0,
                            potential=pot)
    cauto, kic = prop.propagate(pot, 0.25, 2, check_energy=False)
    assert abs(cauto[0] - 1.0) < 2e-2  # MC estimate at 2048 trajectories
    assert np.isfinite(cauto).all() and np.isfinite(kic).all()


def test_comp32_wm_step_on_chip():
    """The production comp32 WM path (per-mode 2x2 fast path + collapsed
    prefactor/overlap constants + residual-folded displacements) on
    hardware: C(0) ~ 1 and finite observables."""
    from semiclassical_jax.potentials import MorsePotential
    from semiclassical_jax.propagation import WaltonManolopoulosPropagator

    rng = np.random.default_rng(42)
    d = 60
    omega = rng.uniform(200.0, 3000.0, size=d) / 219474.63
    S = rng.uniform(0.01, 0.3, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    pot = MorsePotential.create(omega, np.full(d, 0.02), nac,
                                dtype=jnp.float32)
    dQ = np.sqrt(2.0 * S / omega)
    Gamma = np.diag(omega)
    prop = WaltonManolopoulosPropagator(Gamma, Gamma, 10000.0, 10000.0,
                                        dtype=jnp.float32,
                                        traj_dtype="comp32")
    prop.initial_conditions(dQ, np.zeros(d), Gamma, ntraj=2048, key=0,
                            potential=pot)
    assert prop.state.compensated and prop.state.diag_monodromy
    assert prop.params.hk.diag_ka is not None      # collapsed prefactor
    assert prop.params.hk.csot0.diag_w is not None  # collapsed overlaps
    cauto, kic = prop.propagate(pot, 0.25, 5, check_energy=False)
    assert abs(cauto[0] - 1.0) < 2e-2
    assert np.isfinite(cauto).all() and np.isfinite(kic).all()


def test_exact_morse_hybrid_on_chip():
    """The exact Morse integrator's hybrid (mixed mode) on hardware:
    twin run vs the RK4 integrator on the identical ensemble (unbound
    tail rows RK4-routed through the side-channel in the exact run).
    The gap is bounded by the tail-row f32 exponent noise."""
    prop_r, pot = _as60(4096)
    c_r, k_r = prop_r.propagate(pot, 0.25, 20, check_energy=False)

    prop_e, pot_e = _as60(4096, integrator="exact")
    c_e, k_e = prop_e.propagate(pot_e, 0.25, 20, check_energy=True)
    assert np.isfinite(c_e).all() and np.isfinite(k_e).all()
    assert np.abs(c_e - c_r).max() < 5e-3
    # energy trace of the exact part is constant by construction
    assert np.ptp(prop_e.last_energies) < 1e-5
