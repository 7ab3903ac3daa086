# coding: utf-8
"""Tests for the exact constant-Hessian (harmonic) propagation map
(propagation/exact_harmonic.py): an exact affine step built once on the
host via expm + Van Loan, replacing RK4 for the molecular harmonic PES
family (reference potentials.py:529-638 propagated by propagators.py:86-119).

Gates mirror tests/test_exact_morse.py: convergence of RK4 *to* the map,
exactness at coarse dt, exact energy conservation, and the HK twin gap.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from semiclassical_jax.potentials import MolecularHarmonicPotential
from semiclassical_jax.propagation import HermanKlukPropagator
from semiclassical_jax.propagation.eom import rk4_step
from semiclassical_jax.propagation.exact_harmonic import (
    build_harmonic_map, harmonic_step, supports_exact_harmonic)
from semiclassical_jax.propagation.state import TrajState


def _make_potential(d=4, seed=0, with_grad=True, spectrum=None):
    """Synthetic molecular-harmonic PES with mass-weighted normal-mode
    frequencies `spectrum` (squared values land in the Hessian; zero and
    negative entries exercise the translation/saddle generality)."""
    rng = np.random.default_rng(seed)
    mass = rng.uniform(800.0, 2000.0, size=d)
    if spectrum is None:
        spectrum = rng.uniform(0.004, 0.02, size=d) ** 2
    Vv, _ = np.linalg.qr(rng.standard_normal((d, d)))
    Hmw = (Vv * spectrum) @ Vv.T
    sm = np.sqrt(mass)
    H = sm[:, None] * Hmw * sm[None, :]
    grad0 = 1.0e-3 * rng.standard_normal(d) if with_grad else np.zeros(d)
    return MolecularHarmonicPotential(
        pos0=jnp.asarray(rng.standard_normal(d)),
        energy0=jnp.asarray(0.5),
        grad0=jnp.asarray(grad0),
        hess0=jnp.asarray(0.5 * (H + H.T)),
        nac0=jnp.asarray(rng.uniform(-1.0, 1.0, size=d)),
        mass=jnp.asarray(mass),
        origin=jnp.asarray(0.123),
    )


def _make_state(pot, n=16, seed=1):
    d = pot.dimensions()
    rng = np.random.default_rng(seed)
    eye = jnp.broadcast_to(jnp.eye(d), (n, d, d))
    return TrajState(
        q=jnp.asarray(np.asarray(pot.pos0)[None, :]
                      + 0.3 * rng.standard_normal((n, d))),
        p=jnp.asarray(5.0 * rng.standard_normal((n, d))),
        Mqq=eye, Mqp=jnp.zeros((n, d, d)), Mpq=jnp.zeros((n, d, d)),
        Mpp=eye, S=jnp.zeros(n))


def test_supports_detection():
    pot = _make_potential()
    assert supports_exact_harmonic(pot)

    from semiclassical_jax.potentials import MorsePotential
    morse = MorsePotential.create(
        np.array([0.01]), np.array([0.02]), np.array([0.5]))
    assert not supports_exact_harmonic(morse)


def test_rk4_converges_to_exact_map():
    """The fine-dt RK4 limit IS the map (the defining property): one exact
    step of size DT must match 256 RK4 steps of size DT/256 to ~1e-10,
    including a zero mode (translation analog) and a negative-curvature
    (saddle) direction, with a nonzero gradient at the expansion center."""
    d = 5
    spectrum = np.array([0.015**2, 0.008**2, 0.004**2, 0.0, -0.006**2])
    pot = _make_potential(d=d, seed=2, spectrum=spectrum)
    state = _make_state(pot, n=8, seed=3)
    DT = 20.0

    hmap = build_harmonic_map(pot, DT, state)
    exact, _ = harmonic_step(hmap, state, pot)

    fine = state
    nsub = 256
    for _ in range(nsub):
        fine, _ = rk4_step(fine, pot, DT / nsub)

    np.testing.assert_allclose(np.asarray(exact.q), np.asarray(fine.q),
                               rtol=1e-10, atol=1e-11)
    np.testing.assert_allclose(np.asarray(exact.p), np.asarray(fine.p),
                               rtol=1e-10, atol=1e-11)
    np.testing.assert_allclose(np.asarray(exact.S), np.asarray(fine.S),
                               rtol=1e-9, atol=1e-10)
    for leaf in ("Mqq", "Mqp", "Mpq", "Mpp"):
        np.testing.assert_allclose(
            np.asarray(getattr(exact, leaf)), np.asarray(getattr(fine, leaf)),
            rtol=1e-8, atol=1e-9, err_msg=leaf)


def test_monodromy_stays_symplectic():
    """The exact map is symplectic, so M^T J M = J survives many coarse
    steps to roundoff."""
    pot = _make_potential(d=4, seed=4)
    state = _make_state(pot, n=4, seed=5)
    hmap = build_harmonic_map(pot, 50.0, state)
    for _ in range(200):
        state, _ = harmonic_step(hmap, state, pot)
    Mqq, Mqp = np.asarray(state.Mqq), np.asarray(state.Mqp)
    Mpq, Mpp = np.asarray(state.Mpq), np.asarray(state.Mpp)
    # symplectic condition blockwise: Mqq^T Mpp - Mpq^T Mqp = 1, and
    # Mqq^T Mpq, Mqp^T Mpp symmetric
    for i in range(Mqq.shape[0]):
        eye = Mqq[i].T @ Mpp[i] - Mpq[i].T @ Mqp[i]
        np.testing.assert_allclose(eye, np.eye(Mqq.shape[1]),
                                   rtol=1e-10, atol=1e-10)


def test_energy_exactly_conserved():
    """<T+V> along the exact flow is constant to roundoff at ANY dt (RK4
    has secular O(dt^4) drift; the map has none)."""
    pot = _make_potential(d=4, seed=6)
    state = _make_state(pot, n=16, seed=7)
    hmap = build_harmonic_map(pot, 100.0, state)
    energies = []
    for _ in range(50):
        state, en = harmonic_step(hmap, state, pot)
        energies.append(float(en))
    energies = np.asarray(energies)
    assert np.abs(np.diff(energies)).max() < 1e-10 * max(
        1.0, np.abs(energies).max())


def _run_hk(pot, integrator, dt, nt, ntraj=64, key=11):
    d = pot.dimensions()
    # a PSD width matrix: mass-weighted-ish diagonal
    Gamma = np.diag(np.sqrt(np.asarray(pot.mass))
                    * np.linalg.eigvalsh(np.asarray(pot.hess0)).max() ** 0.5)
    q0 = np.asarray(pot.pos0) + 0.05
    prop = HermanKlukPropagator(Gamma, Gamma, integrator=integrator)
    prop.initial_conditions(q0, np.zeros(d), Gamma, ntraj=ntraj, key=key,
                            potential=pot)
    cauto, kic = prop.propagate(pot, dt, nt, energy0_es=0.1)
    return prop.state, cauto, kic


def test_hk_twin_gap_vs_rk4():
    """HK dynamics, identical ensembles: integrator='exact' vs 'rk4'. The
    twin gap must (a) sit at RK4's own discretization-error scale and
    (b) shrink ~16x when dt halves at the same horizon — i.e. the gap IS
    RK4's 4th-order error, the map itself contributing none."""
    pot = _make_potential(d=4, seed=8)

    def gap(dt, nt):
        s_rk4, c_rk4, _ = _run_hk(pot, "rk4", dt=dt, nt=nt)
        s_ex, c_ex, _ = _run_hk(pot, "exact", dt=dt, nt=nt)
        return (np.abs(np.asarray(s_ex.q) - np.asarray(s_rk4.q)).max(),
                np.abs(c_ex - c_rk4).max(), c_rk4)

    gq_c, gc_c, c_rk4 = gap(2.0, 50)
    gq_f, gc_f, _ = gap(1.0, 100)
    assert gq_c < 1e-6 and gc_c < 1e-6  # f64 RK4-error scale at this dt
    assert gq_c / gq_f > 10.0           # 4th-order: expect ~16x
    assert np.abs(c_rk4[-1] - c_rk4[0]) > 1e-4  # non-trivial dynamics


def test_exact_at_coarse_dt():
    """The map is exact at ANY dt: C(t) sampled on a 16x-coarser grid must
    match the fine-grid exact run at the shared times to roundoff-level
    accuracy (cf. tests/test_exact_morse.py's coarse-dt gate)."""
    pot = _make_potential(d=4, seed=9)
    _, c_fine, _ = _run_hk(pot, "exact", dt=2.0, nt=64)
    _, c_coarse, _ = _run_hk(pot, "exact", dt=32.0, nt=4)
    np.testing.assert_allclose(c_coarse, c_fine[::16][:4], rtol=0, atol=5e-12)


def test_cli_integrator_exact_molecular(tmp_path, monkeypatch, ref_data):
    """CLI wiring: `integrator: "exact"` on the methylium molecular-harmonic
    example must run end to end and agree with the rk4 run at production
    steps (identical seeds)."""
    import json

    from semiclassical_jax import cli

    ex = ref_data / "examples" / "methylium_AH"
    s0 = ex / "opt_freq_s0.fchk"
    s1 = ex / "opt_freq_s1.fchk"
    if not s0.exists() or not s1.exists():
        pytest.skip("methylium fixtures not available")
    monkeypatch.chdir(tmp_path)

    def task(integrator, out):
        return {
            "task": "dynamics",
            "potential": {"type": "harmonic",
                          "ground": str(s0),
                          "excited": str(s1),
                          "coupling": str(s1)},
            "propagator": "HK",
            "integrator": integrator,
            "batch_size": 32,
            "num_trajectories": 32,
            "num_steps": 16,
            "time_step_fs": 0.005,
            "manual_seed": 0,
            "results": {"correlations": out},
        }

    cli.run_semiclassical_dynamics(task("rk4", "c_rk4.npz"))
    cli.run_semiclassical_dynamics(task("exact", "c_exact.npz"))
    d_rk4 = np.load("c_rk4.npz")
    d_ex = np.load("c_exact.npz")
    np.testing.assert_allclose(d_ex["autocorrelation"],
                               d_rk4["autocorrelation"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(d_ex["ic_correlation"],
                               d_rk4["ic_correlation"], rtol=0, atol=1e-9)


def test_comp32_step_folds_both_residuals():
    """Compensated states carry the TRUE value as (value + residual) for
    q AND p: one exact step from (v, residual) must match one step from
    (v + residual, 0) — positions, momenta, action. A dropped p-fold
    (regression: pc was never folded into the increment or the f64
    action anchor) breaks this at the residual scale."""
    pot = _make_potential(d=4, seed=30)
    base = _make_state(pot, n=8, seed=31)
    rng = np.random.default_rng(32)
    qc = jnp.asarray(1e-3 * rng.standard_normal(base.q.shape))
    pc = jnp.asarray(1e-3 * rng.standard_normal(base.p.shape))
    zeros = jnp.zeros_like(base.q)

    from semiclassical_jax.pytree import replace as pt_replace
    split = pt_replace(base, qc=qc, pc=pc)
    folded = pt_replace(base, q=base.q + qc, p=base.p + pc,
                        qc=zeros, pc=zeros)

    hmap = build_harmonic_map(pot, 25.0, split)
    s_split, e_split = harmonic_step(hmap, split, pot)
    s_fold, e_fold = harmonic_step(hmap, folded, pot)

    np.testing.assert_allclose(
        np.asarray(s_split.q) + np.asarray(s_split.qc),
        np.asarray(s_fold.q) + np.asarray(s_fold.qc), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(s_split.p) + np.asarray(s_split.pc),
        np.asarray(s_fold.p) + np.asarray(s_fold.pc), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(s_split.S), np.asarray(s_fold.S),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(e_split), float(e_fold),
                               rtol=1e-12, atol=0)


def test_hmap_rebuilds_for_new_potential_object():
    """The exact-map cache must key on the RETAINED potential identity:
    a different potential through the same propagator (same dt, same
    dtypes) must rebuild the map, not reuse the previous constants.
    Gated on the propagated POSITIONS (a 1.3x Hessian visibly bends every
    trajectory; C(t) would be a weaker gate — it decays to ~0 here)."""
    from semiclassical_jax.pytree import replace as pt_replace

    pot_a = _make_potential(d=4, seed=20)
    pot_b = pt_replace(pot_a, hess0=1.3 * pot_a.hess0)
    d = 4
    Gamma = np.diag(np.sqrt(np.asarray(pot_a.mass))
                    * np.linalg.eigvalsh(np.asarray(pot_a.hess0)).max() ** 0.5)
    q0 = np.asarray(pot_a.pos0) + 0.05

    def init(prop, pot):
        prop.initial_conditions(q0, np.zeros(d), Gamma, ntraj=16, key=3,
                                potential=pot)

    prop = HermanKlukPropagator(Gamma, Gamma, integrator="exact")
    init(prop, pot_a)
    prop.propagate(pot_a, 2.0, 8, energy0_es=0.1)
    q_a = np.asarray(prop.state.q)

    # same propagator object, NEW potential object (same dt/dtypes):
    init(prop, pot_b)
    prop.propagate(pot_b, 2.0, 8, energy0_es=0.1)
    q_b_cached = np.asarray(prop.state.q)

    prop2 = HermanKlukPropagator(Gamma, Gamma, integrator="exact")
    init(prop2, pot_b)
    prop2.propagate(pot_b, 2.0, 8, energy0_es=0.1)
    q_b_fresh = np.asarray(prop2.state.q)

    np.testing.assert_allclose(q_b_cached, q_b_fresh, rtol=1e-12, atol=1e-14)
    assert np.abs(q_b_fresh - q_a).max() > 1e-6
