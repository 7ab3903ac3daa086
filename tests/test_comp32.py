# coding: utf-8
"""Compensated-f32 trajectory mode ("comp32").

comp32 keeps the trajectory (q, p) updates out of f64 arithmetic
altogether (on accelerators f64 runs far below the f32 rate). It stores
q/p as f32 value + f32 Neumaier residual (`TrajState.qc/pc`, true value
= q + qc) and folds every RK4 increment in with an exact two-sum, removing
the eps*|q| accumulation rounding that makes plain f32 drift (measured: plain-f32 C(t) error 1.6e-2 after 100 steps of
the 60-mode benchmark vs 1.7e-5 for mixed AND for comp32; over the full
2000-step production horizon comp32 tracks mixed to 5e-7).

The reference has no counterpart (complex128/torch-f64 throughout,
reference propagators.py:321-376); this mode exists purely for speed at
f64-level trajectory accuracy.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from semiclassical_jax.potentials import MorsePotential
from semiclassical_jax.propagation import (
    HermanKlukPropagator,
    WaltonManolopoulosPropagator,
)
from semiclassical_jax.propagation.eom import _comp_accumulate


def test_comp_accumulate_matches_f64():
    """Accumulating 10k small f32 increments with the compensated two-sum
    must track the f64 sum ~100x better than the plain f32 sum."""
    rng = np.random.default_rng(3)
    incs = rng.standard_normal(10000).astype(np.float32) * 1e-3

    @jax.jit
    def run(incs):
        def body(carry, inc):
            (x, c), xp = carry
            x, c = _comp_accumulate(x, c, inc)
            return ((x, c), xp + inc), None
        (xc, plain), _ = jax.lax.scan(
            body, ((jnp.float32(1.0), jnp.float32(0.0)), jnp.float32(1.0)),
            incs)
        return xc, plain

    (x, c), plain = run(jnp.asarray(incs))
    exact = 1.0 + np.sum(incs.astype(np.float64))
    err_comp = abs(float(x) + float(c) - exact)
    err_plain = abs(float(plain) - exact)
    assert err_comp < 1e-9, (err_comp, err_plain)
    assert err_plain > 100 * max(err_comp, 1e-12), (err_comp, err_plain)


def _as12(traj_dtype, ntraj=2048, nt=100):
    rng = np.random.default_rng(0)
    d = 12
    omega = rng.uniform(300.0, 2500.0, size=d) / 219474.63
    chi = np.full(d, 0.02)
    nac = rng.uniform(-1.0, 1.0, size=d)
    S = rng.uniform(0.02, 0.3, size=d)
    pot = MorsePotential.create(omega, chi, nac, dtype=jnp.float32)
    Gamma = np.diag(omega)
    q0 = np.sqrt(2 * S / omega)

    prop = HermanKlukPropagator(Gamma, Gamma, dtype=jnp.float32,
                                traj_dtype=traj_dtype)
    prop.initial_conditions(q0, np.zeros(d), Gamma, ntraj=ntraj, key=11,
                            potential=pot)
    return prop, pot


def test_comp32_matches_mixed():
    """Twin run (identical key/sampling): comp32 must reproduce the
    validated mixed mode (f64 trajectories) to well below the f32-mode
    drift. The only differences are the residual-compensated f32 stage
    arithmetic, so the gap measures exactly what compensation loses."""
    prop_m, pot = _as12(jnp.float64)
    cm, km = prop_m.propagate(pot, 2.0, 100, check_energy=False)
    prop_c, pot = _as12("comp32")
    assert prop_c.state.compensated
    assert prop_c.state.q.dtype == jnp.float32
    assert prop_c.state.S.dtype == jnp.float64
    cc, kc = prop_c.propagate(pot, 2.0, 100, check_energy=True)
    err_c = np.abs(cc - cm).max() / np.abs(cm).max()
    err_k = np.abs(kc - km).max() / max(np.abs(km).max(), 1e-30)
    # plain f32 measures a few e-2 on this config (test_precision.py gate
    # 5e-2); comp32 must sit orders of magnitude below
    assert err_c < 5e-4, err_c
    assert err_k < 5e-4, err_k


def test_comp32_residuals_bounded():
    """The Neumaier residuals stay below one ulp of the value they
    compensate — if the two-sum were algebraically simplified away by the
    compiler they would be exactly zero, and if it were wrong they would
    grow; both are detected here."""
    prop, pot = _as12("comp32", ntraj=512, nt=50)
    prop.propagate(pot, 2.0, 50, check_energy=False)
    q = np.asarray(prop.state.q, dtype=np.float64)
    qc = np.asarray(prop.state.qc, dtype=np.float64)
    scale = np.maximum(np.abs(q), 1e-3)
    assert (np.abs(qc) <= 2.0 ** -23 * scale + 1e-12).all()
    # the residuals must be doing real work (not optimized to zero)
    assert (qc != 0.0).mean() > 0.5


def test_comp32_checkpoint_roundtrip(tmp_path):
    """Mid-run checkpoint of a comp32 state (extra qc/pc leaves) restores
    bit-identically and the resumed run reproduces the uninterrupted one."""
    from semiclassical_jax.checkpoint import (load_propagator_state,
                                              save_propagator_state)
    prop, pot = _as12("comp32", ntraj=256)
    c_full, _ = prop.propagate(pot, 2.0, 20, check_energy=False)

    prop1, pot = _as12("comp32", ntraj=256)
    c_head, _ = prop1.propagate(pot, 2.0, 10, check_energy=False)
    fn = str(tmp_path / "ck.npz")
    save_propagator_state(fn, prop1)

    prop2, pot = _as12("comp32", ntraj=256)
    load_propagator_state(fn, prop2)
    assert np.array_equal(np.asarray(prop2.state.qc),
                          np.asarray(prop1.state.qc))
    c_tail, _ = prop2.propagate(pot, 2.0, 10, check_energy=False)
    np.testing.assert_allclose(np.concatenate([c_head, c_tail]), c_full,
                               rtol=0, atol=1e-12)


def test_comp32_sharding_equality():
    """comp32 state (with its extra residual leaves) under the 8-device
    trajectory mesh reproduces the single-device run exactly."""
    from semiclassical_jax.parallel import ensemble_mesh
    prop1, pot = _as12("comp32", ntraj=1024)
    c1, k1 = prop1.propagate(pot, 2.0, 20, check_energy=False)

    mesh = ensemble_mesh()
    prop8, pot = _as12_mesh(mesh)
    c8, k8 = prop8.propagate(pot, 2.0, 20, check_energy=False)
    # the trajectories are bit-identical across layouts; the per-device
    # observable partial sums are complex64, so fusion/psum reassociation
    # leaves ~ulp_f32 RELATIVE differences against the observable scale
    # (the f64/c128 sharding gates in test_sharding.py hold 1e-12 for the
    # same reason in reverse; k~ic reaches ~1e6 here, so its tolerance
    # must scale with it)
    np.testing.assert_allclose(c8, c1, rtol=0, atol=2e-6 * np.abs(c1).max())
    np.testing.assert_allclose(k8, k1, rtol=0, atol=2e-6 * np.abs(k1).max())


def _as12_mesh(mesh, ntraj=1024):
    rng = np.random.default_rng(0)
    d = 12
    omega = rng.uniform(300.0, 2500.0, size=d) / 219474.63
    chi = np.full(d, 0.02)
    nac = rng.uniform(-1.0, 1.0, size=d)
    S = rng.uniform(0.02, 0.3, size=d)
    pot = MorsePotential.create(omega, chi, nac, dtype=jnp.float32)
    Gamma = np.diag(omega)
    q0 = np.sqrt(2 * S / omega)
    prop = HermanKlukPropagator(Gamma, Gamma, dtype=jnp.float32,
                                traj_dtype="comp32")
    prop.initial_conditions(q0, np.zeros(d), Gamma, ntraj=ntraj, key=11,
                            potential=pot, mesh=mesh)
    return prop, pot


def test_comp32_dense_monodromy_path():
    """comp32 with the *dense* (n, d, d) monodromy representation (the
    molecular/GDML path). Forced here by withholding the potential from
    initial_conditions (no DiagHessian detection); validated on the real
    rank-deficient methylium example to max|dC| = 2e-7 over 400 steps vs
    the mixed twin."""
    def run(traj_dtype):
        rng = np.random.default_rng(0)
        d = 6
        omega = rng.uniform(300.0, 2500.0, size=d) / 219474.63
        pot = MorsePotential.create(omega, np.full(d, 0.02),
                                    rng.uniform(-1, 1, size=d),
                                    dtype=jnp.float32)
        Gamma = np.diag(omega)
        q0 = np.sqrt(2 * rng.uniform(0.02, 0.3, size=d) / omega)
        prop = HermanKlukPropagator(Gamma, Gamma, dtype=jnp.float32,
                                    traj_dtype=traj_dtype)
        # no potential => dense monodromy even for a separable PES
        prop.initial_conditions(q0, np.zeros(d), Gamma, ntraj=1024, key=5)
        assert not prop.state.diag_monodromy
        return prop.propagate(pot, 2.0, 60, check_energy=False)

    cm, km = run(jnp.float64)
    cc, kc = run("comp32")
    assert np.abs(cc - cm).max() / np.abs(cm).max() < 5e-4
    assert np.abs(kc - km).max() / max(np.abs(km).max(), 1e-30) < 5e-4


def _as12_wm(traj_dtype, ntraj=2048, with_potential=True):
    """WM twin-run setup on the 12-mode anharmonic model; withholding the
    potential from initial_conditions forces the dense monodromy state and
    the generic (non-diag) wm_scan_derived branch."""
    rng = np.random.default_rng(0)
    d = 12
    omega = rng.uniform(300.0, 2500.0, size=d) / 219474.63
    chi = np.full(d, 0.02)
    nac = rng.uniform(-1.0, 1.0, size=d)
    S = rng.uniform(0.02, 0.3, size=d)
    pot = MorsePotential.create(omega, chi, nac, dtype=jnp.float32)
    Gamma = np.diag(omega)
    q0 = np.sqrt(2 * S / omega)

    prop = WaltonManolopoulosPropagator(Gamma, Gamma, 1.0e4, 1.0e4,
                                        dtype=jnp.float32,
                                        traj_dtype=traj_dtype)
    prop.initial_conditions(q0, np.zeros(d), Gamma, ntraj=ntraj, key=11,
                            potential=pot if with_potential else None)
    return prop, pot


def test_comp32_wm_matches_mixed():
    """WM twin run (identical sampling): comp32 reproduces the mixed mode —
    every displacement of the eqns. 57-100 chain folds the compensation
    residuals (wm._dQ_evolved/_dp_evolved/_center_minus_initial)."""
    prop_m, pot = _as12_wm(jnp.float64)
    assert prop_m.params.scan_diag and prop_m.state.diag_monodromy
    cm, km = prop_m.propagate(pot, 2.0, 100, check_energy=False)
    prop_c, pot = _as12_wm("comp32")
    assert prop_c.state.compensated and prop_c.state.diag_monodromy
    cc, kc = prop_c.propagate(pot, 2.0, 100, check_energy=False)
    err_c = np.abs(cc - cm).max() / np.abs(cm).max()
    err_k = np.abs(kc - km).max() / max(np.abs(km).max(), 1e-30)
    assert err_c < 5e-4, err_c
    assert err_k < 5e-4, err_k


def test_comp32_wm_dense_path_matches_mixed():
    """Same twin comparison through the dense-monodromy generic
    wm_scan_derived branch (the molecular/rank-deficient WM route)."""
    prop_m, pot = _as12_wm(jnp.float64, ntraj=1024, with_potential=False)
    assert not prop_m.state.diag_monodromy
    cm, km = prop_m.propagate(pot, 2.0, 60, check_energy=False)
    prop_c, pot = _as12_wm("comp32", ntraj=1024, with_potential=False)
    assert prop_c.state.compensated and not prop_c.state.diag_monodromy
    cc, kc = prop_c.propagate(pot, 2.0, 60, check_energy=False)
    assert np.abs(cc - cm).max() / np.abs(cm).max() < 5e-4
    assert np.abs(kc - km).max() / max(np.abs(km).max(), 1e-30) < 5e-4


def test_comp32_requires_f32_algebra():
    with pytest.raises(ValueError):
        HermanKlukPropagator(np.eye(2), np.eye(2), dtype=jnp.float64,
                             traj_dtype="comp32")


def test_cli_precision_comp32(tmp_path, monkeypatch):
    """`semi dynamics --precision comp32` end to end on a tiny AS model."""
    from semiclassical_jax import cli
    monkeypatch.chdir(tmp_path)
    with open("AS_model.dat", "w") as f:
        f.write("1000.0  0.20  0.5  0.02\n")
        f.write(" 600.0  0.30  0.8  0.02\n")
    task = {
        "task": "dynamics",
        "potential": {"type": "anharmonic AS", "model_file": "AS_model.dat"},
        "propagator": "HK",
        "batch_size": 256,
        "num_trajectories": 256,
        "num_steps": 20,
        "time_step_fs": 0.05,
        "results": {"correlations": "correlations.npz"},
    }
    cli.run_semiclassical_dynamics(task, precision="comp32")
    d = np.load("correlations.npz")
    assert abs(d["autocorrelation"][0] - 1.0) < 1e-3
    assert np.isfinite(d["autocorrelation"]).all()
