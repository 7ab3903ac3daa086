# coding: utf-8
"""Per-step Monte-Carlo standard errors on C(t) / k~ic(t).

BEYOND-reference: the reference's only ensemble-convergence diagnostic is
the opt-in O(n^2) norm (reference propagators.py:734-782, cli.py:418-429).
Here two extra fused reductions per scan step accumulate the second
moments of the per-trajectory contributions, giving the exact single-run
standard error of the Monte-Carlo mean at every step:

    sigma(t) = sqrt( sum_i |x_i(t)|^2 - |sum_i x_i(t)|^2 / n )

(the contributions already carry the 1/n-normalized weights). Gates:
identity with the direct per-trajectory computation, 1/sqrt(n) scaling,
statistical calibration across independent ensembles, sharding
invariance, both propagators, both integrators, checkpoint resume, the
CLI keyword, and quadrature accumulation across repetitions.
"""

import json

import numpy as np
import pytest

from semiclassical_jax.potentials import MorsePotential
from semiclassical_jax.propagation import (
    HermanKlukPropagator,
    WaltonManolopoulosPropagator,
)

DT = 1.0  # a.u.


def _as_model(d=4, seed=0):
    rng = np.random.default_rng(seed)
    omega = rng.uniform(500.0, 2000.0, size=d) / 219474.63
    pot = MorsePotential.create(omega, np.full(d, 0.02),
                                rng.uniform(-1.0, 1.0, d))
    Gamma = np.diag(omega)
    q0 = rng.uniform(0.5, 1.5, size=d)
    return pot, Gamma, q0


def _hk(pot, Gamma, q0, ntraj, key, **kw):
    prop = HermanKlukPropagator(Gamma, Gamma, **kw)
    prop.initial_conditions(q0, np.zeros(len(q0)), Gamma, ntraj=ntraj,
                            key=key, potential=pot)
    return prop


def test_stderr_matches_direct_per_trajectory():
    """The in-scan second-moment stderr equals the direct computation from
    the per-trajectory contributions of the granular API (exercised at a
    propagated state, not t=0, where HK importance sampling makes the
    autocorrelation variance exactly zero)."""
    from semiclassical_jax.propagation.hk import hk_autocorr_qp

    pot, Gamma, q0 = _as_model()
    prop = _hk(pot, Gamma, q0, 512, key=0)
    prop.propagate(pot, DT, 5)
    # the scan samples observables BEFORE stepping: index 0 of the next
    # segment is the current state
    _, _, ec, ek = prop.propagate(pot, DT, 1, error_bars=True)

    twin = _hk(pot, Gamma, q0, 512, key=0)
    twin.propagate(pot, DT, 5)
    c = twin.semiclassical_prefactor()
    x = np.asarray(hk_autocorr_qp(twin.params, twin._bc, twin.state, c))
    x = x * twin._bc.weight_scale
    n = x.shape[0]
    direct = np.sqrt((np.abs(x) ** 2).sum() - abs(x.sum()) ** 2 / n)
    assert abs(direct - ec[0]) < 1e-10 * direct + 1e-14, (direct, ec[0])


def test_stderr_zero_at_t0_and_positive_later():
    """At t=0 every HK contribution is exactly 1/n (importance sampling
    from the overlap density), so the C(t) stderr starts at 0 and grows."""
    pot, Gamma, q0 = _as_model()
    prop = _hk(pot, Gamma, q0, 256, key=3)
    cauto, kic, ec, ek = prop.propagate(pot, DT, 10, error_bars=True)
    assert ec[0] < 1e-12
    assert (ec[1:] > 0).all() and (ek > 0).all()
    assert np.isfinite(ec).all() and np.isfinite(ek).all()


def test_stderr_scales_inverse_sqrt_n():
    pot, Gamma, q0 = _as_model()
    _, _, e1, k1 = _hk(pot, Gamma, q0, 256, key=1).propagate(
        pot, DT, 8, error_bars=True)
    _, _, e4, k4 = _hk(pot, Gamma, q0, 4096, key=2).propagate(
        pot, DT, 8, error_bars=True)
    # 16x the trajectories -> 4x smaller stderr (to MC noise of the
    # stderr estimate itself)
    ratio_c = e1[4:] / e4[4:]
    ratio_k = k1[4:] / k4[4:]
    assert 2.5 < np.median(ratio_c) < 6.5, np.median(ratio_c)
    assert 2.5 < np.median(ratio_k) < 6.5, np.median(ratio_k)


def test_stderr_calibration_against_ensemble_scatter():
    """The predicted stderr must match the actual scatter of C(t) across
    independent ensembles (the definition of a standard error)."""
    pot, Gamma, q0 = _as_model()
    runs, preds = [], []
    nrep = 12
    for j in range(nrep):
        c, k, ec, ek = _hk(pot, Gamma, q0, 256, key=100 + j).propagate(
            pot, DT, 6, error_bars=True)
        runs.append(c)
        preds.append(ec)
    runs = np.array(runs)
    pred = np.mean(preds, axis=0)
    # empirical std of the complex mean across runs (Re and Im pooled the
    # same way the predicted sigma pools them)
    emp = np.sqrt(np.mean(np.abs(runs - runs.mean(axis=0)) ** 2, axis=0))
    for t in (2, 4, 5):
        ratio = emp[t] / pred[t]
        assert 0.45 < ratio < 2.2, (t, emp[t], pred[t])


def test_wm_error_bars():
    pot, Gamma, q0 = _as_model()
    prop = WaltonManolopoulosPropagator(Gamma, Gamma, 500.0, 500.0)
    prop.initial_conditions(q0, np.zeros(len(q0)), Gamma, ntraj=512,
                            key=0, potential=pot)
    cauto, kic, ec, ek = prop.propagate(pot, DT, 8, error_bars=True)
    assert np.isfinite(ec).all() and np.isfinite(ek).all()
    assert (ec[1:] > 0).all() and (ek > 0).all()
    # WM's Filinov cell smoothing reweights the t=0 contributions, so the
    # stderr does not vanish there — but it must still start small and grow
    assert ec[0] < ec[-1]

    # plain 2-tuple API unchanged
    c2, k2 = prop.propagate(pot, DT, 2)
    assert np.isfinite(c2).all()


def test_exact_integrator_error_bars_match_rk4():
    """The exact Morse map propagates the same ensemble through the same
    physics — its per-step stderr must track RK4's closely."""
    pot, Gamma, q0 = _as_model()
    r = _hk(pot, Gamma, q0, 512, key=5).propagate(
        pot, DT, 8, error_bars=True)
    e = _hk(pot, Gamma, q0, 512, key=5, integrator="exact").propagate(
        pot, DT, 8, error_bars=True)
    np.testing.assert_allclose(e[2][1:], r[2][1:], rtol=0.05)
    np.testing.assert_allclose(e[3], r[3], rtol=0.05)


def test_sharded_error_bars_match_single_device():
    import jax

    from semiclassical_jax.parallel import ensemble_mesh

    pot, Gamma, q0 = _as_model()
    single = _hk(pot, Gamma, q0, 1024, key=7).propagate(
        pot, DT, 5, error_bars=True)

    mesh = ensemble_mesh(jax.devices()[:8])
    prop = HermanKlukPropagator(Gamma, Gamma)
    prop.initial_conditions(q0, np.zeros(len(q0)), Gamma, ntraj=1024,
                            key=7, potential=pot, mesh=mesh)
    sharded = prop.propagate(pot, DT, 5, error_bars=True)
    # atol covers the t=0 stderr, where the true variance is 0 and the
    # sqrt(max(.,0)) clamp resolves summation roundoff differently across
    # reduction orders
    for a, b in zip(single, sharded):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-9)


def test_checkpointed_run_error_bars(tmp_path):
    from semiclassical_jax.checkpoint import CheckpointedRun

    pot, Gamma, q0 = _as_model()
    plain = _hk(pot, Gamma, q0, 256, key=9).propagate(
        pot, DT, 6, error_bars=True)

    prop = _hk(pot, Gamma, q0, 256, key=9)
    run = CheckpointedRun(str(tmp_path / "ck.npz"), prop, pot, dt=DT, nt=6,
                          segment=2, chunk=2, error_bars=True)
    ck = run.run()
    for a, b in zip(plain, ck):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-14)


def test_resume_without_stored_stderr_drops_error_bars(tmp_path):
    """A checkpoint written WITHOUT error_bars and resumed WITH them must
    not fabricate stderr=0 for the already-completed steps: the stderr
    outputs come back None so the npz keys are dropped (the drop-keys
    contract), with a warning."""
    from semiclassical_jax.checkpoint import CheckpointedRun

    pot, Gamma, q0 = _as_model()
    ckpt = str(tmp_path / "ck.npz")

    # first life of the job: no error bars, killed after one segment
    prop = _hk(pot, Gamma, q0, 256, key=9)
    seg = prop.propagate(pot, DT, 2, chunk=2)
    from semiclassical_jax.checkpoint import save_propagator_state
    cauto = np.zeros(6, dtype=complex)
    kic = np.zeros(6, dtype=complex)
    cauto[:2], kic[:2] = seg
    save_propagator_state(ckpt, prop, partial={"cauto": cauto, "kic": kic,
                                               "steps_done": 2})

    # second life: the user switched error_bars on
    prop2 = _hk(pot, Gamma, q0, 256, key=9)
    run2 = CheckpointedRun(ckpt, prop2, pot, dt=DT, nt=6, segment=2,
                           chunk=2, error_bars=True)
    c2, k2, e_c, e_k = run2.run()
    assert e_c is None and e_k is None
    plain = _hk(pot, Gamma, q0, 256, key=9).propagate(pot, DT, 6, chunk=2)
    np.testing.assert_allclose(c2, plain[0], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(k2, plain[1], rtol=1e-12, atol=1e-14)


def test_accumulate_quadrature(tmp_path):
    from semiclassical_jax.io import results

    times = np.linspace(0.0, 1.0, 5)
    f = str(tmp_path / "r.npz")
    results.init_results(f, "HK", times, np.nan, 0.0)
    c = np.ones(5, dtype=complex)
    k = np.zeros(5, dtype=complex)
    e1 = np.full(5, 0.02)
    e2 = np.full(5, 0.04)
    results.accumulate_results(f, c, k, 100, autocorrelation_stderr=e1,
                               ic_correlation_stderr=e1)
    results.accumulate_results(f, c, k, 300, autocorrelation_stderr=e2,
                               ic_correlation_stderr=e2)
    d = np.load(f)
    # sigma^2 = (n1^2 s1^2 + n2^2 s2^2) / (n1+n2)^2
    expect = np.sqrt((100**2 * 0.02**2 + 300**2 * 0.04**2) / 400**2)
    np.testing.assert_allclose(d["autocorrelation_stderr"], expect)

    # a batch WITHOUT error bars drops the keys instead of corrupting them
    results.accumulate_results(f, c, k, 100)
    d = np.load(f)
    assert "autocorrelation_stderr" not in d


def test_stderr_survives_high_mode_count_f32():
    """Regression: at 60 modes the device-side contributions ride at
    1/weight_scale ~ 1e-26, so a naive sum|x|^2 underflows f32 to exactly
    zero. The factored (max, normalized-sum-of-squares) second moment must
    reproduce the f64 stderr on the production comp32 path."""
    import pathlib
    import sys

    import jax.numpy as jnp

    repo = str(pathlib.Path(__file__).resolve().parent.parent)
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from __graft_entry__ import _as60_setup

    prop, pot = _as60_setup(ntraj=1024, dtype=jnp.float32,
                            traj_dtype="comp32")
    _, _, ec, ek = prop.propagate(pot, 0.25, 6, energy0_es=0.0,
                                  error_bars=True, check_energy=False)
    assert prop._bc.weight_scale > 1e10  # the regime that underflowed
    assert (ec[1:] > 0).all() and (ek > 0).all()

    prop64, pot64 = _as60_setup(ntraj=1024)
    _, _, e64, k64 = prop64.propagate(pot64, 0.25, 6, energy0_es=0.0,
                                      error_bars=True, check_energy=False)
    np.testing.assert_allclose(ec[1:], e64[1:], rtol=5e-3)
    np.testing.assert_allclose(ek, k64, rtol=5e-3)


def test_cli_error_bars(tmp_path, monkeypatch):
    from semiclassical_jax import cli

    monkeypatch.chdir(tmp_path)
    with open("AS_model.dat", "w") as fh:
        fh.write("# freq/cm-1  S  nac  chi\n")
        fh.write("1000.0  0.20  0.5  0.02\n")
        fh.write(" 600.0  0.30  0.8  0.02\n")
    task = {
        "task": "dynamics",
        "potential": {"type": "anharmonic AS", "model_file": "AS_model.dat"},
        "propagator": "HK",
        "batch_size": 128,
        "num_trajectories": 256,
        "num_steps": 10,
        "time_step_fs": 0.05,
        "error_bars": True,
        "results": {"correlations": "correlations.npz"},
    }
    from semiclassical_jax.config import validate_task
    validate_task(task)
    cli.run_semiclassical_dynamics(task)
    d = np.load("correlations.npz")
    assert "autocorrelation_stderr" in d and "ic_correlation_stderr" in d
    assert d["autocorrelation_stderr"].shape == d["times"].shape
    assert np.isfinite(d["autocorrelation_stderr"]).all()
    assert (d["ic_correlation_stderr"] > 0).all()
