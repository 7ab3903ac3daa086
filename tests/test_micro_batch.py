# coding: utf-8
"""Device-side micro-batching (hk._micro_scan): the scan as a serialised
lax.map over sub-batches — the WM production lever (the derived chain is
memory-bound, so its step intermediates stay at the sub-batch size).

Contract: per-trajectory dynamics (state, trackers) are EXACTLY the
monolithic ones — the trajectory pipelines are embarrassingly parallel and
elementwise float ops are deterministic; only the observable reductions
change association order (sub-batch partials then sum), so observables are
gated at f64 tolerance instead of bitwise.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from semiclassical_jax.potentials import MorsePotential
from semiclassical_jax.propagation import (HermanKlukPropagator,
                                           WaltonManolopoulosPropagator)


def _as_potential(d=3, chi=0.02):
    rng = np.random.default_rng(0)
    omega = rng.uniform(0.004, 0.01, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    return MorsePotential.create(omega, np.full(d, chi), nac)


def _gammas(pot):
    d = pot.dimensions()
    return np.diag(np.asarray(pot.omega))


def _run(prop_cls, micro, ntraj=64, nt=25, key=3, error_bars=False,
         **prop_kw):
    pot = _as_potential()
    Gamma = _gammas(pot)
    d = pot.dimensions()
    prop = prop_cls(Gamma, Gamma, **prop_kw)
    prop.initial_conditions(np.full(d, 0.2), np.zeros(d), Gamma,
                            ntraj=ntraj, key=key, potential=pot)
    prop.micro_batch = micro
    out = prop.propagate(pot, 1.0, nt, energy0_es=0.05,
                         error_bars=error_bars)
    return prop, out


@pytest.mark.parametrize("prop_cls,kw", [
    (HermanKlukPropagator, {}),
    (WaltonManolopoulosPropagator, {"alpha": 1e4, "beta": 1e4}),
])
def test_micro_matches_monolithic(prop_cls, kw):
    p_mono, (c_mono, k_mono) = _run(prop_cls, micro=0, **kw)
    p_micro, (c_micro, k_micro) = _run(prop_cls, micro=16, **kw)

    # per-trajectory state advances identically (elementwise pipelines)
    for leaf in ("q", "p", "S"):
        np.testing.assert_array_equal(
            np.asarray(getattr(p_micro.state, leaf)),
            np.asarray(getattr(p_mono.state, leaf)), err_msg=leaf)
    for name, tr in p_micro.trackers.items():
        np.testing.assert_array_equal(
            np.asarray(tr.signs), np.asarray(p_mono.trackers[name].signs),
            err_msg=name)

    # observables re-associate the reduction only
    np.testing.assert_allclose(c_micro, c_mono, rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(k_micro, k_mono, rtol=1e-12, atol=1e-13)
    assert np.abs(c_mono[-1] - c_mono[0]) > 1e-4


def test_micro_error_bars_match():
    _, (c1, k1, ec1, ek1) = _run(HermanKlukPropagator, micro=0,
                                 error_bars=True)
    _, (c2, k2, ec2, ek2) = _run(HermanKlukPropagator, micro=16,
                                 error_bars=True)
    np.testing.assert_allclose(ec2, ec1, rtol=1e-10, atol=1e-15)
    np.testing.assert_allclose(ek2, ek1, rtol=1e-10, atol=1e-15)
    assert ec1.max() > 0


def test_non_divisible_falls_back():
    """micro_batch that does not divide the batch runs monolithic (same
    code path, warning logged) — results bitwise identical."""
    p1, (c1, k1) = _run(HermanKlukPropagator, micro=0)
    p2, (c2, k2) = _run(HermanKlukPropagator, micro=24)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(k1, k2)


def test_micro_ignored_with_exact_integrator():
    """The exact-Morse pack bypasses micro-batching (side-channel plumbing
    is monolithic) — the run must still be correct vs the monolithic exact
    run."""
    p1, (c1, k1) = _run(HermanKlukPropagator, micro=0,
                        integrator="exact")
    p2, (c2, k2) = _run(HermanKlukPropagator, micro=16,
                        integrator="exact")
    np.testing.assert_allclose(c2, c1, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(k2, k1, rtol=1e-12, atol=1e-14)


def test_micro_through_cli_keyword(tmp_path, monkeypatch):
    """`micro_batch` input keyword end to end: same npz as the monolithic
    run at f64 tolerance."""
    import json

    from semiclassical_jax import cli

    monkeypatch.chdir(tmp_path)
    with open("AS_model.dat", "w") as f:
        f.write("# freq/cm-1  S  nac  chi\n")
        f.write("1000.0  0.20  0.5  0.02\n")
        f.write(" 600.0  0.30  0.8  0.02\n")

    def task(micro, out):
        return {
            "task": "dynamics",
            "potential": {"type": "anharmonic AS",
                          "model_file": "AS_model.dat"},
            "propagator": "WM",
            "cell_width": 10000.0,
            "batch_size": 64,
            "num_trajectories": 64,
            "num_steps": 10,
            "time_step_fs": 0.05,
            "manual_seed": 0,
            "micro_batch": micro,
            "results": {"correlations": out},
        }

    cli.run_semiclassical_dynamics(task(0, "mono.npz"))
    cli.run_semiclassical_dynamics(task(16, "micro.npz"))
    mono = np.load("mono.npz")
    micro = np.load("micro.npz")
    np.testing.assert_allclose(micro["autocorrelation"],
                               mono["autocorrelation"],
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(micro["ic_correlation"],
                               mono["ic_correlation"],
                               rtol=1e-12, atol=1e-13)
