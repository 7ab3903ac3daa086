# coding: utf-8
"""End-to-end HK dynamics on the sGDML coumarin potential.

Exercises the full molecular ML pipeline: fchk-derived initial wavepacket
(with 6 zero modes), analytic batched GDML Hessians inside the RK4 monodromy
propagation, and the IC observables — at test scale (small ensemble, short
time)."""

import numpy as np
import pytest

import jax.numpy as jnp

from semiclassical_jax.io import FormattedCheckpointFile
from semiclassical_jax.potentials import MolecularGDMLPotential, minimize
from semiclassical_jax.propagation import HermanKlukPropagator


@pytest.mark.slow
def test_main_gdml_dynamics_without_hess_dtype(ref_data, tmp_path,
                                               monkeypatch):
    """A gdml task without the *optional* hess_dtype keyword must run
    through the real cli.main() path (validate_task + run) — regression for
    the round-2 schema bug that demanded every potential key."""
    import json

    from semiclassical_jax import cli

    model_path = (ref_data / "GDML"
                  / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")

    monkeypatch.chdir(tmp_path)
    task = {
        "task": "dynamics",
        "potential": {
            "type": "gdml",
            "ground": str(model_path),
            "excited": str(s1),
            "coupling": str(s1),
        },
        "batch_size": 8,
        "num_trajectories": 8,
        "num_steps": 3,
        "time_step_fs": 0.002,
        "results": {"correlations": "correlations.npz"},
    }
    with open("input.json", "w") as f:
        json.dump({"semi": [task]}, f)
    assert cli.main(["dynamics", "input.json"]) == 0
    d = np.load("correlations.npz")
    assert np.isfinite(d["autocorrelation"]).all()


@pytest.mark.slow
def test_gdml_short_time_matches_harmonic(ref_data):
    """Physics oracle for GDML-driven *dynamics* (not just the predictor):
    over the short-time window, HK correlation functions on the GDML PES
    must agree with those on the PES's own second-order Taylor expansion at
    the initial geometry. Identical initial conditions (same key) make the
    comparison deterministic — the only difference between the two runs is
    the potential — so the gate is tight, far below MC noise.

    (reference analogue: test_gdml_predictor.py:90-122 checks the
    *predictor* against finite differences; this extends the oracle to the
    propagated observables.)"""
    model_path = (ref_data / "GDML"
                  / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")

    model = np.load(model_path, allow_pickle=True)
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    pot = MolecularGDMLPotential.create(model, exc)
    x0, Gamma0, zpe = exc.vibrational_groundstate()
    x0 = jnp.asarray(x0)

    # second-order Taylor comparator built FROM the GDML PES itself
    v0, g0, h = pot.local_expansion(x0[None, :])
    from semiclassical_jax.potentials.molecular import (
        MolecularHarmonicPotential)
    harm = MolecularHarmonicPotential(
        pos0=x0,
        energy0=v0[0],
        grad0=g0[0],
        hess0=h.dense()[0],
        nac0=pot.nac0,
        mass=pot.mass,
        origin=pot.origin,
    )

    def run(p):
        prop = HermanKlukPropagator(Gamma0, Gamma0)
        prop.initial_conditions(np.asarray(x0), np.zeros_like(np.asarray(x0)),
                                Gamma0, ntraj=16, key=5, potential=p)
        return prop.propagate(p, 0.1, 10, energy0_es=zpe)

    c_gdml, k_gdml = run(pot)
    c_harm, k_harm = run(harm)
    assert np.isfinite(c_gdml).all() and np.isfinite(c_harm).all()
    # identical ensembles, locally identical PES -> the two correlation
    # functions separate only through third-order PES terms; the measured
    # anharmonic drift for this wavepacket is ~6e-3 per a.u., so over the
    # 1 a.u. window 1e-2 leaves margin while any sign/convention bug in the
    # DenseHessian monodromy path shows up at O(0.1) immediately
    np.testing.assert_allclose(c_gdml, c_harm, atol=1e-2)
    np.testing.assert_allclose(k_gdml, k_harm, atol=1e-2)
    # and the window is non-trivial: the correlation actually evolves
    assert np.abs(c_gdml[-1] - c_gdml[0]) > 1e-3


@pytest.mark.slow
def test_gdml_sharded_matches_single_device(ref_data):
    """The DenseHessian monodromy branch under SPMD: a GDML run on the
    8-device ensemble mesh must reproduce the single-device run bitwise-
    tight (the one sharded code path the model potentials don't cover)."""
    import jax

    from semiclassical_jax.parallel import ensemble_mesh

    model_path = (ref_data / "GDML"
                  / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")
    assert len(jax.devices()) >= 8, "tests expect 8 virtual devices"

    model = np.load(model_path, allow_pickle=True)
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    pot = MolecularGDMLPotential.create(model, exc)
    x0, Gamma0, zpe = exc.vibrational_groundstate()

    def run(mesh):
        prop = HermanKlukPropagator(Gamma0, Gamma0)
        prop.initial_conditions(x0, np.zeros_like(x0), Gamma0, ntraj=16,
                                key=9, potential=pot, mesh=mesh)
        return prop.propagate(pot, 1.0, 3, energy0_es=zpe)

    c1, k1 = run(None)
    c8, k8 = run(ensemble_mesh())
    # slightly looser than the model-potential sharding gates (1e-10): the
    # GDML kernel contraction over 200 training points retiles under GSPMD
    # and reassociates the f64 sums
    np.testing.assert_allclose(c8, c1, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(k8, k1, rtol=1e-8, atol=1e-10)


@pytest.mark.slow
def test_gdml_hk_dynamics(ref_data):
    model_path = (ref_data / "GDML"
                  / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    s0 = ref_data / "Gaussian16" / "coumarin_s0.fchk"
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")

    model = np.load(model_path, allow_pickle=True)
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    pot = MolecularGDMLPotential.create(model, exc)

    x0, Gamma0, zpe = exc.vibrational_groundstate()
    pot = minimize(pot, jnp.asarray(x0))

    prop = HermanKlukPropagator(Gamma0, Gamma0)
    prop.initial_conditions(x0, np.zeros_like(x0), Gamma0, ntraj=16, key=0,
                            potential=pot)
    # a handful of small steps — the gate is stability + C(0) normalisation
    dt = 0.1  # a.u.
    cauto, kic = prop.propagate(pot, dt, 5, energy0_es=zpe)
    assert np.isfinite(cauto).all() and np.isfinite(kic).all()
    assert abs(cauto[0] - 1.0) < 0.05  # MC estimate at tiny ntraj
    # |C| decays or stays bounded
    assert np.abs(cauto).max() < 1.5


@pytest.mark.slow
def test_gdml_wm_dynamics(ref_data):
    """WM propagator on the sGDML PES — the combination the reference's
    own README ships as the flagship 'gdml' example (README.rst "with
    'gdml' potential": propagator WM, cell_width 10000). Exercises the
    dense WM path (DenseHessian monodromy, rank-deficient Gamma0 with 6
    zero modes) end to end."""
    from semiclassical_jax.propagation import WaltonManolopoulosPropagator

    model_path = (ref_data / "GDML"
                  / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")

    model = np.load(model_path, allow_pickle=True)
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    pot = MolecularGDMLPotential.create(model, exc)
    x0, Gamma0, zpe = exc.vibrational_groundstate()

    prop = WaltonManolopoulosPropagator(Gamma0, Gamma0, 10000.0, 10000.0)
    prop.initial_conditions(np.asarray(x0), np.zeros_like(np.asarray(x0)),
                            Gamma0, ntraj=16, key=5, potential=pot)
    cauto, kic = prop.propagate(pot, 0.25, 8, energy0_es=zpe)
    cauto = np.asarray(cauto)
    assert np.isfinite(cauto).all() and np.isfinite(np.asarray(kic)).all()
    # WM's cell-integrated C(0) is exact up to the quadrature width
    assert abs(abs(cauto[0]) - 1.0) < 5e-4
    assert np.abs(cauto).max() < 1.5
