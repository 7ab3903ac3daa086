# coding: utf-8
"""Checkpoint/resume: a killed-and-resumed run must reproduce the
uninterrupted run exactly (same trajectories, same sign-tracker state)."""

import numpy as np

from semiclassical_jax.checkpoint import CheckpointedRun
from semiclassical_jax.potentials import NonHarmonicPotential
from semiclassical_jax.propagation import HermanKlukPropagator


def _make_prop(pot, key=5):
    Gi = np.array([[2 * 2.5]])
    G0 = np.array([[1.0]])
    prop = HermanKlukPropagator(Gi, Gi)
    prop.initial_conditions(np.array([7.3]), np.array([0.0]), G0,
                            ntraj=2000, key=key, potential=pot)
    return prop


def test_resume_matches_uninterrupted(tmp_path):
    pot = NonHarmonicPotential.create()
    dt, nt, en0 = 0.02, 40, 0.5

    # uninterrupted
    prop_a = _make_prop(pot)
    cauto_a, kic_a = prop_a.propagate(pot, dt, nt, energy0_es=en0)

    # checkpointed, "killed" after 2 segments, resumed in a fresh process
    ckpt = str(tmp_path / "ckpt.npz")
    prop_b = _make_prop(pot)
    run_b = CheckpointedRun(ckpt, prop_b, pot, dt=dt, nt=nt,
                            energy0_es=en0, segment=10)
    # simulate crash: run only 2 segments manually
    c_part, k_part = prop_b.propagate(pot, dt, 10, energy0_es=en0)
    c_part2, k_part2 = prop_b.propagate(pot, dt, 10, energy0_es=en0)
    from semiclassical_jax.checkpoint import save_propagator_state
    cauto = np.zeros(nt, dtype=complex)
    kic = np.zeros(nt, dtype=complex)
    cauto[:10], cauto[10:20] = c_part, c_part2
    kic[:10], kic[10:20] = k_part, k_part2
    save_propagator_state(ckpt, prop_b,
                          partial={"cauto": cauto, "kic": kic,
                                   "steps_done": 20})

    # resume with a fresh propagator (different RNG key — overwritten by
    # the checkpoint)
    prop_c = _make_prop(pot, key=999)
    run_c = CheckpointedRun(ckpt, prop_c, pot, dt=dt, nt=nt,
                            energy0_es=en0, segment=10)
    cauto_c, kic_c, _, _ = run_c.run()

    np.testing.assert_allclose(cauto_c, cauto_a, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(kic_c, kic_a, rtol=1e-12, atol=1e-14)


def test_chunked_propagation_matches_single_scan():
    """propagate(chunk=k) must reproduce the single-scan result exactly —
    including the branch-cut sign trackers carried across chunk borders."""
    pot = NonHarmonicPotential.create()
    dt, nt, en0 = 0.02, 30, 0.5

    prop_a = _make_prop(pot)
    ca, ka = prop_a.propagate(pot, dt, nt, energy0_es=en0)

    prop_b = _make_prop(pot)
    cb, kb = prop_b.propagate(pot, dt, nt, energy0_es=en0, chunk=7)

    np.testing.assert_allclose(cb, ca, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(kb, ka, rtol=1e-12, atol=1e-14)


def test_restore_preserves_ensemble_sharding(tmp_path):
    """A checkpoint saved from a mesh-sharded run must come back *sharded*
    when restored into a mesh-initialised propagator — restoring a
    100k-trajectory state unsharded is an OOM/perf landmine at exactly the
    scale checkpointing exists for — and the resumed physics must match the
    single-device resume."""
    import jax
    from jax.sharding import NamedSharding

    from semiclassical_jax.checkpoint import (
        load_propagator_state,
        save_propagator_state,
    )
    from semiclassical_jax.parallel import ensemble_mesh

    pot = NonHarmonicPotential.create()
    Gi = np.array([[2 * 2.5]])
    G0 = np.array([[1.0]])
    mesh = ensemble_mesh()
    dt, nt1, nt2, en0 = 0.02, 12, 13, 0.5

    def make(mesh, key=5):
        prop = HermanKlukPropagator(Gi, Gi)
        prop.initial_conditions(np.array([7.3]), np.array([0.0]), G0,
                                ntraj=2048, key=key, potential=pot,
                                mesh=mesh)
        return prop

    # run sharded, checkpoint mid-flight
    prop_a = make(mesh)
    prop_a.propagate(pot, dt, nt1, energy0_es=en0)
    ckpt = str(tmp_path / "sharded.npz")
    save_propagator_state(ckpt, prop_a)

    # restore into a fresh *mesh-initialised* propagator (different key —
    # overwritten by the checkpoint) and check every per-trajectory leaf
    # kept its NamedSharding over the traj axis
    prop_b = make(mesh, key=999)
    load_propagator_state(ckpt, prop_b)
    for leaf in jax.tree.leaves((prop_b.state, prop_b.trackers)):
        assert isinstance(leaf.sharding, NamedSharding), leaf.sharding
        if leaf.ndim and leaf.shape[0] == 2048:
            assert leaf.sharding.spec[0] == "traj", (
                f"per-trajectory leaf restored unsharded: {leaf.sharding}")
    c_sharded, k_sharded = prop_b.propagate(pot, dt, nt2, energy0_es=en0)

    # the resumed run must equal the unsharded checkpoint+resume
    prop_c = make(None)
    prop_c.propagate(pot, dt, nt1, energy0_es=en0)
    ckpt1 = str(tmp_path / "single.npz")
    save_propagator_state(ckpt1, prop_c)
    prop_d = make(None, key=999)
    load_propagator_state(ckpt1, prop_d)
    c_single, k_single = prop_d.propagate(pot, dt, nt2, energy0_es=en0)

    np.testing.assert_allclose(c_sharded, c_single, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(k_sharded, k_single, rtol=1e-12, atol=1e-14)


def test_wm_checkpoint_roundtrip(tmp_path):
    from semiclassical_jax.checkpoint import (
        load_propagator_state,
        save_propagator_state,
    )
    from semiclassical_jax.propagation import WaltonManolopoulosPropagator

    pot = NonHarmonicPotential.create()
    Gi = np.array([[2 * 2.5]])
    G0 = np.array([[1.0]])

    prop = WaltonManolopoulosPropagator(Gi, Gi, 100.0, 100.0)
    prop.initial_conditions(np.array([7.3]), np.array([0.0]), G0,
                            ntraj=500, key=2, potential=pot)
    prop.propagate(pot, 0.02, 10, energy0_es=0.5)
    ckpt = str(tmp_path / "wm.npz")
    save_propagator_state(ckpt, prop)
    ref_c = prop.autocorrelation(energy0_es=0.5)

    prop2 = WaltonManolopoulosPropagator(Gi, Gi, 100.0, 100.0)
    prop2.initial_conditions(np.array([7.3]), np.array([0.0]), G0,
                             ntraj=500, key=77, potential=pot)
    load_propagator_state(ckpt, prop2)
    assert prop2.t == prop.t
    assert abs(prop2.autocorrelation(energy0_es=0.5) - ref_c) < 1e-12
