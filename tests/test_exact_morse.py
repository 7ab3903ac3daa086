# coding: utf-8
"""Exact (closed-form) Morse integrator.

The closed-form action-angle map replaces the RK4 time stepper for
separable Morse potentials with ZERO time-discretization error (the
integrator-change accuracy story: it is exact, not merely consistent).
The gates here check

* the map itself against a tiny-step RK4 reference (machine precision),
* HK / WM correlation functions against the RK4 integrator at a small dt
  (the two must agree up to RK4's own O(dt^4) error),
* chunked-scan equivalence (the carried phase persists across chunks),
* checkpoint kill-and-resume, sharded-vs-single equality, and the
  fail-loud guards (unbound orbits, non-Morse potentials).

The reference has no counterpart — its propagators always run RK4
(reference propagators.py:86-119); the exact map is an accuracy/
capability feature (exact at any dt, no stability limit, exact energy
conservation), not expected to be faster than RK4 at equal dt (both are
elementwise-flop-bound; see exact_morse.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from semiclassical_jax.potentials import MorsePotential, NonHarmonicPotential
from semiclassical_jax.propagation import (
    HermanKlukPropagator,
    WaltonManolopoulosPropagator,
)
from semiclassical_jax.propagation import exact_morse as em
from semiclassical_jax.propagation.eom import rk4_step
from semiclassical_jax.propagation.state import TrajState


def _morse(d=6, seed=0, dtype=jnp.float64, chi=0.02):
    rng = np.random.default_rng(seed)
    omega = rng.uniform(300.0, 2800.0, size=d) / 219474.63
    nac = rng.uniform(-1.0, 1.0, size=d)
    pot = MorsePotential.create(omega, np.full(d, chi), nac, dtype=dtype)
    S = rng.uniform(0.02, 0.3, size=d)
    q0 = np.sqrt(2 * S / omega)
    Gamma = np.diag(omega)
    return pot, q0, Gamma, omega


def test_map_matches_tiny_step_rk4():
    """q/p/monodromy/action of the closed-form map vs the package's own
    RK4 run at a 64x smaller step (f64): the map is exact, so the
    difference is RK4's truncation error — demands it below 1e-9."""
    pot, q0c, Gamma, omega = _morse(d=4, seed=5)
    rng = np.random.default_rng(7)
    n = 16
    qi = q0c[None, :] + rng.normal(0, 0.4, (n, 4)) / np.sqrt(omega)[None, :]
    pi = rng.normal(0, 0.6, (n, 4)) * np.sqrt(omega)[None, :]

    state = TrajState.initial(jnp.asarray(qi), jnp.asarray(pi),
                              diag_monodromy=True)
    dt = 4.0
    nt = 25
    pack, carry = em.build_morse_map(state, pot, dt)
    for _ in range(nt):
        carry = em.morse_map_advance(pack, carry, dt, pot)
    exact, _ = em.morse_map_state(pack, carry, jnp.float64, pot)

    sub = 64
    ref = state
    for _ in range(nt * sub):
        ref, _ = rk4_step(ref, pot, dt / sub)

    scale_q = 1.0 / np.sqrt(omega)[None, :]
    assert (np.abs(np.asarray(exact.q - ref.q)) / scale_q).max() < 1e-9
    assert (np.abs(np.asarray(exact.p - ref.p))
            / np.sqrt(omega)[None, :]).max() < 1e-9
    for blk in ("Mqq", "Mqp", "Mpq", "Mpp"):
        a = np.asarray(getattr(exact, blk))
        b = np.asarray(getattr(ref, blk))
        assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 1e-9, blk
    assert np.abs(np.asarray(exact.S - ref.S)).max() < 1e-9


def test_hk_exact_matches_rk4_correlation():
    """Twin HK runs (identical sampling): the exact integrator must
    reproduce the small-dt RK4 correlation functions to RK4's own
    truncation error."""
    pot, q0, Gamma, _ = _morse(d=6, seed=1)

    def run(integrator):
        prop = HermanKlukPropagator(Gamma, Gamma, integrator=integrator)
        prop.initial_conditions(q0, np.zeros(6), Gamma, ntraj=512, key=3,
                                potential=pot)
        return prop.propagate(pot, 1.0, 80)

    c_rk4, k_rk4 = run("rk4")
    c_ex, k_ex = run("exact")
    assert np.abs(c_ex - c_rk4).max() < 1e-6
    assert np.abs(k_ex - k_rk4).max() / np.abs(k_rk4).max() < 1e-6


def test_hk_exact_large_dt_consistent():
    """The exact map has no stability limit: a 16x larger step must sample
    the SAME C(t) at the shared time points (up to f64 roundoff)."""
    pot, q0, Gamma, _ = _morse(d=4, seed=2)

    def run(dt, nt):
        prop = HermanKlukPropagator(Gamma, Gamma, integrator="exact")
        prop.initial_conditions(q0, np.zeros(4), Gamma, ntraj=256, key=9,
                                potential=pot)
        return prop.propagate(pot, dt, nt)[0]

    fine = run(1.0, 64)
    coarse = run(16.0, 4)
    np.testing.assert_allclose(coarse, fine[::16], rtol=0, atol=1e-9)


def test_exact_chunked_scan_equivalence():
    """The carried phase must persist across chunk boundaries: a chunked
    run reproduces the single-scan run bit-for-bit."""
    pot, q0, Gamma, _ = _morse(d=5, seed=3)

    def run(chunk):
        prop = HermanKlukPropagator(Gamma, Gamma, integrator="exact")
        prop.initial_conditions(q0, np.zeros(5), Gamma, ntraj=128, key=1,
                                potential=pot)
        return prop.propagate(pot, 2.0, 30, chunk=chunk)[0]

    np.testing.assert_array_equal(run(None), run(7))


def test_exact_comp32_matches_f64():
    """comp32 exact (f32 state, two-sum phase carry) vs the f64 exact run:
    the readout errors are non-accumulating single-f32 roundings."""
    pot64, q0, Gamma, _ = _morse(d=12, seed=4)
    pot32 = MorsePotential.create(
        np.asarray(pot64.omega), np.full(12, 0.02), np.asarray(pot64.nac),
        dtype=jnp.float32)

    prop = HermanKlukPropagator(Gamma, Gamma, integrator="exact")
    prop.initial_conditions(q0, np.zeros(12), Gamma, ntraj=1024, key=6,
                            potential=pot64)
    c64, k64 = prop.propagate(pot64, 2.0, 100)

    propc = HermanKlukPropagator(Gamma, Gamma, dtype=jnp.float32,
                                 traj_dtype="comp32", integrator="exact")
    propc.initial_conditions(q0, np.zeros(12), Gamma, ntraj=1024, key=6,
                             potential=pot32)
    cc, kc = propc.propagate(pot32, 2.0, 100)
    assert np.abs(cc - c64).max() < 5e-4
    assert np.abs(kc - k64).max() / np.abs(k64).max() < 5e-4


def test_exact_energy_is_constant():
    """The map conserves energy exactly — the recorded per-step batch-mean
    energies are a constant array (and the conservation guard passes)."""
    pot, q0, Gamma, _ = _morse(d=4, seed=8)
    prop = HermanKlukPropagator(Gamma, Gamma, integrator="exact")
    prop.initial_conditions(q0, np.zeros(4), Gamma, ntraj=64, key=2,
                            potential=pot)
    prop.propagate(pot, 2.0, 20, check_energy=True)
    en = prop.last_energies
    assert np.ptp(en) == 0.0


def test_exact_checkpoint_resume():
    from semiclassical_jax.checkpoint import (load_propagator_state,
                                              save_propagator_state)
    pot, q0, Gamma, _ = _morse(d=5, seed=9)

    def fresh():
        prop = HermanKlukPropagator(Gamma, Gamma, integrator="exact")
        prop.initial_conditions(q0, np.zeros(5), Gamma, ntraj=128, key=4,
                                potential=pot)
        return prop

    prop = fresh()
    c_full, _ = prop.propagate(pot, 2.0, 20)

    prop1 = fresh()
    c_head, _ = prop1.propagate(pot, 2.0, 10)
    import tempfile
    with tempfile.TemporaryDirectory() as td:
        fn = td + "/ck.npz"
        save_propagator_state(fn, prop1)
        prop2 = fresh()
        load_propagator_state(fn, prop2)
        c_tail, _ = prop2.propagate(pot, 2.0, 10)
    # the resumed run re-derives the map constants from the restored state
    # (M0 != identity composes); the restored q/p are the f32-free exact
    # values, so agreement is at f64 roundoff
    np.testing.assert_allclose(np.concatenate([c_head, c_tail]), c_full,
                               rtol=0, atol=1e-10)


def test_exact_sharded_matches_single():
    import jax

    from semiclassical_jax.parallel import ensemble_mesh

    pot, q0, Gamma, _ = _morse(d=4, seed=10)

    def run(mesh):
        prop = HermanKlukPropagator(Gamma, Gamma, integrator="exact")
        prop.initial_conditions(q0, np.zeros(4), Gamma, ntraj=256, key=5,
                                potential=pot, mesh=mesh)
        return prop.propagate(pot, 2.0, 10)[0]

    single = run(None)
    mesh = ensemble_mesh(jax.devices()[:8])
    sharded = run(mesh)
    np.testing.assert_allclose(sharded, single, rtol=0, atol=1e-11)


def test_wm_exact_matches_rk4():
    pot, q0, Gamma, _ = _morse(d=5, seed=11)

    def run(integrator):
        prop = WaltonManolopoulosPropagator(Gamma, Gamma, 200.0, 200.0,
                                            integrator=integrator)
        prop.initial_conditions(q0, np.zeros(5), Gamma, ntraj=512, key=7,
                                potential=pot)
        return prop.propagate(pot, 1.0, 60)

    c_rk4, k_rk4 = run("rk4")
    c_ex, k_ex = run("exact")
    assert np.abs(c_ex - c_rk4).max() < 1e-6
    assert np.abs(k_ex - k_rk4).max() / np.abs(k_rk4).max() < 1e-6


def test_exact_unbound_rows_take_rk4_side_channel():
    """Unbound tail samples (eps = E/D > 1 — they DO occur in production
    Husimi ensembles) are RK4-routed inside the hybrid map: the full-batch
    observables must match the pure-RK4 integrator, and the map must
    report the routing."""
    pot, q0, Gamma, omega = _morse(d=3, seed=12)
    rng = np.random.default_rng(0)
    n = 64
    qi = q0[None, :] + rng.normal(0, 0.3, (n, 3)) / np.sqrt(omega)[None, :]
    pi = rng.normal(0, 0.5, (n, 3)) * np.sqrt(omega)[None, :]
    D0 = float(np.asarray(pot.D)[0])
    pi[5, 0] = np.sqrt(2.4 * D0)   # unbound (dissociating)
    pi[17, 1] = np.sqrt(1.9 * float(np.asarray(pot.D)[1]) * 0.99)

    state = TrajState.initial(jnp.asarray(qi), jnp.asarray(pi),
                              diag_monodromy=True)
    pack, carry = em.build_morse_map(state, pot, 1.0)
    assert pack.has_sub and carry.sub is not None
    nt = 40
    ref = state
    for _ in range(nt):
        carry = em.morse_map_advance(pack, carry, 1.0, pot)
        ref, _ = rk4_step(ref, pot, 1.0 / 8)
        for _ in range(7):
            ref, _ = rk4_step(ref, pot, 1.0 / 8)
    st, en = em.morse_map_state(pack, carry, jnp.float64, pot)
    st = em.morse_map_merge(pack, carry, st)
    # the dissociating row must have flown outward and match RK4
    assert float(st.q[5, 0]) > float(qi[5, 0])
    np.testing.assert_allclose(np.asarray(st.q), np.asarray(ref.q),
                               rtol=0, atol=2e-4 * float(np.abs(ref.q).max()))
    assert np.isfinite(np.asarray(st.S)).all()
    assert np.isfinite(float(en))


def test_exact_propagate_with_unbound_rows_matches_rk4():
    """Full HK propagate (scan + chunking + tracker merge) on a batch
    containing unbound rows: the hybrid must match the pure-RK4 run
    (identical sampling; both handle the hot rows with RK4)."""
    pot, q0, Gamma, omega = _morse(d=4, seed=14)
    D = np.asarray(pot.D)

    def run(integrator, chunk=None):
        prop = HermanKlukPropagator(Gamma, Gamma, integrator=integrator)
        prop.initial_conditions(q0, np.zeros(4), Gamma, ntraj=256, key=8,
                                potential=pot)
        # inject hot rows (dissociating + near-separatrix) into the state;
        # identical surgery on both runs keeps them twins
        from semiclassical_jax.pytree import replace
        p = np.array(prop.state.p)
        p[3, 0] = np.sqrt(2.1 * D[0])
        p[100, 2] = np.sqrt(1.9 * D[2] * 0.95)
        prop.state = replace(prop.state, p=jnp.asarray(p))
        return prop.propagate(pot, 1.0, 30, check_energy=False,
                              chunk=chunk)

    c_rk4, k_rk4 = run("rk4")
    c_ex, k_ex = run("exact")
    assert np.abs(c_ex - c_rk4).max() < 1e-6
    assert np.abs(k_ex - k_rk4).max() / np.abs(k_rk4).max() < 1e-6
    # chunked hybrid reproduces the single-scan hybrid (sub carry +
    # tracker merge across chunk boundaries)
    c_ex7, _ = run("exact", chunk=7)
    np.testing.assert_allclose(c_ex7, c_ex, rtol=0, atol=1e-12)


def test_exact_too_hot_ensemble_raises():
    """If a large fraction of the ensemble is unbound the hybrid refuses
    (the exact map would be pointless)."""
    pot, q0, Gamma, omega = _morse(d=3, seed=13)
    n = 16
    qi = np.zeros((n, 3))
    pi = np.sqrt(2.5 * np.asarray(pot.D))[None, :] * np.ones((n, 3))
    state = TrajState.initial(jnp.asarray(qi), jnp.asarray(pi),
                              diag_monodromy=True)
    with pytest.raises(ValueError, match="too hot"):
        em.build_morse_map(state, pot, 1.0)


def test_exact_nan_rows_are_routed_not_rest_stated():
    """A NaN trajectory (state surgery / bad restart input) must be routed
    to the RK4 side-channel like any other non-exact-safe row — NOT
    silently replaced by a full-weight rest state in the closed-form
    branch (NaN > eps is False, so a max()-based routing test would miss
    it while the element-wise cleanup zeroes its coordinates)."""
    pot, q0, Gamma, omega = _morse(d=3, seed=21)
    rng = np.random.default_rng(1)
    n = 64
    qi = q0[None, :] + rng.normal(0, 0.2, (n, 3)) / np.sqrt(omega)[None, :]
    pi = rng.normal(0, 0.4, (n, 3)) * np.sqrt(omega)[None, :]
    qi[9, 1] = np.nan
    state = TrajState.initial(jnp.asarray(qi), jnp.asarray(pi),
                              diag_monodromy=True)
    pack, carry = em.build_morse_map(state, pot, 1.0)
    assert pack.has_sub
    assert bool(np.asarray(pack.row_bad)[9])
    # the poisoned row is -inf-masked out of the closed-form observables
    # (it rides the RK4 side-channel, where NaN propagates fail-loud into
    # the energy trace exactly as under integrator='rk4')
    st, en = em.morse_map_state(pack, carry, jnp.float64, pot)
    assert not np.isfinite(float(en))


def test_exact_deferred_nacq_refreshes_map_constants():
    """initial_conditions(potential=None) defers the NAC-dependent batch
    constants (and yields a dense-monodromy state — the exact map then
    refuses, fail-loud).  But state surgery to a diagonal-monodromy state
    is a supported pattern, and if the exact-map pack is then built by
    step() BEFORE the first propagate() supplies the nacq, the masked
    scan constants must be refreshed — pre-fix they froze the nacq-less
    bc and k~ic(t) came out identically zero."""
    pot, q0, Gamma, _ = _morse(d=4, seed=22)

    def run(defer):
        prop = HermanKlukPropagator(Gamma, Gamma, integrator="exact")
        prop.initial_conditions(q0, np.zeros(4), Gamma, ntraj=128, key=3,
                                potential=None if defer else pot)
        if defer:
            # same q/p, diagonal monodromy (identical to the non-defer
            # initial state); nacq stays deferred until propagate()
            prop.state = TrajState.initial(
                prop.state.q, prop.state.p, dtype=prop.traj_dtype,
                mono_dtype=prop.dtype, diag_monodromy=True,
                compensated=prop.compensated)
        prop.step(pot, 1.0)          # builds the exact-map pack + bc caches
        return prop.propagate(pot, 1.0, 20)

    c_a, k_a = run(defer=False)
    c_b, k_b = run(defer=True)
    assert np.abs(np.asarray(k_a)).max() > 0
    np.testing.assert_allclose(np.asarray(k_b), np.asarray(k_a),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(c_b), np.asarray(c_a),
                               rtol=0, atol=1e-12)


def test_exact_requires_morse():
    pot = NonHarmonicPotential.create(dim=3)
    Gamma = np.eye(3)
    prop = HermanKlukPropagator(Gamma, Gamma, integrator="exact")
    prop.initial_conditions(np.full(3, 0.2), np.zeros(3), Gamma, ntraj=32,
                            key=0, potential=pot)
    with pytest.raises(ValueError, match="MorsePotential"):
        prop.propagate(pot, 1.0, 2)


def test_exact_invalid_integrator_name():
    with pytest.raises(ValueError, match="integrator"):
        HermanKlukPropagator(np.eye(2), np.eye(2), integrator="leapfrog")


def test_exact_state_surgery_rebuilds_map():
    """Externally assigned state (state surgery is a supported pattern —
    the cache is keyed on object identity) must invalidate the cached
    exact-map pack/carry: the continuation must track RK4 on the SAME
    surged state, not silently replay the cached orbit."""
    from dataclasses import replace as dc_replace

    pot, q0, Gamma, _ = _morse(d=4, seed=8)

    def run(integrator):
        prop = HermanKlukPropagator(Gamma, Gamma, integrator=integrator)
        prop.initial_conditions(q0, np.zeros(4), Gamma, ntraj=128, key=5,
                                potential=pot)
        prop.propagate(pot, 1.0, 10)
        prop.state = dc_replace(prop.state, p=1.2 * prop.state.p)
        return prop.propagate(pot, 1.0, 20)

    c_ex, _ = run("exact")
    c_rk, _ = run("rk4")
    # pre-fix the exact branch returned the *unmutated* continuation
    # (|dC| ~ 1e-1 vs rk4); post-fix both see the surged momenta
    assert np.abs(c_ex - c_rk).max() < 1e-6


def test_exact_wdt_reduced_mod_2pi_any_dt():
    """The constant per-step phase increment is reduced mod 2pi at build
    time (the map is 2pi-periodic in th), so the per-step wrap invariant
    k in {-1, 0, 1} holds at ANY dt — including steps spanning several
    orbital periods."""
    pot, q0c, Gamma, omega = _morse(d=4, seed=6)
    rng = np.random.default_rng(3)
    n = 32
    qi = q0c[None, :] + rng.normal(0, 0.3, (n, 4)) / np.sqrt(omega)[None, :]
    pi = rng.normal(0, 0.5, (n, 4)) * np.sqrt(omega)[None, :]
    state = TrajState.initial(jnp.asarray(qi), jnp.asarray(pi),
                              diag_monodromy=True)

    # several periods of the fastest mode per step
    dt = float(3.0 * np.pi / omega.min())
    pack, _ = em.build_morse_map(state, pot, dt)
    tp = 2.0 * np.pi
    assert np.abs(np.asarray(pack.wdt_hi)).max() <= 0.5 * tp + 1e-12

    # the coarse run must sample the same orbit as a fine run whose
    # increments never needed reduction (already-validated regime)
    sub = 64
    packc, carryc = em.build_morse_map(state, pot, dt)
    packf, carryf = em.build_morse_map(state, pot, dt / sub)
    for _ in range(4):
        carryc = em.morse_map_advance(packc, carryc, dt, pot)
    for _ in range(4 * sub):
        carryf = em.morse_map_advance(packf, carryf, dt / sub, pot)
    coarse, _ = em.morse_map_state(packc, carryc, jnp.float64, pot)
    fine, _ = em.morse_map_state(packf, carryf, jnp.float64, pot)
    for blk in ("q", "p", "S", "Mqq", "Mqp", "Mpq", "Mpp"):
        a, b = np.asarray(getattr(coarse, blk)), np.asarray(
            getattr(fine, blk))
        assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 1e-8, blk
