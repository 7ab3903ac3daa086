# coding: utf-8
"""Tests for `hessian_eval = "step"` — the once-per-step frozen-Hessian
monodromy mode for potentials with expensive Hessians (sGDML).

Contract (eom.rk4_step): trajectories (q, p, S) are bit-identical to the
default 4-stage mode — only the monodromy blocks carry the midpoint-Magnus
approximation, with O(dt^3 ||dH/dt||) local error.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from semiclassical_jax.potentials.base import DenseHessian
from semiclassical_jax.propagation import HermanKlukPropagator
from semiclassical_jax.propagation.eom import rk4_step
from semiclassical_jax.pytree import pytree_dataclass


@pytree_dataclass(meta=("hessian_eval", "taylor_every"))
class _CosCoupledPotential:
    """V = 1/2 q^T K q - lam cos(c.q) — a bounded anharmonic coupling with
    a genuinely geometry-dependent dense Hessian K + lam cos(c.q) c c^T
    (the DenseHessian monodromy branch, i.e. the GDML code path) and a
    closed-form cheap gradient."""

    K: jnp.ndarray
    c: jnp.ndarray
    lam: jnp.ndarray
    nac0: jnp.ndarray
    hessian_eval: str = "stage"
    taylor_every: int = 1

    def dimensions(self):
        return self.K.shape[0]

    def masses(self):
        return jnp.ones(self.K.shape[0], dtype=self.K.dtype)

    def total_energy(self):
        return jnp.zeros((), dtype=self.K.dtype)

    def value_grad(self, q):
        cq = q @ self.c
        v = 0.5 * jnp.sum((q @ self.K) * q, axis=1) - self.lam * jnp.cos(cq)
        grad = q @ self.K + self.lam * jnp.sin(cq)[:, None] * self.c
        return v, grad

    def local_expansion(self, q):
        v, grad = self.value_grad(q)
        cq = q @ self.c
        hess = (self.K[None] + self.lam * jnp.cos(cq)[:, None, None]
                * (self.c[:, None] * self.c[None, :])[None])
        return v, grad, DenseHessian(mat=hess)

    def derivative_coupling_1st(self, q):
        return jnp.broadcast_to(self.nac0[None, :], q.shape)

    def derivative_coupling_2nd(self, q):
        return jnp.zeros_like(q)


def _make_potential(d=4, lam=1.0e-3, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.2, 0.5, size=d)
    c = rng.uniform(-1.0, 1.0, size=d)
    c /= np.linalg.norm(c)
    return _CosCoupledPotential(
        K=jnp.asarray(np.diag(w**2)), c=jnp.asarray(c),
        lam=jnp.asarray(lam), nac0=jnp.asarray(rng.uniform(-1, 1, size=d)))


def _run(pot, nt=40, dt=0.5, ntraj=32, key=3):
    d = pot.dimensions()
    w = np.sqrt(np.diag(np.asarray(pot.K)))
    Gamma = np.diag(w)
    q0 = np.full(d, 0.3)
    prop = HermanKlukPropagator(Gamma, Gamma)
    prop.initial_conditions(q0, np.zeros(d), Gamma, ntraj=ntraj, key=key,
                            potential=pot)
    cauto, kic = prop.propagate(pot, dt, nt,
                                energy0_es=float(w.sum() / 2))
    return prop.state, cauto, kic


def test_frozen_hessian_exact_for_constant_hessian():
    """With lam = 0 the Hessian is geometry-independent, so freezing it
    changes nothing: step and stage modes must agree to roundoff."""
    from semiclassical_jax.pytree import replace
    pot_stage = _make_potential(lam=0.0)
    pot_step = replace(pot_stage, hessian_eval="step")
    s1, c1, k1 = _run(pot_stage, nt=10)
    s2, c2, k2 = _run(pot_step, nt=10)
    np.testing.assert_allclose(np.asarray(s2.Mqq), np.asarray(s1.Mqq),
                               rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(c2, c1, rtol=1e-12, atol=1e-14)


def test_frozen_hessian_trajectories_bit_identical():
    """q, p, S never see the Hessian: the frozen mode must reproduce them
    exactly, while the monodromy differs (but only slightly)."""
    from semiclassical_jax.pytree import replace
    pot = _make_potential(lam=2.0e-2)
    s1, c1, k1 = _run(pot)
    s2, c2, k2 = _run(replace(pot, hessian_eval="step"))
    assert np.array_equal(np.asarray(s1.q), np.asarray(s2.q))
    assert np.array_equal(np.asarray(s1.p), np.asarray(s2.p))
    assert np.array_equal(np.asarray(s1.S), np.asarray(s2.S))
    dM = np.abs(np.asarray(s1.Mqq) - np.asarray(s2.Mqq)).max()
    assert dM > 0.0  # the approximation is real...
    # ...and bounded even at this deliberately coarse regime (w dt ~ 0.25,
    # ~70x coarser than production molecular steps; measured dM ~ 1.6e-3,
    # dC ~ 5e-4 — the O(dt^2) scaling is gated by the convergence test
    # below, production-regime accuracy by the GDML twin test)
    assert dM < 5e-3
    np.testing.assert_allclose(c2, c1, rtol=0, atol=2e-3)
    np.testing.assert_allclose(k2, k1, rtol=0, atol=2e-3)


def test_frozen_hessian_second_order_convergence():
    """The midpoint-frozen monodromy propagator is a 2nd-order method:
    halving dt must shrink the monodromy gap to the stage mode ~4x
    (asymptotically; allow 3x for pre-asymptotic slack)."""
    from semiclassical_jax.pytree import replace
    pot = _make_potential(lam=2.0e-2)
    pot_f = replace(pot, hessian_eval="step")

    def gap(dt, nt):
        s1, _, _ = _run(pot, nt=nt, dt=dt)
        s2, _, _ = _run(pot_f, nt=nt, dt=dt)
        return np.abs(np.asarray(s1.Mpq) - np.asarray(s2.Mpq)).max()

    g_coarse = gap(1.0, 16)   # same physical horizon
    g_fine = gap(0.5, 32)
    assert g_coarse / g_fine > 3.0


def test_single_step_matches_manual_composition():
    """One frozen-H rk4_step must equal the 4-stage recurrence run with the
    midpoint Hessian substituted at every stage (the defining equation of
    the mode), not merely be 'close'."""
    from semiclassical_jax.pytree import replace
    pot = _make_potential(lam=2.0e-2)
    pot_f = replace(pot, hessian_eval="step")
    d = pot.dimensions()
    rng = np.random.default_rng(1)
    n = 8
    from semiclassical_jax.propagation.state import TrajState
    eye = jnp.broadcast_to(jnp.eye(d), (n, d, d))
    state = TrajState(
        q=jnp.asarray(rng.normal(0.3, 0.1, size=(n, d))),
        p=jnp.asarray(rng.normal(0.0, 0.1, size=(n, d))),
        Mqq=eye, Mqp=jnp.zeros((n, d, d)), Mpq=jnp.zeros((n, d, d)),
        Mpp=eye, S=jnp.zeros(n))
    dt = 0.5

    new_f, _ = rk4_step(state, pot_f, dt)

    # manual composition: trajectory block from the plain potential (the
    # trajectories never see the Hessian), midpoint Hessian by hand
    v1, g1 = pot.value_grad(state.q)
    k1q = state.p  # masses are 1
    q_mid = state.q + 0.5 * dt * k1q
    _, _, H_mid = pot.local_expansion(q_mid)

    @pytree_dataclass(meta=("hessian_eval",))
    class _FrozenH:
        base: _CosCoupledPotential
        Hm: jnp.ndarray
        hessian_eval: str = "stage"

        def masses(self):
            return self.base.masses()

        def local_expansion(self, q):
            v, grad = self.base.value_grad(q)
            return v, grad, DenseHessian(
                mat=jnp.broadcast_to(self.Hm, (q.shape[0],) + self.Hm.shape[1:]))

    new_m, _ = rk4_step(state, _FrozenH(base=pot, Hm=H_mid.mat), dt)
    for leaf in ("q", "p", "S", "Mqq", "Mqp", "Mpq", "Mpp"):
        np.testing.assert_allclose(
            np.asarray(getattr(new_f, leaf)), np.asarray(getattr(new_m, leaf)),
            rtol=1e-14, atol=1e-16, err_msg=leaf)


@pytest.mark.slow
def test_gdml_frozen_hessian_close(ref_data):
    """Coumarin sGDML: hessian_eval='step' must track the 4-stage mode —
    identical ensembles, so the gate is far below MC noise. (This is the
    configuration the mode exists for: the analytic sGDML Hessian costs
    ~20x the gradient.)"""
    from semiclassical_jax.io import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularGDMLPotential

    model_path = (ref_data / "GDML"
                  / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")

    model = np.load(model_path, allow_pickle=True)
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    x0, Gamma0, zpe = exc.vibrational_groundstate()

    def run(hessian_eval):
        pot = MolecularGDMLPotential.create(model, exc,
                                            hessian_eval=hessian_eval)
        prop = HermanKlukPropagator(Gamma0, Gamma0)
        prop.initial_conditions(x0, np.zeros_like(x0), Gamma0, ntraj=16,
                                key=7, potential=pot)
        c, k = prop.propagate(pot, 0.25, 12, energy0_es=zpe)
        return prop.state, c, k

    s_stage, c_stage, k_stage = run("stage")
    s_step, c_step, k_step = run("step")
    # the bit-identity contract on the REAL potential: the step mode's
    # order-1 gdml_forward at stages 1/3/4 is a strict code prefix of the
    # order-2 program, and XLA(CPU) reproduces the shared E/grad subgraph
    # exactly — q/p/S never see the Hessian
    assert np.array_equal(np.asarray(s_stage.q), np.asarray(s_step.q))
    assert np.array_equal(np.asarray(s_stage.p), np.asarray(s_step.p))
    assert np.array_equal(np.asarray(s_stage.S), np.asarray(s_step.S))
    np.testing.assert_allclose(c_step, c_stage, rtol=0, atol=2e-7)
    np.testing.assert_allclose(k_step, k_stage, rtol=0, atol=2e-7)
    # the run is non-trivial
    assert np.abs(c_stage[-1] - c_stage[0]) > 1e-4


def test_gdml_create_rejects_bad_hessian_eval(ref_data):
    from semiclassical_jax.io import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularGDMLPotential

    model_path = (ref_data / "GDML"
                  / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")
    model = np.load(model_path, allow_pickle=True)
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    with pytest.raises(ValueError, match="hessian_eval"):
        MolecularGDMLPotential.create(model, exc, hessian_eval="never")


def test_config_accepts_hessian_eval():
    from semiclassical_jax.config import validate_task

    task = {
        "task": "dynamics",
        "potential": {"type": "gdml", "ground": "m.npz", "excited": "e.fchk",
                      "coupling": "c.fchk", "hessian_eval": "step"},
        "num_steps": 2,
        "time_step_fs": 0.005,
        "results": {"correlations": "c.npz"},
    }
    validate_task(task)  # must not raise


# --- hessian_eval = "taylor": one order-2 eval per step, local-quadratic
# stage forces (changes trajectories at O(dt^2), unlike "step") ---


def test_taylor_exact_for_quadratic_potential():
    """With lam = 0 the PES is globally quadratic, so the local expansion
    at the midpoint IS the exact PES: taylor-mode trajectories must match
    the 4-stage mode to roundoff (they are computed through a different
    arithmetic path, so not bit-identical)."""
    from semiclassical_jax.pytree import replace
    pot_stage = _make_potential(lam=0.0)
    pot_t = replace(pot_stage, hessian_eval="taylor")
    s1, c1, k1 = _run(pot_stage, nt=10)
    s2, c2, k2 = _run(pot_t, nt=10)
    np.testing.assert_allclose(np.asarray(s2.q), np.asarray(s1.q),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(s2.p), np.asarray(s1.p),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(np.asarray(s2.Mqq), np.asarray(s1.Mqq),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(c2, c1, rtol=1e-11, atol=1e-13)


def test_taylor_second_order_convergence():
    """The local-harmonic stage forces make taylor a globally 2nd-order
    method for the trajectories: halving dt must shrink the q/p gap to the
    4-stage mode ~4x (allow 3x for pre-asymptotic slack)."""
    from semiclassical_jax.pytree import replace
    pot = _make_potential(lam=2.0e-2)
    pot_t = replace(pot, hessian_eval="taylor")

    def gap(dt, nt):
        s1, _, _ = _run(pot, nt=nt, dt=dt)
        s2, _, _ = _run(pot_t, nt=nt, dt=dt)
        return max(np.abs(np.asarray(s1.q) - np.asarray(s2.q)).max(),
                   np.abs(np.asarray(s1.p) - np.asarray(s2.p)).max())

    g_coarse = gap(1.0, 16)   # same physical horizon
    g_fine = gap(0.5, 32)
    assert g_coarse > 0.0     # the approximation is real
    assert g_coarse / g_fine > 3.0


def test_taylor_single_step_matches_manual_quadratic():
    """One taylor rk4_step must equal an rk4_step on the hand-built
    quadratic expansion of the PES around the free-flight midpoint (the
    defining equation of the mode), not merely be 'close'."""
    from semiclassical_jax.pytree import replace
    from semiclassical_jax.propagation.state import TrajState

    pot = _make_potential(lam=2.0e-2)
    pot_t = replace(pot, hessian_eval="taylor")
    d = pot.dimensions()
    rng = np.random.default_rng(5)
    n = 8
    eye = jnp.broadcast_to(jnp.eye(d), (n, d, d))
    state = TrajState(
        q=jnp.asarray(rng.normal(0.3, 0.1, size=(n, d))),
        p=jnp.asarray(rng.normal(0.0, 0.1, size=(n, d))),
        Mqq=eye, Mqp=jnp.zeros((n, d, d)), Mpq=jnp.zeros((n, d, d)),
        Mpp=eye, S=jnp.zeros(n))
    dt = 0.5

    new_t, _ = rk4_step(state, pot_t, dt)

    # manual composition: expand the PES at q_mid = q + dt/2 p/m and run
    # the plain 4-stage step on that quadratic surrogate
    q_mid = state.q + 0.5 * dt * state.p  # masses are 1
    v0, g0, H0 = pot.local_expansion(q_mid)
    Hm = H0.mat

    @pytree_dataclass
    class _Quadratic:
        q_mid: jnp.ndarray
        v0: jnp.ndarray
        g0: jnp.ndarray
        Hm: jnp.ndarray

        def masses(self):
            return jnp.ones(self.q_mid.shape[1], dtype=self.q_mid.dtype)

        def local_expansion(self, q):
            delta = q - self.q_mid
            hd = jnp.einsum("nxy,ny->nx", self.Hm, delta)
            v = self.v0 + jnp.sum((self.g0 + 0.5 * hd) * delta, axis=1)
            return v, self.g0 + hd, DenseHessian(mat=self.Hm)

    new_m, _ = rk4_step(
        state, _Quadratic(q_mid=q_mid, v0=v0, g0=g0, Hm=Hm), dt)
    for leaf in ("q", "p", "S", "Mqq", "Mqp", "Mpq", "Mpp"):
        np.testing.assert_allclose(
            np.asarray(getattr(new_t, leaf)), np.asarray(getattr(new_m, leaf)),
            rtol=1e-13, atol=1e-15, err_msg=leaf)


@pytest.mark.slow
def test_gdml_taylor_close(ref_data):
    """Coumarin sGDML: hessian_eval='taylor' must track the 4-stage mode on
    identical ensembles. Unlike 'step' the trajectories themselves carry
    the O(dt^2) local-harmonic error, so the gate is looser — but still
    far below the MC noise scale of production runs."""
    from semiclassical_jax.io import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularGDMLPotential

    model_path = (ref_data / "GDML"
                  / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")

    model = np.load(model_path, allow_pickle=True)
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    x0, Gamma0, zpe = exc.vibrational_groundstate()

    def run(hessian_eval):
        pot = MolecularGDMLPotential.create(model, exc,
                                            hessian_eval=hessian_eval)
        prop = HermanKlukPropagator(Gamma0, Gamma0)
        prop.initial_conditions(x0, np.zeros_like(x0), Gamma0, ntraj=16,
                                key=7, potential=pot)
        c, k = prop.propagate(pot, 0.25, 12, energy0_es=zpe)
        return prop.state, c, k

    s_stage, c_stage, k_stage = run("stage")
    s_t, c_t, k_t = run("taylor")
    # trajectories differ (the approximation is real) but stay close at
    # these production-scale steps
    dq = np.abs(np.asarray(s_stage.q) - np.asarray(s_t.q)).max()
    assert dq > 0.0
    np.testing.assert_allclose(c_t, c_stage, rtol=0, atol=5e-6)
    np.testing.assert_allclose(k_t, k_stage, rtol=0, atol=5e-6)
    assert np.abs(c_stage[-1] - c_stage[0]) > 1e-4


# --- taylor_every: k-step re-expansion windows (one order-2 eval per
# window; eom.make_taylor_window) ---


def test_window_exact_for_quadratic_potential():
    """lam = 0: expanding a global quadratic is exact whatever the window
    length, so even very long windows must match the 4-stage mode to
    roundoff."""
    from semiclassical_jax.pytree import replace
    pot_stage = _make_potential(lam=0.0)
    pot_w = replace(pot_stage, hessian_eval="taylor", taylor_every=8)
    s1, c1, k1 = _run(pot_stage, nt=16)
    s2, c2, k2 = _run(pot_w, nt=16)
    np.testing.assert_allclose(np.asarray(s2.q), np.asarray(s1.q),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(c2, c1, rtol=1e-11, atol=1e-13)


def test_window_second_order_in_window_length():
    """The stage-force error is 2nd-order in the window length: at fixed
    horizon, the gap between taylor_every=4 and per-step taylor must
    shrink ~4x when dt halves (window length halves with it)."""
    from semiclassical_jax.pytree import replace
    pot = _make_potential(lam=2.0e-2)
    pot_t = replace(pot, hessian_eval="taylor")
    pot_w = replace(pot, hessian_eval="taylor", taylor_every=4)

    def gap(dt, nt):
        s1, _, _ = _run(pot_t, nt=nt, dt=dt)
        s2, _, _ = _run(pot_w, nt=nt, dt=dt)
        return max(np.abs(np.asarray(s1.q) - np.asarray(s2.q)).max(),
                   np.abs(np.asarray(s1.p) - np.asarray(s2.p)).max())

    g_coarse = gap(0.5, 16)
    g_fine = gap(0.25, 32)
    assert g_coarse > 0.0     # windows really freeze the expansion
    assert g_coarse / g_fine > 3.0


def test_window_matches_manual_quadratic_composition():
    """taylor_every=nt (one window for the whole scan) must equal running
    every step on the hand-built quadratic expanded at the window
    midpoint — the defining equation of the window mode."""
    from semiclassical_jax.propagation.eom import LocalQuadratic
    from semiclassical_jax.pytree import replace

    pot = _make_potential(lam=2.0e-2)
    nt, dt = 4, 0.5
    pot_w = replace(pot, hessian_eval="taylor", taylor_every=nt)
    s_w, c_w, k_w = _run(pot_w, nt=nt, dt=dt)

    # manual: expand once at q0 + (nt dt / 2) p0 (masses are 1), then
    # propagate the ORIGINAL ensemble on that frozen quadratic
    pot_plain = pot
    d = pot.dimensions()
    w = np.sqrt(np.diag(np.asarray(pot.K)))
    Gamma = np.diag(w)
    q0v = np.full(d, 0.3)
    from semiclassical_jax.propagation import HermanKlukPropagator
    prop = HermanKlukPropagator(Gamma, Gamma)
    prop.initial_conditions(q0v, np.zeros(d), Gamma, ntraj=32, key=3,
                            potential=pot_plain)
    st0 = prop.state
    q_mid = st0.q + 0.5 * nt * dt * st0.p
    v0, g0, H0 = pot_plain.local_expansion(q_mid)
    quad = LocalQuadratic(q_mid=q_mid, v0=v0, g0=g0, H=H0.mat,
                          mass=jnp.ones(d), nac0=pot_plain.nac0)
    c_m, k_m = prop.propagate(quad, dt, nt,
                              energy0_es=float(w.sum() / 2))
    np.testing.assert_allclose(c_w, c_m, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(k_w, k_m, rtol=1e-12, atol=1e-14)


@pytest.mark.slow
def test_gdml_window_close(ref_data):
    """Coumarin sGDML: taylor_every=8 must track the per-step taylor mode
    at production-scale steps (identical ensembles)."""
    from semiclassical_jax.io import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularGDMLPotential

    model_path = (ref_data / "GDML"
                  / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")

    model = np.load(model_path, allow_pickle=True)
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    x0, Gamma0, zpe = exc.vibrational_groundstate()

    def run(**kw):
        pot = MolecularGDMLPotential.create(model, exc, **kw)
        prop = HermanKlukPropagator(Gamma0, Gamma0)
        prop.initial_conditions(x0, np.zeros_like(x0), Gamma0, ntraj=16,
                                key=7, potential=pot)
        c, k = prop.propagate(pot, 0.25, 16, energy0_es=zpe)
        return c, k

    c_t, k_t = run(hessian_eval="taylor")
    c_w, k_w = run(hessian_eval="taylor", taylor_every=8)
    assert np.abs(c_w - c_t).max() > 0.0
    np.testing.assert_allclose(c_w, c_t, rtol=0, atol=2e-5)
    np.testing.assert_allclose(k_w, k_t, rtol=0, atol=2e-5)
    # the measured frontier windows: the gap scales ~4x per doubling
    # (2nd order in the window length — measured at 64 production steps:
    # every=8/16/32 -> 1.2e-5/4.9e-5/1.9e-4, all far below the ~1e-3
    # sGDML model error)
    c16, k16 = run(hessian_eval="taylor", taylor_every=16)
    np.testing.assert_allclose(c16, c_t, rtol=0, atol=1e-4)
    np.testing.assert_allclose(k16, k_t, rtol=0, atol=1e-4)


def test_create_rejects_window_without_taylor(ref_data):
    from semiclassical_jax.io import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularGDMLPotential

    model_path = (ref_data / "GDML"
                  / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")
    model = np.load(model_path, allow_pickle=True)
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    with pytest.raises(ValueError, match="taylor_every"):
        MolecularGDMLPotential.create(model, exc, hessian_eval="step",
                                      taylor_every=4)


# --- taylor on separable potentials (DiagHessian + diagonal-monodromy
# state — the AS-model code path) ---


def _morse(hessian_eval="stage", taylor_every=1, d=3):
    from semiclassical_jax.potentials import MorsePotential
    rng = np.random.default_rng(2)
    omega = rng.uniform(0.004, 0.01, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    return MorsePotential.create(omega, np.full(d, 0.02), nac,
                                 hessian_eval=hessian_eval,
                                 taylor_every=taylor_every)


def _run_morse(pot, nt=32, dt=1.0, ntraj=32, key=9):
    d = pot.dimensions()
    Gamma = np.diag(np.asarray(pot.omega))
    prop = HermanKlukPropagator(Gamma, Gamma)
    prop.initial_conditions(np.full(d, 0.25), np.zeros(d), Gamma,
                            ntraj=ntraj, key=key, potential=pot)
    assert prop.state.diag_monodromy  # the separable representation
    cauto, kic = prop.propagate(pot, dt, nt, energy0_es=0.05)
    return prop.state, cauto, kic


def test_morse_taylor_second_order_convergence():
    pot_s = _morse("stage")
    pot_t = _morse("taylor")

    def gap(dt, nt):
        s1, _, _ = _run_morse(pot_s, nt=nt, dt=dt)
        s2, _, _ = _run_morse(pot_t, nt=nt, dt=dt)
        return max(np.abs(np.asarray(s1.q) - np.asarray(s2.q)).max(),
                   np.abs(np.asarray(s1.p) - np.asarray(s2.p)).max())

    g_coarse = gap(4.0, 8)
    g_fine = gap(2.0, 16)
    assert g_coarse > 0.0
    assert g_coarse / g_fine > 3.0


def test_morse_taylor_window_close_and_monodromy_diag():
    """The window path must keep the diagonal-monodromy representation
    (LocalQuadratic returns DiagHessian for separable parents) and track
    the per-step taylor mode at 2nd order in the window length."""
    pot_t = _morse("taylor")
    pot_w = _morse("taylor", taylor_every=4)
    s_t, c_t, k_t = _run_morse(pot_t, nt=16, dt=1.0)
    s_w, c_w, k_w = _run_morse(pot_w, nt=16, dt=1.0)
    assert s_w.diag_monodromy
    assert np.abs(c_w - c_t).max() > 0.0
    np.testing.assert_allclose(c_w, c_t, rtol=0, atol=5e-5)

    def gap(dt, nt):
        s1, _, _ = _run_morse(pot_t, nt=nt, dt=dt)
        s2, _, _ = _run_morse(pot_w, nt=nt, dt=dt)
        return np.abs(np.asarray(s1.q) - np.asarray(s2.q)).max()

    assert gap(2.0, 8) / gap(1.0, 16) > 3.0


def test_morse_taylor_comp32():
    """taylor + comp32 trajectories on the separable path: runs, stays
    finite, and tracks the f64 taylor run at the comp32 accuracy scale."""
    import jax.numpy as jnp

    pot = _morse("taylor")
    d = pot.dimensions()
    Gamma = np.diag(np.asarray(pot.omega))

    def run(**kw):
        pp = (jax.tree.map(lambda x: x.astype(jnp.float32), pot)
              if kw else pot)
        prop = HermanKlukPropagator(Gamma, Gamma, **kw)
        prop.initial_conditions(np.full(d, 0.25), np.zeros(d), Gamma,
                                ntraj=64, key=11, potential=pp)
        return prop.propagate(pp, 1.0, 25, energy0_es=0.05)

    import jax
    c64, k64 = run()
    c32, k32 = run(dtype=jnp.float32, traj_dtype="comp32")
    np.testing.assert_allclose(c32, c64, rtol=0, atol=5e-4)
    assert np.isfinite(k32).all()


def test_wm_taylor_window_runs_and_tracks_stage():
    """The WM scan shares rk4_step and the window branch: taylor and
    taylor_every must run through WaltonManolopoulosPropagator and track
    the stage mode (identical ensembles)."""
    from semiclassical_jax.propagation import WaltonManolopoulosPropagator
    from semiclassical_jax.pytree import replace

    pot = _make_potential(lam=2.0e-2)

    def run(p):
        d = p.dimensions()
        w = np.sqrt(np.diag(np.asarray(p.K)))
        Gamma = np.diag(w)
        prop = WaltonManolopoulosPropagator(Gamma, Gamma, 1e4, 1e4)
        prop.initial_conditions(np.full(d, 0.3), np.zeros(d), Gamma,
                                ntraj=32, key=5, potential=p)
        return prop.propagate(p, 0.5, 12, energy0_es=float(w.sum() / 2))

    c_s, k_s = run(pot)
    c_t, k_t = run(replace(pot, hessian_eval="taylor"))
    c_w, k_w = run(replace(pot, hessian_eval="taylor", taylor_every=4))
    assert np.isfinite(c_t).all() and np.isfinite(c_w).all()
    np.testing.assert_allclose(c_t, c_s, rtol=0, atol=2e-3)
    # the window regime here is deliberately coarse (window = 4 x 0.5 at
    # omega ~ 0.3 -> window phase ~ 0.6 rad); the WM prefactor amplifies
    # the frozen-expansion error more than HK's — production-step
    # accuracy is gated by the GDML twins above, this pins plumbing
    np.testing.assert_allclose(c_w, c_s, rtol=0, atol=2e-2)
    np.testing.assert_allclose(k_w, k_s, rtol=0, atol=2e-2)


@pytest.mark.slow
def test_gdml_wm_taylor_close(ref_data):
    """Coumarin sGDML through the WM propagator: hessian_eval='taylor'
    must track the 4-stage mode on identical ensembles (the WM prefactor
    consumes the monodromy more aggressively than HK's — the production
    WM-GDML recipe is the reference's own gdml example shape)."""
    from semiclassical_jax.io import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularGDMLPotential
    from semiclassical_jax.propagation import WaltonManolopoulosPropagator

    model_path = (ref_data / "GDML"
                  / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")

    model = np.load(model_path, allow_pickle=True)
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    x0, Gamma0, zpe = exc.vibrational_groundstate()

    def run(hessian_eval, taylor_every=1):
        pot = MolecularGDMLPotential.create(model, exc,
                                            hessian_eval=hessian_eval,
                                            taylor_every=taylor_every)
        prop = WaltonManolopoulosPropagator(Gamma0, Gamma0, 1e4, 1e4)
        prop.initial_conditions(x0, np.zeros_like(x0), Gamma0, ntraj=8,
                                key=7, potential=pot)
        c, k = prop.propagate(pot, 0.25, 8, energy0_es=zpe)
        return c, k

    c_stage, k_stage = run("stage")
    c_w, k_w = run("taylor", taylor_every=4)
    assert np.isfinite(c_w).all()
    np.testing.assert_allclose(c_w, c_stage, rtol=0, atol=5e-5)
    np.testing.assert_allclose(k_w, k_stage, rtol=0, atol=5e-5)


def test_window_without_taylor_raises_at_scan():
    """create() validates taylor_every, but direct construction /
    pytree replace() can bypass it — the scan must refuse at trace time
    rather than silently replace stage/step-parity forces with local
    quadratics (same guard philosophy as rk4_step's hessian_eval check)."""
    from semiclassical_jax.pytree import replace

    pot = _make_potential(lam=2.0e-2)
    pot_bad = replace(pot, hessian_eval="step", taylor_every=4)
    with pytest.raises(ValueError, match="taylor_every"):
        _run(pot_bad, nt=4)


def test_window_mono_map_matches_horner(monkeypatch):
    """The precomputed per-window monodromy step map (LocalQuadratic.Tmono,
    ONE stacked K=2d matmul per step) evaluates the SAME degree-4
    truncated exponential as the per-step frozen-H Horner — identical
    windows, identical trajectories, monodromy equal to association-order
    roundoff."""
    from semiclassical_jax.pytree import replace

    pot = replace(_make_potential(lam=2.0e-2), hessian_eval="taylor",
                  taylor_every=4)

    monkeypatch.setenv("SEMI_WINDOW_MONO_MAP", "0")
    s_h, c_h, k_h = _run(pot, nt=16)
    monkeypatch.delenv("SEMI_WINDOW_MONO_MAP")
    s_m, c_m, k_m = _run(pot, nt=16)

    # trajectories never touch the map: bit-identical
    np.testing.assert_array_equal(np.asarray(s_m.q), np.asarray(s_h.q))
    np.testing.assert_array_equal(np.asarray(s_m.p), np.asarray(s_h.p))
    # monodromy/observables: same polynomial, different association
    np.testing.assert_allclose(np.asarray(s_m.Mqq), np.asarray(s_h.Mqq),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(c_m, c_h, rtol=0, atol=1e-10)
    np.testing.assert_allclose(k_m, k_h, rtol=0, atol=1e-10)


def test_window_phase_chunk_dependence_is_bounded_contract(ref_data):
    """CONTRACT: with taylor_every > 1 the window
    phase restarts at every scan segment, so two runs of the same physics
    with different `chunk` are NOT bitwise identical — but their gap is
    bounded by the window approximation error (2nd order in the window
    length), and chunking is bitwise-irrelevant for taylor_every == 1.
    This test pins both halves of the contract (also documented in
    docs/INPUT.md under `taylor_every`)."""
    from semiclassical_jax.io import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularGDMLPotential

    model_path = (ref_data / "GDML"
                  / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    s1 = ref_data / "Gaussian16" / "coumarin_s1.fchk"
    if not model_path.exists() or not s1.exists():
        pytest.skip("coumarin fixtures not available")

    model = np.load(model_path, allow_pickle=True)
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    x0, Gamma0, zpe = exc.vibrational_groundstate()

    def run(every, chunk):
        pot = MolecularGDMLPotential.create(
            model, exc, hessian_eval="taylor")
        from semiclassical_jax.pytree import replace
        pot = replace(pot, taylor_every=every)
        prop = HermanKlukPropagator(Gamma0, Gamma0)
        prop.initial_conditions(x0, np.zeros_like(x0), Gamma0, ntraj=16,
                                key=7, potential=pot)
        c, k = prop.propagate(pot, 0.25, 12, energy0_es=zpe, chunk=chunk)
        return np.asarray(c)

    # taylor_every == 1: chunking is bitwise-irrelevant (no window state)
    c_full = run(1, None)
    c_chunked = run(1, 4)
    np.testing.assert_array_equal(c_full, c_chunked)

    # taylor_every > 1: chunking shifts the window boundaries — results
    # differ beyond roundoff but stay inside the window error scale
    w_full = run(4, None)
    w_chunked = run(4, 6)   # NOT a multiple of the window length
    gap = np.abs(w_full - w_chunked).max()
    assert gap > 1e-14          # the dependence is real (the contract)
    assert gap < 5e-5           # ... and bounded by the window error
