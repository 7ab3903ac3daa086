# coding: utf-8
"""Trajectory-level per-step parity against the torch reference.

Fixed, hand-picked initial conditions are injected into both codes (the
Monte-Carlo layer is bypassed), then both propagate the same 5-mode
anharmonic Morse model step by step. Positions, momenta, action, monodromy
blocks, the sign-tracked HK prefactor C(t) and the per-trajectory
autocorrelation contributions must agree to f64 integration accuracy
(1e-9). This is the SURVEY's "parity debugging against torch per-step
dumps" gate — it would catch any transcription error in the equations of
motion, the RK4 stepping, the prefactor determinant, or the branch-cut
tracking (reference propagators.py:296-398, 951-1066).

The reference implementation is *run* (not copied) from the read-only
checkout with torch-2.x compat shims and a numpy ase stub; skipped when
unavailable.
"""

import sys

import numpy as np
import pytest

import jax.numpy as jnp

from semiclassical_jax.potentials import MorsePotential
from semiclassical_jax.propagation import HermanKlukPropagator
from semiclassical_jax.propagation.hk import hk_autocorr_qp, hk_prefactor_det
from semiclassical_jax.propagation.state import TrajState

REFERENCE_PATH = "/root/reference"

NSTEPS = 12
DT = 2.0  # a.u.


def _model():
    rng = np.random.default_rng(3)
    d = 5
    omega = rng.uniform(500.0, 2000.0, size=d) / 219474.63
    chi = np.full(d, 0.02)
    nac = rng.uniform(-1.0, 1.0, size=d)
    S = rng.uniform(0.05, 0.3, size=d)
    dQ = np.sqrt(2 * S / omega)
    # 4 deterministic trajectories around the displaced center
    n = 4
    qi = dQ[None, :] + 0.1 * rng.standard_normal((n, d)) / np.sqrt(omega)
    pi = 0.1 * rng.standard_normal((n, d)) * np.sqrt(omega)
    return d, omega, chi, nac, dQ, qi, pi


@pytest.fixture(scope="module")
def torch_reference():
    torch = pytest.importorskip("torch")
    torch.set_default_dtype(torch.float64)

    # torch 2.x compat shims for the torch-1.8-era reference
    def _symeig(A, eigenvectors=True):
        return torch.linalg.eigh(A)

    torch.symeig = _symeig

    sys.path.insert(0, REFERENCE_PATH)
    try:
        from semiclassical.potentials import MorsePotential as RefMorse
        from semiclassical.propagators import (
            HermanKlukPropagator as RefHK,
        )
    except Exception as exc:  # pragma: no cover
        pytest.skip(f"torch reference not importable: {exc}")
    finally:
        sys.path.pop(0)
    return torch, RefMorse, RefHK


def test_per_step_parity_hk(torch_reference):
    torch, RefMorse, RefHK = torch_reference
    d, omega, chi, nac, dQ, qi, pi = _model()
    n = qi.shape[0]
    Gamma = np.diag(omega)

    # --- reference: inject the fixed initial conditions -------------------
    ref_pot = RefMorse(torch.from_numpy(omega.copy()),
                       torch.from_numpy(chi.copy()),
                       torch.from_numpy(nac.copy()))
    ref = RefHK(torch.from_numpy(Gamma), torch.from_numpy(Gamma),
                device="cpu")
    torch.manual_seed(0)
    ref.initial_conditions(torch.from_numpy(dQ.copy()),
                           torch.zeros(d, dtype=torch.float64),
                           torch.from_numpy(Gamma), ntraj=n)
    zi = torch.from_numpy(np.concatenate([qi.T, pi.T], axis=0))
    ref.zi = zi
    ref.probi = torch.ones(n, dtype=torch.float64)
    ref.y[:2 * d, :] = zi           # positions/momenta (monodromy stays I)
    ref.y[2 * d:, :] = 0.0
    for i in range(d):              # Mqq = Mpp = identity
        ref.y[2 * d + i * d + i, :] = 1.0
        ref.y[2 * d + 3 * d * d + i * d + i, :] = 1.0
    ref.sign_trackers = {}
    ref._prefactor()                # re-init prefactor/tracker at the new y

    # --- ours: same initial conditions ------------------------------------
    pot = MorsePotential.create(omega, chi, nac)
    prop = HermanKlukPropagator(Gamma, Gamma)
    prop.initial_conditions(dQ, np.zeros(d), Gamma, ntraj=n, key=0,
                            potential=pot)
    # inject the fixed points: new state + rebuilt batch constants with
    # uniform density P = 1 (matching ref.probi = 1 above)
    from semiclassical_jax.propagation.hk import hk_batch_constants

    prop.state = TrajState.initial(jnp.asarray(qi), jnp.asarray(pi))
    prop._bc = hk_batch_constants(prop.params, prop.state.q, prop.state.p,
                                  jnp.zeros(n, dtype=jnp.float64),
                                  potential=pot)
    prop._bc_has_nacq = True
    prop.trackers = prop._make_trackers(prop.state)

    for step in range(NSTEPS):
        # positions / momenta / action
        q_ref = ref.y[:d, :].numpy().T
        p_ref = ref.y[d:2 * d, :].numpy().T
        s_ref = ref.y[-1, :].numpy()
        np.testing.assert_allclose(np.asarray(prop.state.q), q_ref,
                                   rtol=0, atol=1e-9, err_msg=f"q step {step}")
        np.testing.assert_allclose(np.asarray(prop.state.p), p_ref,
                                   rtol=0, atol=1e-9, err_msg=f"p step {step}")
        np.testing.assert_allclose(np.asarray(prop.state.S), s_ref,
                                   rtol=0, atol=1e-9, err_msg=f"S step {step}")

        # monodromy blocks (reference packs (d, d, n))
        Mqq_ref = ref.y[2 * d:2 * d + d * d, :].numpy().reshape(d, d, n)
        np.testing.assert_allclose(
            np.asarray(prop.state.Mqq), np.moveaxis(Mqq_ref, 2, 0),
            rtol=0, atol=1e-8, err_msg=f"Mqq step {step}")

        # sign-tracked prefactor
        c_ref = ref.semiclassical_prefactor().numpy()
        c2 = hk_prefactor_det(prop.params, prop.state)
        tracker = prop.trackers["prefactorC"].update(c2)
        prop.trackers["prefactorC"] = tracker
        c_mine = np.asarray(jnp.sqrt(tracker.previous) * tracker.signs)
        np.testing.assert_allclose(c_mine, c_ref, rtol=0, atol=1e-8,
                                   err_msg=f"C step {step}")

        # per-trajectory autocorrelation contribution: the reference's
        # autocorrelation_qp is unweighted; ours folds in the normalised
        # MC weight, so compare after multiplying the reference by it
        qp_ref = ref.autocorrelation_qp().numpy()
        w = np.asarray(prop._bc.weight)
        qp_mine = np.asarray(hk_autocorr_qp(prop.params, prop._bc,
                                            prop.state, jnp.asarray(c_mine)))
        np.testing.assert_allclose(qp_mine, qp_ref * w, rtol=1e-8,
                                   atol=1e-12, err_msg=f"cauto_qp step {step}")

        # advance both
        ref.step(ref_pot, DT)
        prop.step(pot, DT)


def test_per_step_parity_wm(torch_reference):
    """Same injected-IC per-step comparison for the WM propagator —
    SURVEY's highest transcription-risk component (eqns. 39-100,
    reference propagators.py:1077-1719)."""
    torch, RefMorse, RefHK = torch_reference
    sys.path.insert(0, REFERENCE_PATH)
    try:
        from semiclassical.propagators import (
            WaltonManolopoulosPropagator as RefWM,
        )
    finally:
        sys.path.pop(0)

    from semiclassical_jax.propagation import WaltonManolopoulosPropagator
    from semiclassical_jax.propagation.wm import (
        wm_autocorr_qp,
        wm_batch_constants,
        wm_derived,
    )

    d, omega, chi, nac, dQ, qi, pi = _model()
    n = qi.shape[0]
    Gamma = np.diag(omega)
    alpha = beta = 500.0

    ref_pot = RefMorse(torch.from_numpy(omega.copy()),
                       torch.from_numpy(chi.copy()),
                       torch.from_numpy(nac.copy()))
    ref = RefWM(torch.from_numpy(Gamma), torch.from_numpy(Gamma),
                alpha, beta, device="cpu")
    torch.manual_seed(0)
    ref.initial_conditions(torch.from_numpy(dQ.copy()),
                           torch.zeros(d, dtype=torch.float64),
                           torch.from_numpy(Gamma), ntraj=n)
    zi = torch.from_numpy(np.concatenate([qi.T, pi.T], axis=0))
    ref.zi = zi
    ref.probi = torch.ones(n, dtype=torch.float64)
    ref.y[:2 * d, :] = zi
    ref.y[2 * d:, :] = 0.0
    for i in range(d):
        ref.y[2 * d + i * d + i, :] = 1.0
        ref.y[2 * d + 3 * d * d + i * d + i, :] = 1.0
    ref.sign_trackers = {}
    ref._prefactor()

    pot = MorsePotential.create(omega, chi, nac)
    prop = WaltonManolopoulosPropagator(Gamma, Gamma, alpha, beta)
    prop.initial_conditions(dQ, np.zeros(d), Gamma, ntraj=n, key=0,
                            potential=pot)
    prop.state = TrajState.initial(jnp.asarray(qi), jnp.asarray(pi))
    prop._bc = wm_batch_constants(prop.params, prop.state.q, prop.state.p,
                                  jnp.zeros(n, dtype=jnp.float64),
                                  potential=pot)
    prop._bc_has_nacq = True
    prop.trackers = prop._make_trackers(prop.state)

    for step in range(NSTEPS):
        derived = wm_derived(prop.params, prop._bc, prop.state)
        prop.trackers["detA"] = prop.trackers["detA"].update(derived.detA)
        prop.trackers["detM"] = prop.trackers["detM"].update(derived.detM)

        np.testing.assert_allclose(
            np.asarray(derived.detA), ref.detA.numpy(), rtol=1e-8,
            err_msg=f"detA step {step}")
        # ours is the scaled det(M'/m_scale); unscale for the comparison
        np.testing.assert_allclose(
            np.asarray(derived.detM) * np.exp(prop.params.m_log_det),
            ref.detM.numpy(), rtol=1e-8,
            err_msg=f"detM step {step}")
        np.testing.assert_allclose(
            np.asarray(derived.gamma), ref.gamma.numpy(), rtol=0, atol=1e-9,
            err_msg=f"gamma step {step}")

        qp_ref = ref.autocorrelation_qp().numpy()
        c2 = hk_prefactor_det(prop.params.hk, prop.state)
        tr = prop.trackers["prefactorC"].update(c2)
        prop.trackers["prefactorC"] = tr
        c_mine = jnp.sqrt(tr.previous) * tr.signs
        qp_mine = np.asarray(wm_autocorr_qp(
            prop.params, prop._bc, prop.state, derived, c_mine,
            prop.trackers["detA"].signs, prop.trackers["detM"].signs))
        w = np.asarray(prop._bc.base.weight)
        np.testing.assert_allclose(qp_mine, qp_ref * w, rtol=1e-7,
                                   atol=1e-12, err_msg=f"wm qp step {step}")

        ref.step(ref_pot, DT)
        prop.step(pot, DT)
