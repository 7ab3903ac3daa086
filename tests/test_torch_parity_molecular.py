# coding: utf-8
"""Per-step torch parity on the RANK-DEFICIENT molecular path.

The Morse parity tests (test_torch_parity.py) run at full-rank Gamma; the
zero-mode U-projection machinery (SURVEY hard part #2 — pseudo-dets,
null-space projections in sampling/prefactors/overlaps, reference
propagators.py:496-498,994) only activates for singular width matrices.
This test drives both codes on the methylium harmonic potential (12
cartesian coordinates, 6 vibrational modes, 6 zero modes) from identical
injected initial conditions and compares every per-step quantity plus the
fully weighted observables.

The reference is *run* (not copied) from the read-only checkout with
torch-2.x compat shims and a numpy ase stub; skipped when unavailable.
"""

import sys
import types

import numpy as np
import pytest

import jax.numpy as jnp


from semiclassical_jax.io.fchk import FormattedCheckpointFile
from semiclassical_jax.potentials import MolecularHarmonicPotential
from semiclassical_jax.propagation import HermanKlukPropagator
from semiclassical_jax.propagation.hk import hk_autocorr_qp, hk_prefactor_det
from semiclassical_jax.propagation.state import TrajState

REFERENCE_PATH = "/root/reference"
NSTEPS = 8
DT = 4.0  # a.u.


def _install_ase_stub():
    if "ase" in sys.modules:
        return
    ase = types.ModuleType("ase")
    ase.__version__ = "stub"
    ase_atoms = types.ModuleType("ase.atoms")

    masses = {1: 1.008, 6: 12.011, 7: 14.007, 8: 15.999}

    class Atoms:
        def __init__(self, numbers=None):
            self.numbers = np.asarray(numbers)
            self.positions = np.zeros((len(self.numbers), 3))
            self.masses = np.array(
                [masses.get(int(z), 2.0 * int(z)) for z in self.numbers])

        def set_positions(self, r):
            self.positions = np.asarray(r, dtype=float)

        def get_positions(self):
            return self.positions

        def set_masses(self, m):
            self.masses = np.asarray(m, dtype=float)

        def get_center_of_mass(self):
            return self.masses @ self.positions / self.masses.sum()

        def translate(self, d):
            self.positions = self.positions + np.asarray(d)

        def get_moments_of_inertia(self, vectors=False):
            r, m = self.positions, self.masses
            inertia = np.zeros((3, 3))
            for mi, ri in zip(m, r):
                inertia += mi * (ri @ ri * np.eye(3) - np.outer(ri, ri))
            evals, evecs = np.linalg.eigh(inertia)
            return (evals, evecs.T) if vectors else evals

    ase_atoms.Atoms = Atoms
    ase.atoms = ase_atoms
    sys.modules["ase"] = ase
    sys.modules["ase.atoms"] = ase_atoms


@pytest.fixture(scope="module")
def torch_reference_molecular(ref_data):
    torch = pytest.importorskip("torch")
    torch.set_default_dtype(torch.float64)
    torch.symeig = lambda A, eigenvectors=True: torch.linalg.eigh(A)

    _install_ase_stub()
    sys.path.insert(0, REFERENCE_PATH)
    try:
        from semiclassical import readers as ref_readers
        from semiclassical.potentials import (
            MolecularHarmonicPotential as RefMolecular,
        )
        from semiclassical.propagators import HermanKlukPropagator as RefHK
    except Exception as exc:  # pragma: no cover
        pytest.skip(f"torch reference not importable: {exc}")
    finally:
        sys.path.pop(0)

    s0 = ref_data / "examples" / "methylium_AH" / "opt_freq_s0.fchk"
    s1 = ref_data / "examples" / "methylium_AH" / "opt_freq_s1.fchk"
    if not s0.exists():
        pytest.skip("methylium fixtures not available")
    return torch, ref_readers, RefMolecular, RefHK, s0, s1


def test_per_step_parity_molecular(torch_reference_molecular):
    torch, ref_readers, RefMolecular, RefHK, s0, s1 = (
        torch_reference_molecular)

    # --- reference potential + rank-deficient Gamma_0 ---------------------
    with open(s0) as f:
        rf_ground = ref_readers.FormattedCheckpointFile(f)
    with open(s1) as f:
        rf_exc = ref_readers.FormattedCheckpointFile(f)
    ref_pot = RefMolecular(rf_ground, rf_exc)
    x0_ref, G0_ref, zpe_ref = rf_exc.vibrational_groundstate()

    # --- our potential and wavepacket from our own reader -----------------
    with open(s0) as f:
        ground = FormattedCheckpointFile(f)
    with open(s1) as f:
        exc = FormattedCheckpointFile(f)
    pot = MolecularHarmonicPotential.from_fchk(ground, exc)
    x0, Gamma_0, zpe = exc.vibrational_groundstate()

    np.testing.assert_allclose(x0, x0_ref, atol=1e-10)
    np.testing.assert_allclose(Gamma_0, G0_ref, atol=1e-10)
    assert abs(zpe - zpe_ref) < 1e-10

    d = x0.shape[0]
    rank = np.linalg.matrix_rank(Gamma_0, tol=1e-8)
    assert rank < d, "test must exercise the rank-deficient path"

    # --- identical injected initial conditions ----------------------------
    rng = np.random.default_rng(7)
    n = 4
    # displacements within the vibrational subspace (range of Gamma_0)
    evals, evecs = np.linalg.eigh(Gamma_0)
    U = evecs[:, np.abs(evals) > 1e-8]
    qi = x0[None, :] + 0.3 * (rng.standard_normal((n, rank)) @ U.T)
    pi = 0.3 * (rng.standard_normal((n, rank)) @ U.T)

    ref = RefHK(torch.from_numpy(Gamma_0), torch.from_numpy(Gamma_0),
                device="cpu")
    torch.manual_seed(0)
    ref.initial_conditions(torch.from_numpy(x0.copy()),
                           torch.zeros(d, dtype=torch.float64),
                           torch.from_numpy(Gamma_0), ntraj=n)
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

    from semiclassical_jax.propagation.hk import hk_batch_constants

    prop = HermanKlukPropagator(Gamma_0, Gamma_0)
    prop.initial_conditions(x0, np.zeros(d), Gamma_0, ntraj=n, key=0,
                            potential=pot)
    prop.state = TrajState.initial(jnp.asarray(qi), jnp.asarray(pi))
    prop._bc = hk_batch_constants(prop.params, prop.state.q, prop.state.p,
                                  jnp.zeros(n, dtype=jnp.float64),
                                  potential=pot)
    prop._bc_has_nacq = True
    prop.trackers = prop._make_trackers(prop.state)

    for step in range(NSTEPS):
        q_ref = ref.y[:d, :].numpy().T
        p_ref = ref.y[d:2 * d, :].numpy().T
        s_ref = ref.y[-1, :].numpy()
        np.testing.assert_allclose(np.asarray(prop.state.q), q_ref,
                                   rtol=0, atol=1e-9, err_msg=f"q step {step}")
        np.testing.assert_allclose(np.asarray(prop.state.p), p_ref,
                                   rtol=0, atol=1e-9, err_msg=f"p step {step}")
        np.testing.assert_allclose(np.asarray(prop.state.S), s_ref,
                                   rtol=0, atol=1e-9, err_msg=f"S step {step}")

        # sign-tracked prefactor through the U-projection
        c_ref = ref.semiclassical_prefactor().numpy()
        c2 = hk_prefactor_det(prop.params, prop.state)
        tracker = prop.trackers["prefactorC"].update(c2)
        prop.trackers["prefactorC"] = tracker
        c_mine = np.asarray(jnp.sqrt(tracker.previous) * tracker.signs)
        np.testing.assert_allclose(c_mine, c_ref, rtol=0, atol=1e-8,
                                   err_msg=f"C step {step}")

        # per-trajectory autocorrelation contributions (pseudo-det overlaps)
        qp_ref = ref.autocorrelation_qp().numpy()
        w = np.asarray(prop._bc.weight)
        qp_mine = np.asarray(hk_autocorr_qp(prop.params, prop._bc,
                                            prop.state, jnp.asarray(c_mine)))
        np.testing.assert_allclose(qp_mine, qp_ref * w, rtol=1e-8,
                                   atol=1e-12, err_msg=f"cauto_qp step {step}")

        # fully weighted observables incl. the (2 pi hbar)^dim-vs-rank
        # normalisation conventions (SURVEY hard part #6)
        cauto_ref = complex(ref.autocorrelation(0.0))
        kic_ref = complex(ref.ic_correlation(ref_pot, 0.0))
        cauto, kic = prop.autocorrelation(0.0), prop.ic_correlation(pot, 0.0)
        assert abs(complex(cauto) - cauto_ref) < 1e-8 * max(abs(cauto_ref), 1.0), step
        assert abs(complex(kic) - kic_ref) < 1e-8 * max(abs(kic_ref), 1e-12), step

        ref.step(ref_pot, DT)
        prop.step(pot, DT)
