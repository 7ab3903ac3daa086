# coding: utf-8
"""fchk reader tests on the real coumarin checkpoint files
(reference tests/test_readers.py:21-51)."""

import numpy as np
import pytest

from semiclassical_jax import units
from semiclassical_jax.io import FormattedCheckpointFile


@pytest.fixture(scope="module", params=["coumarin_s0.fchk", "coumarin_s1.fchk"])
def fchk(ref_data, request):
    path = ref_data / "Gaussian16" / request.param
    if not path.exists():
        pytest.skip(f"{path} not available")
    with open(path) as f:
        return FormattedCheckpointFile(f)


def test_frequencies_match_vib_e2(fchk):
    """Frequencies recomputed from the force constants must match the
    checkpoint's own Vib-E2 field; 6 zero modes."""
    nmodes = fchk["Number of Normal Modes"]
    frequencies_fchk = fchk["Vib-E2"][:nmodes]
    masses = fchk.masses()
    pos, energy, grad, hess = fchk.harmonic_approximation()
    isqM = np.diag(1.0 / np.sqrt(masses))
    mwH = isqM @ hess @ isqM
    w2, _ = np.linalg.eigh(mwH)
    assert np.allclose(w2[:6], np.zeros(6))
    frequencies = np.sqrt(w2[6:]) * units.hartree_to_wavenumbers
    assert np.allclose(frequencies, frequencies_fchk)


def test_nonadiabatic_coupling(ref_data):
    with open(ref_data / "Gaussian16" / "coumarin_s1.fchk") as f:
        fchk = FormattedCheckpointFile(f)
    nac = fchk.nonadiabatic_coupling()
    assert nac.shape == (3 * fchk["Number of atoms"],)


def test_vibrational_groundstate(fchk):
    """Gamma_0 is PSD with 3N-6 positive modes; ZPE equals half the sum of
    the vibrational frequencies."""
    x0, Gamma0, en_zpt = fchk.vibrational_groundstate()
    d = x0.shape[0]
    assert Gamma0.shape == (d, d)
    assert np.allclose(Gamma0, Gamma0.T)
    e = np.linalg.eigvalsh(Gamma0)
    assert (e > -1e-10).all()
    # exactly 6 zero modes for the non-linear coumarin molecule
    assert int(np.sum(np.abs(e) < 1e-8)) == 6

    nmodes = fchk["Number of Normal Modes"]
    freqs = fchk["Vib-E2"][:nmodes] / units.hartree_to_wavenumbers
    assert abs(en_zpt - 0.5 * np.sum(freqs)) < 1e-6
