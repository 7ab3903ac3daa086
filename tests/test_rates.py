# coding: utf-8
"""FFT rate pipeline and lineshape tests
(reference tests/test_rates.py:16-46 plus the voigtian fix)."""

import numpy as np

from semiclassical_jax import units
from semiclassical_jax.analysis import (
    gaussian,
    lorentzian,
    rate_from_correlation,
    voigtian,
)


def _lineshape_normalization(lineshape):
    """Transform of a constant correlation = the lineshape's frequency-domain
    distribution; its integral over energies must be 1."""
    times = np.linspace(0.0, 10.0, 500) / units.autime_to_fs
    correlation = np.ones_like(times)
    w, G = rate_from_correlation(times, correlation, lineshape)
    G = G / (1.0e15 / units.autime_to_fs)   # back to atomic units
    dw = w[1] - w[0]
    return float(np.sum(G.real * dw))


def test_gaussian_normalization():
    hwhmG_ev = 0.5
    sigma = hwhmG_ev / np.sqrt(2.0 * np.log(2.0)) / units.hartree_to_ev
    assert abs(_lineshape_normalization(gaussian(sigma)) - 1.0) < 1e-7


def test_lorentzian_normalization():
    gamma = 0.3 / units.hartree_to_ev
    assert abs(_lineshape_normalization(lorentzian(gamma)) - 1.0) < 1e-3


def test_voigtian_normalization():
    """The reference's voigtian factory is broken (composes factories,
    broadening.py:144); ours must evaluate and stay normalised."""
    sigma = 0.4 / np.sqrt(2.0 * np.log(2.0)) / units.hartree_to_ev
    gamma = 0.05 / units.hartree_to_ev
    assert abs(_lineshape_normalization(voigtian(sigma, gamma)) - 1.0) < 1e-3


def test_voigtian_limits():
    """Voigt reduces to Gaussian (gamma->0) and Lorentzian (sigma->0)."""
    t = np.linspace(-50.0, 50.0, 101)
    sigma, gamma = 0.1, 0.02
    assert np.allclose(voigtian(sigma, 0.0)(t), gaussian(sigma)(t))
    assert np.allclose(voigtian(0.0, gamma)(t), lorentzian(gamma)(t))


def test_rate_peak_position():
    """A pure phase e^{-i E0 t} correlation peaks at energy E0."""
    E0 = 0.1
    times = np.linspace(0.0, 2000.0, 2000)
    corr = np.exp(-1j * E0 * times)
    sigma = 0.002
    w, rate = rate_from_correlation(times, corr, gaussian(sigma))
    peak = w[np.argmax(rate.real)]
    assert abs(peak - E0) < 0.002
