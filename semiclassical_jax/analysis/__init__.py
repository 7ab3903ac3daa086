# coding: utf-8
"""Spectral analysis: lineshape functions and the FFT rate pipeline."""

from semiclassical_jax.analysis.broadening import gaussian, lorentzian, voigtian
from semiclassical_jax.analysis.rates import (fourier_stderr,
                                              rate_from_correlation,
                                              spectrum_from_correlation)

__all__ = ["gaussian", "lorentzian", "voigtian", "rate_from_correlation",
           "spectrum_from_correlation", "fourier_stderr"]
