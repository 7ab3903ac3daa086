# coding: utf-8
"""Rate constants by Fourier transform of correlation functions.

Behavioural parity with reference rates.py:20-82. This stage is host-side
numpy on purpose: it runs once per job on a ~10^3-point array — there is
nothing for an accelerator to speed up, and keeping it framework-free lets `semi
rates` run without any accelerator attached.
"""

__all__ = ["rate_from_correlation", "spectrum_from_correlation",
           "fourier_stderr"]

import numpy as np
from numpy import fft

from semiclassical_jax import units


def _fourier_transform(times, correlation, lineshape):
    """Windowed Fourier integral I(E) = \\int dt e^{i E t} f~(t) c(t) of a
    correlation function sampled on [0, t_max], extended Hermitianly to
    negative times. Shared core of the rate and spectrum pipelines.

    Returns (energies, integral) with energies fftshifted to ascending
    order, in Hartree; the integral is in atomic units of 1/energy times
    the correlation's units.
    """
    times = np.asarray(times)
    correlation = np.asarray(correlation)
    assert times.min() == 0.0, "time grid `times` should start at 0.0"
    assert times.shape == correlation.shape, (
        "arrays `times` and `correlation` should have the same length"
    )
    nt = times.shape[0]
    t_max = times.max()
    n_sym = 2 * nt - 1

    # Hermitian extension onto [-t_max, t_max]: only t >= 0 was propagated;
    # c(-t) = c(t)^* because the transform I(E) is real.
    t_sym = np.linspace(-t_max, t_max, n_sym)
    corr_sym = np.concatenate([correlation[:0:-1].conj(), correlation])

    # The integration window is the lineshape times a cos^2 (Gibbs) taper
    # that takes the integrand smoothly to zero at +-t_max, suppressing the
    # ringing of the hard cutoff. The taper also means a too-short t_max
    # yields results set by the window, not the physics — t_max must be
    # converged until the transformed curve stops moving.
    window = lineshape(t_sym) * np.cos(0.5 * np.pi * t_sym / t_max) ** 2

    # ifft computes the mean over the grid (1/N included); scaling by the
    # periodic window length n_sym * dt turns that mean into the Riemann
    # sum dt * sum_k x_k, i.e. the Fourier integral. The matching DFT bin
    # energies use the *actual* sample spacing dt = 2 t_max / (n_sym - 1).
    # The reference labels both with 2 t_max / n_sym (rates.py:57,77) —
    # a relative bias of 1/(n_sym - 1) (~0.1% at nt=500) on every energy
    # and amplitude; this implementation uses the exact grid, a deliberate
    # sub-tolerance deviation from bit-parity (PARITY.md).
    dt = times[1] - times[0]
    integral = n_sym * dt * fft.ifft(fft.ifftshift(window * corr_sym))

    energies = 2.0 * np.pi * fft.fftfreq(n_sym, d=dt)
    return fft.fftshift(energies), fft.fftshift(integral)


def fourier_stderr(times, stderr, lineshape):
    """Monte-Carlo standard error of the windowed Fourier integral computed
    by `_fourier_transform`, propagated from the per-step standard errors
    of the correlation function (the `error_bars` task keyword).

    The transform is linear in c(t), so the propagation is exact given the
    error model: per-step errors are taken as independent across steps and
    isotropic in the complex plane (Var[Re] = Var[Im] = sigma_t^2 / 2,
    where sigma_t is the stored total complex stderr). The Hermitian
    extension c(-t) = c(t)^* reuses each t > 0 sample, so its contribution
    to Re I(E) is 2 w_t Re(c_t e^{iEt}) — fully correlated, not a second
    independent draw. Under isotropy the resulting variance

        Var[Re I(E)] = dt^2 (w_0^2 sigma_0^2 / 2
                             + 2 sum_{t>0} w_t^2 sigma_t^2)

    is independent of E: one scalar describes the band for every energy.
    The independence across steps is an approximation (all steps share the
    same trajectory ensemble); the band is a convergence scale indicator,
    like the per-step stderr it derives from.

    Parameters
    ----------
    times : real ndarray (nt,)
        equidistant time grid covering [0, t_max]
    stderr : real ndarray (nt,)
        per-step total complex standard error of the correlation
    lineshape : callable
        the same time-domain lineshape passed to the transform

    Returns
    -------
    sigma : float
        standard error of Re I(E), constant over the energy grid (same
        units as the transform output)
    """
    times = np.asarray(times)
    stderr = np.asarray(stderr)
    assert times.shape == stderr.shape
    # same grid contract as _fourier_transform: equidistant, starting at 0
    # (the variance bookkeeping below mirrors its symmetric extension, and
    # assumes the lineshape is even — true for all built-in lineshapes)
    dt = times[1] - times[0]
    # tolerate float fuzz on the origin (a resumed/concatenated grid may
    # carry accumulated error)
    if not abs(times[0]) < 1e-9 * max(abs(dt), 1e-300):
        raise ValueError(
            f"time grid must start at t=0 (got times[0]={times[0]!r}); "
            "fourier_stderr's symmetric-extension bookkeeping assumes the "
            "grid of _fourier_transform")
    t_max = times.max()
    window = lineshape(times) * np.cos(0.5 * np.pi * times / t_max) ** 2
    w2s2 = (window * stderr) ** 2
    var = dt * dt * (0.5 * w2s2[0] + 2.0 * w2s2[1:].sum())
    return float(np.sqrt(var))


def rate_from_correlation(times, correlation, lineshape):
    """Rate constant k(E) as the Fourier transform of the correlation k~(t).

    The environment is included by damping k~(t) with the time-domain
    lineshape f~(t):

        k(E) = 1/(2 pi hbar) \\int dt  e^{i E t / hbar} f~(t) k~(t)

    Parameters
    ----------
    times : real ndarray (nt,)
        equidistant time grid covering [0, t_max]
    correlation : complex ndarray (nt,)
        correlation function k~(t) on the time grid
    lineshape : callable
        time-domain lineshape f~(t), called as ``lineshape(times)``

    Returns
    -------
    energies : real ndarray (2 nt - 1,)
        energy gap E (Hartree)
    rate : complex ndarray (2 nt - 1,)
        rate constant k(E) (s^-1)
    """
    energies, rate = _fourier_transform(times, correlation, lineshape)
    rate = rate * 1.0e15 / units.autime_to_fs   # a.u.(time)^-1 -> s^-1
    return energies, rate


def spectrum_from_correlation(times, correlation, lineshape):
    """Spectral density S(E) as the Fourier transform of the wavepacket
    autocorrelation C(t) = <phi(0)|phi(t)> (the Heller time-dependent
    picture of electronic spectroscopy):

        S(E) = \\int dt  e^{i E t / hbar} f~(t) C(t)

    where f~(t) is a time-domain lineshape in this package's convention
    (g(0) = 1/(2 pi), i.e. the Fourier factor rides in the lineshape so
    that the broadened delta-function transforms to a unit-area energy
    distribution — broadening.py). With the framework's stored phase convention
    C(t) = e^{i E0 t} <phi|e^{-iHt}|phi> = sum_n |<phi|n>|^2 e^{-i(E_n-E0)t},
    the peaks of S(E) sit at the transition energies E_n - E0 of the
    propagated surface relative to the wavepacket's reference energy E0
    (the zero-point energy of the initial surface), with Franck-Condon
    areas |<phi|n>|^2. For a normalized wavepacket, S integrates to
    f~(0) C(0) ~= 1, so S is the Franck-Condon-weighted density of states
    — multiply by the squared transition dipole and the usual omega
    prefactor for an absorption cross-section.

    The reference implementation transforms only the IC correlation
    (reference rates.py:20-82); the autocorrelation it stores in every
    `.npz` is never spectrally resolved. This is the missing half of the
    analysis: the same pipeline applied to C(t).

    Parameters
    ----------
    times : real ndarray (nt,)
        equidistant time grid covering [0, t_max]
    correlation : complex ndarray (nt,)
        autocorrelation C(t) on the time grid
    lineshape : callable
        time-domain lineshape f~(t), called as ``lineshape(times)``

    Returns
    -------
    energies : real ndarray (2 nt - 1,)
        energy E (Hartree)
    spectrum : complex ndarray (2 nt - 1,)
        spectral density S(E) (1/Hartree); real up to FFT noise
    """
    # the time-domain lineshapes already carry the 1/(2 pi) of the Fourier
    # convention (broadening.py: g(0) = 1/(2 pi), normalized so that their
    # energy-domain transform integrates to 1) — the windowed integral IS
    # the spectral density, integrating to f~(0)-normalized C(0) = 1
    return _fourier_transform(times, correlation, lineshape)
