# coding: utf-8
"""Spectrum pipeline: S(E) = FT of the wavepacket autocorrelation C(t).

Oracle: the displaced harmonic oscillator. With Huang-Rhys factor S_hr the
exact autocorrelation in the framework's stored phase convention
(C(t) = e^{i ZPE t} <phi|e^{-iHt}|phi>) is

    C(t) = exp(-S_hr (1 - e^{-i w t}))

whose spectrum is the Poisson Franck-Condon progression: peaks at E = n w
with areas e^{-S_hr} S_hr^n / n!. This is closed-form textbook physics —
the test builds C(t) analytically (no propagation), transforms it, and
gates peak positions, peak areas, and the total integral.
"""

import json
import os

import numpy as np
import pytest

from semiclassical_jax.analysis import gaussian, spectrum_from_correlation

OMEGA = 0.01        # Hartree
S_HR = 1.3          # Huang-Rhys factor


def _analytic_autocorrelation(times):
    return np.exp(-S_HR * (1.0 - np.exp(-1j * OMEGA * times)))


def _time_grid():
    # long enough that the Gaussian lineshape (not the cos^2 taper) sets
    # the peak widths, dense enough to resolve the progression
    nt = 4096
    t_max = 40.0 * 2.0 * np.pi / OMEGA
    return np.linspace(0.0, t_max, nt)


def test_poisson_progression():
    times = _time_grid()
    corr = _analytic_autocorrelation(times)
    sigma = OMEGA / 40.0
    energies, spectrum = spectrum_from_correlation(
        times, corr, gaussian(sigma))
    spectrum = spectrum.real

    # total integral = f~(0) C(0) = 1
    total = np.trapezoid(spectrum, energies)
    assert abs(total - 1.0) < 1e-3, total

    # peak-by-peak: integrate S(E) over a window of +-omega/2 around n w
    # and compare to the Poisson weight e^-S S^n / n!
    import math
    for n in range(6):
        e_n = n * OMEGA
        win = (energies > e_n - 0.5 * OMEGA) & (energies <= e_n + 0.5 * OMEGA)
        area = np.trapezoid(spectrum[win], energies[win])
        weight = math.exp(-S_HR) * S_HR ** n / math.factorial(n)
        assert abs(area - weight) < 0.02 * max(weight, 0.01), (n, area, weight)

    # the peak positions themselves: local maxima within each window sit on
    # the progression to within the grid resolution
    de = energies[1] - energies[0]
    for n in range(4):
        e_n = n * OMEGA
        win = (energies > e_n - 0.5 * OMEGA) & (energies <= e_n + 0.5 * OMEGA)
        e_max = energies[win][np.argmax(spectrum[win])]
        assert abs(e_max - e_n) < 2 * de, (n, e_max, e_n)


def test_spectrum_is_real_up_to_fft_noise():
    times = _time_grid()
    corr = _analytic_autocorrelation(times)
    energies, spectrum = spectrum_from_correlation(
        times, corr, gaussian(OMEGA / 40.0))
    assert np.abs(spectrum.imag).max() < 1e-10 * np.abs(spectrum.real).max()


@pytest.fixture()
def synthetic_npz(tmp_path):
    """A minimal correlations.npz as `semi dynamics` would write it."""
    times = _time_grid()
    np.savez(
        tmp_path / "correlations.npz",
        propagator="HK",
        times=times,
        autocorrelation=_analytic_autocorrelation(times),
        ic_correlation=np.zeros_like(times, dtype=complex),
        adiabatic_gap=np.nan,
        zero_point_energy=0.5 * OMEGA,
        trajectories=1000,
    )
    return tmp_path


def test_cli_spectrum_task(synthetic_npz, monkeypatch, capsys):
    from semiclassical_jax import cli, units

    monkeypatch.chdir(synthetic_npz)
    config = {"semi": [{
        "task": "spectrum",
        "broadening": "gaussian",
        "hwhmG_ev": OMEGA / 40.0 * np.sqrt(2 * np.log(2.0))
                    * units.hartree_to_ev,
    }]}
    with open("input.json", "w") as f:
        json.dump(config, f)

    assert cli.main(["spectrum", "input.json"]) in (None, 0)

    data = dict(np.load("correlations.npz"))
    assert "spectrum" in data and "spectrum_energies" in data
    total = np.trapezoid(data["spectrum"], data["spectrum_energies"])
    assert abs(total - 1.0) < 1e-3

    # `semi export` writes spectrum.dat; `semi show` prints the summary
    assert cli.main(["export", "correlations.npz"]) in (None, 0)
    assert os.path.exists("spectrum.dat")
    table = np.loadtxt("spectrum.dat")
    assert table.shape[1] == 2 and np.isfinite(table).all()

    assert cli.main(["show", "correlations.npz"]) in (None, 0)
    out = capsys.readouterr().out
    assert "spectrum integral" in out


def test_fourier_stderr_matches_empirical_spread():
    """fourier_stderr must predict the empirical realization-to-realization
    spread of Re S(E) when the correlation carries iid isotropic complex
    noise with known per-step stderr (the transform is linear, so under
    that error model the propagation is exact and E-independent)."""
    from semiclassical_jax.analysis import fourier_stderr

    rng = np.random.default_rng(3)
    nt = 512
    times = np.linspace(0.0, 12.0 * 2.0 * np.pi / OMEGA, nt)
    corr = _analytic_autocorrelation(times)
    lineshape = gaussian(OMEGA / 10.0)
    # per-step total complex stderr, varying over t (incl. exactly 0 at
    # t=0, as HK importance sampling produces)
    sig = 0.01 * (1.0 + np.sin(0.002 * times) ** 2)
    sig[0] = 0.0

    predicted = fourier_stderr(times, sig, lineshape)

    nreal = 400
    # isotropic complex noise: Var[Re] = Var[Im] = sig^2/2
    noise = (rng.standard_normal((nreal, nt))
             + 1j * rng.standard_normal((nreal, nt))) * (sig / np.sqrt(2.0))
    spectra = np.stack([
        spectrum_from_correlation(times, corr + n, lineshape)[1].real
        for n in noise])
    empirical = spectra.std(axis=0)

    # the spread is constant over E; compare its median to the prediction
    assert predicted > 0
    assert abs(np.median(empirical) / predicted - 1.0) < 0.15
    # and no energy bin deviates wildly from the constant-band model
    assert empirical.max() / predicted < 1.6


def test_cli_spectrum_output_key_alias(synthetic_npz, monkeypatch):
    """`spectrum` is accepted as an alias for the `spectra` output-file
    keyword (the task's own name, like the rates task's `rates` key)."""
    from semiclassical_jax import cli

    monkeypatch.chdir(synthetic_npz)
    config = {"semi": [{"task": "spectrum", "spectrum": "out.npz"}]}
    with open("input.json", "w") as f:
        json.dump(config, f)
    assert cli.main(["spectrum", "input.json"]) in (None, 0)
    data = dict(np.load("out.npz"))
    assert "spectrum" in data and "spectrum_energies" in data


def test_cli_stderr_propagates_to_rate_and_spectrum(synthetic_npz,
                                                    monkeypatch):
    """With per-step stderr stored (error_bars dynamics), the rates and
    spectrum tasks store the propagated scalar bands — and accumulating
    new dynamics invalidates them with the other derived keys."""
    from semiclassical_jax import cli
    from semiclassical_jax.io import results

    monkeypatch.chdir(synthetic_npz)
    data = dict(np.load("correlations.npz"))
    times = data["times"]
    data["autocorrelation_stderr"] = np.full_like(times, 1e-3)
    data["ic_correlation_stderr"] = np.full_like(times, 2e-3)
    data["adiabatic_gap"] = 2.0 * OMEGA
    np.savez("correlations.npz", **data)

    config = {"semi": [
        {"task": "rates", "broadening": "gaussian",
         "hwhmG_ev": 0.01},
        {"task": "spectrum", "broadening": "gaussian",
         "hwhmG_ev": 0.01},
    ]}
    with open("input.json", "w") as f:
        json.dump(config, f)
    assert cli.main(["rates", "input.json"]) in (None, 0)
    assert cli.main(["spectrum", "input.json"]) in (None, 0)

    out = dict(np.load("correlations.npz"))
    assert float(out["ic_rate_stderr"]) > 0
    assert float(out["spectrum_stderr"]) > 0

    results.accumulate_results(
        "correlations.npz",
        _analytic_autocorrelation(times),
        np.zeros_like(times, dtype=complex), ntraj_new=500)
    out = dict(np.load("correlations.npz"))
    assert "ic_rate_stderr" not in out and "spectrum_stderr" not in out


def test_new_dynamics_invalidates_spectrum(synthetic_npz, monkeypatch):
    """Accumulating new dynamics into the npz must drop the stale derived
    spectrum (same protocol as ic_rate, reference cli.py:473-474)."""
    from semiclassical_jax import cli
    from semiclassical_jax.io import results

    monkeypatch.chdir(synthetic_npz)
    config = {"semi": [{"task": "spectrum"}]}
    with open("input.json", "w") as f:
        json.dump(config, f)
    cli.main(["spectrum", "input.json"])
    data = dict(np.load("correlations.npz"))
    assert "spectrum" in data

    times = data["times"]
    results.accumulate_results(
        "correlations.npz",
        _analytic_autocorrelation(times),
        np.zeros_like(times, dtype=complex), ntraj_new=500)
    data = dict(np.load("correlations.npz"))
    assert "spectrum" not in data and "spectrum_energies" not in data


def test_spectrum_task_validates():
    from semiclassical_jax.config import ConfigurationError, validate_task

    validate_task({"task": "spectrum"})
    validate_task({"task": "spectrum", "broadening": "lorentzian",
                   "hwhmL_ev": 1e-4, "spectra": "out.npz"})
    with pytest.raises(ConfigurationError):
        validate_task({"task": "spectrum", "broadening": "boxcar"})
