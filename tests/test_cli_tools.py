# coding: utf-8
"""CLI utility subcommands (export/show), extxyz writer, profiling module."""

import json

import numpy as np
import pytest

from semiclassical_jax import cli, units
from semiclassical_jax.io.extxyz import write_extxyz
from semiclassical_jax.io.results import accumulate_results, init_results
from semiclassical_jax.profiling import PhaseTimer, RunMetrics


@pytest.fixture()
def results_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    nt = 64
    times = np.linspace(0.0, 10.0, nt)
    init_results("correlations.npz", "HK", times, adiabatic_gap=0.2,
                 zero_point_energy=0.05)
    cauto = np.exp(-0.1 * times) * np.exp(1j * 0.3 * times)
    cauto[0] = 1.0
    kic = 1e-8 * np.exp(-0.2 * times)
    accumulate_results("correlations.npz", cauto, kic, 1000)
    return "correlations.npz"


def test_accumulate_weighted_average(results_file):
    data1 = dict(np.load(results_file))
    # add a second batch with different values; average must be weighted
    cauto2 = np.ones_like(data1["autocorrelation"])
    kic2 = np.zeros_like(data1["ic_correlation"])
    total = accumulate_results(results_file, cauto2, kic2, 3000)
    assert total == 4000
    data2 = dict(np.load(results_file))
    expected = (1000 * data1["autocorrelation"] + 3000 * cauto2) / 4000
    assert np.allclose(data2["autocorrelation"], expected)


def test_cli_rates_export_show(results_file, capsys):
    cli.calculate_rates({"task": "rates", "broadening": "gaussian",
                         "hwhmG_ev": 0.1})
    data = np.load(results_file)
    assert "ic_rate" in data.files
    assert (data["energies"] >= 0).all()

    cli._export_tables(results_file)
    auto = np.loadtxt("autocorrelation.dat")
    assert auto.shape[0] == len(data["times"])
    icc = np.loadtxt("ic_correlation.dat")
    assert icc.shape == auto.shape
    rate = np.loadtxt("ic_rate.dat")
    assert rate.shape[0] == len(data["energies"])

    cli._show_information(results_file)
    out = capsys.readouterr().out
    assert "propagator" in out and "HK" in out
    assert "IC rate" in out


def test_cli_main_rates(results_file, tmp_path):
    config = {"semi": [{"task": "rates", "broadening": "lorentzian",
                        "hwhmL_ev": 0.001}]}
    with open("input.json", "w") as f:
        json.dump(config, f)
    assert cli.main(["rates", "input.json"]) == 0
    assert "ic_rate" in np.load(results_file).files


def test_extxyz_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    numbers = [6, 1, 1, 1]
    q = rng.random((3, 12))
    p = rng.random((3, 12))
    path = tmp_path / "traj.xyz"
    write_extxyz(path, numbers, q, p)
    lines = path.read_text().splitlines()
    assert lines[0].strip() == "4"
    assert len(lines) == 3 * (2 + 4)
    first_atom = lines[2].split()
    assert first_atom[0] == "C"
    assert np.isclose(float(first_atom[1]), q[0, 0] * units.bohr_to_angs)
    # append mode
    write_extxyz(path, numbers, q[:1], p[:1], append=True)
    assert len(path.read_text().splitlines()) == 4 * (2 + 4)


def test_phase_timer_and_metrics():
    timer = PhaseTimer()
    with timer.phase("scan"):
        sum(range(1000))
    assert timer.throughput(100, 10) > 0
    m = RunMetrics.from_run(
        energies=np.array([1.0, 1.0001]),
        cauto=np.array([1.0 + 0j, 0.5]),
        kic=np.array([1e-8, 2e-8]),
    )
    assert not m.nan_detected
    assert abs(m.energy_drift_max - 0.0001) < 1e-12
    assert "energy_drift_max" in m.to_json()


def test_cli_plot_smoke(results_file, monkeypatch):
    """`semi plot` renders without a display (Agg backend)."""
    import matplotlib
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    monkeypatch.setattr(plt, "show", lambda: None)
    # stderr keys exercise the error-band branches of all three panels
    data = dict(np.load(results_file))
    data["autocorrelation_stderr"] = np.full_like(data["times"], 1e-3)
    data["ic_correlation_stderr"] = np.full_like(data["times"], 1e-10)
    np.savez(results_file, **data)
    cli.calculate_rates({"task": "rates"})
    assert "ic_rate_stderr" in np.load(results_file).files
    cli._plot_correlation_functions([results_file])
    plt.close("all")


def test_cli_plot_save(results_file, tmp_path):
    """`semi plot --save fig.png` writes the figure to a file through the
    real main() path — the headless-machine workflow (no display needed,
    no plt.show monkeypatching)."""
    out = tmp_path / "fig.png"
    cli.main(["plot", results_file, "--save", str(out)])
    assert out.exists() and out.stat().st_size > 0


def test_console_entry_point():
    import shutil
    import subprocess
    if shutil.which("semi") is None:
        pytest.skip("package not installed in this environment "
                    "(pip install -e . provides the `semi` entry point)")
    out = subprocess.run(["semi", "--version"], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0
    assert "semi" in out.stdout
