# coding: utf-8
"""End-to-end `semi dynamics` on the anharmonic-AS potential branch,
including the cross-run accumulation protocol (overwrite: false) —
the reference's coarse-grained fault-tolerance mechanism
(reference cli.py:344-364, README.rst:111-115)."""

import json

import numpy as np
import pytest

from semiclassical_jax import cli


@pytest.fixture()
def as_setup(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # tiny 3-mode anharmonic AS model
    with open("AS_model.dat", "w") as f:
        f.write("# freq/cm-1  S  nac  chi\n")
        f.write("1000.0  0.20  0.5  0.02\n")
        f.write("1500.0  0.10 -0.3  0.02\n")
        f.write(" 600.0  0.30  0.8  0.02\n")
    task = {
        "task": "dynamics",
        "potential": {"type": "anharmonic AS", "model_file": "AS_model.dat"},
        "propagator": "HK",
        "batch_size": 256,
        "num_trajectories": 512,
        "num_steps": 40,
        "time_step_fs": 0.05,
        "results": {"correlations": "correlations.npz"},
    }
    return task


def test_dynamics_as_branch(as_setup):
    task = as_setup
    cli.run_semiclassical_dynamics(task)
    d = np.load("correlations.npz")
    assert int(d["trajectories"]) == 512  # 2 repetitions of 256
    assert abs(d["autocorrelation"][0] - 1.0) < 1e-3
    assert np.isfinite(d["ic_correlation"]).all()
    assert np.isnan(float(d["adiabatic_gap"]))  # model potentials have none


def test_accumulation_across_runs(as_setup):
    task = as_setup
    cli.run_semiclassical_dynamics(task)
    first = np.load("correlations.npz")["autocorrelation"].copy()

    # second invocation with overwrite: false accumulates
    task["results"]["overwrite"] = False
    cli.run_semiclassical_dynamics(task)
    d = np.load("correlations.npz")
    assert int(d["trajectories"]) == 1024
    assert abs(d["autocorrelation"][0] - 1.0) < 1e-3
    # accumulated curve differs from the first batch but stays close
    # (independent random keys, same physics)
    assert not np.allclose(d["autocorrelation"], first)
    assert np.abs(d["autocorrelation"] - first).max() < 0.2


def test_accumulation_rejects_grid_change(as_setup):
    task = as_setup
    cli.run_semiclassical_dynamics(task)
    task["results"]["overwrite"] = False
    task["num_steps"] = 41
    with pytest.raises(AssertionError):
        cli.run_semiclassical_dynamics(task)


def test_wm_branch_and_export_trajectories(as_setup, tmp_path):
    task = as_setup
    task["propagator"] = "WM"
    task["cell_width"] = 500.0
    task["num_trajectories"] = 256
    cli.run_semiclassical_dynamics(task)
    d = np.load("correlations.npz")
    assert str(d["propagator"]) == "WM"
    assert abs(d["autocorrelation"][0] - 1.0) < 0.05  # finite-cell WM


def test_main_dynamics_json(as_setup, monkeypatch):
    task = as_setup
    with open("input.json", "w") as f:
        json.dump({"semi": [task]}, f)
    assert cli.main(["dynamics", "input.json"]) == 0
