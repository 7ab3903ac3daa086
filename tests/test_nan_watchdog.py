# coding: utf-8
"""NaN/instability watchdog: when a dynamics run blows
up, the CLI must dump the current trajectories to current_trajectories.xyz
for debugging before re-raising (reference cli.py:406-416)."""

import numpy as np
import pytest

from semiclassical_jax import cli


def test_watchdog_dumps_trajectories_on_blowup(tmp_path, monkeypatch,
                                               ref_data):
    ex = ref_data / "examples" / "methylium_AH"
    s0 = ex / "opt_freq_s0.fchk"
    s1 = ex / "opt_freq_s1.fchk"
    if not s0.exists() or not s1.exists():
        pytest.skip("methylium fixtures not available")
    monkeypatch.chdir(tmp_path)

    task = {
        "task": "dynamics",
        "potential": {"type": "harmonic",
                      "ground": str(s0),
                      "excited": str(s1),
                      "coupling": str(s1)},
        "propagator": "HK",
        "batch_size": 16,
        "num_trajectories": 16,
        # an absurd step (50 fs vs the production 0.005 fs) drives the
        # stiff C-H modes unstable within a few RK4 steps: the energy
        # guard / NaN check must fire and the watchdog must dump the
        # geometries
        "num_steps": 40,
        "time_step_fs": 50.0,
        "manual_seed": 0,
        "results": {"correlations": "correlations.npz"},
    }

    with pytest.raises(RuntimeError):
        cli.run_semiclassical_dynamics(task)

    dump = tmp_path / "current_trajectories.xyz"
    assert dump.exists(), "watchdog did not write current_trajectories.xyz"
    text = dump.read_text()
    # one frame with the 4 methylium atoms, finite or not — the file must
    # be a parseable extxyz snapshot
    assert text.strip().splitlines()[0].strip() == "4"
