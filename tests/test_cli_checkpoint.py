# coding: utf-8
"""Kill-and-resume of `semi dynamics` through the mid-batch checkpoint
(task keywords `checkpoint` / `checkpoint_every`).

The reference's recovery unit is a whole repetition batch (reference
cli.py:453-476); the checkpointed CLI path must lose at most one *segment*
on a kill and, with a fixed seed, reproduce the uninterrupted run exactly.
"""

import json

import numpy as np
import pytest

from semiclassical_jax import cli
import semiclassical_jax.checkpoint as ckpt_mod


@pytest.fixture()
def as_task(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with open("AS_model.dat", "w") as f:
        f.write("# freq/cm-1  S  nac  chi\n")
        f.write("1000.0  0.20  0.5  0.02\n")
        f.write(" 600.0  0.30  0.8  0.02\n")
    return {
        "task": "dynamics",
        "potential": {"type": "anharmonic AS", "model_file": "AS_model.dat"},
        "propagator": "HK",
        "batch_size": 128,
        "num_trajectories": 256,   # 2 repetitions
        "num_steps": 40,
        "time_step_fs": 0.05,
        "manual_seed": 7,
        "checkpoint": "ckpt.npz",
        "checkpoint_every": 10,    # 4 segments per repetition
        "results": {"correlations": "correlations.npz"},
    }


def test_cli_kill_and_resume(as_task, monkeypatch):
    import copy
    import os

    # uninterrupted reference run (same seed, separate results file)
    clean = copy.deepcopy(as_task)
    clean["checkpoint"] = "ckpt_clean.npz"
    clean["results"] = {"correlations": "clean.npz"}
    cli.run_semiclassical_dynamics(clean)
    ref = dict(np.load("clean.npz"))
    assert not os.path.exists("ckpt_clean.npz")  # removed after completion

    # "kill" the run during repetition 2, segment 2: the 6th snapshot
    # (4 saves in rep 1 + save of rep-2 segment 1 = 5 persisted) dies
    # before being written — exactly what SIGKILL mid-save looks like,
    # thanks to the tmp+rename protocol
    real_save = ckpt_mod.save_propagator_state
    calls = {"n": 0}

    def killing_save(filename, propagator, partial=None):
        calls["n"] += 1
        if calls["n"] == 6:
            raise KeyboardInterrupt
        real_save(filename, propagator, partial)

    with monkeypatch.context() as m:
        m.setattr(ckpt_mod, "save_propagator_state", killing_save)
        with pytest.raises(KeyboardInterrupt):
            cli.run_semiclassical_dynamics(as_task)

    # repetition 1 was accumulated, the rep-2 segment-1 checkpoint survives
    assert int(np.load("correlations.npz")["trajectories"]) == 128
    meta = ckpt_mod.peek_checkpoint("ckpt.npz")
    assert int(meta["repetition"]) == 1
    assert int(meta["steps_done"]) == 10

    # rerun the identical task: must resume (not restart) and finish
    cli.run_semiclassical_dynamics(as_task)
    assert not os.path.exists("ckpt.npz")
    out = dict(np.load("correlations.npz"))
    assert int(out["trajectories"]) == 256
    # deterministic seed -> the killed+resumed run reproduces the clean run
    np.testing.assert_allclose(out["autocorrelation"],
                               ref["autocorrelation"], atol=1e-12)
    np.testing.assert_allclose(out["ic_correlation"],
                               ref["ic_correlation"], atol=1e-12)


def test_cli_checkpoint_main_json(as_task):
    """The checkpointed path also works through `semi dynamics input.json`
    (exercises config validation of the new keywords)."""
    with open("input.json", "w") as f:
        json.dump({"semi": [as_task]}, f)
    assert cli.main(["dynamics", "input.json"]) == 0
    d = np.load("correlations.npz")
    assert int(d["trajectories"]) == 256
    assert abs(d["autocorrelation"][0] - 1.0) < 1e-3


def test_cli_checkpoint_with_norm_monitoring(as_task, caplog):
    """`checkpoint` and `calc_norm_every` compose:
    the checkpointed run splits its segments at the norm-monitoring
    boundaries, logs the norm there, and still reproduces the plain
    checkpointed run exactly (the norm readout never touches the state)."""
    import copy
    import logging

    plain = copy.deepcopy(as_task)
    plain["checkpoint"] = "ckpt_plain.npz"
    plain["results"] = {"correlations": "plain.npz"}
    cli.run_semiclassical_dynamics(plain)
    ref = dict(np.load("plain.npz"))

    combo = copy.deepcopy(as_task)
    combo["checkpoint"] = "ckpt_combo.npz"
    combo["calc_norm_every"] = 15   # NOT a divisor of checkpoint_every=10
    combo["results"] = {"correlations": "combo.npz"}
    with caplog.at_level(logging.INFO):
        cli.run_semiclassical_dynamics(combo)
    out = dict(np.load("combo.npz"))

    norms = [r for r in caplog.messages if "norm=" in r]
    # boundaries 0, 15, 30 per 40-step repetition, two repetitions
    assert len(norms) == 6
    np.testing.assert_allclose(out["autocorrelation"],
                               ref["autocorrelation"], atol=1e-12)
    np.testing.assert_allclose(out["ic_correlation"],
                               ref["ic_correlation"], atol=1e-12)
