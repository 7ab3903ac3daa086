# coding: utf-8
"""Multi-process accumulation protocol gates (SURVEY §2.2 P2).

The scale-out path for ensembles beyond one process/host is the
reference's own cross-process accumulation contract (reference
cli.py:344-364, README.rst:111-115): cooperating ranks run independent
batches and merge them into one results npz through the trajectory-weighted
average. Here that protocol is exercised with genuinely separate
interpreters running CONCURRENTLY — the file lock added in io/results.py
must serialise the read-modify-replace cycles — and the merged result is
gated against in-process per-rank reference runs (the rank-folded sampling
keys make each rank's batch reproducible in isolation).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# lock correctness under concurrent accumulation (no lost updates)
# ---------------------------------------------------------------------------

_WORKER = r"""
import importlib.util
import sys

# load io/results.py standalone (numpy-only) — no jax import in the workers
spec = importlib.util.spec_from_file_location("results", sys.argv[1])
results = importlib.util.module_from_spec(spec)
spec.loader.exec_module(results)

import numpy as np

filename, value, reps = sys.argv[2], float(sys.argv[3]), int(sys.argv[4])
nt = 4
for _ in range(reps):
    results.accumulate_results(
        filename,
        np.ones(nt, dtype=complex),           # C(0) = 1 contract
        np.full(nt, value, dtype=complex),
        1)
print("worker done")
"""


def test_concurrent_accumulation_no_lost_update(tmp_path):
    """Two interpreters accumulate 25 single-trajectory batches each into
    the same npz at full speed; every batch must survive the interleaving
    and the weighted mean must come out exact."""
    from semiclassical_jax.io.results import init_results

    filename = str(tmp_path / "correlations.npz")
    times = np.linspace(0.0, 1.0, 4)
    init_results(filename, "HK", times, 0.0, 0.0)

    results_py = str(REPO / "semiclassical_jax" / "io" / "results.py")
    reps = 25
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, results_py, filename,
             str(value), str(reps)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for value in (1.0, 3.0)
    ]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()

    data = np.load(filename)
    assert int(data["trajectories"]) == 2 * reps, (
        f"lost updates: {int(data['trajectories'])} of {2 * reps} "
        "batches survived")
    # 25 batches at 1.0 + 25 at 3.0, all weight 1 -> mean exactly 2.0
    assert np.allclose(data["ic_correlation"], 2.0, atol=1e-12)
    assert np.allclose(data["autocorrelation"], 1.0, atol=1e-12)


# ---------------------------------------------------------------------------
# end-to-end: two CLI ranks vs their in-process reference batches
# ---------------------------------------------------------------------------

_RANK_RUNNER = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import json
import sys

sys.path.insert(0, sys.argv[1])
from semiclassical_jax.hostcache import disable_persistent_cache
disable_persistent_cache()
jax.config.update("jax_enable_x64", True)

from semiclassical_jax import cli

with open(sys.argv[2]) as f:
    task = json.load(f)
cli.run_semiclassical_dynamics(task)
print("rank done")
"""


def _as_task(model_file, npz, seed=7, ntraj=256):
    return {
        "task": "dynamics",
        "potential": {"type": "anharmonic AS", "model_file": str(model_file)},
        "propagator": "HK",
        "batch_size": ntraj,
        "num_trajectories": ntraj,
        "num_steps": 6,
        "time_step_fs": 0.1,
        "manual_seed": seed,
        "results": {"correlations": str(npz), "overwrite": False},
    }


def test_two_process_cli_accumulation(tmp_path, monkeypatch):
    model_file = tmp_path / "AS_model.dat"
    # one 1500 cm^-1 mode, Huang-Rhys 0.1, chi = 0.02
    model_file.write_text("1500.0  0.1  0.5  0.02\n")

    shared = tmp_path / "shared.npz"
    taskfiles = []
    for rank in (0, 1):
        tf = tmp_path / f"task{rank}.json"
        tf.write_text(json.dumps(_as_task(model_file, shared)))
        taskfiles.append(tf)

    # two separate interpreters, launched concurrently, same manual_seed —
    # the rank fold must give them disjoint ensembles, the lock must
    # serialise their merges
    procs = []
    for rank, tf in enumerate(taskfiles):
        env = dict(os.environ)
        env["SEMI_PROCESS_ID"] = str(rank)
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK_RUNNER, str(REPO), str(tf)],
            env=env, cwd=tmp_path,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out.decode()

    # per-rank reference batches, reproduced in this process: the same
    # manual_seed + rank fold is deterministic across interpreters
    from semiclassical_jax import cli

    own = []
    for rank in (0, 1):
        monkeypatch.setenv("SEMI_PROCESS_ID", str(rank))
        npz = tmp_path / f"own{rank}.npz"
        cli.run_semiclassical_dynamics(_as_task(model_file, npz))
        own.append(dict(np.load(npz)))
    monkeypatch.delenv("SEMI_PROCESS_ID")

    data = dict(np.load(shared))
    assert int(data["trajectories"]) == 512
    # the ranks drew DIFFERENT ensembles (fold_in worked)
    assert not np.allclose(own[0]["ic_correlation"],
                           own[1]["ic_correlation"], atol=1e-12)
    # equal-weight merge of the two rank batches, whatever their order
    merged_auto = 0.5 * (own[0]["autocorrelation"]
                         + own[1]["autocorrelation"])
    merged_ic = 0.5 * (own[0]["ic_correlation"] + own[1]["ic_correlation"])
    assert np.allclose(data["autocorrelation"], merged_auto, atol=1e-12)
    assert np.allclose(data["ic_correlation"], merged_ic, atol=1e-12)


def test_multiprocess_rank_helper(monkeypatch):
    import jax

    from semiclassical_jax.cli import _multiprocess_rank

    monkeypatch.delenv("SEMI_PROCESS_ID", raising=False)
    assert _multiprocess_rank(jax) == (False, 0)
    monkeypatch.setenv("SEMI_PROCESS_ID", "3")
    assert _multiprocess_rank(jax) == (True, 3)
