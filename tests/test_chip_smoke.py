# coding: utf-8
"""CPU rehearsal of chip_smoke.py and the compile-cache rule.

chip_smoke.py itself refuses any backend but CUDA; its phase functions
take their sizes as arguments, so here they run end to end at toy sizes
on the CPU tier (8 virtual devices) — the same CLI calls, config rewrites
and gates, minus the production widths' runtime and the reference-rate
comparisons, which need the production time grid.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke
from semiclassical_jax import hostcache

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run_script(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run_script(REPO / "chip_smoke.py", REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository there is nothing to smoke."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    out = _run_script(tmp_path / "chip_smoke.py", tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.fixture
def cache_config():
    """Restore the compile-cache settings a test changes."""
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_entry_size_bytes",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    yield
    for n, v in saved.items():
        jax.config.update(n, v)


def test_compile_cache_honours_env(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert hostcache.use_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch, cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = hostcache.use_compile_cache()
    assert got == str(REPO / ".jax_cache") == hostcache.CHECKOUT_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == got
    assert os.path.isdir(got)
    ignored = subprocess.run(["git", "check-ignore", "-q", got], cwd=REPO)
    assert ignored.returncode in (0, 128)   # 128: not a git checkout


def test_det_parity_phase_toy():
    out = chip_smoke.det_parity(det_rows=32, solve_rows=8, solve_ms=(10, 12),
                                ref_rows=8, reps=1, coumarin_ntraj=8,
                                coumarin_steps=8)
    assert set(out["impls"]) == {"xla", "jax"}
    for res in out["impls"].values():
        assert res["passed"]
        assert set(res["time_s"]) == {"det_45", "det_inv_10", "det_inv_12",
                                      "solve_blocks_10"}
    assert set(out["faster_passing"]) == {"det", "solve", "inv"}
    # each implementation ran its own path (a reused trace would give the
    # same rounding for both)
    errs = {i: r["err"]["solve_blocks_y"] for i, r in out["impls"].items()}
    assert errs["xla"] != errs["jax"], errs
    assert out["auto"] == "xla" and out["gates"] == {"auto_passes": True}


def test_as60_hk_phase_toy():
    out = chip_smoke.as60_hk(ntraj=64, nt=10, compare_reference=False)
    assert out["c0_dev"] < 1e-3 and all(out["gates"].values())


def test_as60_f64_phase_toy():
    out = chip_smoke.as60_f64(ntraj=32, nt=5)
    assert out["max_dC"] < 1e-3


def test_as60_wm_phase_toy():
    out = chip_smoke.as60_wm(ntraj=64, nt=5)
    assert all(out["gates"].values())


def test_four_phase_toy():
    """The sharded CLI path on 4 of the tier's virtual devices vs 1."""
    out = chip_smoke.four(ntraj=64, nt=10, devices=4, norm_ntraj=64)
    assert out["rel_dC"] < 1e-6 and out["rel_dnorm"] < 1e-6
