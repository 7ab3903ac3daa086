#!/usr/bin/env python
# coding: utf-8
"""Smoke run of the production path on an NVIDIA GPU, in ONE process.

    python chip_smoke.py          # every one-card phase (needs one GPU)
    python chip_smoke.py --four   # only the sharded 4-card path vs 1 card

Each phase drives the system through the entry points a user calls
(`semi dynamics` then `semi rates`, in-process via `cli.main`) on the
shipped example configurations at their full widths, and checks what comes
out against the repository's own references:

    device            the backend is CUDA (never a silent CPU run)
    det_parity        batched det / inverse / solve of both implementations
                      ("xla", "jax") at production widths vs host LAPACK
    as60_hk           60-mode AS model, HK, 98,304 x 2000 steps + rates
    as60_f64          the same model in complex128 vs the default precision
    as60_wm           60-mode AS model, WM, 65,536 x 200 steps, error bars
    coumarin_hk       sGDML coumarin (51 cartesians, rank 45), HK, as shipped
    coumarin_wm       sGDML coumarin, WM (the dense 2r x 2r det/solves)
    methylium_parity  methylium, 50k x 2000 steps vs the torch reference rate
    gpu_tests         the `gpu`-marked tests, run in this process by pytest

Every phase prints one JSON line (name, sizes, seconds, gate values); the
card's name and power limit are printed as `nvidia-smi` reports them. The
last line is {"ok": true, "device": {...}} only when every phase passed;
otherwise the script exits non-zero without it. The phase functions take
their sizes as arguments so the CPU tests can rehearse them at toy sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import pathlib
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
EXAMPLES = REPO / "examples"
REFDATA = REPO / "tests" / "data" / "refdata"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _run_cli(*argv):
    """`semi <argv>` in this process; raise if it reports a failure."""
    from semiclassical_jax import cli

    argv = [str(a) for a in argv]
    rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"semi {' '.join(argv)} exited with {rc}")


def _write_config(src, workdir, dynamics=None, results=None):
    """Copy the example config `src` into `workdir`, with the dynamics
    task's keys updated from `dynamics` and its output file renamed to
    `results`. The example's input files are made absolute paths; a
    `model_file` stays relative to `workdir`. Returns the path."""
    src = pathlib.Path(src)
    config = json.loads(src.read_text())
    for task in config["semi"]:
        if task["task"] == "dynamics":
            pot = task["potential"]
            for key in ("ground", "excited", "coupling"):
                if key in pot:
                    pot[key] = str((src.parent / pot[key]).resolve())
            task.update(dynamics or {})
        if results:
            for key in ("correlations", "rates", "spectrum", "spectra"):
                if key in task:
                    task[key] = results
            if "results" in task:
                task["results"]["correlations"] = results
    path = pathlib.Path(workdir) / f"{src.stem}.json"
    path.write_text(json.dumps(config, indent=1))
    return path


def _write_as_model(workdir, num_modes=60):
    """AS_model.dat as examples/as_model/make_model.py writes it."""
    import runpy

    make = runpy.run_path(str(EXAMPLES / "as_model" / "make_model.py"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        make["main"](["make_model.py", str(num_modes)])
    (pathlib.Path(workdir) / "AS_model.dat").write_text(out.getvalue())


def _finite(*arrays):
    return bool(all(np.isfinite(a).all() for a in arrays))


def _check(gates, name, ok):
    """Record gate `name` and raise if it failed (after recording)."""
    gates[name] = bool(ok)
    if not ok:
        raise AssertionError(f"gate {name} failed: {gates}")


def _rate_deviation(ours, ref):
    """|k(E*) - k_ref(E*)| / |k_ref(E*)| at the reference's maximum E*."""
    imax = int(np.argmax(ref["ic_rate"]))
    return float(abs(ours["ic_rate"][imax] - ref["ic_rate"][imax])
                 / abs(ref["ic_rate"][imax]))


def _as_dynamics(workdir, src, ntraj, nt, results, **extra):
    """An AS example config at `ntraj` x `nt` writing `results`."""
    return _write_config(src, workdir, dict(
        batch_size=ntraj, num_trajectories=ntraj, num_steps=nt, **extra),
        results=results)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def device(expect_count=1):
    """The CUDA backend is up; versions and the card's power limit."""
    import importlib.metadata as md

    import jax
    import jaxlib

    from semiclassical_jax.profiling import device_info

    info = {**device_info(), "jax": jax.__version__,
            "jaxlib": jaxlib.__version__}
    for dist in ("jax-cuda12-plugin", "jax-cuda13-plugin"):
        try:
            info["cuda_plugin"] = f"{dist} {md.version(dist)}"
            break
        except md.PackageNotFoundError:
            pass
    gates = {}
    _check(gates, "platform_is_gpu", info["platform"] == "gpu")
    _check(gates, "device_count", info["device_count"] >= expect_count)
    _check(gates, "nvidia_smi", bool(info["nvidia_smi"]))
    return {**info, "gates": gates}


def _random_well_conditioned(rng, n, m):
    return (np.eye(m) + 0.3 * (rng.standard_normal((n, m, m))
                               + 1j * rng.standard_normal((n, m, m)))
            / np.sqrt(m)).astype(np.complex64)


def _coumarin_prefactor_mats(ntraj, nsteps):
    """The HK prefactor matrices (ntraj, 45, 45) complex64 of a coumarin
    ensemble after `nsteps` steps, in the shipped example's configuration
    (taylor windows of 8 steps, f32 Hessian, mixed precision)."""
    import jax
    import jax.numpy as jnp

    from semiclassical_jax import units
    from semiclassical_jax.io import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularGDMLPotential, minimize
    from semiclassical_jax.propagation import HermanKlukPropagator
    from semiclassical_jax.propagation.hk import hk_prefactor_mat

    model = np.load(REFDATA / "GDML"
                    / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz",
                    allow_pickle=True)
    with open(REFDATA / "Gaussian16" / "coumarin_s1.fchk") as f:
        exc = FormattedCheckpointFile(f)
    pot = MolecularGDMLPotential.create(model, exc, hess_dtype="float32",
                                        hessian_eval="taylor", taylor_every=8)
    x0, gamma0, _ = exc.vibrational_groundstate()
    pot = minimize(pot, jnp.asarray(x0))
    prop = HermanKlukPropagator(gamma0, gamma0, dtype=jnp.float32,
                                traj_dtype=jnp.float64)
    prop.initial_conditions(x0, np.zeros_like(x0), gamma0, ntraj=ntraj,
                            key=0, potential=pot)
    prop.propagate(pot, 0.005 / units.autime_to_fs, nsteps,
                   check_energy=False,
                   micro_batch=1024 if ntraj > 1024 else None)
    re, im = jax.jit(hk_prefactor_mat)(prop.params, prop.state)
    return (np.asarray(re) + 1j * np.asarray(im)).astype(np.complex64)


def _median_seconds(fn, x, reps):
    import jax

    jax.block_until_ready(fn(*x))                 # compile + warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*x))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def det_parity(det_rows=32768, det_m=45, solve_rows=8192,
               solve_ms=(90, 120), ref_rows=1024, reps=10,
               coumarin_ntraj=8192, coumarin_steps=200, tol=1e-4):
    """Both batched linear-algebra implementations at production widths,
    on random well-conditioned matrices and on real HK prefactor matrices,
    against host complex128 LAPACK on the leading `ref_rows` rows.

    det:    batched_det (det_rows, det_m, det_m) — the HK prefactor
    solve:  batched_det_solve_blocks at (solve_rows, solve_ms[0]) — the
            WM scan's blocked A-matrix solve (coumarin width)
    inv:    batched_det_inv at (solve_rows, m) for m in solve_ms — the WM
            diagnostics (norm, wavefunction)
    Gates: det error <= tol of max |det|, inverse/solve error <= tol, and
    the implementation `auto` resolves to passes them. Times: median of
    `reps` calls after warm-up; `faster_passing` names, per operation, the
    faster of the implementations that passed."""
    import jax
    import jax.numpy as jnp

    from semiclassical_jax import linalg

    rng = np.random.default_rng(0)
    real = _coumarin_prefactor_mats(coumarin_ntraj, coumarin_steps)
    assert real.shape[-1] == det_m, real.shape
    reps_real = -(-det_rows // real.shape[0])
    inputs = {
        "det": {"random": _random_well_conditioned(rng, det_rows, det_m),
                "prefactor": np.tile(real, (reps_real, 1, 1))[:det_rows]},
        "det_inv": {f"random_{m}": _random_well_conditioned(rng, solve_rows, m)
                    for m in solve_ms},
    }
    inputs["det_inv"]["prefactor"] = real[:solve_rows]
    m_blk = solve_ms[0]
    a_blk = inputs["det_inv"][f"random_{m_blk}"]
    b_blk = (rng.standard_normal((solve_rows, m_blk, m_blk // 2))
             + 1j * rng.standard_normal((solve_rows, m_blk, m_blk // 2))
             ).astype(np.complex64)

    def det_err(got, a):
        ref = np.linalg.det(a[:ref_rows].astype(np.complex128))
        return float(np.abs(np.asarray(got)[:ref_rows] - ref).max()
                     / np.abs(ref).max())

    def abs_err(got, ref):
        return float(np.abs(np.asarray(got)[:ref_rows] - ref).max())

    results, gates = {}, {}
    old = linalg._LINALG_IMPL
    try:
        for impl in linalg._IMPLS:
            linalg.set_linalg_impl(impl)
            # fresh functions to jit: the implementation is read at trace
            # time, and jax.jit of the same function reuses its trace
            def blocks(a, b):
                h = a.shape[-1] // 2
                return linalg.batched_det_solve_blocks(
                    a[..., :h, :h], a[..., :h, h:], a[..., h:, :h],
                    a[..., h:, h:], b[..., :h, :], b[..., h:, :])

            f_det = jax.jit(lambda a: linalg.batched_det(a))
            f_inv = jax.jit(lambda a: linalg.batched_det_inv(a))
            f_blk = jax.jit(blocks)
            res = {"time_s": {}, "err": {}}
            for name, a in inputs["det"].items():
                aj = jnp.asarray(a)
                res["err"][f"det_{name}"] = det_err(f_det(aj), a)
                if name == "random":
                    res["time_s"][f"det_{det_m}"] = _median_seconds(
                        f_det, (aj,), reps)
            for name, a in inputs["det_inv"].items():
                aj = jnp.asarray(a)
                d, inv = f_inv(aj)
                res["err"][f"det_inv_{name}_det"] = det_err(d, a)
                res["err"][f"det_inv_{name}_inv"] = abs_err(
                    inv, np.linalg.inv(a[:ref_rows].astype(np.complex128)))
                if name != "prefactor":
                    res["time_s"][f"det_inv_{a.shape[-1]}"] = \
                        _median_seconds(f_inv, (aj,), reps)
            xj = (jnp.asarray(a_blk), jnp.asarray(b_blk))
            d, y = f_blk(*xj)
            a128 = a_blk[:ref_rows].astype(np.complex128)
            res["err"]["solve_blocks_det"] = det_err(d, a_blk)
            res["err"]["solve_blocks_y"] = abs_err(
                y, np.linalg.solve(a128, b_blk[:ref_rows]))
            res["time_s"][f"solve_blocks_{m_blk}"] = _median_seconds(
                f_blk, xj, reps)
            res["passed"] = all(v <= tol for v in res["err"].values())
            results[impl] = res
            del f_det, f_inv, f_blk
    finally:
        linalg.set_linalg_impl(old)

    ops = {"det": f"det_{det_m}", "solve": "solve_blocks_", "inv": "det_inv_"}
    faster = {}
    for op, prefix in ops.items():
        times = {i: sum(t for k, t in r["time_s"].items()
                        if k.startswith(prefix))
                 for i, r in results.items() if r["passed"]}
        faster[op] = min(times, key=times.get) if times else None
    auto = linalg._resolve_impl("auto")
    _check(gates, "auto_passes", results[auto]["passed"])
    return {"sizes": {"det": [det_rows, det_m, det_m],
                      "solve": [[solve_rows, m, m] for m in solve_ms],
                      "ref_rows": ref_rows, "reps": reps,
                      "prefactor_ensemble": [coumarin_ntraj, coumarin_steps]},
            "impls": results, "faster_passing": faster, "auto": auto,
            "gates": gates}


def as60_hk(ntraj=98304, nt=2000, compare_reference=True, rate_tol=0.05):
    """examples/as_model/semi.json: HK dynamics + rates on the 60-mode AS
    model, default precision; the rate at its maximum against the committed
    independent 100k-trajectory run."""
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        _write_as_model(wd)
        cfg = _as_dynamics(wd, EXAMPLES / "as_model" / "semi.json",
                           ntraj, nt, "correlations.npz")
        _run_cli("dynamics", cfg)
        _run_cli("rates", cfg)
        data = dict(np.load("correlations.npz"))
    gates = {}
    c0 = float(abs(data["autocorrelation"][0] - 1.0))
    _check(gates, "finite", _finite(data["autocorrelation"],
                                    data["ic_correlation"], data["ic_rate"]))
    _check(gates, "c0", c0 < 1e-3)
    out = {"sizes": {"ntraj": ntraj, "nt": nt, "modes": 60}, "c0_dev": c0}
    if compare_reference:
        ref = np.load(EXAMPLES / "as_model" / "correlations_100k_reference.npz")
        out["rate_max_dev"] = _rate_deviation(data, ref)
        _check(gates, "rate_max", out["rate_max_dev"] < rate_tol)
    return {**out, "gates": gates}


def as60_f64(ntraj=8192, nt=200, seed=11):
    """The 60-mode AS model once in complex128 (--precision f64) and once
    at the default precision, same ensemble: max |dC(t)|."""
    runs = {}
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        _write_as_model(wd)
        for name, flags in (("f64", ["--precision", "f64"]),
                            ("default", [])):
            cfg = _as_dynamics(wd, EXAMPLES / "as_model" / "semi.json",
                               ntraj, nt, f"correlations_{name}.npz",
                               manual_seed=seed)
            _run_cli("dynamics", cfg, *flags)
            runs[name] = dict(np.load(f"correlations_{name}.npz"))
    gates = {}
    dc = float(np.abs(runs["f64"]["autocorrelation"]
                      - runs["default"]["autocorrelation"]).max())
    dk = float(np.abs(runs["f64"]["ic_correlation"]
                      - runs["default"]["ic_correlation"]).max()
               / np.abs(runs["f64"]["ic_correlation"]).max())
    _check(gates, "finite", _finite(*(r["autocorrelation"]
                                      for r in runs.values())))
    _check(gates, "max_dC", dc < 1e-3)
    return {"sizes": {"ntraj": ntraj, "nt": nt, "modes": 60},
            "max_dC": dc, "max_dkic_rel": dk, "gates": gates}


def _wm_gates(data):
    gates = {}
    c0 = float(abs(data["autocorrelation"][0] - 1.0))
    err0 = float(data["autocorrelation_stderr"][0])
    _check(gates, "finite", _finite(data["autocorrelation"],
                                    data["ic_correlation"]))
    # the Filinov-reweighted t=0 estimate carries Monte-Carlo noise
    _check(gates, "c0_within_stderr", c0 < 5.0 * err0 + 1e-3)
    return {"c0_dev": c0, "c0_stderr": err0, "gates": gates}


def as60_wm(ntraj=65536, nt=200):
    """examples/as_model/semi_wm.json: WM dynamics (per-mode 2x2 fast
    path, default micro-batch) with Monte-Carlo error bars."""
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        _write_as_model(wd)
        cfg = _as_dynamics(wd, EXAMPLES / "as_model" / "semi_wm.json",
                           ntraj, nt, "correlations_wm.npz", error_bars=True)
        _run_cli("dynamics", cfg)
        data = dict(np.load("correlations_wm.npz"))
    return {"sizes": {"ntraj": ntraj, "nt": nt, "modes": 60},
            **_wm_gates(data)}


def coumarin_hk(ntraj=None, nt=None):
    """examples/coumarin_gdml/semi.json as shipped (sizes may be cut for
    the CPU rehearsal): HK on the sGDML force field + rates. The CLI's
    energy-conservation check raises, so a passing run has passed it."""
    upd = {}
    if ntraj:
        upd.update(batch_size=ntraj, num_trajectories=ntraj)
    if nt:
        upd.update(num_steps=nt)
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        cfg = _write_config(EXAMPLES / "coumarin_gdml" / "semi.json", wd,
                            upd)
        task = json.loads(cfg.read_text())["semi"][0]
        _run_cli("dynamics", cfg)
        _run_cli("rates", cfg)
        data = dict(np.load("correlations.npz"))
    gates = {}
    c0 = float(abs(data["autocorrelation"][0] - 1.0))
    _check(gates, "finite", _finite(data["autocorrelation"],
                                    data["ic_correlation"], data["ic_rate"]))
    _check(gates, "c0", c0 < 1e-3)
    return {"sizes": {"ntraj": task["num_trajectories"],
                      "nt": task["num_steps"], "cartesians": 51, "rank": 45},
            "c0_dev": c0, "gates": gates}


def coumarin_wm(ntraj=1024, nt=100):
    """examples/coumarin_gdml/semi_wm.json with error bars: the dense WM
    det / inverse / solves on the sGDML force field."""
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        cfg = _write_config(
            EXAMPLES / "coumarin_gdml" / "semi_wm.json", wd,
            dict(batch_size=ntraj, num_trajectories=ntraj, num_steps=nt,
                 error_bars=True))
        _run_cli("dynamics", cfg)
        data = dict(np.load("correlations_wm.npz"))
    return {"sizes": {"ntraj": ntraj, "nt": nt, "cartesians": 51,
                      "rank": 45}, **_wm_gates(data)}


def methylium_parity(ntraj=50000, nt=2000, seed=1234, compare_reference=True,
                     rate_tol=0.03):
    """The methylium production job through the CLI task functions, gated
    at the reference's own strength: the rate at its maximum within 3% of
    the torch reference (tests/data/methylium_reference_rate_10k.npz)."""
    import shutil

    from semiclassical_jax import cli

    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        shutil.copytree(REFDATA / "examples" / "methylium_AH", "job")
        os.chdir("job")
        config = json.loads(pathlib.Path("semi.json").read_text())
        for task in config["semi"]:
            if task["task"] == "dynamics":
                task.update(num_trajectories=ntraj, batch_size=ntraj,
                            manual_seed=seed, num_steps=nt)
                cli.run_semiclassical_dynamics(task)
        for task in config["semi"]:
            if task["task"] == "rates":
                cli.calculate_rates(task)
        data = dict(np.load("correlations.npz"))
    gates = {}
    out = {"sizes": {"ntraj": ntraj, "nt": nt, "seed": seed},
           "c0_dev": float(abs(data["autocorrelation"][0] - 1.0))}
    _check(gates, "finite", _finite(data["autocorrelation"],
                                    data["ic_correlation"], data["ic_rate"]))
    _check(gates, "c0", out["c0_dev"] < 1e-2)
    if compare_reference:
        ref = np.load(REPO / "tests" / "data"
                      / "methylium_reference_rate_10k.npz")
        out["rate_max_dev"] = _rate_deviation(data, ref)
        _check(gates, "rate_max", out["rate_max_dev"] < rate_tol)
    return {**out, "gates": gates}


def gpu_tests():
    """The `gpu`-marked tests, in this process (a second process would
    open the card again); the full-parity test is methylium_parity."""
    import pytest

    os.environ["SEMI_GPU_TESTS"] = "1"
    rc = pytest.main([str(REPO / "tests"), "-q", "-p", "no:cacheprovider",
                      "-m", "gpu and not full_parity"])
    gates = {}
    _check(gates, "pytest_rc0", int(rc) == 0)
    return {"pytest_rc": int(rc), "gates": gates}


def four(ntraj=393216, nt=500, devices=4, norm_ntraj=16384, seed=5,
         tol=1e-6):
    """The sharded path: AS-60 HK through the CLI on `devices` cards vs 1
    card, same seed (C(t), k~ic(t)), and the O(n^2) norm's ppermute ring
    on the mesh vs the single-device pair sum."""
    import jax
    import jax.numpy as jnp

    from semiclassical_jax.parallel import ensemble_mesh

    from __graft_entry__ import _as60_setup

    runs, wall = {}, {}
    with tempfile.TemporaryDirectory() as wd, contextlib.chdir(wd):
        _write_as_model(wd)
        for n in (devices, 1):
            cfg = _as_dynamics(wd, EXAMPLES / "as_model" / "semi.json",
                               ntraj, nt, f"correlations_{n}.npz",
                               manual_seed=seed)
            t0 = time.perf_counter()
            _run_cli("dynamics", cfg, "--devices", n)
            wall[n] = time.perf_counter() - t0
            runs[n] = dict(np.load(f"correlations_{n}.npz"))

    def rel(key):
        a, b = runs[devices][key], runs[1][key]
        return float(np.abs(a - b).max() / np.abs(b).max())

    norms = {}
    for n in (devices, 1):
        mesh = ensemble_mesh(jax.devices()[:n]) if n > 1 else None
        prop, pot = _as60_setup(norm_ntraj, dtype=jnp.float64, mesh=mesh)
        prop.propagate(pot, 0.25, 20, check_energy=False)
        norms[n] = float(prop.norm())
    gates = {}
    out = {"sizes": {"ntraj": ntraj, "nt": nt, "devices": devices,
                     "norm_ntraj": norm_ntraj},
           "wall_s": {str(k): v for k, v in wall.items()},
           "rel_dC": rel("autocorrelation"),
           "rel_dkic": rel("ic_correlation"),
           "norm": {str(k): v for k, v in norms.items()}}
    out["rel_dnorm"] = abs(norms[devices] - norms[1]) / abs(norms[1])
    _check(gates, "C", out["rel_dC"] < tol)
    _check(gates, "kic", out["rel_dkic"] < tol)
    _check(gates, "norm", out["rel_dnorm"] < tol)
    return {**out, "gates": gates}


# ---------------------------------------------------------------------------

ONE_CARD = ("det_parity", "as60_hk", "as60_f64", "as60_wm", "coumarin_hk",
            "coumarin_wm", "methylium_parity", "gpu_tests")


def _run_phase(name, fn, t_start):
    t0 = time.perf_counter()
    try:
        out = fn()
        passed = True
    except Exception as exc:
        traceback.print_exc()
        out, passed = {"error": repr(exc)[:2000]}, False
    line = {"phase": name, "passed": passed,
            "seconds": time.perf_counter() - t0,
            "elapsed_s": time.perf_counter() - t_start, **out}
    print(json.dumps(line, default=str), flush=True)
    return passed


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-card sharded path and its "
                             "1-card comparison")
    args = parser.parse_args(argv)
    t_start = time.perf_counter()

    import jax

    # a failed CUDA initialisation must be an error, not a CPU run
    jax.config.update("jax_platforms", "cuda")
    import semiclassical_jax  # noqa: F401  (x64, matmul precision)
    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()
    dev = device(expect_count=4 if args.four else 1)
    print(dev["nvidia_smi"], flush=True)
    print(json.dumps({"phase": "device", "passed": True, **dev}), flush=True)

    phases = ("four",) if args.four else ONE_CARD
    passed = [_run_phase(name, globals()[name], t_start) for name in phases]
    if not all(passed):
        failed = [n for n, ok in zip(phases, passed) if not ok]
        print(f"chip_smoke: FAILED phases {failed}", file=sys.stderr)
        return 1
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
