# coding: utf-8
"""Benchmark: three production throughput metrics in ONE process, on a GPU.

Prints one JSON line per metric, each shaped
  {"metric": "...", "value": N, "unit": "...", "vs_baseline": N,
   "device": {platform, device_kind, device_count, nvidia_smi}, ...}
in the order: WM flagship, GDML frontier, HK flagship (the headline metric
prints LAST so a last-line parser records it). Any platform other than a
GPU is refused, and a failed cell is an error, never a smaller batch.

1. `wm_as60`  — Walton-Manolopoulos propagator, 60-mode anharmonic AS,
   comp32 trajectories, device-side micro-batching (the production WM
   configuration).
2. `gdml_coumarin` — sGDML-driven HK dynamics on the coumarin model
   (51 cartesians), mixed precision (f64 E/grad + f32 Hessian),
   `hessian_eval="taylor"` windows with the per-window monodromy map.
   Skipped (with a JSON notice) when neither the reference checkout nor
   the vendored fixture tree provides the trained model.
3. `hk_as60`  — Herman-Kluk propagator, 60-mode anharmonic AS, comp32,
   1,048,576 trajectories. The headline metric: one unit = advancing one
   trajectory (with its monodromy) through one RK4 step AND accumulating
   both observables C(t), k~ic(t) — exactly the per-step work of the
   reference's dynamics loop (reference cli.py:401-436).

The batch shapes are the ones tuned on the previous accelerator and are not
yet re-tuned for the GPU.

Baselines:
* torch reference on a 1-core CPU at the identical 60-mode config:
  213.4 traj-steps/s (the reference publishes no numbers of its own).
  Used for hk_as60 and — conservatively, the reference's WM step is
  strictly MORE work than its HK step — for wm_as60.
* the reference's only published perf claim: ~10,000 molecules/s for
  batched sGDML E+grad+Hessian "on a GPU" (reference
  gdml_predictor.py:51-54). At 4 PES evaluations per dynamics step that
  bounds its dynamics loop at ~2,500 traj-steps/s; used for
  gdml_coumarin.
"""

import gc
import json
import os
import sys

import numpy as np

TORCH_CPU_BASELINE = 213.4    # traj-steps/s, torch reference, 1-core CPU
GDML_GPU_BASELINE = 2500.0    # traj-steps/s bound implied by the
                              # reference's 10k molecules/s GPU headline

REPO = os.path.dirname(os.path.abspath(__file__))


def _gdml_fixture_dir():
    """Directory holding GDML/ and Gaussian16/ fixtures, or None."""
    cands = [os.environ.get("SEMI_REF_DATA"),
             "/root/reference/tests/DATA",
             os.path.join(REPO, "tests", "data", "refdata")]
    model_rel = os.path.join(
        "GDML", "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    for c in cands:
        if c and os.path.exists(os.path.join(c, model_rel)):
            return c
    return None


def _result(metric, value, unit, baseline, config, timer, device):
    return {
        "metric": metric,
        "value": round(value, 1),
        "unit": unit,
        "vs_baseline": round(value / baseline, 2),
        "device": device,
        "config": config,
        "phases": {k: round(v, 3) for k, v in timer.summary().items()},
    }


def _timed_scan(timer, prop, pot, nt, micro=None, dt=0.25, en0=0.0):
    """Compile (one untimed run from a snapshot of the state), then the
    timed scan; checks the observables are finite."""
    import copy

    snapshot = (prop.state, copy.copy(prop.trackers), prop.t)
    with timer.phase("compile"):
        prop.propagate(pot, dt, nt, energy0_es=en0, check_energy=False,
                       micro_batch=micro)
    prop.state, prop.trackers, prop.t = snapshot
    with timer.phase("scan"):
        cauto, kic = prop.propagate(pot, dt, nt, energy0_es=en0,
                                    check_energy=False, micro_batch=micro)
    with timer.phase("reduce"):
        assert np.isfinite(cauto).all() and np.isfinite(kic).all()


def bench_wm(jax, jnp, device):
    from semiclassical_jax.potentials import MorsePotential
    from semiclassical_jax.profiling import PhaseTimer
    from semiclassical_jax.propagation import WaltonManolopoulosPropagator

    timer = PhaseTimer()
    ntraj = int(os.environ.get("BENCH_WM_NTRAJ", "524288"))
    nt = int(os.environ.get("BENCH_WM_NT", "500"))
    micro = 8192 if ntraj > 8192 else None

    with timer.phase("sample"):
        rng = np.random.default_rng(42)
        d = 60
        omega = rng.uniform(200.0, 3000.0, size=d) / 219474.63
        S = rng.uniform(0.01, 0.3, size=d)
        nac = rng.uniform(-1.0, 1.0, size=d)
        chi = np.full(d, 0.02)
        # algebra-dtype PES pack (the CLI does the same): the Morse
        # transcendentals run in f32
        pot = MorsePotential.create(omega, chi, nac, dtype=jnp.float32)
        prop = WaltonManolopoulosPropagator(
            np.diag(omega), np.diag(omega), 1e4, 1e4,
            dtype=jnp.float32, traj_dtype="comp32")
        dQ = np.sqrt(2.0 * S / omega)
        prop.initial_conditions(dQ, np.zeros(d), np.diag(omega),
                                ntraj=ntraj, key=0, potential=pot)
    _timed_scan(timer, prop, pot, nt, micro, en0=float(np.sum(0.5 * omega)))

    value = timer.throughput(ntraj, nt, 1)
    return _result("wm_as60_traj_steps_per_sec_per_chip", value,
                   "traj-steps/s/chip", TORCH_CPU_BASELINE, {
                       "ntraj": ntraj, "nt": nt, "dim": 60,
                       "dtype": "comp32", "micro_batch": micro,
                       "wall_s": round(timer.phases["scan"], 3),
                       "baseline": "torch reference HK step rate on a "
                                   "1-core CPU (conservative: the "
                                   "reference WM step is heavier)",
                   }, timer, device)


def bench_gdml(jax, jnp, device):
    data = _gdml_fixture_dir()
    if data is None:
        return {"metric": "gdml_coumarin_traj_steps_per_sec_per_chip",
                "skipped": "no sGDML fixture available", "device": device}

    from semiclassical_jax.io.fchk import FormattedCheckpointFile
    from semiclassical_jax.potentials import (MolecularGDMLPotential,
                                              minimize)
    from semiclassical_jax.profiling import PhaseTimer
    from semiclassical_jax.propagation import HermanKlukPropagator

    timer = PhaseTimer()
    # taylor_every=32 windows + per-window monodromy map, micro-batch 256
    ntraj = int(os.environ.get("BENCH_GDML_NTRAJ", "32768"))
    nt = int(os.environ.get("BENCH_GDML_NT", "100"))
    every = 32
    micro = 256 if ntraj > 256 else None

    with timer.phase("sample"):
        model = np.load(os.path.join(
            data, "GDML",
            "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz"),
            allow_pickle=True)
        with open(os.path.join(data, "Gaussian16", "coumarin_s1.fchk")) as f:
            exc = FormattedCheckpointFile(f)
        pot = MolecularGDMLPotential.create(
            model, exc, hess_dtype=jnp.float32, hessian_eval="taylor",
            taylor_every=every)
        x0, Gamma0, zpe = exc.vibrational_groundstate()
        pot = minimize(pot, jnp.asarray(x0))
        prop = HermanKlukPropagator(Gamma0, Gamma0, dtype=jnp.float32,
                                    traj_dtype=jnp.float64)
        prop.initial_conditions(x0, np.zeros_like(x0), Gamma0,
                                ntraj=ntraj, key=0, potential=pot)
    _timed_scan(timer, prop, pot, nt, micro, dt=0.1)

    value = timer.throughput(ntraj, nt, 1)
    return _result("gdml_coumarin_traj_steps_per_sec_per_chip", value,
                   "traj-steps/s/chip", GDML_GPU_BASELINE, {
                       "ntraj": ntraj, "nt": nt, "n_cartesian": 51,
                       "hessian_eval": "taylor", "taylor_every": every,
                       "micro_batch": micro, "hess_dtype": "float32",
                       "wall_s": round(timer.phases["scan"], 3),
                       "fixtures": os.path.relpath(data, REPO),
                       "baseline": "reference's published ~10k molecules/s "
                                   "GPU headline / 4 PES evals per step",
                   }, timer, device)


def bench_hk(jax, jnp, device):
    sys.path.insert(0, REPO)
    from __graft_entry__ import _as60_setup
    from semiclassical_jax.profiling import PhaseTimer

    timer = PhaseTimer()
    ntraj = int(os.environ.get("BENCH_NTRAJ", "1048576"))
    # "comp32" = compensated-f32 trajectories (Neumaier residuals), the
    # CLI default for HK on model potentials: tracks the mixed mode (f64
    # trajectories) to 5e-7 over the full 2000-step horizon
    # (tests/test_comp32.py). BENCH_DTYPE overrides ("mixed" = the
    # f64-trajectory ablation, "float64", "float32").
    dtype_name = os.environ.get("BENCH_DTYPE", "comp32")
    nt = int(os.environ.get("BENCH_NT", "500"))

    with timer.phase("sample"):
        if dtype_name == "mixed":
            prop, pot = _as60_setup(ntraj=ntraj, dtype=jnp.float32,
                                    traj_dtype=jnp.float64)
        elif dtype_name == "comp32":
            prop, pot = _as60_setup(ntraj=ntraj, dtype=jnp.float32,
                                    traj_dtype="comp32")
        else:
            dtype = jnp.float64 if dtype_name == "float64" else jnp.float32
            prop, pot = _as60_setup(ntraj=ntraj, dtype=dtype)
    _timed_scan(timer, prop, pot, nt)   # dt = 0.25 a.u.: stable at 3000 cm-1

    value = timer.throughput(ntraj, nt, 1)
    return _result("hk_as60_traj_steps_per_sec_per_chip", value,
                   "traj-steps/s/chip", TORCH_CPU_BASELINE, {
                       "ntraj": ntraj, "nt": nt, "dim": 60,
                       "dtype": dtype_name,
                       "wall_s": round(timer.phases["scan"], 3),
                       "compile_s": round(timer.phases["compile"], 1),
                   }, timer, device)


def main():
    import jax

    # a failed CUDA initialisation must be an error, not a CPU run
    jax.config.update("jax_platforms", "cuda")
    import jax.numpy as jnp

    from semiclassical_jax.hostcache import use_compile_cache
    from semiclassical_jax.profiling import device_info

    use_compile_cache()
    device = device_info()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX runs on {device['platform']}")

    only = os.environ.get("BENCH_ONLY", "")
    benches = {"wm": bench_wm, "gdml": bench_gdml, "hk": bench_hk}
    # EXECUTION order: the 1M-trajectory HK bench, the memory-hungriest,
    # runs first; PRINT order keeps the headline hk line LAST for
    # last-line parsers.
    exec_order = ["hk", "wm", "gdml"]
    print_order = ["wm", "gdml", "hk"]
    results = {}
    for name in exec_order:
        if only and name != only:
            continue
        try:
            results[name] = benches[name](jax, jnp, device)
        except Exception as exc:
            results[name] = {"metric": f"{name}_bench_error",
                             "error": repr(exc), "device": device}
        # free every device buffer the bench left behind for the next one;
        # the persistent disk cache makes dropped executables cheap to
        # reload
        gc.collect()
        jax.clear_caches()
        gc.collect()
    for name in print_order:
        if results.get(name) is not None:
            print(json.dumps(results[name]), flush=True)
    if any("error" in r for r in results.values()):
        sys.exit(1)              # no cell may fail quietly


if __name__ == "__main__":
    main()
