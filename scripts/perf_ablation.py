# coding: utf-8
"""Single-chip perf ablation of the HK step (60-mode AS flagship config).

Dissects the per-step cost into its parts (det, observables, RK4).

Run one variant per process (clean device memory) on the GPU:

    python scripts/perf_ablation.py --variant full --ntraj 32768 --nt 20

Variants
--------
full          det + observables + rk4      (production path)
det_rk4       det + rk4
rk4           rk4 only
det           det only (M nudged per step so the loop isn't hoisted)
obs_rk4       observables (c=1) + rk4
assemble_rk4  prefactor matrix assembly only (no det) + rk4

Prints one JSON line per run.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="full")
    ap.add_argument("--ntraj", type=int, default=32768)
    ap.add_argument("--nt", type=int, default=20)
    ap.add_argument("--profile_dir", default="")
    ap.add_argument("--traj", default="float64",
                    choices=["float64", "comp32"])
    args = ap.parse_args()

    import functools

    import jax
    import jax.numpy as jnp
    from jax import lax

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    from __graft_entry__ import _as60_setup
    from semiclassical_jax.propagation.eom import rk4_step
    from semiclassical_jax.propagation.hk import (hk_observables,
                                                  hk_prefactor_det,
                                                  hk_prefactor_mat)

    traj_dtype = jnp.float64 if args.traj == "float64" else "comp32"
    prop, pot = _as60_setup(ntraj=args.ntraj, dtype=jnp.float32,
                            traj_dtype=traj_dtype)
    state0, tracker0 = prop.state, prop.trackers["prefactorC"]
    dt = 0.25

    def make_scan(variant):
        # params/bc hold complex leaves: they must flow as jit *arguments*
        # (a closure capture becomes an mlir constant, and complex
        # host->device constants are unimplemented on this backend)
        def body(params, bc, carry, _):
            state, tracker, t = carry
            cauto = kic = jnp.zeros((), jnp.complex64)
            en = jnp.zeros((), jnp.float64)
            if variant in ("full", "det_rk4", "det"):
                c2 = hk_prefactor_det(params, state)
                tracker = tracker.update(c2)
                c = jnp.sqrt(c2) * tracker.signs
            if variant == "assemble_rk4":
                mre, mim = hk_prefactor_mat(params, state)
                # consume the assembly without a det: cheap trace-like sums
                cauto = jax.lax.complex(jnp.sum(mre), jnp.sum(mim)).astype(
                    jnp.complex64)
            if variant == "full":
                cauto, kic = hk_observables(params, bc, state, c, pot)
            elif variant == "obs_rk4":
                c = jnp.ones((args.ntraj,), jnp.complex64)
                cauto, kic = hk_observables(params, bc, state, c, pot)
            elif variant == "autocorr_rk4":
                # only the autocorrelation part (overlap exponents + phases)
                from semiclassical_jax.propagation.hk import hk_autocorr_qp
                c = jnp.ones((args.ntraj,), jnp.complex64)
                cauto = jnp.sum(hk_autocorr_qp(params, bc, state, c))
            elif variant == "nac_rk4":
                # only the NAC factor of k~ic (tau couplings + quadratic form)
                from semiclassical_jax.propagation.hk import (_nac_factor,
                                                              _shifted_momentum)
                PI = _shifted_momentum(params, state.p)
                nacQ = _nac_factor(params, pot, state.q,
                                   PI.astype(jnp.complex64), -1.0)
                cauto = jnp.sum(nacQ)
            if variant == "det":
                # nudge M so the det isn't loop-invariant (mimics the real
                # dependency structure at negligible cost relative to det)
                from semiclassical_jax.pytree import replace
                eps = jnp.float32(1e-30)
                state = replace(state,
                                Mqq=state.Mqq + eps * state.Mpq,
                                Mpp=state.Mpp + eps * state.Mqp)
            else:
                state, en = rk4_step(state, pot, dt)
            return (state, tracker, t + dt), (cauto, kic, en)

        def run(params, bc, state, tracker):
            return lax.scan(functools.partial(body, params, bc),
                            (state, tracker, jnp.float64(0.0)), None,
                            length=args.nt)
        return jax.jit(run)

    run = make_scan(args.variant)

    t0 = time.time()
    carry, outs = jax.block_until_ready(
        run(prop.params, prop._bc, state0, tracker0))
    compile_s = time.time() - t0

    if args.profile_dir:
        jax.profiler.start_trace(args.profile_dir)
    t0 = time.time()
    carry, outs = jax.block_until_ready(
        run(prop.params, prop._bc, state0, tracker0))
    wall = time.time() - t0
    if args.profile_dir:
        jax.profiler.stop_trace()

    print(json.dumps({
        "variant": args.variant, "ntraj": args.ntraj, "nt": args.nt,
        "wall_s": round(wall, 3), "ms_per_step": round(1e3 * wall / args.nt, 2),
        "traj_steps_per_s": round(args.ntraj * args.nt / wall, 1),
        "compile_s": round(compile_s, 1),
        "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
