# coding: utf-8
"""Opt-in taylor/taylor_every modes on the 60-mode AS flagship (HK, comp32).

    python scripts/as_taylor_bench.py --ntraj 1048576 --nt 500

The headline bench (bench.py) keeps hessian_eval="stage" — its unit of
work is the reference RK4 loop. This measures the opt-in reduced-cost
PES sampling modes against it in ONE process. Prints one JSON line per
config.
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
    ap.add_argument("--ntraj", type=int, default=1048576)
    ap.add_argument("--nt", type=int, default=500)
    ap.add_argument("--configs", default="stage:1,taylor:1,taylor:4,taylor:8")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    from __graft_entry__ import _as60_setup
    from semiclassical_jax.propagation.hk import _hk_scan_jit
    from semiclassical_jax.pytree import replace

    prop, pot = _as60_setup(ntraj=args.ntraj, dtype=jnp.float32,
                            traj_dtype="comp32")

    ref_c = None
    for spec in args.configs.split(","):
        mode, every_s = spec.split(":")
        every = int(every_s)
        p = replace(pot, hessian_eval=mode,
                    taylor_every=every if mode == "taylor" else 1)

        run = lambda: _hk_scan_jit(
            prop.params, prop._bc, p, prop.state,
            prop.trackers["prefactorC"],
            jnp.float64(0.0), jnp.float64(0.25), args.nt)

        t0 = time.time()
        carry, (cauto, kic, en) = run()
        c_host = np.asarray(jax.device_get(cauto.real))
        compile_s = time.time() - t0
        t0 = time.time()
        carry, (cauto, kic, en) = run()
        c_host = np.asarray(jax.device_get(cauto.real))
        wall = time.time() - t0
        assert np.isfinite(c_host).all()
        if mode == "stage":
            ref_c = c_host.copy()
        gap = (float(np.abs(c_host - ref_c).max() * prop._bc.weight_scale)
               if ref_c is not None else None)

        print(json.dumps({
            "bench": "as60_hk_step", "ntraj": args.ntraj, "nt": args.nt,
            "hessian_eval": mode, "taylor_every": every,
            "ms_per_step": round(1e3 * wall / args.nt, 3),
            "traj_steps_per_s": round(args.ntraj * args.nt / wall, 1),
            "compile_s": round(compile_s, 1),
            "max_dC_vs_stage": gap,
        }), flush=True)


if __name__ == "__main__":
    main()
