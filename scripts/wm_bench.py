# coding: utf-8
"""Single-chip WM step benchmark (60-mode AS flagship config).

    python scripts/wm_bench.py --ntraj 8192 --nt 20

Prints one JSON line. Timing forces a host fetch (np.asarray).
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
    ap.add_argument("--ntraj", type=int, default=8192)
    ap.add_argument("--nt", type=int, default=20)
    ap.add_argument("--alpha", type=float, default=10000.0)
    ap.add_argument("--impl", default="")
    ap.add_argument("--traj", default="float64",
                    choices=["float64", "comp32"],
                    help="trajectory mode: f64 (mixed) or compensated f32")
    ap.add_argument("--profile_dir", default="")
    ap.add_argument("--micro", type=int, default=0,
                    help="device-side micro-batch size (lax.map over "
                         "sub-batches inside one dispatch; 0 = monolithic)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    if args.impl:
        from semiclassical_jax import linalg
        linalg.set_linalg_impl(args.impl)

    from semiclassical_jax.potentials import MorsePotential
    from semiclassical_jax.propagation import WaltonManolopoulosPropagator
    from semiclassical_jax.propagation.wm import (_wm_scan_jit,
                                                  _wm_scan_micro_jit)

    rng = np.random.default_rng(42)
    d = 60
    omega = rng.uniform(200.0, 3000.0, size=d) / 219474.63
    S = rng.uniform(0.01, 0.3, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    chi = np.full(d, 0.02)
    pot = MorsePotential.create(omega, chi, nac, dtype=jnp.float64)
    # the CLI casts model potentials to the algebra dtype in the mixed
    # mode (cli.py) so the per-stage Morse exp runs native f32 — match it
    pot = jax.tree.map(lambda x: x.astype(jnp.float32), pot)
    dQ = np.sqrt(2.0 * S / omega)
    Gamma = np.diag(omega)

    traj_dtype = jnp.float64 if args.traj == "float64" else "comp32"
    prop = WaltonManolopoulosPropagator(Gamma, Gamma, args.alpha, args.alpha,
                                        dtype=jnp.float32,
                                        traj_dtype=traj_dtype)
    prop.initial_conditions(dQ, np.zeros(d), Gamma, ntraj=args.ntraj, key=0,
                            potential=pot)

    trackers0 = (prop.trackers["prefactorC"], prop.trackers["detA"],
                 prop.trackers["detM"])
    if args.micro and args.ntraj % args.micro == 0 and args.ntraj > args.micro:
        k = args.ntraj // args.micro
        run = lambda: _wm_scan_micro_jit(
            prop.params, prop._bc, pot, prop.state, trackers0,
            jnp.float64(0.0), jnp.float64(0.25), args.nt, k)
    else:
        run = lambda: _wm_scan_jit(
            prop.params, prop._bc, pot, prop.state, trackers0,
            jnp.float64(0.0), jnp.float64(0.25), args.nt)

    t0 = time.time()
    carry, (cauto, kic, en) = run()
    c_host = np.asarray(jax.device_get(cauto.real))
    compile_s = time.time() - t0

    if args.profile_dir:
        jax.profiler.start_trace(args.profile_dir)
    t0 = time.time()
    carry, (cauto, kic, en) = run()
    c_host = np.asarray(jax.device_get(cauto.real))
    wall = time.time() - t0
    if args.profile_dir:
        jax.profiler.stop_trace()

    print(json.dumps({
        "bench": "wm_step", "ntraj": args.ntraj, "nt": args.nt,
        "micro": args.micro,
        "impl": args.impl or "auto", "traj": args.traj,
        "wall_s": round(wall, 3),
        "ms_per_step": round(1e3 * wall / args.nt, 2),
        "traj_steps_per_s": round(args.ntraj * args.nt / wall, 1),
        "compile_s": round(compile_s, 1),
        "c0": float(c_host[0]),
        "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
