# coding: utf-8
"""Multi-GPU flagship benchmark: the multi-device THROUGHPUT number
(correctness is covered by the CPU-mesh gates, the dry run and
`chip_smoke.py --four`).

    # all local GPUs of one host, one process:
    python scripts/pod_bench.py --ntraj-per-chip 524288

    # several hosts: launch one process per host with
    #   --coordinator host0:port --num-processes N --process-id k
    # (jax.distributed; the mesh then spans every host's GPUs)

    # smoke test without hardware (8 virtual CPU devices):
    JAX_PLATFORMS="" python scripts/pod_bench.py --virtual 8 \
        --ntraj-per-chip 256 --nt 10

The ensemble axis is the data-parallel axis (SURVEY §2.2): trajectories
shard over the `traj` mesh, parameter packs replicate, and the per-step
observable reductions lower to psum (NCCL). Weak-scaling metric:
traj-steps/s/chip should stay ~flat as chips are added (the only
cross-chip traffic is two psum'd scalars per step).
"""

import argparse
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ntraj-per-chip", type=int, default=524288)
    ap.add_argument("--nt", type=int, default=500)
    ap.add_argument("--propagator", default="HK", choices=["HK", "WM"])
    ap.add_argument("--virtual", type=int, default=0,
                    help="use N virtual CPU devices (smoke test)")
    ap.add_argument("--coordinator", default="")
    ap.add_argument("--num-processes", type=int, default=0)
    ap.add_argument("--process-id", type=int, default=-1)
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        ).strip()
        import jax
        jax.config.update("jax_platforms", "cpu")
    else:
        import jax
        if args.coordinator:
            jax.distributed.initialize(
                coordinator_address=args.coordinator,
                num_processes=args.num_processes,
                process_id=args.process_id)
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()
    jax.config.update("jax_enable_x64", True)
    from semiclassical_jax.parallel import ensemble_mesh
    from semiclassical_jax.potentials import MorsePotential
    from semiclassical_jax.propagation import (HermanKlukPropagator,
                                               WaltonManolopoulosPropagator)

    devices = jax.devices()
    nchips = len(devices)
    mesh = ensemble_mesh(devices)
    ntraj = args.ntraj_per_chip * nchips
    on_gpu = devices[0].platform == "gpu"

    rng = np.random.default_rng(42)
    d = 60
    omega = rng.uniform(200.0, 3000.0, size=d) / 219474.63
    S = rng.uniform(0.01, 0.3, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    chi = np.full(d, 0.02)
    algebra = jnp.float32 if on_gpu else jnp.float64
    pot = MorsePotential.create(omega, chi, nac, dtype=algebra)
    dQ = np.sqrt(2.0 * S / omega)
    Gamma = np.diag(omega)

    if args.propagator == "WM":
        prop = WaltonManolopoulosPropagator(
            Gamma, Gamma, 1e4, 1e4, dtype=algebra,
            traj_dtype="comp32" if on_gpu else None)
    else:
        prop = HermanKlukPropagator(
            Gamma, Gamma, dtype=algebra,
            traj_dtype="comp32" if on_gpu else None)
    prop.initial_conditions(dQ, np.zeros(d), Gamma, ntraj=ntraj, key=0,
                            potential=pot, mesh=mesh)

    en0 = 0.0
    dt = 0.25
    # warm/compile
    c, k = prop.propagate(pot, dt, args.nt, energy0_es=en0,
                          check_energy=False)
    t0 = time.time()
    c, k = prop.propagate(pot, dt, args.nt, energy0_es=en0,
                          check_energy=False)
    np.asarray(c.real)
    wall = time.time() - t0
    assert np.isfinite(c).all()

    print(json.dumps({
        "bench": "pod_flagship", "propagator": args.propagator,
        "nchips": nchips, "ntraj": ntraj, "nt": args.nt,
        "traj_steps_per_s": round(ntraj * args.nt / wall, 1),
        "traj_steps_per_s_per_chip": round(ntraj * args.nt / wall / nchips,
                                           1),
        "wall_s": round(wall, 3),
        "devices": [str(x) for x in devices[:4]]
        + (["..."] if nchips > 4 else []),
    }), flush=True)


if __name__ == "__main__":
    main()
