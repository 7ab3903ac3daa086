# coding: utf-8
"""GDML-driven HK dynamics step benchmark (coumarin, 51 cartesians).

    python scripts/gdml_dynamics_bench.py --ntraj 2048 --nt 100

The unit of work is the reference's production ML-PES dynamics loop
(reference cli.py:401-436 with MolecularGDMLPotential): one RK4 step =
4 batched sGDML energy/gradient/Hessian evaluations + the dense (n, d, d)
monodromy update + HK prefactor + both observables. Default precision is
the mixed mode (f64 E/grad + f32 Hessian via `hess_dtype`,
f64 trajectories, f32 algebra) — the configuration validated to 1e-4 in
tests/test_precision.py.

Prints one JSON line. Fixtures come from the read-only reference tree.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_DATA = "/root/reference/tests/DATA"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ntraj", type=int, default=2048)
    ap.add_argument("--nt", type=int, default=100)
    ap.add_argument("--f64", action="store_true",
                    help="full-f64 GDML instead of the "
                         "mixed hess_dtype mode")
    ap.add_argument("--taylor-every", type=int, default=1,
                    help="re-expansion window length (taylor mode)")
    ap.add_argument("--hessian-eval", choices=("stage", "step", "taylor"),
                    default="stage",
                    help="'step' = one midpoint Hessian per RK4 step, "
                         "frozen across the monodromy update (the sGDML "
                         "Hessian costs ~20x the gradient); 'taylor' = "
                         "ONE order-2 eval per step, stage forces from "
                         "the local quadratic expansion")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    from semiclassical_jax.io.fchk import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularGDMLPotential, minimize
    from semiclassical_jax.propagation import HermanKlukPropagator
    from semiclassical_jax.propagation.hk import _hk_scan_jit

    model = np.load(os.path.join(
        REF_DATA, "GDML",
        "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz"),
        allow_pickle=True)
    with open(os.path.join(REF_DATA, "Gaussian16", "coumarin_s1.fchk")) as f:
        exc = FormattedCheckpointFile(f)
    pot = MolecularGDMLPotential.create(
        model, exc, hess_dtype=None if args.f64 else jnp.float32,
        hessian_eval=args.hessian_eval, taylor_every=args.taylor_every)
    x0, Gamma0, zpe = exc.vibrational_groundstate()
    pot = minimize(pot, jnp.asarray(x0))

    prop = HermanKlukPropagator(Gamma0, Gamma0, dtype=jnp.float32,
                                traj_dtype=jnp.float64)
    prop.initial_conditions(x0, np.zeros_like(x0), Gamma0, ntraj=args.ntraj,
                            key=0, potential=pot)

    run = lambda: _hk_scan_jit(
        prop.params, prop._bc, pot, prop.state, prop.trackers["prefactorC"],
        jnp.float64(0.0), jnp.float64(0.1), args.nt)

    t0 = time.time()
    carry, (cauto, kic, en) = run()
    c_host = np.asarray(jax.device_get(cauto.real))
    compile_s = time.time() - t0

    t0 = time.time()
    carry, (cauto, kic, en) = run()
    c_host = np.asarray(jax.device_get(cauto.real))
    wall = time.time() - t0

    assert np.isfinite(c_host).all()
    print(json.dumps({
        "bench": "gdml_hk_step", "ntraj": args.ntraj, "nt": args.nt,
        "dim": int(pot.dimensions()),
        "mode": "f64" if args.f64 else "mixed(hess_dtype=f32)",
        "hessian_eval": args.hessian_eval,
        "taylor_every": args.taylor_every,
        "wall_s": round(wall, 3),
        "ms_per_step": round(1e3 * wall / args.nt, 2),
        "traj_steps_per_s": round(args.ntraj * args.nt / wall, 1),
        "pes_evals_per_s": round(4 * args.ntraj * args.nt / wall, 1),
        "compile_s": round(compile_s, 1),
        "c0": float(c_host[0]),
        "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
