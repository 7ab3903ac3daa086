# coding: utf-8
"""WM-GDML dynamics throughput in ONE process (cf. gdml_final_bench.py).

The reference's own gdml recipe runs the WM propagator (its README
hard-codes alpha = beta = 1e4); this measures the WM dense path on
the coumarin fixture across hessian_eval modes / taylor windows /
micro-batch sizes, steady-state (repeat propagate() calls in-process:
the first call pays executable deserialization + first dispatch).

    python scripts/wm_gdml_bench.py --configs "2048:taylor:8:1024,..."
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
    ap.add_argument("--nt", type=int, default=100)
    ap.add_argument("--configs", default=(
        "2048:stage:1,2048:taylor:1,2048:taylor:8,2048:taylor:8:1024,"
        "8192:taylor:8:1024"))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    from semiclassical_jax.io.fchk import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularGDMLPotential, minimize
    from semiclassical_jax.propagation import WaltonManolopoulosPropagator
    from semiclassical_jax.pytree import replace

    t_setup = time.time()
    model = np.load(os.path.join(
        REF_DATA, "GDML",
        "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz"),
        allow_pickle=True)
    with open(os.path.join(REF_DATA, "Gaussian16", "coumarin_s1.fchk")) as f:
        exc = FormattedCheckpointFile(f)
    base_pot = MolecularGDMLPotential.create(
        model, exc, hess_dtype=jnp.float32, hessian_eval="taylor")
    x0, Gamma0, zpe = exc.vibrational_groundstate()
    base_pot = minimize(base_pot, jnp.asarray(x0))
    dt = 0.005 / 0.02418884326505  # the production 0.005 fs step in au
    print(json.dumps({"setup_s": round(time.time() - t_setup, 1)}),
          flush=True)

    props = {}

    def get_prop(ntraj):
        if ntraj not in props:
            prop = WaltonManolopoulosPropagator(
                Gamma0, Gamma0, 1e4, 1e4, dtype=jnp.float32,
                traj_dtype=jnp.float64)
            prop.initial_conditions(x0, np.zeros_like(x0), Gamma0,
                                    ntraj=ntraj, key=0, potential=base_pot)
            props[ntraj] = prop
        return props[ntraj]

    for spec in args.configs.split(","):
        parts = spec.split(":")
        ntraj_s, mode, every_s = parts[:3]
        micro = int(parts[3]) if len(parts) > 3 else 0
        ntraj, every = int(ntraj_s), int(every_s)
        pot = replace(base_pot, hessian_eval=mode,
                      taylor_every=every if mode == "taylor" else 1)
        prop = get_prop(ntraj)
        prop.micro_batch = micro or 0

        t0 = time.time()
        c, k = prop.propagate(pot, dt, args.nt, energy0_es=zpe,
                              chunk=args.nt)
        np.asarray(c)
        compile_s = time.time() - t0
        t0 = time.time()
        c, k = prop.propagate(pot, dt, args.nt, energy0_es=zpe,
                              chunk=args.nt)
        c_host = np.asarray(c)
        wall = time.time() - t0
        assert np.isfinite(c_host).all()

        print(json.dumps({
            "bench": "gdml_wm_step", "ntraj": ntraj, "nt": args.nt,
            "hessian_eval": mode, "taylor_every": every, "micro": micro,
            "ms_per_step": round(1e3 * wall / args.nt, 2),
            "traj_steps_per_s": round(ntraj * args.nt / wall, 1),
            "compile_s": round(compile_s, 1),
        }), flush=True)


if __name__ == "__main__":
    main()
