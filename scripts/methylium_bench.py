# coding: utf-8
"""Molecular-harmonic dynamics step benchmark (methylium, 12 cartesians):
RK4 (constant-Hessian T-map branch) vs integrator="exact" (the expm/Van
Loan affine map — zero time-discretization error at any dt).

    python scripts/methylium_bench.py --ntraj 32768 --nt 100

One process, one JSON line per config.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EXAMPLES = "/root/reference/tests/DATA/examples/methylium_AH"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ntraj", type=int, default=32768)
    ap.add_argument("--nt", type=int, default=100)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    from semiclassical_jax.io.fchk import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularHarmonicPotential
    from semiclassical_jax.propagation import HermanKlukPropagator
    from semiclassical_jax.pytree import replace

    with open(os.path.join(EXAMPLES, "opt_freq_s0.fchk")) as f:
        s0 = FormattedCheckpointFile(f)
    with open(os.path.join(EXAMPLES, "opt_freq_s1.fchk")) as f:
        s1 = FormattedCheckpointFile(f)
    pot = MolecularHarmonicPotential.from_fchk(s0, s1)
    # the CLI's mixed-mode contraction dtype
    pot = replace(pot, contract_dtype="float32")
    x0, Gamma0, zpe = s1.vibrational_groundstate()

    dt = 0.005 / 0.02418884254  # production 0.005 fs in a.u.

    results = {}
    c_ref = None
    for integrator in ("rk4", "exact"):
        prop = HermanKlukPropagator(Gamma0, Gamma0, dtype=jnp.float32,
                                    traj_dtype=jnp.float64,
                                    integrator=integrator)
        prop.initial_conditions(x0, np.zeros_like(x0), Gamma0,
                                ntraj=args.ntraj, key=0, potential=pot)

        run = lambda: prop._scan(pot, dt, args.nt)
        t0 = time.time()
        carry, outs = run()
        c_host = np.asarray(jax.device_get(outs[0].real))
        compile_s = time.time() - t0
        t0 = time.time()
        carry, outs = run()
        c_host = np.asarray(jax.device_get(outs[0].real))
        wall = time.time() - t0
        assert np.isfinite(c_host).all()
        if integrator == "rk4":
            c_ref = c_host.copy()
        gap = float(np.abs(c_host - c_ref).max()) if c_ref is not None else 0

        print(json.dumps({
            "bench": "methylium_hk_step", "ntraj": args.ntraj,
            "nt": args.nt, "integrator": integrator,
            "ms_per_step": round(1e3 * wall / args.nt, 3),
            "traj_steps_per_s": round(args.ntraj * args.nt / wall, 1),
            "compile_s": round(compile_s, 1),
            "max_dC_vs_rk4_devunits": gap,
        }), flush=True)


if __name__ == "__main__":
    main()
