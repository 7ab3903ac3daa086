# coding: utf-8
"""Variance reduction on the 60-mode AS flagship at production scale.

    python scripts/vr_flagship_bench.py --ntraj 65536 --nt 100 --keys 6

For each sampling method: run `keys` independent realizations (fresh
initial conditions, same physics), accumulate C(t)/k~ic(t), report the
across-key variance (mean over steps) and the sampling wall. Prints one
JSON line per method.
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
    ap.add_argument("--ntraj", type=int, default=65536)
    ap.add_argument("--nt", type=int, default=100)
    ap.add_argument("--keys", type=int, default=6)
    ap.add_argument("--methods", default="pseudo,sobol,antithetic")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    from semiclassical_jax.potentials import MorsePotential
    from semiclassical_jax.propagation import HermanKlukPropagator

    rng = np.random.default_rng(42)
    d = 60
    omega = rng.uniform(200.0, 3000.0, size=d) / 219474.63
    S = rng.uniform(0.01, 0.3, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    chi = np.full(d, 0.02)
    pot = MorsePotential.create(omega, chi, nac, dtype=jnp.float32)
    dQ = np.sqrt(2.0 * S / omega)
    Gamma = np.diag(omega)
    en0 = 0.0
    dt = 0.25

    for method in args.methods.split(","):
        cs, ks = [], []
        t_sample = 0.0
        t_scan = 0.0
        for key in range(args.keys):
            prop = HermanKlukPropagator(Gamma, Gamma, dtype=jnp.float32,
                                        traj_dtype="comp32")
            t0 = time.time()
            prop.initial_conditions(dQ, np.zeros(d), Gamma,
                                    ntraj=args.ntraj, key=1000 + key,
                                    potential=pot, sampling_method=method)
            t_sample += time.time() - t0
            t0 = time.time()
            c, k = prop.propagate(pot, dt, args.nt, energy0_es=en0,
                                  check_energy=False)
            t_scan += time.time() - t0
            cs.append(np.asarray(c))
            ks.append(np.asarray(k))
        cs = np.stack(cs)
        ks = np.stack(ks)
        print(json.dumps({
            "bench": "vr_flagship", "method": method,
            "ntraj": args.ntraj, "nt": args.nt, "keys": args.keys,
            "var_C": float(np.mean(np.var(cs, axis=0))),
            "var_kic": float(np.mean(np.var(ks, axis=0))),
            "mean_absC_final": float(np.mean(np.abs(cs[:, -1]))),
            "sample_s_per_rep": round(t_sample / args.keys, 3),
            "scan_s_per_rep": round(t_scan / args.keys, 3),
            "device": str(jax.devices()[0]),
        }), flush=True)


if __name__ == "__main__":
    main()
