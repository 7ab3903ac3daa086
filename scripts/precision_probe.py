# coding: utf-8
"""Probe: C(t) accuracy of the trajectory-precision modes on the 60-mode
AS flagship config, identical sampling key (differences are pure rounding,
no Monte-Carlo noise).

Compares, over `--nt` steps at dt=0.25:
  f64 (CPU host run)        -- the accuracy anchor
  mixed (f32 algebra/f64 trajectories)
  float32 (everything f32)
  optional: comp32 (compensated-f32 trajectories), once implemented

Run one mode per process (the CPU anchor forces the CPU backend):

    python scripts/precision_probe.py --mode f64 --ntraj 2048 --nt 100
    python scripts/precision_probe.py --mode mixed --ntraj 2048 --nt 100
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", required=True,
                    choices=["f64", "mixed", "float32", "comp32"])
    ap.add_argument("--ntraj", type=int, default=2048)
    ap.add_argument("--nt", type=int, default=100)
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    import jax

    if args.mode == "f64":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from __graft_entry__ import _as60_setup
    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    kw = dict(
        f64=dict(dtype=jnp.float64),
        mixed=dict(dtype=jnp.float32, traj_dtype=jnp.float64),
        float32=dict(dtype=jnp.float32),
        comp32=dict(dtype=jnp.float32, traj_dtype="comp32"),
    )[args.mode]
    prop, pot = _as60_setup(ntraj=args.ntraj, **kw)
    cauto, kic = prop.propagate(pot, 0.25, args.nt, energy0_es=0.0,
                                check_energy=False)
    out = np.stack([np.asarray(cauto.real, dtype=np.float64),
                    np.asarray(cauto.imag, dtype=np.float64),
                    np.asarray(kic.real, dtype=np.float64),
                    np.asarray(kic.imag, dtype=np.float64)])
    path = args.out or f"/tmp/precision_probe_{args.mode}.npy"
    np.save(path, out)
    print(json.dumps({"mode": args.mode, "ntraj": args.ntraj, "nt": args.nt,
                      "abs_c_last": float(np.hypot(out[0, -1], out[1, -1])),
                      "saved": path}))


if __name__ == "__main__":
    main()
