# coding: utf-8
"""O(n^2) pairwise-norm timing at production scale (60-mode AS, HK).

    python scripts/norm_bench.py --ntraj 131072 --block 4096

The block loop runs as one jitted device-side lax.map over the Hermitian
block-pair grid (hk.blocked_pair_sum). Prints one JSON line.
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
    ap.add_argument("--ntraj", type=int, default=131072)
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--nt", type=int, default=10,
                    help="steps to propagate before measuring (t > 0 norm)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    from __graft_entry__ import _as60_setup
    from semiclassical_jax.propagation.hk import pairwise_norm

    prop, pot = _as60_setup(ntraj=args.ntraj, dtype=jnp.float32,
                            traj_dtype="comp32")
    prop.propagate(pot, 0.25, args.nt, energy0_es=0.0, check_energy=False)
    v = prop.coefficients()

    t0 = time.time()
    norm = pairwise_norm(prop.params.csott, prop.state.q, prop.state.p, v,
                         block=args.block)
    first_s = time.time() - t0    # includes compile
    t0 = time.time()
    norm = pairwise_norm(prop.params.csott, prop.state.q, prop.state.p, v,
                         block=args.block)
    wall = time.time() - t0

    print(json.dumps({
        "bench": "pairwise_norm", "ntraj": args.ntraj, "block": args.block,
        "norm": round(norm, 6),
        "wall_s": round(wall, 3),
        "first_s_incl_compile": round(first_s, 1),
        "block_pairs": (args.ntraj // args.block) ** 2 // 2
        + (args.ntraj // args.block) // 2,
        "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
