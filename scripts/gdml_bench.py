# coding: utf-8
"""sGDML predictor throughput: batched energy + gradient + analytic
Hessian (the reference's own headline: ~10,000 medium-sized molecules/s for
E+grad+Hess on a GPU, reference gdml_predictor.py:51-53).

    python scripts/gdml_bench.py [--batch 4096] [--order 2]

Uses the coumarin model fixture (51 cartesian coords, 200 training points
x symmetry permutations).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

MODEL = ("/root/reference/tests/DATA/GDML/"
         "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
GEOM = "/root/reference/tests/DATA/Gaussian16/coumarin_s0.fchk"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--order", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dtype", default="float32")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    from semiclassical_jax.gdml import GDMLParams, gdml_forward
    from semiclassical_jax.io.fchk import FormattedCheckpointFile

    # "mixed" = f64 pack (exact energies/gradients) + f32 Hessian
    dtype = jnp.float32 if args.dtype == "float32" else jnp.float64
    hess_dtype = jnp.float32 if args.dtype == "mixed" else None
    model = np.load(MODEL, allow_pickle=True)
    params = GDMLParams.from_npz(model, dtype=dtype)
    with open(GEOM) as f:
        fchk = FormattedCheckpointFile(f)
    x0 = np.asarray(fchk["Current cartesian coordinates"], dtype=np.float64)

    rng = np.random.default_rng(0)
    r = jnp.asarray(x0[None, :] + 0.02 * rng.standard_normal(
        (args.batch, x0.shape[0])), dtype)

    fwd = jax.jit(lambda r: gdml_forward(params, r, order=args.order,
                                         hess_dtype=hess_dtype))

    out = jax.block_until_ready(fwd(r))
    t0 = time.time()
    for _ in range(args.iters):
        out = fwd(r)
    jax.block_until_ready(out)
    wall = time.time() - t0

    print(json.dumps({
        "batch": args.batch, "order": args.order, "dtype": args.dtype,
        "molecules_per_s": round(args.batch * args.iters / wall, 1),
        "ms_per_batch": round(1e3 * wall / args.iters, 2),
        "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
