# coding: utf-8
"""Break down the bench `sample` phase at the 1M flagship shape.

    python scripts/sample_profile.py --ntraj 1048576

Times each stage of HermanKlukPropagator.initial_conditions separately
(one host fetch per stage as the timing fence). Prints one JSON line.
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
    ap.add_argument("--method", default="pseudo")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()
    from __graft_entry__ import _as60_setup
    from semiclassical_jax import sampling as smod
    from semiclassical_jax.propagation import hk as hkmod
    from semiclassical_jax.propagation.state import TrajState

    import gc

    out = {"bench": "sample_profile", "ntraj": args.ntraj,
           "method": args.method}

    # one full setup at the target shape: cold then warm wall, then FREE
    # it — a persistent 1M state plus the stage temporaries OOMs the chip
    t0 = time.time()
    prop, pot = _as60_setup(ntraj=args.ntraj, dtype=jnp.float32,
                            traj_dtype="comp32")
    out["full_cold_s"] = round(time.time() - t0, 3)
    del prop
    gc.collect()
    t0 = time.time()
    prop, _ = _as60_setup(ntraj=args.ntraj, dtype=jnp.float32,
                          traj_dtype="comp32")
    out["full_warm_s"] = round(time.time() - t0, 3)
    del prop
    gc.collect()

    # small setup: only the (tiny) parameter packs are kept
    small, _ = _as60_setup(ntraj=1024, dtype=jnp.float32,
                           traj_dtype="comp32")
    sampling, params = small.sampling, small.params
    del small
    gc.collect()
    key = jax.random.key(0)

    def fence(x):
        leaf = jax.tree_util.tree_leaves(x)[0]
        if getattr(leaf, "ndim", 0) > 0:
            np.asarray(leaf[:1])     # device fetch = timing fence
        # host floats (sampling_statistics) are already synced

    def timed(name, fn):
        r = fn(); fence(r)              # warm/compile
        del r
        gc.collect()
        t0 = time.time()
        r = fn(); fence(r)
        out[name + "_s"] = round(time.time() - t0, 3)
        return r

    draw = jax.jit(lambda k: smod.sample_initial_conditions(
        sampling, k, args.ntraj, method=args.method))
    qi, pi, prob = timed("draw_transform_logprob", lambda: draw(key))

    timed("sampling_statistics",
          lambda: smod.sampling_statistics(sampling, qi, pi))

    bc = timed("batch_constants",
               lambda: hkmod.hk_batch_constants(params, qi, pi, prob,
                                                potential=pot))
    del bc
    gc.collect()

    timed("state_init",
          lambda: TrajState.initial(qi, pi, dtype=None,
                                    mono_dtype=jnp.float32,
                                    diag_monodromy=True, compensated=True))

    out["device"] = str(jax.devices()[0])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
