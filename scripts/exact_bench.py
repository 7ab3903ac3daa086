# coding: utf-8
"""Accuracy + throughput comparison: exact Morse map vs RK4 (comp32).

Runs the 60-mode AS HK benchmark configuration twice with identical
sampling (same key): once with the comp32 RK4 integrator (the default
precision mode for this model) and once with the exact closed-form map,
and reports

* per-step wall time / traj-steps/s at the requested batch size,
* max |C_exact(t) - C_rk4(t)| over the horizon (the two differ by RK4's
  truncation + accumulation error only — the map is exact),
* optionally a small-batch f64-CPU exact run as the accuracy anchor.

Usage: python scripts/exact_bench.py [ntraj] [nt]
Env:   EB_PROP=HK|WM  EB_MODE=comp32|mixed
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    import jax.numpy as jnp

    from __graft_entry__ import _as60_setup

    ntraj = int(sys.argv[1]) if len(sys.argv) > 1 else 524288
    nt = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    mode = os.environ.get("EB_MODE", "comp32")
    dt = 0.25
    traj_dtype = "comp32" if mode == "comp32" else jnp.float64

    results = {}
    for integ in ("rk4", "exact"):
        prop, pot = _as60_setup(ntraj=ntraj, dtype=jnp.float32,
                                traj_dtype=traj_dtype, integrator=integ)
        import copy
        # build the exact-map pack + initial carry NOW, outside every timed
        # window (the emulated-f64 setup + host eps fetch cost ~0.3-1 s at
        # 524k; leaving _integ_carry=None in the snapshot would put that
        # re-setup inside the timed run and inflate the exact ms/step)
        if integ == "exact":
            prop._integ(pot, dt)
        snap = (prop.state, copy.copy(prop.trackers), prop.t,
                prop._integ_carry, prop._integ_state_ref)
        t0 = time.time()
        c, k = prop.propagate(pot, dt, nt, check_energy=False)
        compile_s = time.time() - t0
        (prop.state, prop.trackers, prop.t, prop._integ_carry,
         prop._integ_state_ref) = snap
        t0 = time.time()
        c, k = prop.propagate(pot, dt, nt, check_energy=False)
        wall = time.time() - t0
        assert np.isfinite(c).all()
        results[integ] = (c, k, wall)
        print(f"{integ:6s}: {wall * 1e3 / nt:8.3f} ms/step  "
              f"{ntraj * nt / wall / 1e6:8.2f}M traj-steps/s  "
              f"(compile {compile_s:.1f}s)")

    c_r, k_r, w_r = results["rk4"]
    c_e, k_e, w_e = results["exact"]
    gap = np.abs(c_e - c_r)
    print(f"max |C_exact - C_rk4|  = {gap.max():.3e}  "
          f"(MC noise floor ~{1.0 / np.sqrt(ntraj):.1e})")
    idx = [0, nt // 10, nt // 2, nt - 1]
    print("gap(t) profile:", {i: f"{gap[i]:.2e}" for i in idx})
    print(f"max |k_exact - k_rk4|/max|k| = "
          f"{np.abs(k_e - k_r).max() / np.abs(k_r).max():.3e}")
    print(f"speedup: {w_r / w_e:.2f}x")


if __name__ == "__main__":
    main()
