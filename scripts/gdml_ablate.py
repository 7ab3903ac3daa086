# coding: utf-8
"""Where does the GDML dynamics step spend its time? (coumarin, 51 cartesians)

    python scripts/gdml_ablate.py --ntraj 2048 --nt 50

Measures, each inside a single lax.scan (one dispatch per number):

  * order-1 f64 E+grad eval              (the RK4 stage unit, x4 per step)
  * order-2 mixed E+grad+f32-Hessian     (the once-per-step unit in step mode)
  * full HK dynamics step, hessian_eval in {stage, step}

The difference order2 - order1 prices the Hessian assembly; 4*order1 +
(order2 - order1) vs the measured step prices the monodromy/prefactor rest.
Prints one JSON line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF_DATA = "/root/reference/tests/DATA"
MODEL = os.path.join(REF_DATA, "GDML",
                     "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
GEOM = os.path.join(REF_DATA, "Gaussian16", "coumarin_s1.fchk")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ntraj", type=int, default=2048)
    ap.add_argument("--nt", type=int, default=50)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    from semiclassical_jax.gdml import GDMLParams, gdml_forward
    from semiclassical_jax.io.fchk import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularGDMLPotential, minimize
    from semiclassical_jax.propagation import HermanKlukPropagator
    from semiclassical_jax.propagation.hk import _hk_scan_jit

    model = np.load(MODEL, allow_pickle=True)
    params = GDMLParams.from_npz(model, dtype=jnp.float64)
    with open(GEOM) as f:
        exc = FormattedCheckpointFile(f)
    x0 = np.asarray(exc["Current cartesian coordinates"], dtype=np.float64)

    rng = np.random.default_rng(0)
    r0 = jnp.asarray(x0[None, :] + 0.02 * rng.standard_normal(
        (args.ntraj, x0.shape[0])), jnp.float64)

    results = {"bench": "gdml_ablate", "ntraj": args.ntraj, "nt": args.nt}

    def timed_scan(name, body, init):
        """scan body(carry) -> carry, one dispatch, fetch to host to fence."""
        def f(carry, _):
            return body(carry), None

        @jax.jit
        def run(c0):
            c, _ = jax.lax.scan(f, c0, None, length=args.nt)
            return c

        c = run(init)                       # compile + warm
        np.asarray(jax.tree_util.tree_leaves(c)[0])
        t0 = time.time()
        c = run(init)
        np.asarray(jax.tree_util.tree_leaves(c)[0])
        wall = time.time() - t0
        results[name + "_ms"] = round(1e3 * wall / args.nt, 3)

    # --- order-1 f64 eval (the stage unit) ---
    def eval1(r):
        v, g = gdml_forward(params, r, order=1)
        return r + 1.0e-9 * g + 1.0e-12 * v[:, None]

    timed_scan("order1_f64", eval1, r0)

    # --- order-2 mixed eval (the step-mode Hessian unit) ---
    def eval2(r):
        v, g, h = gdml_forward(params, r, order=2, hess_dtype=jnp.float32)
        return (r + 1.0e-9 * g + 1.0e-12 * v[:, None]
                + 1.0e-12 * jnp.sum(h, axis=2).astype(r.dtype))

    timed_scan("order2_mixed", eval2, r0)

    # --- full dynamics step, both hessian_eval modes ---
    x0j, Gamma0, zpe = exc.vibrational_groundstate()
    for mode in ("stage", "step", "taylor"):
        pot = MolecularGDMLPotential.create(
            model, exc, hess_dtype=jnp.float32, hessian_eval=mode)
        pot = minimize(pot, jnp.asarray(x0j))
        prop = HermanKlukPropagator(Gamma0, Gamma0, dtype=jnp.float32,
                                    traj_dtype=jnp.float64)
        prop.initial_conditions(x0j, np.zeros_like(x0j), Gamma0,
                                ntraj=args.ntraj, key=0, potential=pot)
        run = lambda: _hk_scan_jit(
            prop.params, prop._bc, pot, prop.state,
            prop.trackers["prefactorC"],
            jnp.float64(0.0), jnp.float64(0.1), args.nt)
        carry, (cauto, kic, en) = run()
        np.asarray(jax.device_get(cauto.real))
        t0 = time.time()
        carry, (cauto, kic, en) = run()
        c_host = np.asarray(jax.device_get(cauto.real))
        wall = time.time() - t0
        assert np.isfinite(c_host).all()
        results[f"dyn_{mode}_ms"] = round(1e3 * wall / args.nt, 3)
        results[f"dyn_{mode}_tsps"] = round(args.ntraj * args.nt / wall, 1)

    o1 = results["order1_f64_ms"]
    o2 = results["order2_mixed_ms"]
    results["hessian_block_ms"] = round(o2 - o1, 3)
    results["model_4g1h_ms"] = round(4 * o1 + (o2 - o1), 3)
    results["device"] = str(jax.devices()[0])
    print(json.dumps(results))


if __name__ == "__main__":
    main()
