# coding: utf-8
"""Isolate the cost of the taylor-mode GDML step pieces (coumarin, 2048).

    python scripts/gdml_taylor_probe.py --ntraj 2048 --nt 50

Pieces, each one scan (one dispatch):
  o2        order-2 mixed eval alone
  o2+loc    + the 4 local-quadratic stage forces (no monodromy)
  rk4       full taylor rk4_step (trajectories + monodromy, no observables)
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
    ap.add_argument("--nt", type=int, default=50)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    from semiclassical_jax.gdml import GDMLParams, gdml_forward
    from semiclassical_jax.io.fchk import FormattedCheckpointFile
    from semiclassical_jax.potentials import MolecularGDMLPotential
    from semiclassical_jax.propagation.eom import rk4_step
    from semiclassical_jax.propagation.state import TrajState

    model = np.load(os.path.join(
        REF_DATA, "GDML",
        "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz"),
        allow_pickle=True)
    params = GDMLParams.from_npz(model, dtype=jnp.float64)
    with open(os.path.join(REF_DATA, "Gaussian16", "coumarin_s1.fchk")) as f:
        exc = FormattedCheckpointFile(f)
    x0 = np.asarray(exc["Current cartesian coordinates"], dtype=np.float64)
    d = x0.shape[0]

    pot = MolecularGDMLPotential(
        gdml=params,
        nac0=jnp.asarray(np.random.default_rng(1).uniform(-1, 1, size=d)),
        mass=jnp.asarray(exc.masses()),
        origin=jnp.asarray(0.0),
        hess_dtype="float32",
        hessian_eval="taylor",
    )

    rng = np.random.default_rng(0)
    n = args.ntraj
    q0 = jnp.asarray(x0[None, :] + 0.02 * rng.standard_normal((n, d)))
    p0 = jnp.asarray(5.0 * rng.standard_normal((n, d)))
    eye = jnp.broadcast_to(jnp.eye(d, dtype=jnp.float32), (n, d, d))
    state0 = TrajState(q=q0, p=p0, Mqq=eye, Mqp=jnp.zeros_like(eye),
                       Mpq=jnp.zeros_like(eye), Mpp=eye,
                       S=jnp.zeros(n))

    results = {"bench": "gdml_taylor_probe", "ntraj": n, "nt": args.nt}

    def timed(name, body, init):
        def f(c, _):
            return body(c), None

        @jax.jit
        def run(c0):
            c, _ = jax.lax.scan(f, c0, None, length=args.nt)
            return c

        c = run(init)
        np.asarray(jax.tree_util.tree_leaves(c)[0])
        t0 = time.time()
        c = run(init)
        np.asarray(jax.tree_util.tree_leaves(c)[0])
        results[name + "_ms"] = round(1e3 * (time.time() - t0) / args.nt, 3)

    inv_m = 1.0 / np.asarray(exc.masses())

    # o2: the order-2 eval alone
    def o2(c):
        q, p = c
        q_mid = q + 0.05 * (p * inv_m[None, :])
        v, g, h = gdml_forward(params, q_mid, order=2,
                               hess_dtype=jnp.float32)
        return (q + 1e-9 * g, p + 1e-12 * jnp.sum(h, axis=2).astype(p.dtype))

    timed("o2", o2, (q0, p0))

    # o2 + the 4 local quadratic stage forces (no monodromy update)
    def o2loc(c):
        q, p = c
        dt = 0.1
        q_mid = q + 0.5 * dt * (p * inv_m[None, :])
        v, g, H = gdml_forward(params, q_mid, order=2,
                               hess_dtype=jnp.float32)
        Hm = H

        def vg(qs):
            delta = (qs - q_mid).astype(jnp.float32)
            hd = jnp.einsum("nag,ng->na", Hm, delta)
            vv = v + jnp.sum((g.astype(jnp.float32) + 0.5 * hd) * delta,
                             axis=1).astype(v.dtype)
            return vv, g + hd.astype(g.dtype)

        def stage(qs, ps):
            vv, gg = vg(qs)
            return (ps * inv_m[None, :], -gg)

        k1 = stage(q, p)
        k2 = stage(q + 0.5 * dt * k1[0], p + 0.5 * dt * k1[1])
        k3 = stage(q + 0.5 * dt * k2[0], p + 0.5 * dt * k2[1])
        k4 = stage(q + dt * k3[0], p + dt * k3[1])
        nq = q + dt / 6 * (k1[0] + 2 * (k2[0] + k3[0]) + k4[0])
        np_ = p + dt / 6 * (k1[1] + 2 * (k2[1] + k3[1]) + k4[1])
        return (nq, np_)

    timed("o2_loc", o2loc, (q0, p0))

    # full taylor rk4_step (no observables)
    def full(c):
        st, _ = rk4_step(c[0], pot, 0.1)
        return (st, c[1])

    timed("rk4_taylor", full, (state0, jnp.zeros(())))

    # reference point: step-mode rk4_step (4 grads + 1 hess)
    from semiclassical_jax.pytree import replace
    pot_step = replace(pot, hessian_eval="step")

    def full_step(c):
        st, _ = rk4_step(c[0], pot_step, 0.1)
        return (st, c[1])

    timed("rk4_step", full_step, (state0, jnp.zeros(())))

    results["device"] = str(jax.devices()[0])
    print(json.dumps(results))


if __name__ == "__main__":
    main()
