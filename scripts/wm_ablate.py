# coding: utf-8
"""Phase-level timing of the WM scan fast path.

    python scripts/wm_ablate.py --ntraj 8192 --nt 20

Each phase runs `nt` times inside ONE jitted lax.scan (per-call dispatch
would dominate standalone per-step timing). A tiny per-iteration
perturbation of q defeats CSE. Complex parameter packs flow as jit
arguments (package numerics contract: no complex closure constants).
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
    ap.add_argument("--ntraj", type=int, default=8192)
    ap.add_argument("--nt", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax import lax

    from semiclassical_jax.hostcache import use_compile_cache

    use_compile_cache()

    from semiclassical_jax.potentials import MorsePotential
    from semiclassical_jax.propagation import WaltonManolopoulosPropagator
    from semiclassical_jax.propagation.eom import rk4_step
    from semiclassical_jax.propagation.hk import hk_prefactor_det
    from semiclassical_jax.propagation.wm import (wm_scan_derived,
                                                  wm_scan_observables)
    from semiclassical_jax.pytree import replace

    rng = np.random.default_rng(42)
    d = 60
    omega = rng.uniform(200.0, 3000.0, size=d) / 219474.63
    S = rng.uniform(0.01, 0.3, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    chi = np.full(d, 0.02)
    pot = MorsePotential.create(omega, chi, nac, dtype=jnp.float64)
    # match the CLI's mixed-mode cast — without it rk4's PES runs emulated
    # f64 (~57 ms of phantom cost at 524k; CLAUDE.md WM bench rule)
    pot = jax.tree.map(lambda x: x.astype(jnp.float32), pot)
    dQ = np.sqrt(2.0 * S / omega)
    Gamma = np.diag(omega)

    prop = WaltonManolopoulosPropagator(Gamma, Gamma, 10000.0, 10000.0,
                                        dtype=jnp.float32,
                                        traj_dtype=jnp.float64)
    prop.initial_conditions(dQ, np.zeros(d), Gamma, ntraj=args.ntraj, key=0,
                            potential=pot)
    params, bc, state0 = prop.params, prop._bc, prop.state
    nt = args.nt

    def scan_time(name, body, base_ms=0.0):
        """body(params, bc, state) -> cheap real scalar; scanned nt times
        on the genuinely rk4-evolved state (a static state would let XLA
        hoist every monodromy-dependent op out of the loop). Reported time
        subtracts `base_ms` (the rk4-only baseline)."""
        @jax.jit
        def run(params, bc, state):
            def step(carry, i):
                st, acc = carry
                out = jnp.sum(body(params, bc, st))
                st, _en = rk4_step(st, pot, 0.25)
                return (st, acc + out), None
            (st, acc), _ = lax.scan(
                step, (state, jnp.float32(0.0)),
                jnp.arange(nt, dtype=state.q.dtype))
            return acc

        acc = run(params, bc, state0)
        _ = np.asarray(acc)
        ts = []
        for _i in range(args.reps):
            t0 = time.time()
            acc = run(params, bc, state0)
            _ = np.asarray(acc)
            ts.append(time.time() - t0)
        ms = 1e3 * min(ts) / nt - base_ms
        print(json.dumps({"phase": name, "ms_per_step": round(ms, 2)}),
              flush=True)
        return ms

    def full_body(p, b, s):
        sd = wm_scan_derived(p, b, s, pot)
        ones = jnp.ones(s.q.shape[0], dtype=p.hk.cdtype)
        sg = jnp.ones(s.q.shape[0], dtype=p.Gt.dtype)
        ca, ki = wm_scan_observables(p, b, s, sd, ones, sg, sg)
        return jnp.abs(ca).astype(jnp.float32)

    # finer-grained sub-chains of wm_scan_derived: each body recomputes the
    # prefix (XLA CSE removes nothing across scan_time calls — they are
    # separate jits), so phase cost = this row minus the previous row
    from semiclassical_jax import linalg as _lin
    from semiclassical_jax.linalg import times_i
    from semiclassical_jax.units import hbar as _hbar

    def _chain(p, b, s, upto):
        rd = p.Gt.dtype
        cdtype = p.hk.cdtype
        Mqq = s.Mqq.astype(rd); Mqp = s.Mqp.astype(rd)
        Mpq = s.Mpq.astype(rd); Mpp = s.Mpp.astype(rd)
        MqqU1 = Mqq @ p.U1; MqpU2 = Mqp @ p.U2
        MpqU1 = Mpq @ p.U1; MppU2 = Mpp @ p.U2
        MqzUb = jnp.concatenate([MqqU1, MqpU2], axis=2)
        MpzUb = jnp.concatenate([MpqU1, MppU2], axis=2)
        T11 = jnp.einsum("nia,nib->nab", MpqU1, MqqU1)
        T12 = jnp.einsum("nia,nib->nab", MpqU1, MqpU2)
        T21 = jnp.einsum("nia,nib->nab", MppU2, MqqU1)
        T22 = jnp.einsum("nia,nib->nab", MppU2, MqpU2)
        T12t = jnp.swapaxes(T12, 1, 2); T22t = jnp.swapaxes(T22, 1, 2)
        imag_blk = jnp.concatenate([
            jnp.concatenate([T11, T12], axis=2),
            jnp.concatenate([2.0 * T21 - T12t, 2.0 * T22 - T22t], axis=2),
        ], axis=1)
        GtMqzUb = jnp.einsum("ij,njb->nib", p.Gt.astype(rd), MqzUb)
        sym_blk = jnp.einsum("nia,nib->nab", MqzUb, GtMqzUb)
        Ab = (p.A_const_b[None] + sym_blk.astype(cdtype)
              + times_i(imag_blk / _hbar))
        if upto == "Ab":
            return jnp.abs(Ab).sum().astype(jnp.float32)
        BQUb = GtMqzUb.astype(cdtype) + times_i(MpzUb / _hbar)
        U = p.hk.U.astype(rd)
        P = jnp.einsum("nia,ij->naj", BQUb, U)
        detA, Y = _lin.batched_det_solve_t(Ab, P)
        if upto == "Y":
            return (jnp.abs(detA).sum() + jnp.abs(Y).sum()).astype(jnp.float32)
        C2Y = jnp.einsum("ab,nbk->nak", p.C2b, Y)
        Mp = (p.M0.astype(cdtype)[None]
              - jnp.einsum("nak,nal->nkl", Y, P + C2Y))
        if upto == "Mp":
            return jnp.abs(Mp).sum().astype(jnp.float32)
        m_scale = p.m_scale.astype(rd)
        detM, iM_s = _lin.batched_det_inv(Mp / m_scale)
        iM = iM_s / m_scale
        if upto == "detM_iM":
            return (jnp.abs(detM).sum() + jnp.abs(iM).sum()).astype(jnp.float32)
        return jnp.abs(detM).sum().astype(jnp.float32)

    base = scan_time("rk4", lambda p, b, s: jnp.float32(0.0))
    scan_time("hk_prefactor_det", lambda p, b, s: jnp.sum(
        jnp.abs(hk_prefactor_det(p.hk, s)).astype(jnp.float32)), base)
    scan_time("chain:Ab", lambda p, b, s: _chain(p, b, s, "Ab"), base)
    scan_time("chain:+detsolveA(120)", lambda p, b, s: _chain(p, b, s, "Y"),
              base)
    scan_time("chain:+C2Y,Mp", lambda p, b, s: _chain(p, b, s, "Mp"), base)
    scan_time("chain:+detinvM(60)",
              lambda p, b, s: _chain(p, b, s, "detM_iM"), base)
    scan_time("detA_chain", lambda p, b, s: jnp.sum(
        jnp.abs(wm_scan_derived(p, b, s, pot).detA).astype(jnp.float32)),
        base)
    scan_time("detM_chain", lambda p, b, s: jnp.sum(
        jnp.abs(wm_scan_derived(p, b, s, pot).detM).astype(jnp.float32)),
        base)
    scan_time("derived+observables", full_body, base)

    def with_prec(prec, f):
        def g(p, b, s):
            with jax.default_matmul_precision(prec):
                return f(p, b, s)
        return g

    for prec in ("high", "default"):
        scan_time(f"derived+observables@{prec}",
                  with_prec(prec, full_body), base)

    # accuracy: detA/detM/gamma/cauto under lowered matmul precision vs
    # highest, same state (no scan, single call; complex fetched via planes)
    from semiclassical_jax.linalg import from_device

    def derived_vals(p, b, s, prec):
        with jax.default_matmul_precision(prec):
            sd = wm_scan_derived(p, b, s, pot)
            ones = jnp.ones(s.q.shape[0], dtype=p.hk.cdtype)
            sg = jnp.ones(s.q.shape[0], dtype=p.Gt.dtype)
            ca, ki = wm_scan_observables(p, b, s, sd, ones, sg, sg)
        return sd.detA, sd.detM, sd.gamma, ca

    # evolve a few steps so the monodromy is nontrivial
    def _evolve(s, k):
        def stp(c, _):
            ns, _en = rk4_step(c, pot, 0.25)
            return ns, None
        out, _ = lax.scan(stp, s, None, length=k)
        return out

    st = jax.jit(lambda s: _evolve(s, 10))(state0)
    fn = jax.jit(derived_vals, static_argnames=("prec",))
    ref = [np.asarray(from_device(x)) for x in fn(params, bc, st, "highest")]
    for prec in ("high", "default"):
        got = [np.asarray(from_device(x)) for x in fn(params, bc, st, prec)]
        rel = [float(np.abs(g - r).max() / np.abs(r).max())
               for g, r in zip(got, ref)]
        print(json.dumps({"accuracy_vs_highest": prec,
                          "rel_detA": rel[0], "rel_detM": rel[1],
                          "rel_gamma": rel[2], "rel_cauto": rel[3]}),
              flush=True)


if __name__ == "__main__":
    main()
