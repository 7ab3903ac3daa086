# coding: utf-8
"""Newton's equations of motion for trajectories + monodromy matrices,
and the fixed-step RK4 integrator.

Capability parity with reference propagators.py:86-119 (RK4) and
propagators.py:296-398 (EquationsOfMotion). Differences by design:

* the derivative acts on the structured `TrajState` pytree via `tree_map`
  instead of a packed flat vector;
* the Hessian-monodromy products go through the potential's structured
  `HessianOp`, so separable potentials cost O(n d^2) instead of O(n d^3);
* each RK4 stage evaluates the potential once, exactly like the reference
  (4 PES evaluations per step — required for trajectory-level parity);
* potentials whose Hessian is far more expensive than the gradient (sGDML)
  may opt into `hessian_eval = "step"`: the trajectory block still takes
  all 4 gradient stages, but the Hessian is evaluated ONCE per step at the
  midpoint stage and held frozen across the monodromy update — the
  second-order (midpoint-Magnus) approximation of the time-ordered
  monodromy propagator, with O(dt^3 ||dH/dt||) local error. Trajectories
  (q, p, S) are bit-identical to the 4-stage mode; only the monodromy
  blocks (and through them the prefactor) carry the approximation;
* potentials whose every f64 evaluation is expensive (sGDML again: the
  energy/gradient regression sums carry ~1e11 alphas and NEED the f64
  path) may opt into `hessian_eval = "taylor"`: ONE order-2
  evaluation per step at the free-flight midpoint; the four RK4 stage
  forces come from the local quadratic expansion around it. This is RK4
  on the locally-harmonic PES — trajectories acquire an O(dt^2) global
  error (the stage-force error is O(|delta|^2 ||d3V||), |delta| = O(dt)),
  gated by a convergence test; the monodromy freezes the same midpoint
  Hessian as "step";
* the step is integrated in THREE independent subsystems that share the
  stage Hessians: the trajectory block (q, p, S) first, then the two
  monodromy pairs (Mqq, Mpq) and (Mqp, Mpp).  The pairs are genuinely
  decoupled (dMqq/dt = Mpq/m, dMpq/dt = -H Mqq, and likewise for the other
  pair; the Hessians depend only on the stage positions, which the
  trajectory block fixes) — so at most 8 monodromy-sized buffers are live
  at any point instead of 16, halving the peak-memory cost of the step and
  doubling the single-chip trajectory-batch ceiling;
* the batch-mean total energy <T + V> at the step start is returned for the
  post-scan energy-conservation check (the reference syncs it to the host
  every step, propagators.py:380-398).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

# Ablation switch for the per-window monodromy step map (default on). Read
# ONCE at import: expand() runs at trace time under jit, and the jit cache
# keys only on shapes/statics — a mid-process env toggle would silently keep
# the previously traced branch structure.
_WINDOW_MONO_MAP = os.environ.get("SEMI_WINDOW_MONO_MAP", "1") != "0"

from semiclassical_jax.potentials.base import (ConstHessian, DenseHessian,
                                               DiagHessian)
from semiclassical_jax.propagation.state import TrajState

__all__ = ["state_derivative", "rk4_step"]


def _comp_accumulate(x, c, inc):
    """One Neumaier-compensated accumulation step: returns (x', c') with
    x' + c' = x + c + inc to ~f64 accuracy using only f32 arithmetic.

    `c` carries the running residual (true value = x + c). The incoming
    residual is folded into the increment (|inc + c| stays far below |x|
    for integrator-sized increments), then a branch-free exact two-sum
    (Knuth) splits x + y into the rounded sum and its exact error. XLA
    preserves IEEE float semantics under jit, so the cancellation pattern
    is not optimized away."""
    y = inc + c
    t = x + y
    yv = t - x            # the part of y that made it into t
    xv = t - yv           # the part of x that made it into t
    r = (x - xv) + (y - yv)
    return t, r


def state_derivative(state: TrajState, potential):
    """dy/dt for the combined (q, p, M, S) system.

        dq/dt = p / m
        dp/dt = -grad V
        dMqq/dt = Mpq / m        dMqp/dt = Mpp / m
        dMpq/dt = -H Mqq         dMpp/dt = -H Mqp
        dS/dt = T - V

    (reference propagators.py:342-368)

    Returns (dstate, mean_energy) where mean_energy = <T + V> over the batch.
    The derivative has no compensation residuals (qc/pc = None) — comp32
    integration is handled inside `rk4_step`, not by tree arithmetic on
    derivatives.
    """
    inv_m = 1.0 / potential.masses()                     # (d,)
    vpot, grad, hess = potential.local_expansion(state.q)

    tkin = 0.5 * jnp.sum(state.p**2 * inv_m[None, :], axis=1)

    inv_m_mono = inv_m.astype(state.Mqq.dtype)
    if state.diag_monodromy and not isinstance(hess, DiagHessian):
        raise TypeError(
            "diagonal-monodromy state requires a separable potential "
            "(DiagHessian local expansions)")
    im = (inv_m_mono[None, :] if state.diag_monodromy
          else inv_m_mono[None, :, None])
    dstate = TrajState(
        q=state.p * inv_m[None, :],
        p=-grad.astype(state.p.dtype),
        Mqq=state.Mpq * im,
        Mqp=state.Mpp * im,
        Mpq=-hess.matmul(state.Mqq),
        Mpp=-hess.matmul(state.Mqp),
        S=tkin - vpot,
    )
    mean_energy = jnp.mean(tkin + vpot)
    return dstate, mean_energy


def rk4_step(state: TrajState, potential, dt):
    """One classic 4th-order Runge-Kutta step.

    Returns (new_state, mean_energy_at_step_start). The returned energy is
    evaluated at the k1 stage (the exact state at time t), which is the
    quantity whose step-to-step drift the conservation guard monitors.
    """
    inv_m = 1.0 / potential.masses()                     # (d,)
    q, p, S = state.q, state.p, state.S
    # dt may arrive as a traced f64 scalar while the state is f32: cast once
    # per precision domain so no leaf dtype drifts in the scan carry
    tdt = jnp.asarray(dt).astype(q.dtype)
    half = 0.5 * tdt

    # stage arithmetic runs at the trajectory dtype: keep the constant
    # 1/m at that dtype so f32 states (comp32) don't silently promote the
    # (n, d) stage products onto the emulated-f64 path
    inv_m_t = inv_m.astype(q.dtype)

    # hessian_eval = "step" (opt-in on the potential, e.g. sGDML where the
    # analytic Hessian costs ~20x the gradient): gradients at all 4 stages,
    # Hessian once at the midpoint stage, frozen across the monodromy
    # update (midpoint-Magnus; trajectories are unchanged bit for bit)
    hessian_eval = getattr(potential, "hessian_eval", "stage")
    if hessian_eval not in ("stage", "step", "taylor", ""):
        # trace-time guard: a typo'd value set by direct construction or
        # pytree replace() must not silently fall back to the 4-stage mode
        raise ValueError(f"unknown hessian_eval {hessian_eval!r} "
                         "(expected 'stage', 'step' or 'taylor')")
    frozen_hess = hessian_eval in ("step", "taylor")
    value_grad = getattr(potential, "value_grad", None)
    if value_grad is None:
        def value_grad(qs):
            vpot, grad, _ = potential.local_expansion(qs)
            return vpot, grad

    H_mid = None
    if hessian_eval == "taylor":
        # hessian_eval = "taylor": ONE order-2 PES evaluation per step, at
        # the free-flight midpoint (the same point the "step" mode samples
        # its Hessian — q + dt/2 k1_q, and k1_q = p/m is PES-independent);
        # all four stage forces come from the local quadratic expansion
        #     V(q_mid + delta) ~ V_mid + g_mid.delta + 1/2 delta.H delta.
        # Unlike "step" this changes the trajectories: the stage-force
        # error is O(|delta|^2 ||d3V||) with |delta| <= O(dt |qdot|), so
        # the method is globally 2nd-order in dt (gated in
        # tests/test_hessian_eval.py) — far below the ML-PES model error
        # at production molecular steps, for 1/4 of the expensive f64
        # energy/gradient evaluations (sGDML needs the f64 path end to
        # end; the quadratic corrections below are small step-scale
        # quantities and run at the Hessian's reduced precision).
        q_mid = q + half * (p * inv_m_t)
        v_mid, g_mid, H_mid = potential.local_expansion(q_mid)
        cdt = (H_mid.diag.dtype if isinstance(H_mid, DiagHessian)
               else H_mid.mat.dtype)
        g_mid_c = g_mid.astype(cdt)

        def value_grad(qs):
            delta = (qs - q_mid).astype(cdt)
            hd = H_mid.matvec(delta)
            # correction terms scale the small displacement, not the f64
            # anchors v_mid/g_mid — reduced precision costs ~eps*|delta|
            v = v_mid + jnp.sum((g_mid_c + 0.5 * hd) * delta,
                                axis=1).astype(v_mid.dtype)
            grad = g_mid + hd.astype(g_mid.dtype)
            return v, grad

    def pack_stage(qs, ps, vpot, grad):
        tkin = 0.5 * jnp.sum(ps**2 * inv_m_t[None, :], axis=1)
        return ((ps * inv_m_t[None, :]).astype(q.dtype),
                -grad.astype(p.dtype),
                (tkin - vpot.astype(tkin.dtype)).astype(S.dtype)), \
            tkin + vpot.astype(tkin.dtype)

    def traj_stage(qs, ps):
        vpot, grad, hess = potential.local_expansion(qs)
        k, e = pack_stage(qs, ps, vpot, grad)
        return k, hess, e

    def traj_stage_nohess(qs, ps):
        vpot, grad = value_grad(qs)
        k, e = pack_stage(qs, ps, vpot, grad)
        return k, None, e

    # --- trajectory block (q, p, S): 4 PES evaluations (1 for "taylor") ---
    if frozen_hess:
        k1, _, e1 = traj_stage_nohess(q, p)
        if H_mid is not None:
            # taylor: the order-2 expansion at q_mid already happened and
            # the stage forces are local quadratics — no further PES calls
            H2 = H_mid
            k2, _, _ = traj_stage_nohess(q + half * k1[0], p + half * k1[1])
        else:
            k2, H2, _ = traj_stage(q + half * k1[0], p + half * k1[1])
        k3, _, _ = traj_stage_nohess(q + half * k2[0], p + half * k2[1])
        k4, _, _ = traj_stage_nohess(q + tdt * k3[0], p + tdt * k3[1])
        H1 = H3 = H4 = H2
    else:
        k1, H1, e1 = traj_stage(q, p)
        k2, H2, _ = traj_stage(q + half * k1[0], p + half * k1[1])
        k3, H3, _ = traj_stage(q + half * k2[0], p + half * k2[1])
        k4, H4, _ = traj_stage(q + tdt * k3[0], p + tdt * k3[1])
    sixth = tdt / 6.0
    if state.compensated:
        # comp32: the f32 increment is folded into the state by an exact
        # two-sum, so the accumulation rounding (the eps*|q| term that
        # dominates plain f32) vanishes; only the eps*|increment| stage
        # rounding remains (see _comp_accumulate)
        new_q, new_qc = _comp_accumulate(
            q, state.qc, sixth * (k1[0] + 2.0 * (k2[0] + k3[0]) + k4[0]))
        new_p, new_pc = _comp_accumulate(
            p, state.pc, sixth * (k1[1] + 2.0 * (k2[1] + k3[1]) + k4[1]))
    else:
        new_q = q + sixth * (k1[0] + 2.0 * (k2[0] + k3[0]) + k4[0])
        new_p = p + sixth * (k1[1] + 2.0 * (k2[1] + k3[1]) + k4[1])
        new_qc = new_pc = None
    new_S = S + (sixth * (k1[2] + 2.0 * (k2[2] + k3[2]) + k4[2])
                 ).astype(S.dtype)
    mean_energy = jnp.mean(e1)

    # --- monodromy pairs, sharing the stage Hessians ---
    mdt = state.Mqq.dtype
    im = inv_m.astype(mdt)[None, :, None]
    dts = jnp.asarray(dt).astype(mdt)
    h6, h3, h2 = dts / 6.0, dts / 3.0, dts / 2.0

    if state.diag_monodromy:
        # Diagonal monodromy representation ((n, d) blocks — valid only for
        # separable potentials, see TrajState): every stage Hessian must be
        # diagonal, and the RK4 update of mode i is the per-(trajectory,
        # mode) 2x2 linear map obtained by running the stage recurrence on
        # the (1, 0) / (0, 1) seeds. The O(n d^2) monodromy work of the
        # dense path disappears entirely.
        if not all(isinstance(H, DiagHessian) for H in (H1, H2, H3, H4)):
            raise TypeError(
                "diagonal-monodromy state requires a separable potential "
                "(DiagHessian local expansions)")
        u = inv_m.astype(mdt)[None, :]
        hs = tuple(H.diag.astype(mdt) for H in (H1, H2, H3, H4))

        def row_map(a, b):
            ka = u * b
            kb = -hs[0] * a
            acc_a = a + h6 * ka
            acc_b = b + h6 * kb
            sa = a + h2 * ka
            sb = b + h2 * kb
            ka = u * sb
            kb = -hs[1] * sa
            acc_a = acc_a + h3 * ka
            acc_b = acc_b + h3 * kb
            sa = a + h2 * ka
            sb = b + h2 * kb
            ka = u * sb
            kb = -hs[2] * sa
            acc_a = acc_a + h3 * ka
            acc_b = acc_b + h3 * kb
            sa = a + dts * ka
            sb = b + dts * kb
            ka = u * sb
            kb = -hs[3] * sa
            return acc_a + h6 * ka, acc_b + h6 * kb

        one = jnp.ones_like(hs[0])
        zero = jnp.zeros_like(hs[0])
        raa, rba = row_map(one, zero)
        rab, rbb = row_map(zero, one)
        new_state = TrajState(
            q=new_q, p=new_p, S=new_S, qc=new_qc, pc=new_pc,
            Mqq=raa * state.Mqq + rab * state.Mpq,
            Mpq=rba * state.Mqq + rbb * state.Mpq,
            Mqp=raa * state.Mqp + rab * state.Mpp,
            Mpp=rba * state.Mqp + rbb * state.Mpp,
        )
        return new_state, mean_energy

    if all(isinstance(H, ConstHessian) for H in (H1, H2, H3, H4)):
        # Constant-Hessian monodromy (harmonic molecular PES): the stage
        # recurrence is a linear map with constant coefficients, so one RK4
        # step is EXACTLY the degree-4 truncated exponential
        #     T = I + h L + h^2/2 L^2 + h^3/6 L^3 + h^4/24 L^4,
        #     L = [[0, diag(1/m)], [-H, 0]]  (2d, 2d)
        # applied to the stacked blocks — the same polynomial the 4-stage
        # chain evaluates (matches to 2e-16 at f64), at a fraction of the
        # memory traffic: 8 thin constant-left matmuls replace the 4-stage
        # chain's dozens of (n, d, d) buffer passes.
        d = state.q.shape[1]
        Hm = H1.mat.astype(mdt)
        L = jnp.zeros((2 * d, 2 * d), dtype=mdt)
        L = L.at[:d, d:].set(jnp.diag(inv_m.astype(mdt)))
        L = L.at[d:, :d].set(-Hm)
        eye2 = jnp.eye(2 * d, dtype=mdt)
        T = eye2 + (dts / 4.0) * L
        T = eye2 + (dts / 3.0) * (L @ T)
        T = eye2 + (dts / 2.0) * (L @ T)
        T = eye2 + dts * (L @ T)
        # one constant-left product on the fully stacked (n, 2d, 2d)
        # blocks: same MACs as 8 per-block products, twice the
        # contraction depth (K = 2d), one fused matmul
        Z = jnp.concatenate(
            [jnp.concatenate([state.Mqq, state.Mqp], axis=2),
             jnp.concatenate([state.Mpq, state.Mpp], axis=2)], axis=1)
        Z = jnp.einsum("ab,nbc->nac", T, Z)
        new_state = TrajState(
            q=new_q, p=new_p, S=new_S, qc=new_qc, pc=new_pc,
            Mqq=Z[:, :d, :d], Mqp=Z[:, :d, d:],
            Mpq=Z[:, d:, :d], Mpp=Z[:, d:, d:],
        )
        return new_state, mean_energy

    d = state.q.shape[1]
    if frozen_hess and isinstance(H1, DenseHessian):
        # Frozen dense Hessian (step/taylor modes): the 4-stage recurrence
        # with constant H is EXACTLY the degree-4 truncated exponential
        #     T = I + h L + h^2/2 L^2 + h^3/6 L^3 + h^4/24 L^4,
        #     L = [[0, diag(1/m)], [-H_n, 0]]   (per trajectory),
        # evaluated by Horner on the COLUMN-STACKED monodromy blocks
        # [Mqq | Mqp] / [Mpq | Mpp]: each Horner stage is ONE batched
        # (n, d, d) @ (n, d, 2d) H-matmul plus a mass row-scale — 4
        # H-matmuls per step instead of the stage chain's 8 d-wide ones,
        # at 2d output columns. Algebraically identical to the pair()
        # chain below with H1 = .. = H4 (the composition test in
        # tests/test_hessian_eval pins it).
        Tw = getattr(potential, "Tmono", None)
        if Tw is not None:
            # taylor_every window: H (hence the degree-4 map) is frozen
            # for the whole window — apply the precomputed (n, 2d, 2d)
            # step map as ONE row-stacked batched matmul (same MACs as
            # the Horner below, at twice the contraction depth and a
            # single fused product instead of 4 interleaved ones)
            Z = jnp.concatenate(
                [jnp.concatenate([state.Mqq, state.Mqp], axis=2),
                 jnp.concatenate([state.Mpq, state.Mpp], axis=2)], axis=1)
            Z = jnp.einsum("nab,nbc->nac", Tw.astype(mdt), Z)
            new_state = TrajState(
                q=new_q, p=new_p, S=new_S, qc=new_qc, pc=new_pc,
                Mqq=Z[:, :d, :d], Mqp=Z[:, :d, d:],
                Mpq=Z[:, d:, :d], Mpp=Z[:, d:, d:],
            )
            return new_state, mean_energy
        Mq = jnp.concatenate([state.Mqq, state.Mqp], axis=2)   # (n, d, 2d)
        Mp = jnp.concatenate([state.Mpq, state.Mpp], axis=2)
        Yq, Yp = Mq, Mp
        for c in (dts / 4.0, dts / 3.0, dts / 2.0, dts):
            LYq = Yp * im
            LYp = -H1.matmul(Yq)
            Yq = Mq + c * LYq
            Yp = Mp + c * LYp
        new_state = TrajState(
            q=new_q, p=new_p, S=new_S, qc=new_qc, pc=new_pc,
            Mqq=Yq[:, :, :d], Mqp=Yq[:, :, d:],
            Mpq=Yp[:, :, :d], Mpp=Yp[:, :, d:],
        )
        return new_state, mean_energy

    def pair(Ma, Mb):
        """RK4 for dMa/dt = Mb/m, dMb/dt = -H(t) Ma, with sequential
        accumulation: at most 8 (n, d, d) buffers live at once."""
        ka = Mb * im
        kb = -H1.matmul(Ma)
        acc_a = Ma + h6 * ka
        acc_b = Mb + h6 * kb
        sa = Ma + h2 * ka
        sb = Mb + h2 * kb
        ka = sb * im
        kb = -H2.matmul(sa)
        acc_a = acc_a + h3 * ka
        acc_b = acc_b + h3 * kb
        sa = Ma + h2 * ka
        sb = Mb + h2 * kb
        ka = sb * im
        kb = -H3.matmul(sa)
        acc_a = acc_a + h3 * ka
        acc_b = acc_b + h3 * kb
        sa = Ma + dts * ka
        sb = Mb + dts * kb
        ka = sb * im
        kb = -H4.matmul(sa)
        return acc_a + h6 * ka, acc_b + h6 * kb

    # NOTE: the pairs deliberately run sequentially (not column-stacked):
    # stacking would double the output width but also the peak monodromy
    # memory, halving the dense-path batch ceiling (the frozen-Hessian
    # branch above stacks because its use cases run far below ceiling)
    Mqq, Mpq = pair(state.Mqq, state.Mpq)
    Mqp, Mpp = pair(state.Mqp, state.Mpp)

    new_state = TrajState(q=new_q, p=new_p, S=new_S, qc=new_qc, pc=new_pc,
                          Mqq=Mqq, Mqp=Mqp, Mpq=Mpq, Mpp=Mpp)
    return new_state, mean_energy


# ---------------------------------------------------------------------------
# k-step re-expansion windows (taylor_every)
# ---------------------------------------------------------------------------

from semiclassical_jax.pytree import pytree_dataclass as _pytree_dataclass


@_pytree_dataclass(meta=("hessian_eval",))
class LocalQuadratic:
    """Frozen local quadratic expansion of an expensive PES — the
    `taylor_every` window surrogate:

        V(q) = v0 + g0 . (q - q_mid) + 1/2 (q - q_mid)^T H (q - q_mid).

    Acts as the potential inside rk4_step with hessian_eval='taylor':
    re-expanding a quadratic about any point is exact, so the per-step
    taylor machinery reproduces this window's forces and freezes this
    window's H for the monodromy. Precision: v0/g0 keep the parent's
    (f64) dtype — they anchor the action phase; H rides at the parent's
    hess_dtype and only ever scales small step-size displacements.
    """

    q_mid: jnp.ndarray   # (n, d)
    v0: jnp.ndarray      # (n,)
    g0: jnp.ndarray      # (n, d)
    H: jnp.ndarray       # (n, d, d) dense, or (n, d) diagonal (separable)
    mass: jnp.ndarray    # (d,)
    nac0: jnp.ndarray    # (d,)
    # per-window monodromy step map (n, 2d, 2d): H is frozen for the
    # whole window, so the degree-4 truncated exponential the frozen-H
    # Horner evaluates is the SAME matrix at every step — precomputed
    # once per window, each step becomes ONE stacked batched matmul at
    # K = 2d (the per-step Horner is 4 matmuls at K = d). None disables
    # the path.
    Tmono: jnp.ndarray | None = None
    hessian_eval: str = "taylor"

    def dimensions(self):
        return self.q_mid.shape[1]

    def masses(self):
        return self.mass

    def _hessian_op(self):
        from semiclassical_jax.potentials.base import (DenseHessian as _DH,
                                                       DiagHessian as _DG)
        return _DG(diag=self.H) if self.H.ndim == 2 else _DH(mat=self.H)

    def local_expansion(self, q):
        delta = q - self.q_mid                                # (n, d)
        hop = self._hessian_op()
        hd = hop.matvec(delta.astype(self.H.dtype))           # (n, d) @ ht
        # the linear anchor term at full precision, the quadratic
        # corrections at the Hessian's precision (they scale |delta|^2)
        v = (self.v0 + jnp.sum(self.g0 * delta, axis=1)
             + 0.5 * jnp.sum(hd * delta.astype(hd.dtype),
                             axis=1).astype(self.v0.dtype))
        grad = self.g0 + hd.astype(self.g0.dtype)
        return v, grad, hop

    def derivative_coupling_1st(self, q):
        return jnp.broadcast_to(self.nac0[None, :], q.shape)

    def derivative_coupling_2nd(self, q):
        return jnp.zeros_like(q)


def make_taylor_window(potential, dt, every):
    """(carry0_fn, step_fn) implementing the k-step re-expansion window
    for `hessian_eval='taylor'` potentials (`taylor_every` keyword).

    One order-2 PES evaluation per WINDOW of `every` steps: the window
    expands the real PES once at the free-flight window midpoint, and all
    steps inside the window run the per-step taylor machinery on the
    frozen quadratic (exact for a quadratic — stage forces and monodromy
    Hessian are the window expansion's). Stage-force error grows to
    O((every dt |qdot|)^2 ||d3V||) at the window edges — 2nd-order in the
    window length, gated in tests/test_hessian_eval.py. Window phase
    restarts at every scan segment (a fresh expansion at the segment
    head), so results can shift within the approximation error when
    `scan_chunk` changes.
    """
    inv_m = 1.0 / potential.masses()

    def _window_mono_map(Hw, state):
        """Degree-4 truncated exponential T (n, 2d, 2d) of the window
        Hessian — the per-step monodromy map, computed ONCE per window
        (Horner on the identity rows; cost = one step's Horner,
        amortised 1/every)."""
        mdt = state.Mqq.dtype
        n, dd = Hw.shape[0], Hw.shape[1]
        dts = jnp.asarray(dt).astype(mdt)
        im_r = inv_m.astype(mdt)[None, :, None]
        eye = jnp.eye(2 * dd, dtype=mdt)
        eyeq = jnp.broadcast_to(eye[:dd], (n, dd, 2 * dd))
        eyep = jnp.broadcast_to(eye[dd:], (n, dd, 2 * dd))
        Hm = Hw.astype(mdt)
        Yq, Yp = eyeq, eyep
        for c in (dts / 4.0, dts / 3.0, dts / 2.0, dts):
            LYq = Yp * im_r
            LYp = -jnp.einsum("nab,nbc->nac", Hm, Yq)
            Yq = eyeq + c * LYq
            Yp = eyep + c * LYp
        return jnp.concatenate([Yq, Yp], axis=1)

    def expand(state):
        q, p = state.q, state.p
        if state.compensated:
            q = q + state.qc
            p = p + state.pc
        half_window = 0.5 * every * jnp.asarray(dt).astype(q.dtype)
        qp = q + half_window * (p * inv_m[None, :].astype(q.dtype))
        v0, g0, H = potential.local_expansion(qp)
        if isinstance(H, DiagHessian):
            Hw = H.diag                         # separable: (n, d) diagonal
            Tw = None
        else:
            Hw = jnp.broadcast_to(H.dense(),
                                  (q.shape[0],) + (q.shape[1],) * 2)
            # dense monodromy only: the diag representation has no Horner.
            # SEMI_WINDOW_MONO_MAP=0 (read at import) falls back to the
            # per-step Horner (ablation switch; default on)
            Tw = (_window_mono_map(Hw, state)
                  if _WINDOW_MONO_MAP and not state.diag_monodromy else None)
        return LocalQuadratic(
            q_mid=qp, v0=v0, g0=g0, H=Hw, Tmono=Tw,
            mass=potential.masses(),
            nac0=potential.derivative_coupling_1st(qp[:1])[0])

    def carry0(state0):
        return (expand(state0), jnp.asarray(0, dtype=jnp.int32))

    def step(state, sc):
        quad, cnt = sc
        quad = jax.lax.cond(
            jnp.logical_and(cnt % every == 0, cnt > 0),
            lambda _: expand(state), lambda _: quad, None)
        new_state, en = rk4_step(state, quad, dt)
        return new_state, en, (quad, cnt + 1)

    return carry0, step
