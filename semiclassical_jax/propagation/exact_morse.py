# coding: utf-8
"""Exact (closed-form) propagation map for separable Morse potentials.

The Morse oscillator is integrable: with E = p^2/2 + V(q) < D the orbit is

    e^{a q(th)} = (1 - s cos th) / (1 - eps),   th = th0 + wE t,
    p(th)       = (s wE / a) sin th / (1 - s cos th),

with eps = E/D, s = sqrt(eps), wE = w0 sqrt(1 - eps), w0 = a sqrt(2 D).
Positions, momenta, the monodromy M(t) = dZ(t)/dZ(0) and the classical
action S(t) = int (T - V) dt all have closed forms — so for a separable
Morse PES (reference potentials.py:243-255; every mode evolves
independently) the whole RK4 time-stepper can be replaced by an EXACT
fixed-dt map.  This is the "accuracy story" an integrator change needs:
the map has NO time-discretization error at any dt (validated against
tiny-step RK4 to 1e-9 over random orbits spanning eps in [1e-10, 0.8] —
scripts/exact_morse_check.py).

Structure
---------
* The only evolving quantity is the phase th (n, d), advanced by the
  per-trajectory constant wE dt through a Neumaier two-sum (value +
  residual), exactly like the comp32 trajectory accumulation.  Everything
  else — q, p, the four diagonal monodromy components and the action — is
  evaluated FRESH from setup-time constants every step, so readout errors
  are bounded by one f32 rounding and never accumulate.
* The scan carry shrinks from the eight (n, d) comp32-RK4 state buffers to
  two (th, its residual), cutting the per-step carry memory traffic 4x.
* The monodromy factorizes as M(t) = Jhat(th) . shear(t) . Jhat(th0)^{-1}
  with the regularized Jacobian Jhat = d(q,p)/d(th,eps) . diag(1/s, s)
  whose entries stay finite through the harmonic limit s -> 0 (where the
  map degenerates smoothly to the exact harmonic rotation).
* Per (trajectory, mode, step) the map costs ~4 transcendentals
  (sincos, log, arctan) and ~60 flops — vs RK4's 4 PES exponentials plus
  the stage chains and monodromy row maps.

Cost/benefit: both the exact body and RK4 are elementwise-flop-bound,
and the map's transcendentals roughly trade against the PES/stage flops
it removes, so at equal dt it is not expected to be faster (its speed on
the GPU is not measured).  What it buys is physics: zero time-
discretization error at ANY dt (a 16x-coarser observable grid reproduces
the fine-grid C(t) to 1e-9 — RK4's O(dt^4) phase error is ~0.3 rad
there), exact energy conservation, and
non-accumulating trajectory error over arbitrarily long horizons.  Use
it for coarse-grid / long-horizon runs; keep RK4 for per-step-observable
throughput.  The comp32 twin-gap vs RK4 is flat in time, present at
t=0, and traced to f32 exponent-cancellation noise on extreme-tail
Monte-Carlo rows (fused exponents are sums of +-O(100) log-weights; ANY
regrouping of that arithmetic perturbs exp() at ulp-level), i.e.
sampling-noise-floor territory, not integrator error; the f64 twin-gap is
2.2e-12.

Setup runs once per batch in float64 (a one-time cost); the per-step map
runs at the trajectory dtype.
"""

from __future__ import annotations

import logging

import numpy as np
import jax
import jax.numpy as jnp

from semiclassical_jax.propagation.eom import _comp_accumulate
from semiclassical_jax.propagation.state import TrajState
from semiclassical_jax.pytree import pytree_dataclass

logger = logging.getLogger(__name__)

__all__ = [
    "supports_exact_morse",
    "build_morse_map",
    "morse_map_state",
    "morse_map_advance",
    "MorseMapPack",
    "MorseMapCarry",
]

# Trajectories whose largest per-mode eps = E/D exceeds this are routed to
# the RK4 side-channel: above it the orbit is unbound (eps >= 1, no
# periodic closed form) or close enough to the separatrix that the map's
# constants degrade (wE -> 0).  The map itself is validated to eps = 0.8;
# 0.9 keeps a safety margin.  At production sampling scales the Husimi
# tails DO produce unbound samples (measured: eps_max = 2.03 at 8192 x 60
# modes on the AS model), so the hybrid is required, not optional.
EPS_EXACT = 0.9
# if more than this fraction of the batch is RK4-routed, the exact map is
# pointless for the ensemble — fail loudly instead of quietly degrading
RK4_FRACTION_MAX = 0.25


def _split_hi_lo(x64, wdtype):
    """Split a float64 array into (hi, lo) at `wdtype` with hi + lo = x64
    to ~2x wdtype precision."""
    hi = x64.astype(wdtype)
    lo = (x64 - hi.astype(jnp.float64)).astype(wdtype)
    return hi, lo


def _two_pi(wdtype):
    """(hi, lo) split of 2*pi at wdtype."""
    tp = 2.0 * np.pi
    hi = np.asarray(tp, dtype=wdtype)
    lo = np.asarray(tp - np.float64(hi), dtype=wdtype)
    return jnp.asarray(hi), jnp.asarray(lo)


@pytree_dataclass(meta=("compose_m0", "compensated", "wdtype_name",
                        "has_sub"))
class MorseMapPack:
    """Per-batch constants of the exact Morse map (all (n, d) at the work
    dtype unless noted).  Built once per (batch, potential, dt).

    Hybrid side-channel: rows whose max per-mode eps exceeds EPS_EXACT
    (unbound / near-separatrix — a ~1e-5 tail fraction of production
    Husimi ensembles) are stepped by RK4 in a small padded sub-batch and
    scattered over the (NaN) closed-form rows at every materialization.
    `sub_idx` holds their row indices, padded with n (scattered with OOB
    drop semantics)."""

    s: jnp.ndarray        # sqrt(eps)
    inv_a: jnp.ndarray    # (d,) 1/a
    qoff: jnp.ndarray     # -log1p(-eps)/a: q = log(den)/a + qoff
    pamp: jnp.ndarray     # s wE / a
    cE: jnp.ndarray       # wE / a
    c12a: jnp.ndarray     # (d,) inv_a / 2
    c12b: jnp.ndarray     # s/(1-eps) * inv_a
    c22a: jnp.ndarray     # (wpE eps + wE/2) * inv_a
    c22b: jnp.ndarray     # s wE inv_a / 2
    bco_hi: jnp.ndarray   # eps * wpE  (hi part)
    bco_lo: jnp.ndarray   # eps * wpE  (lo part)
    j011: jnp.ndarray     # Jhat(th0)^{-1} entries
    j012: jnp.ndarray
    j021: jnp.ndarray
    j022: jnp.ndarray
    beta: jnp.ndarray     # s / (1 + sqrt(1-eps))
    pc1: jnp.ndarray      # (d,) 2 D / w0       (action: coefficient of g)
    pc2: jnp.ndarray      # -2 D (1-eps) s / wE (action: coefficient of sn/den)
    wdt_hi: jnp.ndarray   # wE dt (hi part)
    wdt_lo: jnp.ndarray   # wE dt (lo part)
    A: jnp.ndarray        # (n,) f64  secular dS/dt = sum_d E_d - 2 D (1-rt)
    S_base: jnp.ndarray   # (n,) f64  S0 - P(th0) summed over modes
    e_bound_sum: jnp.ndarray  # () f64 total energy summed over bound rows
                              # (a constant of the exact map)
    # monodromy at setup time, to compose M(t) = M_formula(t) . M0 when
    # resuming from an already-evolved state; None at M0 = identity
    m0qq: jnp.ndarray | None = None
    m0qp: jnp.ndarray | None = None
    m0pq: jnp.ndarray | None = None
    m0pp: jnp.ndarray | None = None
    # RK4 side-channel row indices (padded with n = OOB-drop) and the
    # (n,) routed-row mask; None when every trajectory is bound
    sub_idx: jnp.ndarray | None = None
    row_bad: jnp.ndarray | None = None
    compose_m0: bool = False
    compensated: bool = False   # emit qc/pc = 0 residual leaves
    wdtype_name: str = "float32"
    has_sub: bool = False
    n_bad: int = 0              # static: real (non-pad) sub rows

    @property
    def wdtype(self):
        return jnp.dtype(self.wdtype_name)


@pytree_dataclass
class MorseMapCarry:
    """Scan-carried state of the exact map: the phase and its two-sum
    residual (true phase = th + thc, kept wrapped to [-pi, pi]), plus the
    f64 time since setup (enters the monodromy shear and the secular
    action term).  `sub` is the RK4-stepped sub-batch of unbound /
    near-separatrix rows (None when the whole batch is bound)."""

    th: jnp.ndarray    # (n, d) work dtype
    thc: jnp.ndarray   # (n, d) work dtype
    t_rel: jnp.ndarray  # () f64
    sub: TrajState | None = None
    # the propagator's sign trackers for the side-channel's own observable
    # pipeline (HK: one, WM: three) — attached by the propagator
    sub_trackers: tuple = ()


def supports_exact_morse(potential, state) -> bool:
    """The exact map applies to bound orbits of a non-harmonic separable
    MorsePotential with the state in the diagonal-monodromy representation
    (the automatic choice for separable potentials)."""
    from semiclassical_jax.potentials.model import MorsePotential

    return (isinstance(potential, MorsePotential)
            and not potential.harmonic
            and state.diag_monodromy)


def _setup_f64(q, p, S0, a, D, dt):
    """f64 setup math (jitted; one-time per batch).  Returns the pack
    leaves still at f64 plus the routing diagnostics (eps_raw).

    Elements with eps_raw > EPS_EXACT (their whole trajectory is diverted
    to the RK4 side-channel) are REPLACED by the rest state (q = p = 0)
    before any constant is derived: every closed-form row then carries
    finite, well-conditioned values (the rest state is the exact harmonic
    limit s -> 0), and the diverted rows' zero contribution to the
    observables is enforced via their -inf log-weights — never through
    NaN arithmetic."""
    a = a[None, :]
    D = D[None, :]
    w0 = a * jnp.sqrt(2.0 * D)
    em_raw = jnp.expm1(-a * q)
    eps_raw = (0.5 * p * p + D * em_raw * em_raw) / D
    bad_elem = ~(eps_raw <= EPS_EXACT)        # catches NaN/inf too
    q = jnp.where(bad_elem, 0.0, q)
    p = jnp.where(bad_elem, 0.0, p)
    em = jnp.expm1(-a * q)                    # ex - 1
    V = D * em * em                           # D (1 - ex)^2
    E = 0.5 * p * p + V                       # (n, d) per-mode energies
    eps = E / D
    one_m_eps = 1.0 - eps
    s = jnp.sqrt(eps)
    rt = jnp.sqrt(one_m_eps)
    wE = w0 * rt
    wpE = -w0 / (2.0 * rt)
    # phase: s cos th0 = 1 - (1-eps) e^{a q} = eps - (1-eps) expm1(a q)
    #        s sin th0 = a p (1-eps) e^{a q} / wE
    em2 = jnp.expm1(a * q)
    eaq = em2 + 1.0
    cos_part = eps - one_m_eps * em2
    sin_part = a * p * one_m_eps * eaq / wE
    th0 = jnp.arctan2(sin_part, cos_part)
    # Jhat(th0) and its inverse via the analytic det(Jhat) = D / wE
    sn0, cs0 = jnp.sin(th0), jnp.cos(th0)
    den0 = 1.0 - s * cs0
    r0 = 1.0 / den0
    J11 = sn0 * r0 / a
    J21 = (wE / a) * (cs0 - s) * r0 * r0
    J12 = (-cs0 * r0 / 2.0 + s / one_m_eps) / a
    J22 = sn0 * ((wpE * eps + wE / 2.0) / a * r0
                 + (s * wE / (2.0 * a)) * cs0 * r0 * r0)
    idet = wE / D
    j011 = J22 * idet
    j012 = -J12 * idet
    j021 = -J21 * idet
    j022 = J11 * idet
    # action: S(t) = S0 + A t + P(th) - P(th0), with the periodic part
    # P(th) = pc1 g(th) + pc2 sin th / den,  g = 2 atan2(beta sn, 1-beta cs)
    beta = s / (1.0 + rt)
    pc2 = -2.0 * D * one_m_eps * s / wE
    g0 = 2.0 * jnp.arctan2(beta * sn0, 1.0 - beta * cs0)
    P0 = (2.0 * D / w0) * g0 + pc2 * sn0 * r0
    A = jnp.sum(E - 2.0 * D * (1.0 - rt), axis=1)            # (n,) f64
    S_base = S0.astype(jnp.float64) - jnp.sum(P0, axis=1)
    e_row = jnp.sum(E, axis=1)                               # (n,) f64
    # Reduce the per-step phase increment mod 2pi once, in f64, at build
    # time: every quantity of the map is 2pi-periodic in th (the explicit
    # t-dependence rides t_rel separately), so dropping whole periods from
    # the constant increment is exact — and it keeps |th| <= 2pi at the
    # per-step wrap for ANY dt, preserving the k in {-1, 0, 1} invariant
    # the compensated wrap arithmetic relies on.
    wdt = wE * dt
    wdt = wdt - (2.0 * np.pi) * jnp.round(wdt / (2.0 * np.pi))
    consts = dict(
        s=s, qoff=-jnp.log1p(-eps) / a, pamp=s * wE / a, cE=wE / a,
        c12b=s / one_m_eps / a,
        c22a=(wpE * eps + wE / 2.0) / a, c22b=s * wE / (2.0 * a),
        bco=eps * wpE, j011=j011, j012=j012, j021=j021, j022=j022,
        beta=beta, pc2=pc2, wdt=wdt,
        th0=th0, A=A, S_base=S_base, e_row=e_row,
    )
    return consts, eps_raw


_setup_f64_jit = jax.jit(_setup_f64)


def build_morse_map(state: TrajState, potential, dt):
    """Build the exact-map constant pack and initial carry from the current
    state.  Rows with an unbound/near-separatrix mode (eps > EPS_EXACT) are
    routed to the RK4 side-channel; a ValueError is raised only for
    unsupported configurations (harmonic/non-Morse potential, dense
    monodromy, non-unit masses) or when more than RK4_FRACTION_MAX of the
    batch would be routed."""
    from semiclassical_jax.potentials.model import MorsePotential

    if not isinstance(potential, MorsePotential) or potential.harmonic:
        raise ValueError(
            "the exact integrator requires a non-harmonic MorsePotential "
            f"(got {type(potential).__name__}); use integrator='rk4'")
    if not state.diag_monodromy:
        raise ValueError(
            "the exact integrator requires the diagonal-monodromy "
            "representation (automatic for separable potentials)")
    masses = np.asarray(potential.masses(), dtype=np.float64)
    if not np.allclose(masses, 1.0):
        raise ValueError("the exact Morse map assumes unit masses")

    wdtype = state.q.dtype
    q = state.q.astype(jnp.float64)
    p = state.p.astype(jnp.float64)
    if state.compensated:
        q = q + state.qc.astype(jnp.float64)
        p = p + state.pc.astype(jnp.float64)
    a64 = jnp.asarray(np.asarray(potential.a, dtype=np.float64))
    D64 = jnp.asarray(np.asarray(potential.D, dtype=np.float64))
    consts, eps = _setup_f64_jit(q, p, state.S, a64, D64,
                                 jnp.asarray(dt, dtype=jnp.float64))

    # route unbound / near-separatrix rows to the RK4 side-channel
    n = state.q.shape[0]
    # ~all(<=) rather than max(>) so NaN/inf rows are routed to the RK4
    # side-channel too (NaN > x is False, which would otherwise leave a
    # NaN trajectory in the closed-form branch as a spurious full-weight
    # rest state; under RK4 it NaN-poisons the energies and the energy
    # guard raises — same behavior as integrator='rk4' on the same input)
    bad_row = np.asarray(~jnp.all(eps <= EPS_EXACT, axis=1))
    n_bad = int(bad_row.sum())
    if n_bad > RK4_FRACTION_MAX * n:
        raise ValueError(
            f"exact Morse map: {n_bad}/{n} trajectories have a mode with "
            f"eps = E/D > {EPS_EXACT} (unbound or near-separatrix) — the "
            "ensemble is too hot for the closed-form map; use "
            "integrator='rk4'")
    sub_idx = None
    sub0 = None
    if n_bad:
        bucket = max(64, 1 << (n_bad - 1).bit_length())
        idx = np.full(bucket, n, dtype=np.int32)     # pad = n -> OOB drop
        idx[:n_bad] = np.nonzero(bad_row)[0]
        sub_idx = jnp.asarray(idx)
        take = lambda arr: (None if arr is None else
                            jnp.take(arr, sub_idx, axis=0, mode="fill",
                                     fill_value=0))
        # pad rows become the rest state (q = p = 0, M = identity, S = 0):
        # a valid Morse trajectory whose step is exact and whose
        # observable contribution is masked to zero via -inf log-weights
        ident = lambda arr: arr.at[n_bad:].set(1.0)
        sub0 = TrajState(q=take(state.q), p=take(state.p),
                         qc=take(state.qc), pc=take(state.pc),
                         Mqq=ident(take(state.Mqq)), Mqp=take(state.Mqp),
                         Mpq=take(state.Mpq), Mpp=ident(take(state.Mpp)),
                         S=take(state.S))
        logger.info("exact Morse map: %d/%d rows RK4-routed "
                    "(eps > %s)", n_bad, n, EPS_EXACT)

    e_bound_sum = jnp.sum(jnp.where(jnp.asarray(~bad_row),
                                    consts["e_row"], 0.0))

    inv_a = (1.0 / a64).astype(wdtype)
    d32 = lambda x: x.astype(wdtype)
    bco_hi, bco_lo = _split_hi_lo(consts["bco"], wdtype)
    wdt_hi, wdt_lo = _split_hi_lo(consts["wdt"], wdtype)
    th_hi, th_lo = _split_hi_lo(consts["th0"], wdtype)

    compose = bool(not _is_identity_diag_monodromy(state))
    pack = MorseMapPack(
        s=d32(consts["s"]), inv_a=inv_a, qoff=d32(consts["qoff"]),
        pamp=d32(consts["pamp"]), cE=d32(consts["cE"]),
        c12a=0.5 * inv_a, c12b=d32(consts["c12b"]),
        c22a=d32(consts["c22a"]), c22b=d32(consts["c22b"]),
        bco_hi=bco_hi, bco_lo=bco_lo,
        j011=d32(consts["j011"]), j012=d32(consts["j012"]),
        j021=d32(consts["j021"]), j022=d32(consts["j022"]),
        beta=d32(consts["beta"]),
        pc1=(2.0 * D64 / (a64 * jnp.sqrt(2.0 * D64))).astype(wdtype),
        pc2=d32(consts["pc2"]),
        wdt_hi=wdt_hi, wdt_lo=wdt_lo,
        A=consts["A"], S_base=consts["S_base"],
        e_bound_sum=e_bound_sum,
        m0qq=state.Mqq if compose else None,
        m0qp=state.Mqp if compose else None,
        m0pq=state.Mpq if compose else None,
        m0pp=state.Mpp if compose else None,
        sub_idx=sub_idx,
        row_bad=jnp.asarray(bad_row) if n_bad else None,
        compose_m0=compose,
        compensated=state.compensated,
        wdtype_name=jnp.dtype(wdtype).name,
        has_sub=n_bad > 0,
        n_bad=n_bad,
    )
    carry = MorseMapCarry(th=th_hi, thc=th_lo,
                          t_rel=jnp.zeros((), dtype=jnp.float64),
                          sub=sub0)
    return pack, carry


def _is_identity_diag_monodromy(state: TrajState) -> bool:
    """Host check whether M0 == identity (the fresh-batch fast path that
    skips the per-step 2x2 composition).  One fused device reduction and
    one host round-trip instead of one per jnp.all() term."""
    return bool(
        jnp.all((state.Mqq == 1.0) & (state.Mpp == 1.0)
                & (state.Mqp == 0.0) & (state.Mpq == 0.0)))


def morse_map_state(pack: MorseMapPack, carry: MorseMapCarry,
                    mono_dtype, potential) -> tuple[TrajState, jnp.ndarray]:
    """Materialize the full TrajState at the carry's phase/time.  Returns
    (state, batch_mean_energy) — the exact-map energy is a constant of the
    motion; the RK4 sub-batch contributes its current energies, so the
    conservation guard still monitors the side-channel's drift."""
    w = pack.wdtype
    th, thc = carry.th, carry.thc
    sn0, cs0 = jnp.sin(th), jnp.cos(th)
    # first-order residual correction: sin/cos at (th + thc) without f64
    sn = sn0 + thc * cs0
    cs = cs0 - thc * sn0
    den = 1.0 - pack.s * cs
    r = 1.0 / den
    r2 = r * r
    q = jnp.log(den) * pack.inv_a[None, :] + pack.qoff
    p = pack.pamp * sn * r
    j11 = sn * r * pack.inv_a[None, :]
    j21 = pack.cE * (cs - pack.s) * r2
    j12 = pack.c12b - cs * r * pack.c12a[None, :]
    j22 = sn * (pack.c22a * r + pack.c22b * cs * r2)
    # shear entry b = eps * wpE * t via a two-product against the f64 time
    t_hi = carry.t_rel.astype(w)
    t_lo = (carry.t_rel - t_hi.astype(jnp.float64)).astype(w)
    b = pack.bco_hi * t_hi + (pack.bco_hi * t_lo + pack.bco_lo * t_hi)
    m11 = pack.j011 + b * pack.j021
    m12 = pack.j012 + b * pack.j022
    mqq = j11 * m11 + j12 * pack.j021
    mqp = j11 * m12 + j12 * pack.j022
    mpq = j21 * m11 + j22 * pack.j021
    mpp = j21 * m12 + j22 * pack.j022
    if pack.compose_m0:
        mqq, mqp, mpq, mpp = (
            mqq * pack.m0qq + mqp * pack.m0pq,
            mqq * pack.m0qp + mqp * pack.m0pp,
            mpq * pack.m0qq + mpp * pack.m0pq,
            mpq * pack.m0qp + mpp * pack.m0pp,
        )
    # action: S = S_base + A t + sum_d P(th)
    g = 2.0 * jnp.arctan2(pack.beta * sn, 1.0 - pack.beta * cs)
    P = pack.pc1[None, :] * g + pack.pc2 * sn * r
    Psum = jnp.sum(P, axis=1)
    S = (pack.S_base + pack.A * carry.t_rel
         + Psum.astype(jnp.float64))
    if pack.compensated:
        qc = jnp.zeros_like(q)
        pc = jnp.zeros_like(p)
    else:
        qc = pc = None
        S = S.astype(w)
    mqq = mqq.astype(mono_dtype)
    mqp = mqp.astype(mono_dtype)
    mpq = mpq.astype(mono_dtype)
    mpp = mpp.astype(mono_dtype)

    n = q.shape[0]
    en = pack.e_bound_sum
    if pack.has_sub:
        # energy of the RK4 side-channel rows — the routed rows' closed-
        # form columns are zeroed rest states contributing 0 to
        # e_bound_sum, and the sub pad rows are rest states contributing
        # exactly 0 here.  (The sub STATE is NOT merged per step — that is
        # a scatter per (n, d) array; the side-channel runs its own
        # observable pipeline and merges once per scan, see
        # morse_map_merge.)
        sub = carry.sub
        # the unused grad/Hessian outputs are elementwise for the Morse
        # potential (the only one the exact map supports) and DCE'd under
        # jit — this costs one extra (n_sub, d) exp over the small routed
        # bucket, not a Hessian assembly
        vpot, _, _ = potential.local_expansion(sub.q)
        tkin = 0.5 * jnp.sum(sub.p.astype(w) ** 2, axis=1)
        en = en + jnp.sum(tkin.astype(jnp.float64)
                          + vpot.astype(jnp.float64))
    en = (en / n).astype(w)

    state = TrajState(q=q, p=p, qc=qc, pc=pc,
                      Mqq=mqq, Mqp=mqp, Mpq=mpq, Mpp=mpp, S=S)
    return state, en


def gather_tracker(tracker, sub_idx):
    """Side-channel view of a SignTracker: the routed rows' branch-cut
    state rides the main tracker between scans (it is what checkpoints
    save), so the sub pipeline starts from the authoritative signs.  Pad
    rows get (previous=1, sign=1) — benign."""
    from semiclassical_jax.propagation.state import SignTracker

    take = lambda a, fill: jnp.take(a, sub_idx, axis=0, mode="fill",
                                    fill_value=fill)
    return SignTracker(previous=take(tracker.previous, 1.0),
                       signs=take(tracker.signs, 1.0))


def merge_tracker(main, sub_tracker, sub_idx):
    """Scatter the side-channel tracker rows back into the main tracker
    (once per scan): the stored/checkpointed tracker then carries the
    true branch-cut state for every trajectory."""
    from semiclassical_jax.propagation.state import SignTracker

    put = lambda dst, src: dst.at[sub_idx].set(src.astype(dst.dtype),
                                               mode="drop")
    return SignTracker(previous=put(main.previous, sub_tracker.previous),
                       signs=put(main.signs, sub_tracker.signs))


def morse_map_merge(pack: MorseMapPack, carry: MorseMapCarry,
                    state: TrajState) -> TrajState:
    """Scatter the RK4 side-channel rows over their (rest-state
    placeholder) closed-form rows — called ONCE per scan to produce the
    stored/checkpointed state, never inside the step loop (scatter
    cost).  Pad indices (= n) drop out of bounds."""
    if not pack.has_sub:
        return state
    sub = carry.sub
    put = lambda dst, src: (None if dst is None else dst.at[pack.sub_idx]
                            .set(src.astype(dst.dtype), mode="drop"))
    return TrajState(
        q=put(state.q, sub.q), p=put(state.p, sub.p),
        qc=put(state.qc, sub.qc), pc=put(state.pc, sub.pc),
        Mqq=put(state.Mqq, sub.Mqq), Mqp=put(state.Mqp, sub.Mqp),
        Mpq=put(state.Mpq, sub.Mpq), Mpp=put(state.Mpp, sub.Mpp),
        S=put(state.S, sub.S),
    )


def morse_map_advance(pack: MorseMapPack, carry: MorseMapCarry,
                      dt, potential) -> MorseMapCarry:
    """Advance the phase by one step: th += wE dt through the Neumaier
    two-sum, wrapped to [-pi, pi] (every quantity of the map is 2pi-
    periodic in th except the explicit t-dependence, which rides t_rel).
    The RK4 side-channel sub-batch, if any, takes a normal RK4 step."""
    from semiclassical_jax.propagation.eom import rk4_step

    th, thc = _comp_accumulate(carry.th, carry.thc + pack.wdt_lo,
                               pack.wdt_hi)
    tp_hi, tp_lo = _two_pi(pack.wdtype)
    k = jnp.round(th * (1.0 / (2.0 * np.pi)))
    th = th - k * tp_hi            # exact: k in {-1, 0, 1}
    thc = thc - k * tp_lo
    sub = carry.sub
    if pack.has_sub:
        sub, _ = rk4_step(sub, potential, dt)
    return MorseMapCarry(th=th, thc=thc,
                         t_rel=carry.t_rel + jnp.asarray(dt, jnp.float64),
                         sub=sub, sub_trackers=carry.sub_trackers)
