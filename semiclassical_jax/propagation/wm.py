# coding: utf-8
"""Walton-Manolopoulos (WM) semiclassical IVR propagator.

[WM] A. Walton, D. Manolopoulos, Mol. Phys. 87, 961-978 (1996)

The WM propagator is the Filinov-smoothed, cell-integrated variant of HK:
the function L = log C + i S / hbar is expanded to quadratic order around
each initial phase-space point and the integral over a phase-space cell of
widths ~ alpha^{-1/2}, beta^{-1/2} is carried out analytically, giving per-
trajectory Gaussian parameter tensors (eqns. 50-84) and modified observables
(eqns. 85-100). Capability parity with reference propagators.py:1077-1719.

Design decisions (beyond those shared with hk.py):

* everything that touches the 2d-dimensional phase space is built directly
  in the *projected* non-zero subspace of dimension 2r: the monodromy blocks
  are right-multiplied by U once per step (4 real (n, d, r) matmuls) and all
  (2d, 2d) algebra of the reference (A assembly, inverse, determinant —
  propagators.py:1232-1259) shrinks to (2r, 2r);
* the reference computes b0 = gradL - i/hbar (Mqz^T P - Eqz^T p)
  (eqn. 55, propagators.py:1266-1268). With the WM approximation
  gradL = i/hbar (Mqq^T P - p, Mqp^T P) (eqns. A4-A5) this is *identically
  zero* — the two expressions are the same contraction — so b0, and with it
  the b0-dependent shifts of eqns. 60, 74 (pi_t = P, pi_i = p,
  eps = -1/(2 hbar^2) (p0-p)^T [Gi+G0]^{-1} (p0-p)), are simplified
  analytically. eps and PIq (eqn. 72) then depend only on the initial
  momenta and are precomputed per batch.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from semiclassical_jax import linalg
from semiclassical_jax.coherent import complex_exp
from semiclassical_jax.linalg import (from_device, phase_exp, real_dtype,
                                      times_i, to_device)
from semiclassical_jax.propagation.eom import rk4_step
from semiclassical_jax.propagation.exact_harmonic import (HarmonicMap,
                                                          harmonic_step)
from semiclassical_jax.propagation.exact_morse import (morse_map_advance,
                                                       morse_map_merge,
                                                       morse_map_state)
from semiclassical_jax.propagation.hk import (
    BatchConstants,
    HKParams,
    HermanKlukPropagator,
    _build_hk_params,
    _m2_contrib,
    _m2_factored,
    _obs_combine,
    check_energy_conservation,
    complex_dtype,
    hk_autocorr_qp,
    hk_batch_constants,
    hk_prefactor_det,
    with_nacq,
)
from semiclassical_jax.propagation.state import SignTracker, TrajState
from semiclassical_jax.pytree import pytree_dataclass, replace
from semiclassical_jax.units import hbar

__all__ = ["WMParams", "WMBatchConstants", "WaltonManolopoulosPropagator"]

@pytree_dataclass
class WMDiagConsts:
    """Per-mode constants of the separable all-diagonal WM fast path.

    Valid when Gamma_0, Gamma_i, Gamma_t are all diagonal and rank == dim
    (no zero modes): every block of the balanced A-matrix (eqn. 50) is then
    diagonal, so A decouples into d independent 2x2 complex systems per
    trajectory — the (n, 2r, 2r) factorisations, (n, d, 2r) projections and
    (n, r, r) M-solves of `wm_scan_derived` all collapse to elementwise
    (n, d) arithmetic, and the determinants become log-space per-mode
    products (the same structure as HK's `factors_diag` prefactor).

    Every field is a REAL (d,) vector; purely-imaginary constants are kept
    as their imaginary plane (`*_im`) so no complex constant is ever
    captured by jit (package numerics contract).
    """

    u1: jnp.ndarray        # Dbal q-column scale / sqrt(s) = 1/sqrt(g0 s)
    u2: jnp.ndarray        # Dbal p-column scale / sqrt(s) = sqrt(g0 / s)
    gt: jnp.ndarray        # Gamma_t diagonal
    g0: jnp.ndarray        # Gamma_0 diagonal
    cb11: jnp.ndarray      # A_const_b^T [0,0] = (2 alpha g0 + gi)/(g0 s)
    cb12_im: jnp.ndarray   # A_const_b^T [0,1] / i = -2/(hbar s)
    cb22: jnp.ndarray      # A_const_b^T [1,1] = 2 beta / s
    fq1: jnp.ndarray       # Fq q-column: g0 gi u1 / (g0 + gi)
    fq2_im: jnp.ndarray    # Fq p-column / i: -g0 u2 / (hbar (g0 + gi))
    bq1: jnp.ndarray       # BqUb q-column: gi u1
    bq2_im: jnp.ndarray    # BqUb p-column / i: -u2 / hbar
    c2_11: jnp.ndarray     # C2b [0,0] = gi^2 u1^2 / (g0 + gi)
    c2_12_im: jnp.ndarray  # C2b [0,1] / i = -gi u1 u2 / (hbar (g0 + gi))
    c2_22: jnp.ndarray     # C2b [1,1] = -u2^2 / (hbar^2 (g0 + gi))
    m0: jnp.ndarray        # M0 diagonal: g0 + gt
    cqq: jnp.ndarray       # Cqq diagonal: g0 gi / (g0 + gi)
    ig0i: jnp.ndarray      # [Gi + G0]^{-1} diagonal: 1 / (g0 + gi)


@pytree_dataclass(meta=("dim", "rank", "m_log_det", "scan_diag"))
class WMParams:
    """Constant parameter pack of the WM propagator.

    Pseudo-determinants absorb their pi / 2 pi factors as in the reference
    (propagators.py:1107-1125): detG0 = det(G0)/pi^r etc.,
    detGi0 = det(Gi+G0)/(2 pi)^r.

    The M-matrix determinant is kept SCALED: det(M'/(2 pi)) has magnitude
    ~ prod_k(omega_k / pi)^r, which underflows complex64 beyond ~15 modes
    (e.g. 1e-180 at 60 modes, where unscaled WM observables came out
    NaN). `wm_derived` therefore computes
    detM = det(M' / m_scale) with m_scale = 2 pi exp(m_log_det / r) chosen
    so detM is O(1) (m_log_det = log det(2 U^T G0 U / (2 pi)), the t = 0
    magnitude of M'), and the exact compensation exp(-m_log_det / 2) is
    folded into `auto_pref`'s host-side log-space assembly.
    """

    hk: HKParams
    alpha: jnp.ndarray       # ()
    beta: jnp.ndarray        # ()
    auto_pref: jnp.ndarray   # ()  detG0^{1/2} detGt^{1/4} detGi^{1/4}
                             #     / detGi0^{1/2} / exp(m_log_det/2),
                             #     combined in log space
    coef_pref: jnp.ndarray   # ()  detG0^{1/4} detGt^{1/4} detGi^{1/4}
                             #     / detGi0^{1/2}
    log_coef_pref: jnp.ndarray  # () f64  log of coef_pref — the range-safe
                                # representation (coef_pref itself underflows
                                # f32 beyond ~40 modes)
    Gt: jnp.ndarray          # (d, d)  Gamma_t
    A_const: jnp.ndarray     # (2r, 2r) complex: 2 F' + [[U^T Gi U, 0],[0,0]]
                             #                   - 2i/hbar [[0,0],[I_r,0]]
    BqU: jnp.ndarray         # (d, 2r) complex: [Gi U, -i/hbar U]
    G0U: jnp.ndarray         # (d, r)  Gamma_0 U
    UtG0U: jnp.ndarray       # (r, r)  U^T Gamma_0 U
    Cqq: jnp.ndarray         # (d, d)  G0 - G0 [Gi+G0]^{-1} G0  (eqn. 69)
    G0iGi0: jnp.ndarray      # (d, d)  G0 [Gi+G0]^{-1}
    m_scale: jnp.ndarray     # ()  2 pi exp(m_log_det / r)
    Dbal: jnp.ndarray        # (2r, 2r) real blockdiag(W^{-1/2}, W^{1/2}),
                             # W = U^T G0 U: det-preserving balancing of A
    # --- scan fast path: balanced-and-scaled constants (see wm_scan_derived).
    # U1 = U W^{-1/2} / sqrt(s), U2 = U W^{1/2} / sqrt(s), s = 2 sqrt(alpha
    # beta): projecting the monodromy blocks with U1/U2 *is* the balancing
    # conjugation D (.) D / s — zero runtime cost (no explicit einsum
    # conjugation pass over the monodromy blocks).
    U1: jnp.ndarray          # (d, r) real
    U2: jnp.ndarray          # (d, r) real
    A_const_b: jnp.ndarray   # (2r, 2r) complex  D A_const D / s
    BqUb: jnp.ndarray        # (d, 2r) complex  Bq U2r D / sqrt(s)
    Fq: jnp.ndarray          # (d, 2r) complex  G0 [Gi+G0]^{-1} BqUb
    C2b: jnp.ndarray         # (2r, 2r) complex BqUb^T [Gi+G0]^{-1} BqUb
    M0: jnp.ndarray          # (r, r) real      U^T (G0 + Gt) U
    diag: WMDiagConsts | None  # per-mode constants (scan_diag only)
    dim: int
    rank: int
    m_log_det: float         # static: log of the factored-out detM scale
    scan_diag: bool          # static: all widths diagonal and rank == dim —
                             # the scan fast path runs per-mode 2x2 algebra


@pytree_dataclass
class WMBatchConstants:
    """HK batch constants plus WM-specific initial-point quantities."""

    base: BatchConstants
    eps: jnp.ndarray     # (n,)   eqn. 74 with b0 = 0 (time-independent)
    PIq: jnp.ndarray     # (n, d) eqn. 72 with pi_i = p (time-independent)
    n1q: jnp.ndarray     # (n, d) -hbar^2 tau1(q)/m
    n2q: jnp.ndarray     # (n,)   -hbar^2/2 sum_k tau2_k(q)/m_k
    z0: jnp.ndarray      # (n, 2r) complex  BqUb^T [Gi+G0]^{-1} (p0 - pi):
                         # the constant half of the dPIQ_U chain (fast path)

    @property
    def weight_scale(self):
        return self.base.weight_scale

    @property
    def log_weight_scale(self):
        return self.base.log_weight_scale


@pytree_dataclass
class WMDerived:
    """Per-step derived tensors of the WM propagator (eqns. 50-84)."""

    detA: jnp.ndarray   # (n,) complex  det(A' / 2 sqrt(alpha beta))
    detM: jnp.ndarray   # (n,) complex  det(M' / m_scale), O(1) by
                        # construction (= det(M'/2pi) exp(-m_log_det))
    CQQ: jnp.ndarray    # (n, d, d) complex  (eqn. 70)
    CqQ: jnp.ndarray    # (n, d, d) complex  (eqn. 71)
    PIQ: jnp.ndarray    # (n, d) complex     (eqn. 73)
    Rqq: jnp.ndarray    # (n, d, d) complex  (eqn. 79)
    RQQ: jnp.ndarray    # (n, d, d) complex  (eqn. 80)
    RqQ: jnp.ndarray    # (n, d, d) complex  (eqn. 81)
    Pq: jnp.ndarray     # (n, d) complex     (eqn. 82)
    PQ: jnp.ndarray     # (n, d) complex     (eqn. 83)
    gamma: jnp.ndarray  # (n,) complex       (eqn. 84)


def _build_wm_params(hk: HKParams, Gamma_i, Gamma_t, Gamma_0, alpha, beta,
                     dtype):
    cdtype = complex_dtype(dtype)
    U = np.asarray(hk.U, dtype=np.float64)
    r = hk.rank
    iG0 = linalg.pseudo_inverse(Gamma_0)
    iGi0 = np.asarray(hk.iGi0, dtype=np.float64)
    G0iGi0 = Gamma_0 @ iGi0

    # A's constant part in the projected 2r space:
    #   2 blockdiag(alpha U^T G0 U, beta U^T iG0 U)
    #   + [[U^T Gi U, 0], [0, 0]] - 2i/hbar [[0, 0], [I_r, 0]]
    # (reference propagators.py:1227-1238)
    A_const = np.zeros((2 * r, 2 * r), dtype=np.complex128)
    A_const[:r, :r] = 2.0 * alpha * (U.T @ Gamma_0 @ U) + U.T @ Gamma_i @ U
    A_const[r:, r:] = 2.0 * beta * (U.T @ iG0 @ U)
    A_const[r:, :r] = -2j / hbar * np.eye(r)

    # Bq U2 = [Gi U, -i/hbar U]  (eqn. 54 projected; constant)
    BqU = np.concatenate(
        [Gamma_i @ U, (-1j / hbar) * U.astype(np.complex128)], axis=1
    )

    # combine the pseudo-determinant prefactors in log space — the
    # individual determinants under/overflow for many modes
    # (pi / 2 pi absorption as in reference propagators.py:1107-1125)
    ld0 = linalg.pseudo_logdet(Gamma_0, scale=np.pi)
    ldi = linalg.pseudo_logdet(Gamma_i, scale=np.pi)
    ldt = linalg.pseudo_logdet(Gamma_t, scale=np.pi)
    ldi0 = linalg.pseudo_logdet(Gamma_0 + Gamma_i, scale=2 * np.pi)
    # detM scale: m_log_det = log det(2 U^T G0 U / (2 pi)) = ld0; dividing
    # M' by m_scale = 2 pi exp(m_log_det / r) keeps its determinant O(1)
    # at any mode count (see WMParams docstring), and the compensator
    # exp(-m_log_det / 2) joins the log-space prefactor assembly:
    #   0.5 ld0 + ... - 0.5 m_log_det = 0.25 ldt + 0.25 ldi - 0.5 ldi0
    m_log_det = float(ld0)
    auto_pref = np.exp(0.25 * ldt + 0.25 * ldi - 0.5 * ldi0)
    log_coef_pref = 0.25 * ld0 + 0.25 * ldt + 0.25 * ldi - 0.5 * ldi0
    coef_pref = np.exp(log_coef_pref)

    # determinant-preserving balancing of A: blockdiag(W^{-1/2}, W^{1/2}),
    # W = U^T G0 U. det(D) = 1 exactly, so det(D A D) = det(A), but the
    # conjugation brings every block of A/(2 sqrt(alpha beta)) to O(1) —
    # without it the Schur recursion's *intermediate* block determinants
    # are ~ prod(omega)^r and underflow complex64 beyond ~15 modes
    W = U.T @ Gamma_0 @ U
    ew, Vw = np.linalg.eigh(W)
    W_sqrt = (Vw * np.sqrt(ew)) @ Vw.T
    W_isqrt = (Vw / np.sqrt(ew)) @ Vw.T
    Dbal = np.zeros((2 * r, 2 * r))
    Dbal[:r, :r] = W_isqrt
    Dbal[r:, r:] = W_sqrt

    # scan fast path: fold BOTH the balancing D and the 1/s scale into the
    # projectors. Every trajectory-dependent term of A is bilinear in the
    # 2r-projected monodromy, so projecting with U1/U2 = U W^{-/+1/2}/sqrt(s)
    # assembles Ab = D (A/s) D directly — det(Ab) = det(A/s) (det D = 1) and
    # iA = (D/sqrt(s)) iAb (D/sqrt(s)) re-absorbs into the SAME balanced
    # operands everywhere downstream (BQUb iAb BqUb^T etc.), so no explicit
    # conjugation pass ever runs.
    s_ab = 2.0 * np.sqrt(alpha * beta)
    sc = 1.0 / np.sqrt(s_ab)
    U1 = U @ W_isqrt * sc
    U2 = U @ W_sqrt * sc
    A_const_b = Dbal @ A_const @ Dbal / s_ab
    BqUb = np.concatenate(
        [Gamma_i @ U1, (-1j / hbar) * U2.astype(np.complex128)], axis=1)
    Fq = G0iGi0 @ BqUb
    C2b = BqUb.T @ iGi0 @ BqUb  # plain transpose (no conjugation)
    M0 = U.T @ (Gamma_0 + Gamma_t) @ U

    # separable all-diagonal detection (see WMDiagConsts): exact-zero
    # off-diagonals, like HK's factors_diag — model potentials build their
    # width matrices with np.diag, molecular fchk widths are dense
    def _isdiag(M):
        M = np.asarray(M, dtype=np.float64)
        return float(np.abs(M - np.diag(np.diag(M))).max()) == 0.0

    scan_diag = (r == hk.dim and _isdiag(Gamma_0) and _isdiag(Gamma_i)
                 and _isdiag(Gamma_t))
    diag = None
    if scan_diag:
        g0d = np.diag(np.asarray(Gamma_0, dtype=np.float64))
        gid = np.diag(np.asarray(Gamma_i, dtype=np.float64))
        gtd = np.diag(np.asarray(Gamma_t, dtype=np.float64))
        u1d = 1.0 / np.sqrt(g0d) * sc
        u2d = np.sqrt(g0d) * sc
        gi0 = g0d + gid
        vec = lambda x: jnp.asarray(np.broadcast_to(x, g0d.shape),
                                    dtype=dtype)
        diag = WMDiagConsts(
            u1=vec(u1d), u2=vec(u2d), gt=vec(gtd), g0=vec(g0d),
            cb11=vec((2.0 * alpha * g0d + gid) / (g0d * s_ab)),
            cb12_im=vec(-2.0 / (hbar * s_ab)),
            cb22=vec(2.0 * beta / s_ab),
            fq1=vec(g0d * gid * u1d / gi0),
            fq2_im=vec(-g0d * u2d / (hbar * gi0)),
            bq1=vec(gid * u1d),
            bq2_im=vec(-u2d / hbar),
            c2_11=vec(gid**2 * u1d**2 / gi0),
            c2_12_im=vec(-gid * u1d * u2d / (hbar * gi0)),
            c2_22=vec(-u2d**2 / (hbar**2 * gi0)),
            m0=vec(g0d + gtd),
            cqq=vec(g0d * gid / gi0),
            ig0i=vec(1.0 / gi0),
        )

    return WMParams(
        hk=hk,
        alpha=jnp.asarray(alpha, dtype=dtype),
        beta=jnp.asarray(beta, dtype=dtype),
        auto_pref=jnp.asarray(auto_pref, dtype=dtype),
        coef_pref=jnp.asarray(coef_pref, dtype=dtype),
        log_coef_pref=jnp.asarray(log_coef_pref, dtype=jnp.float64),
        Gt=jnp.asarray(Gamma_t, dtype=dtype),
        A_const=to_device(A_const, cdtype),
        BqU=to_device(BqU, cdtype),
        G0U=jnp.asarray(Gamma_0 @ U, dtype=dtype),
        UtG0U=jnp.asarray(U.T @ Gamma_0 @ U, dtype=dtype),
        Cqq=jnp.asarray(Gamma_0 - Gamma_0 @ iGi0 @ Gamma_0, dtype=dtype),
        G0iGi0=jnp.asarray(G0iGi0, dtype=dtype),
        m_scale=jnp.asarray(2.0 * np.pi * np.exp(m_log_det / r),
                            dtype=dtype),
        Dbal=jnp.asarray(Dbal, dtype=dtype),
        U1=jnp.asarray(U1, dtype=dtype),
        U2=jnp.asarray(U2, dtype=dtype),
        A_const_b=to_device(A_const_b, cdtype),
        BqUb=to_device(BqUb, cdtype),
        Fq=to_device(Fq, cdtype),
        C2b=to_device(C2b, cdtype),
        M0=jnp.asarray(M0, dtype=dtype),
        diag=diag,
        dim=hk.dim,
        rank=hk.rank,
        m_log_det=m_log_det,
        scan_diag=scan_diag,
    )


# ---------------------------------------------------------------------------
# per-step derived quantities
# ---------------------------------------------------------------------------


def _mono_proj(M, U):
    """M @ U for a dense (n, d, d) monodromy block, or the row-scale
    diag(M) U for the (n, d) diagonal representation (see TrajState)."""
    return M @ U if M.ndim == 3 else M[:, :, None] * U[None]

def wm_derived(params: WMParams, bc: WMBatchConstants,
               state: TrajState) -> WMDerived:
    """All per-trajectory WM tensors for the current state (eqns. 50-84)."""
    hk = params.hk
    cdtype = hk.cdtype
    U = hk.U.astype(state.Mqq.dtype)             # (d, r)
    r = params.rank
    p0 = hk.p0

    # project monodromy blocks once: (n, d, r) real matmuls
    MqqU = _mono_proj(state.Mqq, U)
    MqpU = _mono_proj(state.Mqp, U)
    MpqU = _mono_proj(state.Mpq, U)
    MppU = _mono_proj(state.Mpp, U)
    MqzU = jnp.concatenate([MqqU, MqpU], axis=2)   # (n, d, 2r)
    MpzU = jnp.concatenate([MpqU, MppU], axis=2)   # (n, d, 2r)

    # hess(L)' = i/hbar [[Mpq^T Mqq, Mpq^T Mqp], [Mqp^T Mpq, Mqp^T Mpp]]
    # projected (eqns. A6-A9, reference propagators.py:1179-1191)
    Sqq = jnp.einsum("nia,nib->nab", MpqU, MqqU)
    Sqp = jnp.einsum("nia,nib->nab", MpqU, MqpU)
    Spq = jnp.einsum("nia,nib->nab", MqpU, MpqU)
    Spp = jnp.einsum("nia,nib->nab", MqpU, MppU)
    hessL = times_i(jnp.concatenate([
        jnp.concatenate([Sqq, Sqp], axis=2),
        jnp.concatenate([Spq, Spp], axis=2)], axis=1) / hbar)  # (n, 2r, 2r)

    # A' (eqn. 50 projected)
    GtMqzU = jnp.einsum("ij,njb->nib", params.Gt, MqzU)    # (n, d, 2r)
    A = (params.A_const[None]
         - hessL
         + jnp.einsum("nia,nib->nab", MqzU, GtMqzU).astype(cdtype)
         + times_i(jnp.einsum("nia,nib->nab", MpzU, MqzU) * (2.0 / hbar)))

    # det(A / 2 sqrt(alpha beta)) — the limit of det(A) is
    # (2 sqrt(alpha beta))^{2r} for alpha, beta -> oo, so the *scaled*
    # determinant is O(1) (reference propagators.py:1312-1332). Factorise
    # the scaled matrix once: inv(A) = inv(A/s) / s.
    s_ab = (2.0 * jnp.sqrt(params.alpha * params.beta)).astype(
        real_dtype(cdtype))
    # balance before factorising: det unchanged (det Dbal = 1), Schur
    # intermediates stay O(1) in complex64 (see _build_wm_params)
    D = params.Dbal.astype(real_dtype(cdtype))
    Abal = jnp.einsum("ab,nbc,cd->nad", D, A / s_ab, D)
    detA, iAb = linalg.batched_det_inv(Abal)
    iA = jnp.einsum("ab,nbc,cd->nad", D, iAb, D) / s_ab     # (n, 2r, 2r)

    # BQ U2 = Gt Mqz U2 + i/hbar Mpz U2 (eqn. 53 projected)
    BQU = GtMqzU.astype(cdtype) + times_i(MpzU / hbar)      # (n, d, 2r)

    # eqn. 57: Gt(t) = Gt - BQ iA BQ^T
    iA_BQ = jnp.einsum("nab,njb->naj", iA, BQU)             # (n, 2r, d)
    Gt_t = params.Gt.astype(cdtype)[None] - jnp.einsum(
        "nia,naj->nij", BQU, iA_BQ)
    # eqn. 59: Gti = BQ iA Bq^T  (Bq is constant)
    iA_Bq = jnp.einsum("nab,jb->naj", iA, params.BqU)       # (n, 2r, d)
    Gti = jnp.einsum("nia,naj->nij", BQU, iA_Bq)            # (n, d, d)

    # eqns. 68-73 (with pi_i = p, pi_t = P since b0 = 0)
    iGi0 = hk.iGi0
    Gti_iGi0 = jnp.einsum("nij,jk->nik", Gti, iGi0.astype(cdtype))
    CQQ = Gt_t - jnp.einsum("nik,nlk->nil", Gti_iGi0, Gti)            # (70)
    CqQ = jnp.einsum("ik,nlk->nil", params.G0iGi0.astype(cdtype), Gti)  # (71)
    dp0 = _center_minus_initial(p0, hk.p0c, bc.base.pi).astype(cdtype)  # (n, d)
    PIQ = state.p.astype(cdtype) + jnp.einsum("nik,nk->ni", Gti_iGi0, dp0)  # (73)

    # eqn. 78: M = G0 + CQQ, projected to the non-zero subspace
    Mp = params.UtG0U.astype(cdtype)[None] + jnp.einsum(
        "ia,nij,jb->nab", U.astype(cdtype), CQQ, U.astype(cdtype))
    # scaled determinant — see WMParams docstring; plain det(M'/2 pi)
    # underflows complex64 beyond ~15 modes
    m_scale = params.m_scale.astype(real_dtype(cdtype))
    detM, iM_s = linalg.batched_det_inv(Mp / m_scale)
    iM = iM_s / m_scale                                         # (n, r, r)

    # eqns. 79-84 with iM folded through U
    CqQU = CqQ @ U.astype(cdtype)                           # (n, d, r)
    G0U = params.G0U.astype(cdtype)                         # (d, r)
    iM_CqQ = jnp.einsum("nab,njb->naj", iM, CqQU)           # (n, r, d)
    Rqq = params.Cqq.astype(cdtype)[None] - jnp.einsum(
        "nia,naj->nij", CqQU, iM_CqQ)                                  # (79)
    iM_G0 = jnp.einsum("nab,jb->naj", iM, G0U)              # (n, r, d)
    RQQ = hk.G0.astype(cdtype)[None] - jnp.einsum(
        "ia,naj->nij", G0U, iM_G0)                                     # (80)
    RqQ = jnp.einsum("nia,naj->nij", CqQU, iM_G0)                      # (81)

    dPIQ = PIQ - p0[None, :].astype(cdtype)                 # PIQ - p0
    dPIQ_U = dPIQ @ U.astype(cdtype)                        # (n, r)
    iM_dPIQ = jnp.einsum("nab,nb->na", iM, dPIQ_U)          # (n, r)
    Pq = bc.PIq.astype(cdtype) - jnp.einsum("nia,na->ni", CqQU, iM_dPIQ)  # (82)
    PQ = p0[None, :].astype(cdtype) + jnp.einsum("ia,na->ni", G0U, iM_dPIQ)  # (83)
    gamma = bc.eps.astype(cdtype) - (0.5 / hbar**2) * jnp.einsum(
        "na,na->n", dPIQ_U, iM_dPIQ)                                   # (84)

    return WMDerived(detA=detA, detM=detM, CQQ=CQQ, CqQ=CqQ, PIQ=PIQ,
                     Rqq=Rqq, RQQ=RQQ, RqQ=RqQ, Pq=Pq, PQ=PQ, gamma=gamma)


# ---------------------------------------------------------------------------
# scan fast path
# ---------------------------------------------------------------------------
#
# The production time loop never needs the (n, d, d) Gaussian-parameter
# tensors of eqns. 57-83 — every observable of eqns. 85-100 is a scalar
# bilinear form x^T R y with x, y drawn from {q0-q(0), q0-q(t), n1(q),
# n1(Q), dPIQ}. Substituting the R definitions turns each form into
# (projected r-vector)^T iM (projected r-vector), and the projected vectors
# themselves come from ONE per-step (n, 2r, r) solve product Y = iAb^T P.
# The full-tensor chain is memory-bound (8+ (n, d, d) complex
# materialisations per step); this path materialises only Ab, iAb
# (n, 2r, 2r) and Mp, iM (n, r, r).
# The full-tensor `wm_derived` remains for the diagnostics (wavefunction /
# norm / granular API) and as the parity cross-check.

@pytree_dataclass
class WMScanDerived:
    """Per-trajectory scalars — everything eqns. 85-100 need."""

    detA: jnp.ndarray    # (n,) complex  det(A'/2 sqrt(alpha beta))
    detM: jnp.ndarray    # (n,) complex  det(M'/m_scale)
    gamma: jnp.ndarray   # (n,) complex  eqn. 84
    rqq: jnp.ndarray     # (n,) complex  dq^T Rqq dq
    rQQ: jnp.ndarray     # (n,) complex  dQ^T RQQ dQ
    rqQ: jnp.ndarray     # (n,) complex  dq^T RqQ dQ
    Pq_dq: jnp.ndarray   # (n,) complex  Pq . dq
    PQ_dQ: jnp.ndarray   # (n,) complex  PQ . dQ
    kfac: jnp.ndarray    # (n,) complex  nacqQ + nacQ nacq  (eqns. 89-100)


# the log-space complex mode product shared with hk_prefactor_det —
# canonical implementation in linalg
_logspace_prod = linalg.logspace_mode_product


def _wm_diag_core(params: WMParams, state: TrajState):
    """Per-mode 2x2 A/M algebra of the diag fast path: returns (detA,
    detM, y1, y2, iM) with every batched tensor (n, d)."""
    hk = params.hk
    cdtype = hk.cdtype
    rd = real_dtype(cdtype)
    dg = params.diag
    ih = 1.0 / hbar

    row = lambda v: v.astype(rd)[None, :]
    u1, u2, gt = row(dg.u1), row(dg.u2), row(dg.gt)
    X1 = state.Mqq.astype(rd) * u1                        # (n, d)
    X2 = state.Mqp.astype(rd) * u2
    Z1 = state.Mpq.astype(rd) * u1
    Z2 = state.Mpp.astype(rd) * u2

    # balanced transposed-A blocks, per mode (cf. the Gram-block assembly
    # of the generic path; all re/im planes are real elementwise products)
    G11, G12, G22 = gt * X1 * X1, gt * X1 * X2, gt * X2 * X2
    B11, B12 = X1 * Z1, X1 * Z2
    B21, B22 = X2 * Z1, X2 * Z2
    TR1, TR2 = Z1 * X2, Z2 * X2
    At11 = lax.complex(row(dg.cb11) + G11, B11 * ih)
    At12 = lax.complex(G12, row(dg.cb12_im) + (2.0 * B12 - TR1) * ih)
    At21 = lax.complex(G12, B21 * ih)
    At22 = lax.complex(row(dg.cb22) + G22, (2.0 * B22 - TR2) * ih)
    P1 = lax.complex(gt * X1, Z1 * ih)
    P2 = lax.complex(gt * X2, Z2 * ih)

    det_i = At11 * At22 - At12 * At21                     # (n, d) complex
    detA = _logspace_prod(det_i.real, det_i.imag, cdtype)

    # Y = At^{-1} P, closed-form 2x2 per mode. XLA's complex divide lowers
    # to Smith's scaled algorithm (branches + several real divides per
    # element); the balanced dets are O(1) by construction, so the plain
    # conj/|z|^2 reciprocal is safe and much cheaper.
    inv_det = jnp.conj(det_i) * (1.0 / (det_i.real**2 + det_i.imag**2))
    y1 = (At22 * P1 - At12 * P2) * inv_det
    y2 = (At11 * P2 - At21 * P1) * inv_det

    # M' = M0 - Y^T (P + C2b Y), scalar per mode
    c2y1 = row(dg.c2_11) * y1 + row(dg.c2_12_im) * times_i(y2)
    c2y2 = row(dg.c2_12_im) * times_i(y1) + row(dg.c2_22) * y2
    Mp = (row(dg.m0).astype(cdtype)
          - (y1 * (P1 + c2y1) + y2 * (P2 + c2y2)))
    Mps = Mp * (1.0 / params.m_scale.astype(rd))
    detM = _logspace_prod(Mps.real, Mps.imag, cdtype)
    # same conj/|z|^2 reciprocal rationale as inv_det above
    iM = jnp.conj(Mp) * (1.0 / (Mp.real**2 + Mp.imag**2))  # (n, d) complex
    return detA, detM, y1, y2, iM


# module-level wrapper: a fresh jax.jit(...) per call would rebuild the
# trace cache every repetition (_make_trackers runs once per batch)
_wm_diag_core_jit = jax.jit(_wm_diag_core)


def _wm_scan_derived_diag(params: WMParams, bc: WMBatchConstants,
                          state: TrajState, potential) -> WMScanDerived:
    """Per-mode 2x2 evaluation of `wm_scan_derived` (see WMDiagConsts).

    Numerically identical to the generic path (the projection basis U is
    orthogonal and the balancing is det-preserving, so detA, detM and every
    bilinear form agree to rounding — gated by
    tests/test_wm_fastpath.py::test_diag_path_matches_generic); all batched
    tensors are (n, d) and the whole derivation is elementwise plus
    mode-axis reductions — nothing ever enters a batched matmul.
    """
    hk = params.hk
    cdtype = hk.cdtype
    rd = real_dtype(cdtype)
    dg = params.diag
    row = lambda v: v.astype(rd)[None, :]

    # projected observable vectors (differences at trajectory precision,
    # comp32 residuals folded in)
    t = params.Gt.dtype
    dq = _center_minus_initial(hk.q0, hk.q0c, bc.base.qi).astype(t)
    dQ = _dQ_evolved(hk, state).astype(t)
    n1q = bc.n1q.astype(t)
    n1Q_t, n2Q_t = _nac_terms(potential, state.q)
    n1Q = n1Q_t.astype(t)
    dp = _dp_evolved(hk, state).astype(t)
    dp0 = _center_minus_initial(hk.p0, hk.p0c, bc.base.pi).astype(t)
    g0r = dg.g0.astype(t)[None, :]

    detA, detM, y1, y2, iM = _wm_diag_core(params, state)

    # A_vec(x) = (y . Fq) x, dPIQ_U = dp + (y . BqUb) [Gi+G0]^{-1} (p0-pi)
    yf = row(dg.fq1) * y1 + row(dg.fq2_im) * times_i(y2)  # (n, d) complex
    yb = row(dg.bq1) * y1 + row(dg.bq2_im) * times_i(y2)
    s0 = yf * dq
    s1 = yf * n1q
    s2 = (g0r * dQ).astype(cdtype)
    s3 = (g0r * n1Q).astype(cdtype)
    s4 = dp.astype(cdtype) + yb * (dg.ig0i.astype(t)[None, :] * dp0)
    # the 13 needed gram entries s_k^T iM s_l as explicit fused reductions
    # over the mode axis (a batched (n, 5, d) @ (n, d, 5) einsum would run
    # a 5x5-output matmul per trajectory)
    sv = (s0, s1, s2, s3, s4)
    wv = tuple(s * iM for s in sv)
    gram = {(k, l): jnp.sum(sv[k] * wv[l], axis=1)
            for k, l in ((0, 0), (0, 1), (0, 2), (0, 3), (0, 4),
                         (1, 2), (1, 3), (1, 4),
                         (2, 2), (2, 3), (2, 4),
                         (3, 4), (4, 4))}
    g_DD = jnp.sum(dQ * g0r * dQ, axis=1).astype(cdtype)
    g_Dn = jnp.sum(dQ * g0r * n1Q, axis=1).astype(cdtype)
    p0_dQ = jnp.einsum("i,ni->n", hk.p0.astype(t), dQ).astype(cdtype)
    p0_n = jnp.einsum("i,ni->n", hk.p0.astype(t), n1Q).astype(cdtype)

    # constant-matrix bilinear pieces, diagonal weights (batch constants —
    # XLA hoists them out of the time scan)
    cqq = dg.cqq.astype(t)[None, :]
    c_dd = jnp.sum(dq * cqq * dq, axis=1).astype(cdtype)
    c_dn = jnp.sum(dq * cqq * n1q, axis=1).astype(cdtype)
    piq_dq = jnp.einsum("ni,ni->n", bc.PIq.astype(t), dq).astype(cdtype)
    piq_n = jnp.einsum("ni,ni->n", bc.PIq.astype(t), n1q).astype(cdtype)

    rqq = c_dd - gram[0, 0]
    rQQ = g_DD - gram[2, 2]
    rqQ = gram[0, 2]
    Pq_dq = piq_dq - gram[0, 4]
    PQ_dQ = p0_dQ + gram[2, 4]
    gamma = bc.eps.astype(cdtype) - (0.5 / hbar**2) * gram[4, 4]

    nacqQ = gram[1, 3]
    nacQ = (n2Q_t.astype(cdtype)
            + (g_Dn - gram[2, 3])
            - gram[0, 3]
            - times_i((p0_n + gram[3, 4]) / hbar))
    nacq = (bc.n2q.astype(cdtype)
            + (c_dn - gram[0, 1])
            - gram[1, 2]
            + times_i((piq_n - gram[1, 4]) / hbar))
    kfac = nacqQ + nacQ * nacq

    return WMScanDerived(detA=detA, detM=detM, gamma=gamma, rqq=rqq,
                         rQQ=rQQ, rqQ=rqQ, Pq_dq=Pq_dq, PQ_dQ=PQ_dQ,
                         kfac=kfac)


def wm_scan_derived(params: WMParams, bc: WMBatchConstants, state: TrajState,
                    potential) -> WMScanDerived:
    if params.scan_diag and state.diag_monodromy:
        return _wm_scan_derived_diag(params, bc, state, potential)
    hk = params.hk
    cdtype = hk.cdtype
    rd = real_dtype(cdtype)
    r = params.rank

    # balanced projections: U1/U2 carry D and 1/sqrt(s)
    X2 = _mono_proj(state.Mqp.astype(rd), params.U2)       # (n, d, r)
    XL = jnp.concatenate(
        [_mono_proj(state.Mqq.astype(rd), params.U1), X2], axis=2)
    ZL = jnp.concatenate(
        [_mono_proj(state.Mpq.astype(rd), params.U1),
         _mono_proj(state.Mpp.astype(rd), params.U2)], axis=2)  # (n, d, 2r)

    Gt = params.Gt.astype(rd)
    W = jnp.einsum("ij,njb->nib", Gt, XL)                  # (n, d, 2r)

    # Gram blocks of the TRANSPOSED balanced A-matrix, from THREE wide
    # batched matmuls instead of seven (n, r, r) einsums:
    #   G  = [X1|X2]^T Gt [X1|X2]   all four symmetric blocks at once
    #   B  = [X1|X2]^T [Z1|Z2]      = [[T11^T, T21^T], [T12^T, T22^T]]
    #   TR = [Z1|Z2]^T X2           = [[T12], [T22]]  (n, 2r, r)
    # Blocks of Ab: sym (symmetric) and imag = [[T11, T12],
    # [2 T21 - T12^T, 2 T22 - T22^T]]; the transposed assembly needs
    # imag^T = [[T11^T, 2 T21^T - T12], [T12^T, 2 T22^T - T22]] — its left
    # half is B's, its right half is 2 B[:, :, r:] - TR.
    G = jnp.einsum("nia,nib->nab", XL, W)                  # (n, 2r, 2r)
    B = jnp.einsum("nia,nib->nab", XL, ZL)                 # (n, 2r, 2r)
    TR = jnp.einsum("nia,nib->nab", ZL, X2)                # (n, 2r, r)

    cbT = jnp.swapaxes(params.A_const_b, 0, 1)             # (2r, 2r) const
    At11 = (cbT[None, :r, :r] + G[:, :r, :r].astype(cdtype)
            + times_i(B[:, :r, :r] / hbar))
    At12 = (cbT[None, :r, r:] + G[:, :r, r:].astype(cdtype)
            + times_i((2.0 * B[:, :r, r:] - TR[:, :r, :]) / hbar))
    At21 = (cbT[None, r:, :r] + G[:, r:, :r].astype(cdtype)
            + times_i(B[:, r:, :r] / hbar))
    At22 = (cbT[None, r:, r:] + G[:, r:, r:].astype(cdtype)
            + times_i((2.0 * B[:, r:, r:] - TR[:, r:, :]) / hbar))

    # P = BQUb^T U with BQUb = W + i ZL/hbar — two fused 2r-row products
    # instead of four r-row ones
    U = hk.U.astype(rd)
    PW = jnp.einsum("nia,ij->naj", W, U)                   # (n, 2r, r)
    PZ = jnp.einsum("nia,ij->naj", ZL, U)
    P1 = PW[:, :r, :].astype(cdtype) + times_i(PZ[:, :r, :] / hbar)
    P2 = PW[:, r:, :].astype(cdtype) + times_i(PZ[:, r:, :] / hbar)

    # Y = Ab^{-T} P = At^{-1} P — one det+solve on the blocked system;
    # the (n, 2r, 2r) inverse is never materialised
    detA, Y = linalg.batched_det_solve_blocks(
        At11, At12, At21, At22, P1, P2)                    # (n, 2r, r)
    P = jnp.concatenate([P1, P2], axis=1)                  # (n, 2r, r)

    # M' = U^T (G0 + Gt(t)) U ... = M0 - Y^T (P + C2b Y)  (eqns. 68, 78)
    C2Y = jnp.einsum("ab,nbk->nak", params.C2b, Y)
    Mp = (params.M0.astype(cdtype)[None]
          - jnp.einsum("nak,nal->nkl", Y, P + C2Y))
    m_scale = params.m_scale.astype(rd)

    # projected observable vectors (differences at trajectory precision,
    # comp32 residuals folded in)
    t = params.Gt.dtype
    dq = _center_minus_initial(hk.q0, hk.q0c, bc.base.qi).astype(t)
    dQ = _dQ_evolved(hk, state).astype(t)
    n1q = bc.n1q.astype(t)
    n1Q_t, n2Q_t = _nac_terms(potential, state.q)
    n1Q = n1Q_t.astype(t)

    def A_vec(x):
        # CqQU^T x = Y^T (Fq^T x)  (see module docstring derivation)
        z = jnp.einsum("ia,ni->na", params.Fq, x)          # (n, 2r)
        return jnp.einsum("nak,na->nk", Y, z)              # (n, r)

    G0U = params.G0U.astype(t)
    A_dq = A_vec(dq)
    A_n1q = A_vec(n1q)
    G_dQ = (dQ @ G0U).astype(cdtype)
    G_n1Q = (n1Q @ G0U).astype(cdtype)
    dp = _dp_evolved(hk, state).astype(t)
    dPIQ_U = ((dp @ U.astype(t)).astype(cdtype)
              + jnp.einsum("nak,na->nk", Y, bc.z0))        # (n, r)

    # one fused det+solve applies iM to the whole 5-vector stack — the
    # (n, r, r) inverse is never materialised
    stack = jnp.stack([A_dq, A_n1q, G_dQ, G_n1Q, dPIQ_U], axis=2)  # (n,r,5)
    detM, Z5 = linalg.batched_det_solve(Mp / m_scale, stack)
    iM_stack = Z5 / m_scale
    gram = jnp.einsum("nak,nal->nkl", stack, iM_stack)     # (n, 5, 5)

    # constant-matrix bilinear pieces
    Cqq = params.Cqq.astype(t)
    G0 = hk.G0.astype(t)
    c_dd = jnp.einsum("ni,ij,nj->n", dq, Cqq, dq).astype(cdtype)
    c_dn = jnp.einsum("ni,ij,nj->n", dq, Cqq, n1q).astype(cdtype)
    g_DD = jnp.einsum("ni,ij,nj->n", dQ, G0, dQ).astype(cdtype)
    g_Dn = jnp.einsum("ni,ij,nj->n", dQ, G0, n1Q).astype(cdtype)
    piq_dq = jnp.einsum("ni,ni->n", bc.PIq.astype(t), dq).astype(cdtype)
    piq_n = jnp.einsum("ni,ni->n", bc.PIq.astype(t), n1q).astype(cdtype)
    p0_dQ = jnp.einsum("i,ni->n", hk.p0.astype(t), dQ).astype(cdtype)
    p0_n = jnp.einsum("i,ni->n", hk.p0.astype(t), n1Q).astype(cdtype)

    rqq = c_dd - gram[:, 0, 0]                             # dq^T Rqq dq
    rQQ = g_DD - gram[:, 2, 2]                             # dQ^T RQQ dQ
    rqQ = gram[:, 0, 2]                                    # dq^T RqQ dQ
    Pq_dq = piq_dq - gram[:, 0, 4]
    PQ_dQ = p0_dQ + gram[:, 2, 4]
    gamma = bc.eps.astype(cdtype) - (0.5 / hbar**2) * gram[:, 4, 4]

    # IC-correlation NAC factors (eqns. 89-100, cf. wm_observables)
    nacqQ = gram[:, 1, 3]                                  # n1q^T RqQ n1Q
    nacQ = (n2Q_t.astype(cdtype)
            + (g_Dn - gram[:, 2, 3])                       # dQ^T RQQ n1Q
            - gram[:, 0, 3]                                # dq^T RqQ n1Q
            - times_i((p0_n + gram[:, 3, 4]) / hbar))      # PQ . n1Q
    nacq = (bc.n2q.astype(cdtype)
            + (c_dn - gram[:, 0, 1])                       # dq^T Rqq n1q
            - gram[:, 1, 2]                                # n1q^T RqQ dQ
            + times_i((piq_n - gram[:, 1, 4]) / hbar))     # Pq . n1q
    kfac = nacqQ + nacQ * nacq

    return WMScanDerived(detA=detA, detM=detM, gamma=gamma, rqq=rqq,
                         rQQ=rQQ, rqQ=rqQ, Pq_dq=Pq_dq, PQ_dQ=PQ_dQ,
                         kfac=kfac)


def wm_scan_observables(params: WMParams, bc: WMBatchConstants,
                        state: TrajState, sd: WMScanDerived, c_signed,
                        signs_A, signs_M, with_m2=False):
    """(C_auto(t), k~ic(t)) from the scalar forms (eqns. 85, 89-100).
    With `with_m2` additionally the second moments sum|x_i|^2 of both
    per-trajectory contribution vectors (Monte-Carlo standard errors on
    the host — see hk.hk_observables)."""
    cdtype = c_signed.dtype
    pref = (params.auto_pref.astype(cdtype) * c_signed
            * phase_exp(state.S / hbar, cdtype)
            * signs_A / jnp.sqrt(sd.detA)
            * signs_M / jnp.sqrt(sd.detM))
    expo = (sd.gamma
            + bc.base.logw_norm.astype(cdtype)
            - 0.5 * sd.rqq - 0.5 * sd.rQQ + sd.rqQ
            + times_i((sd.PQ_dQ - sd.Pq_dq) / hbar))
    cauto_qp = pref * jnp.exp(expo)
    kic_qp = (1.0 / hbar**2) * sd.kfac * cauto_qp
    if with_m2:
        return (jnp.sum(cauto_qp), jnp.sum(kic_qp),
                _m2_contrib(cauto_qp, with_m2),
                _m2_contrib(kic_qp, with_m2))
    return jnp.sum(cauto_qp), jnp.sum(kic_qp)


# ---------------------------------------------------------------------------
# batch constants
# ---------------------------------------------------------------------------

def wm_batch_constants(params: WMParams, qi, pi, log_prob,
                       potential=None) -> WMBatchConstants:
    base = hk_batch_constants(params.hk, qi, pi, log_prob,
                              potential=potential)
    dp0 = _center_minus_initial(params.hk.p0, params.hk.p0c, pi)
    # eps (eqn. 74 with b0 = 0) and PIq (eqn. 72 with pi_i = p). The
    # difference dp0 is formed at trajectory precision above; the (d, d)
    # contractions run at the OBSERVABLE dtype — the same precision
    # structure as every other observable quadratic form (hk.py
    # _build_hk_params docstring); eps/PIq are consumed at the observable
    # dtype downstream anyway.
    t = params.Gt.dtype
    dp0t = dp0.astype(t)
    eps = -(0.5 / hbar**2) * jnp.einsum(
        "na,ab,nb->n", dp0t, params.hk.iGi0.astype(t), dp0t)
    PIq = params.hk.p0[None, :].astype(t) - dp0t @ params.G0iGi0.T.astype(t)
    if potential is None:
        n1q = jnp.zeros_like(qi)
        n2q = jnp.zeros(qi.shape[0], dtype=qi.dtype)
    else:
        n1q, n2q = _nac_terms(potential, qi)
    v0 = (dp0t @ params.hk.iGi0.astype(t))                    # (n, d)
    z0 = jnp.einsum("ia,ni->na", params.BqUb, v0)             # (n, 2r)
    return WMBatchConstants(base=base, eps=eps, PIq=PIq, n1q=n1q, n2q=n2q,
                            z0=z0)


# register with the fused initial-conditions program (hk._ic_setup); the
# registry avoids a function-valued static jit arg, whose repr (memory
# address) would poison the persistent-compile-cache key
from semiclassical_jax.propagation import hk as _hk_mod  # noqa: E402

_hk_mod._BC_BUILDERS["wm"] = wm_batch_constants


def _center_minus_initial(x0, x0c, xi):
    """x0 - xi at the sampling precision. `xi` is the f64 sampler output in
    every mode (comp32 included); the comp32 center is stored split as
    x0 + x0c, so recombine it at xi's dtype before differencing. Depends
    only on batch constants — XLA hoists it out of the time scan."""
    x0f = x0.astype(xi.dtype)
    if x0c is not None:
        x0f = x0f + x0c.astype(xi.dtype)
    return x0f[None, :] - xi


def _dQ_evolved(hk, state):
    """q0 - q(t) at trajectory-difference quality: in comp32 mode both the
    center and the state are split f32 + residual, and folding the residual
    difference in keeps the f64-difference quality of the mixed mode at
    f32-op cost (same pattern as hk_autocorr_qp)."""
    dQ = hk.q0[None, :] - state.q.astype(hk.q0.dtype)
    if state.compensated and hk.q0c is not None:
        dQ = dQ + (hk.q0c - state.qc)
    return dQ


def _dp_evolved(hk, state):
    """p(t) - p0 with comp32 residuals folded in (see _dQ_evolved)."""
    dp = state.p.astype(hk.p0.dtype) - hk.p0[None, :]
    if state.compensated and hk.p0c is not None:
        dp = dp + (state.pc - hk.p0c)
    return dp


def _nac_terms(potential, x):
    """n1 = -hbar^2 tau1/m (n, d), n2 = -hbar^2/2 sum_k tau2_k/m_k (n,)
    (eqns. 89-90, reference propagators.py:1692-1697)."""
    inv_m = 1.0 / potential.masses()
    tau1 = potential.derivative_coupling_1st(x)
    tau2 = potential.derivative_coupling_2nd(x)
    n1 = -(hbar**2) * tau1 * inv_m[None, :]
    n2 = -(hbar**2) * 0.5 * jnp.sum(tau2 * inv_m[None, :], axis=1)
    return n1, n2


# ---------------------------------------------------------------------------
# observables
# ---------------------------------------------------------------------------

def wm_autocorr_qp(params: WMParams, bc: WMBatchConstants, state: TrajState,
                   derived: WMDerived, c_signed, signs_A, signs_M):
    """Per-trajectory autocorrelation contribution (eqn. 85,
    reference propagators.py:1577-1614)."""
    hk = params.hk
    cdtype = c_signed.dtype
    dq = _center_minus_initial(hk.q0, hk.q0c,
                               bc.base.qi).astype(cdtype)   # q0 - q(0)
    dQ = _dQ_evolved(hk, state).astype(cdtype)              # q0 - q(t)

    pref = params.auto_pref.astype(cdtype)
    phase = phase_exp(state.S / hbar, cdtype)
    pref = (pref * c_signed * phase
            * signs_A / jnp.sqrt(derived.detA)
            * signs_M / jnp.sqrt(derived.detM))

    # normalised MC log-weight folded into the exponent: the Gaussian factor
    # alone can underflow the complex dtype for tail trajectories while the
    # weighted contribution stays O(1/n)
    expo = (derived.gamma
            + bc.base.logw_norm.astype(cdtype)
            - 0.5 * jnp.einsum("ni,nij,nj->n", dq, derived.Rqq, dq)
            - 0.5 * jnp.einsum("ni,nij,nj->n", dQ, derived.RQQ, dQ)
            + jnp.einsum("ni,nij,nj->n", dq, derived.RqQ, dQ)
            + times_i((jnp.einsum("ni,ni->n", derived.PQ, dQ)
                       - jnp.einsum("ni,ni->n", derived.Pq, dq)) / hbar))
    return pref * jnp.exp(expo)


def wm_observables(params: WMParams, bc: WMBatchConstants, state: TrajState,
                   derived: WMDerived, c_signed, signs_A, signs_M,
                   potential):
    """(C_auto(t), k~ic(t)) reduced over the batch (eqns. 85, 89-100,
    reference propagators.py:1616-1719)."""
    cdtype = c_signed.dtype
    cauto_qp = wm_autocorr_qp(params, bc, state, derived, c_signed,
                              signs_A, signs_M)
    cauto = jnp.sum(cauto_qp)

    n1Q, n2Q = _nac_terms(potential, state.q)
    n1q = bc.n1q.astype(cdtype)
    n1Q = n1Q.astype(cdtype)
    dq = _center_minus_initial(params.hk.q0, params.hk.q0c,
                               bc.base.qi).astype(cdtype)
    dQ = _dQ_evolved(params.hk, state).astype(cdtype)

    nacqQ = jnp.einsum("ni,nij,nj->n", n1q, derived.RqQ, n1Q)
    nacQ = (n2Q.astype(cdtype)
            + jnp.einsum("ni,nij,nj->n", dQ, derived.RQQ, n1Q)
            - jnp.einsum("ni,nij,nj->n", dq, derived.RqQ, n1Q)
            - times_i(jnp.einsum("ni,ni->n", derived.PQ, n1Q) / hbar))
    # the cross term pairs (q0 - Q) with the *second* index of RqQ:
    # sum_ij n1q_j RqQ[j, i] (q0 - Q)_i   (reference propagators.py:1709)
    nacq = (bc.n2q.astype(cdtype)
            + jnp.einsum("ni,nij,nj->n", dq, derived.Rqq, n1q)
            - jnp.einsum("nj,nji,ni->n", n1q, derived.RqQ, dQ)
            + times_i(jnp.einsum("ni,ni->n", derived.Pq, n1q) / hbar))

    kic_qp = (1.0 / hbar**2) * (nacqQ + nacQ * nacq) * cauto_qp
    kic = jnp.sum(kic_qp)
    return cauto, kic


def wm_coefficients(params: WMParams, bc: WMBatchConstants, state: TrajState,
                    derived: WMDerived, c_signed, signs_A):
    """Gaussian expansion coefficients (eqn. 75,
    reference propagators.py:1391-1432). Factors of pi / 2 pi are absorbed in
    the pseudo-determinants; the explicit 1/(2 pi)^d of eqn. 75 is the same
    (2 pi hbar)^d already folded into the Monte-Carlo weight."""
    cdtype = c_signed.dtype
    dq = _center_minus_initial(params.hk.q0, params.hk.q0c,
                               bc.base.qi).astype(cdtype)
    phase = phase_exp(state.S / hbar, cdtype)
    v = (params.coef_pref.astype(cdtype)
         * c_signed * phase
         * signs_A / jnp.sqrt(derived.detA)
         * jnp.exp(bc.eps.astype(cdtype)))
    v = v * jnp.exp(
        -0.5 * jnp.einsum("ni,ij,nj->n", dq, params.Cqq.astype(cdtype), dq)
        - times_i(jnp.einsum("ni,ni->n", bc.PIq.astype(cdtype), dq) / hbar))
    return v * bc.base.weight


def wm_log_coefficients(params: WMParams, bc: WMBatchConstants,
                        state: TrajState, derived: WMDerived, c_signed,
                        signs_A):
    """log v_i of the Gaussian expansion coefficients as two real f64
    arrays (log_re = log |v_i|, log_im = arg v_i, unwrapped additively).

    This is the range-safe representation of eqn. 75: the linear-scale
    coefficient magnitude is ~1e-41 at the 60-mode flagship (it underflows
    complex64, the round-2 known gap), while log |v| stays O(100) in any
    precision — the same trick the MC weights already use
    (hk_batch_constants). Includes the MC weight *and* the host weight
    scale, so exp(log v) is the fully weighted coefficient."""
    hk = params.hk
    t = params.Gt.dtype
    f64 = jnp.float64
    dq_t = _center_minus_initial(hk.q0, hk.q0c, bc.base.qi)  # traj precision
    dq = dq_t.astype(t)
    quad = 0.5 * jnp.einsum("ni,ij,nj->n", dq, params.Cqq, dq)
    phase_pi = jnp.einsum("ni,ni->n", bc.PIq.astype(t), dq) / hbar

    log_re = (params.log_coef_pref
              + jnp.log(jnp.abs(c_signed)).astype(f64)
              - 0.5 * jnp.log(jnp.abs(derived.detA)).astype(f64)
              + bc.eps.astype(f64)
              + bc.base.logw_norm.astype(f64)
              + bc.base.log_weight_scale
              - quad.astype(f64))
    log_im = (jnp.angle(c_signed).astype(f64)
              + state.S.astype(f64) / hbar
              - 0.5 * jnp.angle(derived.detA).astype(f64)
              + jnp.where(signs_A < 0, np.pi, 0.0)
              - phase_pi.astype(f64))
    return log_re, log_im


def wm_wavefunction(params: WMParams, bc: WMBatchConstants, state: TrajState,
                    derived: WMDerived, log_v, x):
    """psi(x, t) on a grid x (nx, d) (eqn. 75,
    reference propagators.py:1434-1482), from log-coefficients
    (wm_log_coefficients): each trajectory's log |v| joins its Gaussian
    exponent and the sum over trajectories is exponent-shifted, so the
    evaluation works at any mode count."""
    log_re, log_im = log_v
    cdtype = complex_dtype(params.Gt.dtype)
    rd = real_dtype(cdtype)
    dxQ = x[None, :, :].astype(cdtype) - state.q[:, None, :].astype(cdtype)
    dq = _center_minus_initial(params.hk.q0, params.hk.q0c,
                               bc.base.qi).astype(cdtype)
    expo = (-0.5 * jnp.einsum("nxi,nij,nxj->nx", dxQ, derived.CQQ, dxQ)
            + jnp.einsum("ni,nij,nxj->nx", dq, derived.CqQ, dxQ)
            + times_i(jnp.einsum("ni,nxi->nx", derived.PIQ, dxQ) / hbar))
    Zre = log_re.astype(rd)[:, None] + expo.real               # (n, nx)
    Zim = log_im.astype(rd)[:, None] + expo.imag
    zmax = jnp.max(Zre, axis=0)                                # (nx,)
    psi = jnp.sum(complex_exp(Zre - zmax[None, :], Zim, cdtype), axis=0)
    # the exponent recombination happens on the HOST at f64: the true psi
    # magnitude at many modes sits below the f32 normal range (1e-38 at the
    # 60-mode flagship grid), so exp(zmax) must not be taken in the device
    # dtype (the reduced-precision modes hold no complex128 on device)
    return psi, zmax


def _wm_norm_block_term(pack, Qi, di, CQQi, lri, lii, Qj, dj, CQQj, lrj,
                        lij):
    """One (bi, bj) block of the WM pair sum (module-level: it is a static
    jit argument of the shared pair-sum runners, hk._pair_sum_device)."""
    U, m_scale, m_log_det = pack
    cdtype = Qi.dtype
    dQij = Qj[None, :, :] - Qi[:, None, :]               # (bi, bj, d)
    di_ = jnp.conj(di)[:, None, :]
    dj_ = dj[None, :, :]
    CQQj_ = CQQj[None, :, :, :]
    Dij = jnp.conj(CQQi)[:, None] + CQQj_                # (bi, bj, d, d)
    # project to the non-zero subspace before inverting (one
    # linalg.batched_det_inv factorisation gives det and inverse)
    DijU = jnp.einsum("ia,mnij,jb->mnab", U, Dij, U)
    # det(DijU / 2 pi) itself underflows complex64 at many modes (it is
    # ~ det(2 U^T G0 U / 2 pi) at t = 0) — factorise at the O(1) scale
    # m_scale and carry the exact compensator m_log_det in the log
    # (same pattern as the M matrix, see WMParams)
    detDij, iDij_s = linalg.batched_det_inv(DijU / m_scale)
    iDij = iDij_s / m_scale
    bij = (jnp.einsum("nab,mnb->mna", CQQj, dQij) + di_ + dj_)  # (bi,bj,d)
    bijU = jnp.einsum("mna,ab->mnb", bij, U)
    pair_expo = (
        -0.5 * jnp.einsum("mna,nab,mnb->mn", dQij, CQQj, dQij)
        - jnp.einsum("na,mna->mn", dj, dQij)
        + 0.5 * jnp.einsum("mna,mnab,mnb->mn", bijU, iDij, bijU))
    # exp(-1/2 Log det) with the principal log = 1/sqrt(det) principal;
    # log det(DijU / 2 pi) = log det(DijU / m_scale) + m_log_det
    total_re = (lri[:, None] + lrj[None, :] + pair_expo.real
                - 0.5 * (jnp.log(jnp.abs(detDij)) + m_log_det))
    total_im = (-lii[:, None] + lij[None, :] + pair_expo.imag
                - 0.5 * jnp.angle(detDij))
    return jnp.sum(complex_exp(total_re, total_im, cdtype))


_wm_norm_block_jit = jax.jit(_wm_norm_block_term)


def wm_norm(params: WMParams, bc: WMBatchConstants, state: TrajState,
            derived: WMDerived, log_v, block=4096, mesh=None,
            sample_pairs=None, key=0):
    """|psi| of the WM wavefunction — O(n^2) with per-pair r x r inverses
    (reference propagators.py:1484-1575). Opt-in diagnostic.

    Consumes log-coefficients: the pair term conj(v_m) <m|n> v_n is
    assembled as ONE exponent (log v_m^* + log v_n + the pair-overlap
    exponent - 1/2 Log det), which is O(1) per entry even when both factors
    over/underflow the complex dtype individually — this is what lifts the
    c64 diagnostic ceiling at high mode counts.

    The full ordered block-pair grid runs device-side in one jitted
    program (hk._pair_sum_device; the WM pair exponent is not assembled
    symmetrically, so the Hermitian-triangle shortcut is not taken);
    under a mesh the reduction runs as the shard_map systolic ring
    (hk._pair_sum_ring)."""
    from semiclassical_jax.propagation.hk import (_pair_sum_ring,
                                                  blocked_pair_sum)

    hk = params.hk
    log_re, log_im = log_v
    cdtype = complex_dtype(params.Gt.dtype)
    rd = real_dtype(cdtype)
    # keep U real: jnp.einsum upcasts against the complex operands, and a
    # complex closure constant would violate the package numerics contract
    U = hk.U.astype(rd)
    dq0i = _center_minus_initial(hk.q0, hk.q0c, bc.base.qi).astype(cdtype)
    dvec = (jnp.einsum("nji,nj->ni", derived.CqQ, dq0i)
            + times_i(derived.PIQ / hbar))                   # (n, d)
    Q = state.q.astype(cdtype)
    CQQ = derived.CQQ
    lr = log_re.astype(rd)
    li = log_im.astype(rd)

    pack = (U, params.m_scale.astype(rd), params.m_log_det)
    arrays = (Q, dvec, CQQ, lr, li)
    n = Q.shape[0]

    if sample_pairs is not None:
        # subsampled variance-characterized estimate (hk.py docstring);
        # the WM grid is ORDERED (non-symmetric assembly)
        from semiclassical_jax.propagation.hk import subsampled_pair_sum
        assert mesh is None, "subsampled norm: single-device route only"
        b = block if n % block == 0 else next(
            bb for bb in range(min(block, n), 0, -1) if n % bb == 0)
        norm2, err2 = subsampled_pair_sum(
            _wm_norm_block_term, pack, arrays, block=b,
            sample_pairs=sample_pairs, key=key, hermitian=False)
        if norm2 <= 0.0:
            return 0.0, float(err2)
        norm = float(np.sqrt(norm2))
        return norm, err2 / (2.0 * norm)

    if mesh is not None:
        norm2 = _pair_sum_ring(_wm_norm_block_term, pack, arrays, mesh,
                               block)
        return float(np.sqrt(norm2))

    if n % block == 0:
        return float(np.sqrt(blocked_pair_sum(
            _wm_norm_block_term, pack, arrays, block=block,
            hermitian=False)))

    # fallback: host loop over uneven blocks
    nblocks = -(-n // block)
    norm2 = 0.0 + 0.0j
    for ib in range(nblocks):
        si = slice(ib * block, min((ib + 1) * block, n))
        for jb in range(nblocks):
            sj = slice(jb * block, min((jb + 1) * block, n))
            norm2 += complex(from_device(
                _wm_norm_block_jit(
                    pack, Q[si], dvec[si], CQQ[si], lr[si], li[si],
                    Q[sj], dvec[sj], CQQ[sj], lr[sj], li[sj])))
    return float(np.sqrt(norm2.real))


# ---------------------------------------------------------------------------
# scan driver
# ---------------------------------------------------------------------------

def _wm_scan(params, bc, potential, state0, trackers0, t0, dt, nt,
             integ=None, with_m2=False):
    step_fn = rk4_step
    if integ is not None and isinstance(integ[0], HarmonicMap):
        # exact harmonic map — see _hk_scan / propagation/exact_harmonic
        hmap = integ[0]
        step_fn = lambda st, pot, _dt: harmonic_step(hmap, st, pot)
        integ = None
    if integ is not None:
        # exact-Morse integrator — see _hk_scan and propagation/exact_morse
        pack, mcarry0, bc_sub = integ
        mono = state0.Mqq.dtype

        def body(carry, _):
            (tr_c, tr_A, tr_M), mcarry = carry
            state, en = morse_map_state(pack, mcarry, mono, potential)
            c2 = hk_prefactor_det(params.hk, state)
            tr_c = tr_c.update(c2)
            c = jnp.sqrt(c2) * tr_c.signs
            sd = wm_scan_derived(params, bc, state, potential)
            tr_A = tr_A.update(sd.detA)
            tr_M = tr_M.update(sd.detM)
            obs = wm_scan_observables(params, bc, state, sd, c,
                                      tr_A.signs, tr_M.signs,
                                      with_m2=with_m2)
            if pack.has_sub:
                (ts_c, ts_A, ts_M) = mcarry.sub_trackers
                sub = mcarry.sub
                c2s = hk_prefactor_det(params.hk, sub)
                ts_c = ts_c.update(c2s)
                cs = jnp.sqrt(c2s) * ts_c.signs
                sds = wm_scan_derived(params, bc_sub, sub, potential)
                ts_A = ts_A.update(sds.detA)
                ts_M = ts_M.update(sds.detM)
                # disjoint -inf-masked row sets: sums add, factored
                # second moments combine via _m2_combine (see _hk_scan)
                obs_s = wm_scan_observables(params, bc_sub, sub, sds,
                                            cs, ts_A.signs, ts_M.signs,
                                            with_m2=with_m2)
                obs = _obs_combine(obs, obs_s, with_m2)
                mcarry = replace(mcarry, sub_trackers=(ts_c, ts_A, ts_M))
            mcarry = morse_map_advance(pack, mcarry, dt, potential)
            return ((tr_c, tr_A, tr_M), mcarry), obs + (en,)

        (trackers, mcarry), outs = lax.scan(body, (trackers0, mcarry0),
                                            None, length=nt)
        state_fin, _ = morse_map_state(pack, mcarry, mono, potential)
        state_fin = morse_map_merge(pack, mcarry, state_fin)
        if pack.has_sub:
            from semiclassical_jax.propagation.exact_morse import \
                merge_tracker
            trackers = tuple(
                merge_tracker(tr, ts, pack.sub_idx)
                for tr, ts in zip(trackers, mcarry.sub_trackers))
        return (state_fin, trackers, t0 + nt * dt, mcarry), outs

    every = int(getattr(potential, "taylor_every", 1) or 1)
    if every > 1 and step_fn is rk4_step:
        # taylor_every re-expansion windows — see _hk_scan
        if getattr(potential, "hessian_eval", "stage") != "taylor":
            raise ValueError(
                "taylor_every > 1 requires hessian_eval='taylor'")
        from semiclassical_jax.propagation.eom import make_taylor_window
        carry0_fn, wstep = make_taylor_window(potential, dt, every)

        def wbody(carry, _):
            state, (tr_c, tr_A, tr_M), t, sc = carry
            c2 = hk_prefactor_det(params.hk, state)
            tr_c = tr_c.update(c2)
            c = jnp.sqrt(c2) * tr_c.signs
            sd = wm_scan_derived(params, bc, state, potential)
            tr_A = tr_A.update(sd.detA)
            tr_M = tr_M.update(sd.detM)
            obs = wm_scan_observables(params, bc, state, sd, c,
                                      tr_A.signs, tr_M.signs,
                                      with_m2=with_m2)
            new_state, en, sc = wstep(state, sc)
            return (new_state, (tr_c, tr_A, tr_M), t + dt, sc), obs + (en,)

        (state, trackers, t, _), outs = lax.scan(
            wbody, (state0, trackers0, t0, carry0_fn(state0)), None,
            length=nt)
        return (state, trackers, t, None), outs

    def body(carry, _):
        state, (tr_c, tr_A, tr_M), t = carry
        c2 = hk_prefactor_det(params.hk, state)
        tr_c = tr_c.update(c2)
        c = jnp.sqrt(c2) * tr_c.signs
        sd = wm_scan_derived(params, bc, state, potential)
        tr_A = tr_A.update(sd.detA)
        tr_M = tr_M.update(sd.detM)
        obs = wm_scan_observables(params, bc, state, sd, c,
                                  tr_A.signs, tr_M.signs, with_m2=with_m2)
        new_state, en = step_fn(state, potential, dt)
        return (new_state, (tr_c, tr_A, tr_M), t + dt), obs + (en,)

    (state, trackers, t), outs = lax.scan(body, (state0, trackers0, t0),
                                          None, length=nt)
    return (state, trackers, t, None), outs


_wm_scan_jit = jax.jit(_wm_scan, static_argnames=("nt", "with_m2"))


def _wm_scan_micro(params, bc, potential, state0, trackers0, t0, dt, nt,
                   k, with_m2=False):
    """Micro-batched WM scan: lax.map over k device-side sub-batches —
    the WM derived chain is memory-bound, so its step intermediates are
    kept at the sub-batch size (see hk._micro_scan)."""
    from semiclassical_jax.propagation.hk import _micro_scan
    return _micro_scan(_wm_scan, params, bc, potential, state0, trackers0,
                       t0, dt, nt, k, with_m2)


_wm_scan_micro_jit = jax.jit(_wm_scan_micro,
                             static_argnames=("nt", "k", "with_m2"))


# ---------------------------------------------------------------------------
# stateful wrapper
# ---------------------------------------------------------------------------

class WaltonManolopoulosPropagator(HermanKlukPropagator):
    """WM propagator with the reference-shaped API plus the jitted scan path.

    Parameters
    ----------
    Gamma_i, Gamma_t : (d, d) width matrices of the frozen Gaussians
    alpha, beta : float > 0
        Filinov cell parameters; the HK propagator is integrated over a
        phase-space cell of volume ~ (2 sqrt(alpha beta))^{-dim}; larger
        values make the linearisation more accurate but need more
        trajectories (reference propagators.py:1088-1093).
    """

    def __init__(self, Gamma_i, Gamma_t, alpha, beta, dtype=jnp.float64,
                 traj_dtype=None, integrator="rk4"):
        super().__init__(Gamma_i, Gamma_t, dtype=dtype, traj_dtype=traj_dtype,
                         integrator=integrator)
        self.alpha = float(alpha)
        self.beta = float(beta)

    # -- hooks ---------------------------------------------------------------

    def _make_params(self, Gamma_0, q0, p0, U, iGi0):
        hk = _build_hk_params(self.Gamma_i, self.Gamma_t, Gamma_0,
                              q0, p0, U, iGi0, self.dtype,
                              traj_dtype=self.traj_dtype)
        return _build_wm_params(hk, self.Gamma_i, self.Gamma_t, Gamma_0,
                                self.alpha, self.beta, self.dtype)

    _bc_tag = "wm"

    def _make_batch_constants(self, qi, pi, prob, potential):
        return wm_batch_constants(self.params, qi, pi, prob,
                                  potential=potential)

    def _require_nacq(self, potential):
        if not self._bc_has_nacq:
            base = with_nacq(self.params.hk, self._bc.base, potential)
            n1q, n2q = _nac_terms(potential, self._bc.base.qi)
            self._bc = replace(self._bc, base=base, n1q=n1q, n2q=n2q)
            self._bc_has_nacq = True
            self._integ_refresh_bc()

    def _make_trackers(self, state):
        c2 = hk_prefactor_det(self.params.hk, state)
        if self.params.scan_diag and state.diag_monodromy:
            # per-mode core only — the full-tensor wm_derived materialises
            # (n, d, d) complex tensors, which would cap the batch size the
            # diag scan path exists to lift
            detA, detM, _, _, _ = _wm_diag_core_jit(self.params, state)
        else:
            derived = wm_derived(self.params, self._bc, state)
            detA, detM = derived.detA, derived.detM
        return {
            "prefactorC": SignTracker.fresh(c2),
            "detA": SignTracker.fresh(detA),
            "detM": SignTracker.fresh(detM),
        }

    def _mask_routed_rows(self, bc, row_bad):
        return replace(bc,
                       base=self._mask_batch_constants(bc.base, row_bad))

    def _gather_sub_rows(self, bc, sub_idx, n_bad):
        base = super()._gather_sub_rows(bc.base, sub_idx, n_bad)
        take = lambda a: jnp.take(a, sub_idx, axis=0, mode="fill",
                                  fill_value=0)
        return replace(bc, base=base, eps=take(bc.eps), PIq=take(bc.PIq),
                       n1q=take(bc.n1q), n2q=take(bc.n2q), z0=take(bc.z0))

    def _sub_trackers(self, sub_state, bc_sub, sub_idx):
        from semiclassical_jax.propagation.exact_morse import gather_tracker
        return (gather_tracker(self.trackers["prefactorC"], sub_idx),
                gather_tracker(self.trackers["detA"], sub_idx),
                gather_tracker(self.trackers["detM"], sub_idx))

    def _scan(self, potential, dt, nt, with_m2=False):
        integ = self._integ(potential, dt)
        harmonic = integ is not None and isinstance(integ[0], HarmonicMap)
        bc = self._bc if (integ is None or harmonic) else self._integ_bc_scan
        trackers0 = (self.trackers["prefactorC"], self.trackers["detA"],
                     self.trackers["detM"])
        k = self._micro_k()
        if k > 1 and integ is None:
            return _wm_scan_micro_jit(
                self.params, bc, potential, self.state, trackers0,
                jnp.asarray(self.t, dtype=self._scalar_dtype),
                jnp.asarray(dt, dtype=self._scalar_dtype), nt, k, with_m2)
        return _wm_scan_jit(
            self.params, bc, potential, self.state, trackers0,
            jnp.asarray(self.t, dtype=self._scalar_dtype),
            jnp.asarray(dt, dtype=self._scalar_dtype), nt,
            integ, with_m2,
        )

    def _store_scan_carry(self, carry):
        state, (tr_c, tr_A, tr_M), t, mcarry = carry
        self.state = state
        self.trackers = {"prefactorC": tr_c, "detA": tr_A, "detM": tr_M}
        self.t = float(t)
        if mcarry is not None:
            self._integ_carry = mcarry
            self._integ_state_ref = state  # carry and state advanced together

    # -- granular API ---------------------------------------------------------

    def semiclassical_prefactor(self):
        c2 = hk_prefactor_det(self.params.hk, self.state)
        tracker = self.trackers["prefactorC"].update(c2)
        self.trackers["prefactorC"] = tracker
        return jnp.sqrt(tracker.previous) * tracker.signs

    def _sync_derived(self):
        derived = wm_derived(self.params, self._bc, self.state)
        self.trackers["detA"] = self.trackers["detA"].update(derived.detA)
        self.trackers["detM"] = self.trackers["detM"].update(derived.detM)
        return derived

    def autocorrelation(self, energy0_es=0.0):
        c = self.semiclassical_prefactor()
        derived = self._sync_derived()
        cauto_qp = wm_autocorr_qp(self.params, self._bc, self.state, derived,
                                  c, self.trackers["detA"].signs,
                                  self.trackers["detM"].signs)
        cauto = jnp.sum(cauto_qp)
        return (complex(from_device(cauto)) * self._bc.base.weight_scale
                * np.exp(1j / hbar * self.t * energy0_es))

    def ic_correlation(self, potential, energy0_es=0.0):
        self._require_nacq(potential)
        c = self.semiclassical_prefactor()
        derived = self._sync_derived()
        _, kic = wm_observables(self.params, self._bc, self.state, derived, c,
                                self.trackers["detA"].signs,
                                self.trackers["detM"].signs, potential)
        return (complex(from_device(kic)) * self._bc.base.weight_scale
                * np.exp(1j / hbar * self.t * energy0_es))

    def _coefficients_and_derived(self):
        """Sign-synced, weight-scale-restored coefficients + derived tensors."""
        c = self.semiclassical_prefactor()
        derived = self._sync_derived()
        v = wm_coefficients(self.params, self._bc, self.state, derived, c,
                            self.trackers["detA"].signs)
        return (v * jnp.asarray(self._bc.base.weight_scale,
                                dtype=real_dtype(v.dtype)), derived)

    def _log_coefficients_and_derived(self):
        c = self.semiclassical_prefactor()
        derived = self._sync_derived()
        log_v = wm_log_coefficients(self.params, self._bc, self.state,
                                    derived, c, self.trackers["detA"].signs)
        return log_v, derived

    def coefficients(self):
        """Linear-scale coefficients (reference API,
        propagators.py:1391-1432); underflows the complex dtype where the
        true magnitude does — use log_coefficients at high mode counts."""
        return self._coefficients_and_derived()[0]

    def log_coefficients(self):
        """(log |v|, arg v) as f64 numpy arrays — exact at any mode count."""
        log_v, _ = self._log_coefficients_and_derived()
        return np.asarray(log_v[0]), np.asarray(log_v[1])

    def wavefunction(self, x):
        log_v, derived = self._log_coefficients_and_derived()
        psi, zmax = wm_wavefunction(self.params, self._bc, self.state,
                                    derived, log_v, jnp.asarray(x))
        return (from_device(psi).astype(np.complex128)
                * np.exp(np.asarray(zmax, dtype=np.float64)))

    def norm(self, sample_pairs=None, key=0):
        log_v, derived = self._log_coefficients_and_derived()
        return wm_norm(self.params, self._bc, self.state, derived, log_v,
                       mesh=self.mesh, sample_pairs=sample_pairs, key=key)
