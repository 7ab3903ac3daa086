# coding: utf-8
"""Herman-Kluk (HK) semiclassical IVR propagator.

[HK] E. Kluk, M. Herman, H. Davis, J. Chem. Phys. 84, 326 (1986)

Capability parity with reference propagators.py:407-1066, redesigned for
batched accelerator execution:

* `HKParams` / `BatchConstants` are host-precomputed pytrees. The null-space
  projector U of singular width matrices is folded into the constant factors
  of the prefactor (U^T Gt^{+-1/2}) and (Gi^{+-1/2} U), so the per-step work
  is two complex (n, d, r) matmul chains plus one batched (n, r, r)
  determinant — nothing with dynamic rank enters jit;
* quantities that depend only on the *initial* phase-space points — the
  overlap <qi,pi|phi(0)>, the Monte-Carlo weights, and the whole nac(q)
  factor of the IC correlation — are computed once per batch instead of
  every time step (the reference recomputes them per step,
  propagators.py:793-795, 880-903);
* `propagate` runs the full time loop as one `lax.scan` inside jit, emitting
  C(t) and k~ic(t); the branch-cut sign tracker of sqrt(det) is scan-carried
  state.
"""

from __future__ import annotations

import logging

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from semiclassical_jax import linalg
from semiclassical_jax.linalg import (from_device, phase_exp, real_dtype,
                                      times_i, to_device)
from semiclassical_jax.coherent import (
    OverlapParams,
    WavefunctionParams,
    complex_exp,
    overlap_exponent_displaced,
    overlap_exponent_vector,
    overlap_matrix,
    overlap_vector,
    wavefunction,
)
from semiclassical_jax.propagation.eom import rk4_step
from semiclassical_jax.propagation.exact_harmonic import (
    HarmonicMap, build_harmonic_map, harmonic_step, supports_exact_harmonic)
from semiclassical_jax.propagation.exact_morse import (
    build_morse_map, gather_tracker, merge_tracker, morse_map_advance,
    morse_map_merge, morse_map_state, supports_exact_morse)
from semiclassical_jax.propagation.state import SignTracker, TrajState
from semiclassical_jax.pytree import pytree_dataclass, replace
from semiclassical_jax.sampling import SamplingParams, sample_initial_conditions
from semiclassical_jax.units import hbar

logger = logging.getLogger(__name__)

__all__ = [
    "HKParams",
    "BatchConstants",
    "HermanKlukPropagator",
    "hk_prefactor_det",
    "check_energy_conservation",
    "pairwise_norm",
]


def complex_dtype(dtype):
    return jnp.complex128 if jnp.dtype(dtype) == jnp.float64 else jnp.complex64


@pytree_dataclass(meta=("dim", "rank", "factors_real", "factors_diag"))
class HKParams:
    """Constant parameter pack of the HK propagator.

    Prefactor (reference propagators.py:951-1004, eqn. 29):

        C^2 = det( U^T [ 1/2 ( Gt^{1/2} Mqq Gi^{-1/2} + Gt^{-1/2} Mpp Gi^{1/2}
                   - i hbar Gt^{1/2} Mqp Gi^{1/2}
                   + i/hbar Gt^{-1/2} Mpq Gi^{-1/2} ) ] U )

    with U the basis of the non-zero subspace of Gamma_i + Gamma_0.
    Lt_* = U^T Gt^{+-1/2} and Ri_* = Gi^{+-1/2} U are precomputed, stored as
    separate re/im *real* planes: the monodromy blocks are real, so the
    prefactor assembly runs entirely in real matmuls — for the usual
    PSD width matrices (imaginary planes exactly zero, `factors_real`) this
    is 8 real matmuls instead of the 4 complex ones of a complex-cast
    formulation, i.e. half the matmul flops and no (n, d, d) complex
    temporaries in device memory.
    """

    Lt_s_re: jnp.ndarray   # (r, d)  Re U^T Gt^{1/2}
    Lt_s_im: jnp.ndarray   # (r, d)  Im U^T Gt^{1/2}
    Lt_i_re: jnp.ndarray   # (r, d)  Re U^T Gt^{-1/2}
    Lt_i_im: jnp.ndarray   # (r, d)
    Ri_s_re: jnp.ndarray   # (d, r)  Re Gi^{1/2} U
    Ri_s_im: jnp.ndarray   # (d, r)
    Ri_i_re: jnp.ndarray   # (d, r)  Re Gi^{-1/2} U
    Ri_i_im: jnp.ndarray   # (d, r)
    q0: jnp.ndarray     # (d,)
    p0: jnp.ndarray     # (d,)
    G0: jnp.ndarray     # (d, d)   Gamma_0
    iGi0: jnp.ndarray   # (d, d)   pseudo-inverse of Gamma_i + Gamma_0
    R: jnp.ndarray      # (d, d)   Gamma_0 [Gi+G0]^{-1} Gamma_i
    U: jnp.ndarray      # (d, r)
    csoi0: OverlapParams  # <.,Gi | .,G0>
    csot0: OverlapParams  # <.,Gt | .,G0>
    csott: OverlapParams  # <.,Gt | .,Gt>
    wf: WavefunctionParams  # Gamma_t
    dim: int
    rank: int
    factors_real: bool  # static: all imaginary planes exactly zero
    factors_diag: bool  # static: real factors whose Lt_x Ri_y products are
                        # all diagonal (diagonal widths, up to the mode
                        # permutation in U) — the assembled prefactor matrix
                        # is then diagonal for any diagonal monodromy, and
                        # the determinant is a per-mode product
    # comp32 mode: q0/p0 are stored f32 and these (d,) f32 residuals carry
    # the rest of their f64 values (true q0 = q0 + q0c) so the observable
    # displacements q0 - q(t) keep f64-difference quality against the
    # compensated trajectory state. None in the plain modes.
    q0c: jnp.ndarray | None = None
    p0c: jnp.ndarray | None = None
    # factors_diag fast path: each prefactor factor product Lt_x diag(m)
    # Ri_y is a generalized permutation matrix (one nonzero per row), and
    # the mode product defining the determinant is permutation-invariant —
    # so when all four factors share the same permutation and rank == dim,
    # the four (n, d) @ (d, r) matmuls of the diagonal prefactor collapse
    # to elementwise scales in unpermuted mode order (measured: the thin
    # K=60 matmuls were ~5.5 ms of the 11.4 ms 524k comp32 step). None
    # when the collapse does not apply.
    diag_ka: jnp.ndarray | None = None  # (d,) scale of Lt_s . Ri_i
    diag_kb: jnp.ndarray | None = None  # (d,) scale of Lt_s . Ri_s
    diag_kc: jnp.ndarray | None = None  # (d,) scale of Lt_i . Ri_s
    diag_ke: jnp.ndarray | None = None  # (d,) scale of Lt_i . Ri_i
    # diagonals of R = G0 [Gi+G0]^{-1} Gi (NAC factor) and of the momentum
    # shift (G0 [Gi+G0]^{-1})^T when those matrices are exactly diagonal —
    # collapses the last thin per-step (n, d) @ (d, d) contractions of the
    # observable path. None otherwise.
    R_diag: jnp.ndarray | None = None
    shift_diag: jnp.ndarray | None = None

    @property
    def cdtype(self):
        """Complex dtype of the prefactor outputs."""
        return complex_dtype(self.Lt_s_re.dtype)


@pytree_dataclass
class BatchConstants:
    """Per-batch constants: initial conditions and precomputed observables.

    The Monte-Carlo weights 1/(n P(qi,pi) (2 pi hbar)^d) span hundreds of
    orders of magnitude across the batch in many dimensions, so they are
    stored *normalised* (geometric mean factored out) together with the
    f64 scalar `weight_scale`; observable sums computed with the normalised
    weights are multiplied by the scale on the host. This keeps the scan
    float32/complex64-safe in the reduced-precision modes.
    """

    qi: jnp.ndarray       # (n, d)  initial positions
    pi: jnp.ndarray       # (n, d)  initial momenta
    log_prob: jnp.ndarray  # (n,) f64  log sampling densities log P(qi, pi)
    weight: jnp.ndarray   # (n,)    normalised MC weights
    logw_norm: jnp.ndarray  # (n,) traj-precision  log of the normalised
                            # weights (= log weight)
    log_weight_scale: jnp.ndarray  # () f64 log scale:
                                   # true weight = weight * exp(log_weight_scale)
    vi: jnp.ndarray       # (n,) complex  <qi,pi,Gi|phi(0)>
    obs_re: jnp.ndarray   # (n,) traj-precision  Re log(vi/fac) + logw_norm
    obs_im: jnp.ndarray   # (n,) traj-precision  Im log(vi/fac)
    nacq: jnp.ndarray     # (n,) complex  initial-point NAC factor of k~ic

    @property
    def weight_scale(self):
        import numpy as _np
        return _np.exp(float(self.log_weight_scale))


def _build_hk_params(Gamma_i, Gamma_t, Gamma_0, q0, p0, U, iGi0, dtype,
                     traj_dtype=None):
    """`dtype` is the monodromy/complex precision (the prefactor factor
    matrices, all complex outputs, and the observable quadratic forms),
    `traj_dtype` the precision of the geometry-side constants (q0, p0, ...)
    that enter *differences* with the trajectory state.

    Precision structure of the observable exponents: the displacements
    dq = q0 - q(t), dp = p0 - p(t) are computed at trajectory precision
    (f64 in the mixed mode — they are differences of nearby large values),
    then the quadratic forms dq^T A dq run at `dtype`. The forms' inputs
    are O(1-30) and the results O(1e2) at worst, so f32 costs ~1e-5
    absolute exponent error — far below the Monte-Carlo floor — while the
    (n, d) @ (d, d) contractions run at `dtype` (the mixed-vs-f64 gate in
    tests/test_precision.py holds at 1e-4)."""
    compensated = isinstance(traj_dtype, str) and traj_dtype == "comp32"
    if compensated:
        # constants entering differences with the compensated state are
        # stored f32 + f32 residual (true value = x + xc)
        traj_dtype = jnp.float32
    if traj_dtype is None:
        traj_dtype = dtype
    cdtype = complex_dtype(dtype)
    rdtype = real_dtype(cdtype)
    sqGi, isqGi = linalg.sym_sqrtm(Gamma_i)
    sqGt, isqGt = linalg.sym_sqrtm(Gamma_t)
    Uc = U.astype(np.complex128)
    R = Gamma_0 @ iGi0 @ Gamma_i
    Lt_s = Uc.T @ sqGt
    Lt_i = Uc.T @ isqGt
    Ri_s = sqGi @ Uc
    Ri_i = isqGi @ Uc
    factors_real = all(
        float(np.abs(np.imag(m)).max()) == 0.0
        for m in (Lt_s, Lt_i, Ri_s, Ri_i))
    # The prefactor matrix Lt_x diag(m) Ri_y is diagonal for EVERY
    # diagonal m iff each |Lt_x| |Ri_y| product has zero off-diagonal —
    # true for diagonal widths up to the mode permutation U introduces
    # (the factors are then generalized permutation matrices).
    def _offdiag_zero(L, R):
        O = np.abs(L) @ np.abs(R)
        return float(np.abs(O - np.diag(np.diag(O))).max()) == 0.0

    factors_diag = factors_real and all(
        _offdiag_zero(L.real, R.real)
        for L, R in ((Lt_s, Ri_i), (Lt_s, Ri_s), (Lt_i, Ri_s), (Lt_i, Ri_i)))

    # permutation-collapsed factor scales (see HKParams.diag_ka): K-matrix
    # K[i, a] = L[a, i] R[i, a] has one nonzero per row; when all four
    # share the same row->column permutation and rank == dim, store the
    # scales in unpermuted mode order
    diag_k = {}
    if factors_diag and U.shape[0] == U.shape[1]:
        nd = U.shape[0]
        perms, scales = [], []
        for Lf, Rf in ((Lt_s, Ri_i), (Lt_s, Ri_s),
                       (Lt_i, Ri_s), (Lt_i, Ri_i)):
            K = (Lf.real * Rf.real.T).T                   # (d, d)
            perm = np.argmax(np.abs(K), axis=1)
            perms.append(perm)
            scales.append(K[np.arange(nd), perm])
        if all((perm == perms[0]).all() for perm in perms[1:]):
            diag_k = {name: jnp.asarray(s, dtype=rdtype)
                      for name, s in zip(("diag_ka", "diag_kb",
                                          "diag_kc", "diag_ke"), scales)}
    shift = Gamma_0 @ iGi0
    for name, M in (("R_diag", R), ("shift_diag", shift.T)):
        if float(np.abs(M - np.diag(np.diag(M))).max()) == 0.0:
            diag_k[name] = jnp.asarray(np.diag(M), dtype=traj_dtype)
    plane = lambda m: jnp.asarray(m, dtype=rdtype)
    return HKParams(
        Lt_s_re=plane(Lt_s.real), Lt_s_im=plane(Lt_s.imag),
        Lt_i_re=plane(Lt_i.real), Lt_i_im=plane(Lt_i.imag),
        Ri_s_re=plane(Ri_s.real), Ri_s_im=plane(Ri_s.imag),
        Ri_i_re=plane(Ri_i.real), Ri_i_im=plane(Ri_i.imag),
        factors_real=factors_real,
        factors_diag=factors_diag,
        q0=jnp.asarray(q0, dtype=traj_dtype),
        p0=jnp.asarray(p0, dtype=traj_dtype),
        q0c=(jnp.asarray(q0 - np.float32(q0).astype(np.float64),
                         dtype=jnp.float32) if compensated else None),
        p0c=(jnp.asarray(p0 - np.float32(p0).astype(np.float64),
                         dtype=jnp.float32) if compensated else None),
        **diag_k,
        G0=jnp.asarray(Gamma_0, dtype=traj_dtype),
        iGi0=jnp.asarray(iGi0, dtype=traj_dtype),
        R=jnp.asarray(R, dtype=traj_dtype),
        U=jnp.asarray(U, dtype=dtype),
        csoi0=OverlapParams.create(Gamma_i, Gamma_0, dtype=dtype,
                                   out_dtype=cdtype),
        csot0=OverlapParams.create(Gamma_t, Gamma_0, dtype=dtype,
                                   out_dtype=cdtype),
        csott=OverlapParams.create(Gamma_t, Gamma_t, dtype=dtype,
                                   out_dtype=cdtype),
        wf=WavefunctionParams.create(Gamma_t, dtype=dtype),
        dim=int(q0.shape[0]),
        rank=int(U.shape[1]),
    )


# ---------------------------------------------------------------------------
# functional core
# ---------------------------------------------------------------------------

def hk_prefactor_mat(params: HKParams, state: TrajState):
    """The prefactor matrix, shape (n, r, r), as separate (re, im) real
    planes.

    mat = 1/2 ( Lt_s (Mqq Ri_i - i hbar Mqp Ri_s)
              + Lt_i (Mpp Ri_s + i/hbar Mpq Ri_i) )

    The monodromy blocks are real; the contractions run as real matmuls on
    the re/im planes of the constant factors — 8 real matmuls when the
    factors are real (the PSD-width case, `factors_real`), 16 in the
    general case. No (n, d, d) complex temporaries are materialised.
    """
    rdtype = params.Lt_s_re.dtype
    Mqq = state.Mqq.astype(rdtype)
    Mqp = state.Mqp.astype(rdtype)
    Mpq = state.Mpq.astype(rdtype)
    Mpp = state.Mpp.astype(rdtype)
    if state.diag_monodromy:
        # (n, d) diagonal blocks: M @ Ri is a row scale of the constant
        # right factor — the four batched (n, d, d) matmuls become
        # elementwise producers XLA fuses into the Lt contractions.
        rmul = lambda M, Ri: M[:, :, None] * Ri[None]
    else:
        rmul = lambda M, Ri: M @ Ri
    lt = lambda L, X: jnp.einsum("ai,nib->nab", L, X)

    # inner products with the right factors, by re/im plane
    a_re = rmul(Mqq, params.Ri_i_re)
    b_re = rmul(Mqp, params.Ri_s_re)
    c_re = rmul(Mpp, params.Ri_s_re)
    e_re = rmul(Mpq, params.Ri_i_re)
    if params.factors_real:
        # inner_s = a - i hbar b ; inner_i = c + (i/hbar) e — all planes real
        mat_re = 0.5 * (lt(params.Lt_s_re, a_re) + lt(params.Lt_i_re, c_re))
        mat_im = 0.5 * (-hbar * lt(params.Lt_s_re, b_re)
                        + lt(params.Lt_i_re, e_re) / hbar)
        return mat_re, mat_im

    a_im = rmul(Mqq, params.Ri_i_im)
    b_im = rmul(Mqp, params.Ri_s_im)
    c_im = rmul(Mpp, params.Ri_s_im)
    e_im = rmul(Mpq, params.Ri_i_im)
    # inner_s = (Mqq Ri_i) - i hbar (Mqp Ri_s)
    s_re = a_re + hbar * b_im
    s_im = a_im - hbar * b_re
    # inner_i = (Mpp Ri_s) + i/hbar (Mpq Ri_i)
    i_re = c_re - e_im / hbar
    i_im = c_im + e_re / hbar
    mat_re = 0.5 * (lt(params.Lt_s_re, s_re) - lt(params.Lt_s_im, s_im)
                    + lt(params.Lt_i_re, i_re) - lt(params.Lt_i_im, i_im))
    mat_im = 0.5 * (lt(params.Lt_s_re, s_im) + lt(params.Lt_s_im, s_re)
                    + lt(params.Lt_i_re, i_im) + lt(params.Lt_i_im, i_re))
    return mat_re, mat_im


def hk_prefactor_det(params: HKParams, state: TrajState):
    """C^2(t) for every trajectory, shape (n,) complex.

    When the width factors are diagonal (diagonal Gamma_i/Gamma_t, full
    rank) AND the monodromy is in the diagonal representation, the
    prefactor matrix itself is diagonal and the determinant is a plain
    product over modes — the batched (n, r, r) determinant (the single
    most expensive kernel of the dense HK step) disappears."""
    if params.factors_diag and state.diag_monodromy:
        rdtype = params.Lt_s_re.dtype
        mqq = state.Mqq.astype(rdtype)
        mqp = state.Mqp.astype(rdtype)
        mpq = state.Mpq.astype(rdtype)
        mpp = state.Mpp.astype(rdtype)
        if params.diag_ka is not None:
            # permutation-collapsed factors (HKParams.diag_ka): the four
            # generalized-permutation K-matrices reduce to elementwise
            # scales in unpermuted mode order — valid because the mode
            # product below is permutation-invariant. Removes the four
            # thin (n, d) @ (d, d) matmuls.
            diag_re = 0.5 * (mqq * params.diag_ka[None]
                             + mpp * params.diag_kc[None])
            diag_im = 0.5 * (mpq * params.diag_ke[None] / hbar
                             - hbar * (mqp * params.diag_kb[None]))
        else:
            # per-mode weights of the diagonal: mat_aa = sum_i Lt[a,i] m_i
            # Ri[i,a] = (m @ K^T)_a with K = Lt * Ri^T elementwise —
            # constants, folded by XLA
            Ka = (params.Lt_s_re * params.Ri_i_re.T).T     # (d, r)
            Kb = (params.Lt_s_re * params.Ri_s_re.T).T
            Kc = (params.Lt_i_re * params.Ri_s_re.T).T
            Ke = (params.Lt_i_re * params.Ri_i_re.T).T
            diag_re = 0.5 * (mqq @ Ka + mpp @ Kc)          # (n, r)
            diag_im = 0.5 * (mpq @ Ke / hbar - hbar * (mqp @ Kb))
        # product over modes in log space (range-safe at any d); XLA fuses
        # log/arctan2 into this elementwise chain.
        return linalg.logspace_mode_product(diag_re, diag_im, params.cdtype)
    mat_re, mat_im = hk_prefactor_mat(params, state)
    return linalg.batched_det(jax.lax.complex(mat_re, mat_im))


def _nac_factor(params: HKParams, potential, x, pvec, sign, xc=None):
    """The NAC factor entering k~ic (reference propagators.py:888-903).

    nac = n2 + (q0 - x)^T R n1 + sign * i/hbar pvec . n1
    with n1 = -hbar^2 tau1/m, n2 = -hbar^2/2 sum_k tau2_k/m_k.
    sign = +1 at the initial point (q), -1 at the current point (Q).
    `xc` is the comp32 residual of x (true x = x + xc), if any.
    """
    # the difference q0 - x runs at trajectory precision; the contractions
    # at the observable precision (see _build_hk_params)
    t = params.Lt_s_re.dtype
    inv_m = 1.0 / potential.masses()
    tau1 = potential.derivative_coupling_1st(x)
    tau2 = potential.derivative_coupling_2nd(x)
    n1 = (-(hbar**2) * tau1 * inv_m[None, :]).astype(t)     # (n, d)
    n2 = (-(hbar**2) * 0.5
          * jnp.sum(tau2 * inv_m[None, :], axis=1)).astype(t)  # (n,)
    dq = params.q0[None, :] - x.astype(params.q0.dtype)
    if xc is not None and params.q0c is not None:
        dq = dq + (params.q0c - xc)
    dq = dq.astype(t)
    if params.R_diag is not None:
        core = n2 + jnp.sum(dq * params.R_diag.astype(t) * n1, axis=1)
    else:
        core = n2 + jnp.einsum("na,ab,nb->n", dq, params.R.astype(t), n1)
    core = core.astype(real_dtype(pvec.dtype))
    return core + (sign / hbar) * times_i(
        jnp.einsum("na,na->n", pvec, n1.astype(pvec.dtype)))


def _shifted_momentum(params: HKParams, p, pc=None):
    """p0 + Gamma_0 [Gi+G0]^{-1} (p - p0)  (reference propagators.py:894-895).

    The difference p - p0 runs at trajectory precision, the (d, d)
    contraction at the observable precision. `pc` is the comp32 residual
    of p (true p = p + pc), if any."""
    t = params.Lt_s_re.dtype
    p = p.astype(params.p0.dtype)
    dp = p - params.p0[None, :]
    if pc is not None and params.p0c is not None:
        dp = dp + (pc - params.p0c)
    dp = dp.astype(t)
    if params.shift_diag is not None:
        return (params.p0[None, :].astype(t)
                + dp * params.shift_diag.astype(t))
    shift = (params.G0 @ params.iGi0).T.astype(t)
    return params.p0[None, :].astype(t) + dp @ shift


def hk_batch_constants(params: HKParams, qi, pi, log_prob,
                       potential=None) -> BatchConstants:
    """Precompute everything that depends only on the initial conditions.

    If `potential` is given, the initial-point NAC factor of k~ic is filled
    in; otherwise it is zero and can be added later via `with_nacq`.
    """
    n = qi.shape[0]
    logw = -(np.log(n) + log_prob
             + params.dim * np.log(2.0 * np.pi * hbar))
    log_scale = jnp.mean(logw)
    logw_norm = (logw - log_scale).astype(qi.dtype)
    weight = jnp.exp(logw_norm).astype(params.Lt_s_re.dtype)
    # comp32 stores the center split as f32 + residual; these one-time
    # constants are built against the full-precision (f64) center
    if params.q0c is not None:
        q0 = params.q0.astype(qi.dtype) + params.q0c.astype(qi.dtype)
        p0 = params.p0.astype(pi.dtype) + params.p0c.astype(pi.dtype)
    else:
        q0, p0 = params.q0, params.p0
    vi = overlap_vector(params.csoi0, qi, pi, q0, p0)
    # exponent parts of the *weighted* initial overlap: for trajectories far
    # in the tail, vi underflows the complex dtype while weight * vi is
    # O(1/n) — the product must live as a single fused exponent
    re_i, im_i = overlap_exponent_vector(params.csoi0, qi, pi, q0, p0)
    obs_re = re_i + logw_norm
    if potential is None:
        nacq = jnp.zeros(n, dtype=vi.dtype)
    else:
        pvec = _shifted_momentum(params, pi)
        nacq = _nac_factor(params, potential, qi, pvec.astype(vi.dtype), +1.0)
    return BatchConstants(qi=qi, pi=pi, log_prob=log_prob, weight=weight,
                          logw_norm=logw_norm, log_weight_scale=log_scale,
                          vi=vi, obs_re=obs_re, obs_im=im_i, nacq=nacq)


def with_nacq(params: HKParams, bc: BatchConstants, potential) -> BatchConstants:
    pvec = _shifted_momentum(params, bc.pi)
    nacq = _nac_factor(params, potential, bc.qi, pvec.astype(bc.vi.dtype), +1.0)
    return replace(bc, nacq=nacq)


def hk_autocorr_qp(params: HKParams, bc: BatchConstants, state: TrajState,
                   c_signed):
    """Per-trajectory *weighted* contribution to the autocorrelation
    function: cauto_qp * w~ with w~ the normalised MC weight (reference
    propagators.py:784-807, 829-837). The weight, both overlap exponents
    and the action phase are combined into one exponent at trajectory
    precision before exponentiating, so tail trajectories whose raw overlap
    underflows the complex dtype still contribute exactly."""
    if state.compensated:
        # comp32: fold the trajectory/center residuals into the
        # displacements — (q0 + q0c) - (q + qc) at f32-op cost, keeping
        # the f64-difference quality of the mixed mode
        dq = (params.q0[None, :] - state.q) + (params.q0c - state.qc)
        dp = (params.p0[None, :] - state.p) + (params.p0c - state.pc)
        pj = jnp.broadcast_to(params.p0[None, :], state.q.shape)
        re_t, im_t = overlap_exponent_displaced(params.csot0, dq, dp, pj)
    else:
        re_t, im_t = overlap_exponent_vector(params.csot0, state.q, state.p,
                                             params.q0, params.p0)
    total_re = re_t + bc.obs_re
    total_im = (bc.obs_im - im_t) + state.S.astype(re_t.dtype) / hbar
    fac = jnp.conj(params.csot0.fac) * params.csoi0.fac
    return fac * c_signed * complex_exp(total_re, total_im, c_signed.dtype)


def _m2_factored(x_qp):
    """Second moment sum_i |x_i|^2 of per-trajectory complex contributions
    in the scale-safe factored form (mx, ssq) with sum|x|^2 = mx^2 * ssq.

    The device-side contributions ride at 1/weight_scale (the Monte-Carlo
    scale is exponentiated on the HOST — package numerics contract), so at
    high mode counts |x_i| is ~1e-23 and |x_i|^2 underflows float32
    outright. Normalizing by the L-infinity maximum before squaring keeps
    every squared operand O(1); the single mx^2 * weight_scale^2 squaring
    happens on the host at f64. mx == 0 (all contributions zero) yields
    (0, 0)."""
    a = jnp.real(x_qp)
    b = jnp.imag(x_qp)
    mx = jnp.maximum(jnp.max(jnp.abs(a)), jnp.max(jnp.abs(b)))
    den = jnp.where(mx > 0, mx, 1).astype(a.dtype)
    ya = a / den
    yb = b / den
    return mx, jnp.sum(ya * ya + yb * yb)


def _m2_contrib(x_qp, with_m2):
    """Factored second moment of the per-sample contributions.

    `with_m2` is the static error-bars mode: True treats every trajectory
    as an independent sample; "pairs" (antithetic sampling) folds each
    interleaved +-pair into ONE sample first — the members are
    anticorrelated by construction, so the i.i.d. formula over individual
    trajectories would overstate the error and hide the variance
    reduction. Requires an even batch length (guaranteed by
    initial_conditions for antithetic ensembles)."""
    if with_m2 == "pairs":
        x_qp = x_qp.reshape(-1, 2).sum(axis=1)
    return _m2_factored(x_qp)


def _m2_combine(a, b):
    """Combine two factored second moments over DISJOINT trajectory sets
    (the exact-integrator side-channel): rescale both to the common
    maximum and add the normalized sums."""
    mxa, sa = a
    mxb, sb = b
    mx = jnp.maximum(mxa, mxb)
    den = jnp.where(mx > 0, mx, 1).astype(sa.dtype)
    return mx, sa * (mxa / den) ** 2 + sb * (mxb / den) ** 2


def _obs_combine(obs, obs_s, with_m2):
    """Combine observable tuples of two disjoint trajectory pipelines:
    sums add; factored second moments go through _m2_combine."""
    if not with_m2:
        return tuple(a + b for a, b in zip(obs, obs_s))
    ca, ki, m2c, m2k = obs
    ca_s, ki_s, m2c_s, m2k_s = obs_s
    return (ca + ca_s, ki + ki_s,
            _m2_combine(m2c, m2c_s), _m2_combine(m2k, m2k_s))


def hk_observables(params: HKParams, bc: BatchConstants, state: TrajState,
                   c_signed, potential, with_m2=False):
    """(C_auto(t), k~ic(t)) reduced over the trajectory batch, *without* the
    excited-state dynamical phase exp(i t E0/hbar) — that phase is separable
    and applied on the host (reference propagators.py:809-911 applies it per
    call with a per-observable E0).

    With `with_m2` additionally returns the second moments
    sum_i |cauto_qp_i|^2 and sum_i |kic_qp_i|^2 — two extra fused
    reductions that turn into per-step Monte-Carlo standard errors on the
    host (BEYOND-reference: the reference's only convergence diagnostic is
    the O(n^2) norm, reference propagators.py:734-782)."""
    cauto_qp = hk_autocorr_qp(params, bc, state, c_signed)
    cauto = jnp.sum(cauto_qp)

    PI = _shifted_momentum(params, state.p, pc=state.pc)
    nacQ = _nac_factor(params, potential, state.q, PI.astype(c_signed.dtype),
                       -1.0, xc=state.qc)
    kic_qp = (1.0 / hbar**2) * nacQ * bc.nacq * cauto_qp
    kic = jnp.sum(kic_qp)
    if with_m2:
        return (cauto, kic, _m2_contrib(cauto_qp, with_m2),
                _m2_contrib(kic_qp, with_m2))
    return cauto, kic


def hk_coefficients(params: HKParams, bc: BatchConstants, state: TrajState,
                    c_signed):
    """Expansion coefficients v_i of the HK wavefunction in the coherent-state
    basis (reference propagators.py:657-686)."""
    phase = phase_exp(state.S / hbar, c_signed.dtype)
    return c_signed * phase * bc.vi * bc.weight


def _pair_sum_device(block_term, params, blocks, pairs,
                     double_offdiag=True):
    """sum_ij Re term(i, j) over the block-pair grid, one program.

    `block_term(params, *blk_i, *blk_j) -> complex scalar` must be a
    module-level function (it is a STATIC jit argument — a fresh closure
    would re-trace on every call).
    The loop over the upper-triangular pair list runs DEVICE-side via
    lax.map (serialised — only one (block, block) intermediate is ever
    live), so the whole O(n^2) reduction is a single dispatch instead of
    O((n/block)^2) host round-trips. Off-diagonal blocks are counted once
    and doubled (the pair matrix is Hermitian — identical bra/ket width
    matrices).
    """
    def one(pr):
        bi = tuple(b[pr[0]] for b in blocks)
        bj = tuple(b[pr[1]] for b in blocks)
        t = block_term(params, *(bi + bj))
        if not double_offdiag:
            return t.real      # full ordered grid: Re is linear, so
                               # summing Re(t) equals Re(sum t)
        return jnp.where(pr[0] == pr[1], t.real, 2.0 * t.real)

    return jnp.sum(lax.map(one, pairs))


_pair_sum_device_jit = jax.jit(_pair_sum_device,
                               static_argnums=(0, 4))


def blocked_pair_sum(block_term, params, arrays, block=4096,
                     hermitian=True, max_pairs_per_dispatch=8192):
    """Host wrapper for _pair_sum_device: reshape to blocks, build the
    pair list (upper triangle when the pair matrix is Hermitian, the full
    ordered grid otherwise), run device-side. Requires block | n (callers
    fall back to a host loop otherwise).

    The pair grid is split into dispatches of at most
    `max_pairs_per_dispatch` pairs, which bounds the length of one XLA
    execution: the pair count grows as (n/block)^2 — 131k trajectories is
    528 pairs, 1M would be ~33k pairs in one execution without the split.
    At most two program shapes compile (full chunks + one remainder)."""
    n = arrays[0].shape[0]
    assert n % block == 0
    nb = n // block
    blocks = tuple(a.reshape((nb, block) + a.shape[1:]) for a in arrays)
    if hermitian:
        iu, ju = np.triu_indices(nb)
    else:
        iu, ju = (g.ravel() for g in np.mgrid[0:nb, 0:nb])
    total = 0.0
    for s in range(0, iu.shape[0], max_pairs_per_dispatch):
        pairs = jnp.asarray(
            np.stack([iu[s:s + max_pairs_per_dispatch],
                      ju[s:s + max_pairs_per_dispatch]], axis=1),
            dtype=jnp.int32)
        total += float(from_device(_pair_sum_device_jit(
            block_term, params, blocks, pairs, hermitian)))
    return total


def _pair_terms_device(block_term, params, blocks, pairs):
    """Per-pair real block sums Re term(i, j) (no reduction) — the
    sampling primitive of the subsampled norm estimator."""
    def one(pr):
        bi = tuple(b[pr[0]] for b in blocks)
        bj = tuple(b[pr[1]] for b in blocks)
        return block_term(params, *(bi + bj)).real

    return lax.map(one, pairs)


_pair_terms_device_jit = jax.jit(_pair_terms_device, static_argnums=(0,))


def subsampled_pair_sum(block_term, params, arrays, block=4096,
                        sample_pairs=512, key=0, hermitian=True):
    """Unbiased estimate of the O(n^2) pair sum from a random subsample
    of off-diagonal block pairs, with a Monte-Carlo standard error.

    The full norm diagnostic is variance-limited at high mode counts
    (PARITY.md known-gaps): the ensembles where it would matter make the
    exact O(n^2) reduction impractical, and a noisy point estimate
    WITHOUT an error bar is uninterpretable. This estimator keeps the
    diagonal block pairs exact (they carry the positive |v_i|^2 mass) and
    samples `sample_pairs` of the P = nb(nb-1)/2 off-diagonal pairs
    without replacement:

        sum_est = diag + (P/m) sum_sample 2 Re t_k
        var_est = P^2 var(2 Re t_k) / m * (1 - m/P)   (finite population)

    Cost: O(nb + m) block pairs instead of O(nb^2). sample_pairs >= P
    degenerates to the exact sum (stderr 0). Returns (sum, stderr).
    Gated against the full f64 reduction in tests/test_norm_device.py.

    hermitian=False (the WM pair exponent is not assembled symmetrically):
    the sample is drawn from the P = nb(nb-1) ORDERED off-diagonal pairs
    and the terms are not doubled — the estimator stays unbiased because
    the full ordered sum is still the target.
    """
    n = arrays[0].shape[0]
    assert n % block == 0, "subsampled norm needs block | n"
    nb = n // block
    blocks = tuple(a.reshape((nb, block) + a.shape[1:]) for a in arrays)

    diag = jnp.asarray(
        np.stack([np.arange(nb), np.arange(nb)], axis=1), dtype=jnp.int32)
    diag_sum = float(np.sum(from_device(
        _pair_terms_device_jit(block_term, params, blocks, diag))))

    if hermitian:
        iu, ju = np.triu_indices(nb, k=1)
    else:
        ii, jj = np.mgrid[0:nb, 0:nb]
        off = ii != jj
        iu, ju = ii[off], jj[off]
    P = iu.shape[0]
    if P == 0:
        return diag_sum, 0.0
    m = min(int(sample_pairs), P)
    rng = np.random.default_rng(key)
    sel = rng.choice(P, size=m, replace=False)
    pairs = jnp.asarray(np.stack([iu[sel], ju[sel]], axis=1),
                        dtype=jnp.int32)
    terms = (2.0 if hermitian else 1.0) * np.asarray(from_device(
        _pair_terms_device_jit(block_term, params, blocks, pairs)),
        dtype=np.float64)
    est = P * float(np.mean(terms))
    if m > 1 and m < P:
        var = P * P * float(np.var(terms, ddof=1)) / m * (1.0 - m / P)
    else:
        var = 0.0
    return diag_sum + est, float(np.sqrt(var))


def _pair_sum_ring_run(block_term, mesh, nb, acc_dtype, params, *arrays):
    """Distributed O(n^2) pair reduction: a shard_map systolic ring.

    Each chip keeps its ensemble shard and a rotating copy; at rotation r
    it reduces (local x visiting) over ALL ordered pairs, then ppermutes
    the visiting copy one step around the `traj` ring (device-to-device
    traffic only — SURVEY P4's all-gather-style exchange). After ndev
    rotations every global ordered pair was visited exactly once; a final psum yields
    norm^2. Within one rotation the local x visiting product is blocked
    nb-ways with a device-side lax.map. Jitted once per (block_term, mesh,
    nb, shapes) — all static args are hashable, params flow as arguments.
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    ndev = int(mesh.devices.size)
    perm = [(i, (i + 1) % ndev) for i in range(ndev)]
    n_loc = arrays[0].shape[0] // ndev
    blk = n_loc // nb

    def local_sum(params, loc, vis):
        """sum over all ordered (local i, visiting j) pairs, complex."""
        if nb == 1:
            return block_term(params, *(loc + vis))
        lb = tuple(a.reshape((nb, blk) + a.shape[1:]) for a in loc)
        vb = tuple(a.reshape((nb, blk) + a.shape[1:]) for a in vis)
        ii, jj = np.mgrid[0:nb, 0:nb]
        pairs = jnp.asarray(
            np.stack([ii.ravel(), jj.ravel()], axis=1), dtype=jnp.int32)

        def one(pr):
            return block_term(params, *(tuple(b[pr[0]] for b in lb)
                                        + tuple(b[pr[1]] for b in vb)))

        return jnp.sum(lax.map(one, pairs))

    def body(params, *shards):
        shards = tuple(shards)

        def step(r, carry):
            vis, acc = carry
            acc = acc + local_sum(params, shards, vis)
            vis = jax.tree.map(
                lambda a: lax.ppermute(a, "traj", perm), vis)
            return (vis, acc)

        # the accumulator dtype is the block term's OUTPUT dtype (passed
        # in statically): deriving it from the input arrays promoted f64
        # log-coefficients to complex128 in the reduced-precision modes
        cdt = jnp.dtype(acc_dtype)
        # the accumulator must carry the `traj` varying axis from the
        # start (the loop output does, and scan/fori carries must match)
        zero = jnp.zeros((), dtype=cdt)
        try:
            zero = lax.pvary(zero, ("traj",))
        except AttributeError:
            zero = zero + (0.0 * shards[-1].ravel()[0]).astype(cdt)
        _, acc = lax.fori_loop(0, ndev, step, (shards, zero))
        return lax.psum(acc, "traj")

    spec_in = ((P(),)
               + tuple(P("traj", *([None] * (a.ndim - 1))) for a in arrays))
    f = shard_map(body, mesh=mesh, in_specs=spec_in, out_specs=P())
    return f(params, *arrays)


_pair_sum_ring_jit = jax.jit(_pair_sum_ring_run,
                             static_argnums=(0, 1, 2, 3))


def _block_term_out_dtype(block_term, params, arrays):
    """The block term's complex output dtype, found abstractly (no
    device work) on zero-length blocks."""
    zeros = tuple(jax.ShapeDtypeStruct((0,) + a.shape[1:], a.dtype)
                  for a in arrays)
    out = jax.eval_shape(lambda p, *bs: block_term(p, *(bs + bs)),
                         params, *zeros)
    return jnp.dtype(out.dtype).name


def _ring_block_count(n_loc, block):
    """Blocks per shard for the systolic ring. Whole shards no larger
    than `block` run as one block; otherwise `block` must divide the
    shard, or the largest divisor of n_loc near the requested size is
    used — silently falling back to one whole-shard block would
    materialise an (n_loc, n_loc) pair intermediate (OOM at production
    shard sizes), so refuse loudly if no usable divisor exists."""
    if n_loc % block == 0:
        return n_loc // block
    if n_loc <= block:
        return 1
    b = next((b for b in range(block, 0, -1) if n_loc % b == 0), 1)
    if b < block // 4:
        raise ValueError(
            f"block={block} does not divide the per-device shard "
            f"({n_loc}) and no usable divisor exists; choose a block "
            "that divides ntraj / n_devices")
    return n_loc // b


def _pair_sum_ring(block_term, params, arrays, mesh, block):
    ndev = int(mesh.devices.size)
    n_loc = arrays[0].shape[0] // ndev
    nb = _ring_block_count(n_loc, block)
    acc_dtype = _block_term_out_dtype(block_term, params, arrays)
    norm2 = _pair_sum_ring_jit(block_term, mesh, nb, acc_dtype, params,
                               *arrays)
    return complex(from_device(norm2)).real


def _hk_norm_block_term(overlap_params, qi, pi, vi, qj, pj, vj):
    olap = overlap_matrix(overlap_params, qi, pi, qj, pj)
    return jnp.einsum("i,ij,j", jnp.conj(vi), olap, vj)


def hk_log_coefficients(params: HKParams, bc: BatchConstants,
                        state: TrajState, c_signed):
    """log v_i of the fully weighted HK expansion coefficients as two f64
    arrays (log_re = log |v_i|, log_im = arg v_i) — the range-safe form of
    hk_coefficients: the normalised MC weights exp(logw_norm) alone span
    exp(+-O(100)) at high mode counts and overflow f32/f64 linear scale,
    while the combined exponent stays O(-log n) for every contributing
    trajectory (vi tail suppression cancels the weight growth — the same
    fusion hk_batch_constants applies to the observables). Validated to
    1e-16 against hk_coefficients where the linear scale is finite
    (tests/test_norm_device.py). Cf. wm_log_coefficients."""
    f64 = jnp.float64
    fac = params.csoi0.fac
    log_re = (jnp.log(jnp.abs(c_signed)).astype(f64)
              + bc.obs_re.astype(f64)
              + jnp.log(jnp.abs(fac)).astype(f64)
              + bc.log_weight_scale)
    log_im = (jnp.angle(c_signed).astype(f64)
              + state.S.astype(f64) / hbar
              + bc.obs_im.astype(f64)
              + jnp.angle(fac).astype(f64))
    return log_re, log_im


def _hk_norm_log_block_term(overlap_params, qi, pi, lri, lii, qj, pj, lij_r,
                            lij_i):
    """Log-space pair block: conj(v_i) <g_i|g_j> v_j assembled as ONE
    exponent per entry (log-coefficients + the pair-overlap exponent +
    log fac) — finite wherever the true pair term is, independent of the
    linear-scale range of v or the normalised weights."""
    from semiclassical_jax.coherent import overlap_exponent_matrix

    re, im = overlap_exponent_matrix(overlap_params, qi, pi, qj, pj)
    rd = re.dtype
    fac = overlap_params.fac
    total_re = (lri.astype(rd)[:, None] + lij_r.astype(rd)[None, :] + re
                + jnp.log(jnp.abs(fac)).astype(rd))
    total_im = ((-lii).astype(rd)[:, None] + lij_i.astype(rd)[None, :] + im
                + jnp.angle(fac).astype(rd))
    return jnp.sum(complex_exp(total_re, total_im, fac.dtype))


_hk_norm_log_block_jit = jax.jit(_hk_norm_log_block_term)


def pairwise_norm_log(overlap_params, q, p, log_v, block=4096, mesh=None,
                      sample_pairs=None, key=0):
    """|psi| from log-coefficients — the range-safe pairwise norm (the
    linear `pairwise_norm` is reference-equivalent but its coefficients
    overflow/underflow the complex dtype at high mode counts). Same three
    execution routes as pairwise_norm.

    With `sample_pairs` (single-device route only): the subsampled
    variance-characterized estimate — returns (norm, stderr) from
    `subsampled_pair_sum` instead of a bare float. The stderr is
    propagated through the square root (sigma_norm = sigma_n2 / (2 norm));
    a norm^2 estimate within noise of zero returns (0.0, sqrt(sigma_n2)).
    """
    lr, li = log_v
    arrays = (q, p, lr, li)

    if sample_pairs is not None:
        assert mesh is None, (
            "subsampled norm: single-device route only (the mesh ring is "
            "already O(n^2 / ndev) — run it, or fetch the ensemble)")
        n = q.shape[0]
        b = block if n % block == 0 else next(
            bb for bb in range(min(block, n), 0, -1) if n % bb == 0)
        norm2, err2 = subsampled_pair_sum(
            _hk_norm_log_block_term, overlap_params, arrays, block=b,
            sample_pairs=sample_pairs, key=key)
        if norm2 <= 0.0:
            # within noise of zero: report the norm^2 stderr itself as
            # the (conservative) uncertainty scale
            return 0.0, float(err2)
        norm = float(np.sqrt(norm2))
        return norm, err2 / (2.0 * norm)

    if mesh is not None:
        norm2 = _pair_sum_ring(_hk_norm_log_block_term, overlap_params,
                               arrays, mesh, block)
        return float(np.sqrt(norm2))

    n = q.shape[0]
    if n % block == 0:
        return float(np.sqrt(blocked_pair_sum(
            _hk_norm_log_block_term, overlap_params, arrays, block=block)))

    nblocks = -(-n // block)
    norm2 = 0.0
    for ib in range(nblocks):
        sl_i = slice(ib * block, min((ib + 1) * block, n))
        for jb in range(ib, nblocks):
            sl_j = slice(jb * block, min((jb + 1) * block, n))
            term = complex(_hk_norm_log_block_jit(
                overlap_params, q[sl_i], p[sl_i], lr[sl_i], li[sl_i],
                q[sl_j], p[sl_j], lr[sl_j], li[sl_j]))
            norm2 += term.real if jb == ib else 2.0 * term.real
    return float(np.sqrt(norm2))


def pairwise_norm(overlap_params, q, p, v, block=4096, mesh=None):
    """|psi| = sqrt( sum_ij v_i^* <g_i|g_j> v_j ) by blocked accumulation.

    O(n^2) — opt-in convergence diagnostic (reference propagators.py:734-782).
    The block-pair loop runs device-side in one jit (blocked_pair_sum);
    under a mesh the reduction runs as a shard_map systolic ring
    (_pair_sum_ring).
    """
    if mesh is not None:
        norm2 = _pair_sum_ring(_hk_norm_block_term, overlap_params,
                               (q, p, v), mesh, block)
        return float(np.sqrt(norm2))

    n = q.shape[0]
    if n % block == 0:
        return float(np.sqrt(blocked_pair_sum(
            _hk_norm_block_term, overlap_params, (q, p, v), block=block)))

    # fallback: host loop over the Hermitian upper triangle (uneven blocks)
    nblocks = -(-n // block)
    norm2 = 0.0
    for ib in range(nblocks):
        sl_i = slice(ib * block, min((ib + 1) * block, n))
        for jb in range(ib, nblocks):
            sl_j = slice(jb * block, min((jb + 1) * block, n))
            term = complex(_hk_norm_block_jit(
                overlap_params, q[sl_i], p[sl_i], v[sl_i],
                q[sl_j], p[sl_j], v[sl_j]))
            norm2 += term.real if jb == ib else 2.0 * term.real
    return float(np.sqrt(norm2))


_hk_norm_block_jit = jax.jit(_hk_norm_block_term)


def check_energy_conservation(energies, change_tol=1.0e-2):
    """Post-scan guard: raise if the batch-mean <T+V> drifts between steps
    (reference propagators.py:385-398) or if the trace contains NaNs."""
    energies = np.asarray(energies)
    if np.isnan(energies).any():
        raise RuntimeError("NaN encountered in trajectory energies")
    change = np.abs(np.diff(energies))
    if change.size and change.max() > change_tol:
        step = int(np.argmax(change))
        logger.error("  energy conservation violated")
        logger.error(
            f"  <T+V>(t-dt)= {energies[step]}, <T+V>(t)= {energies[step + 1]}"
        )
        raise RuntimeError(
            "average energy of classical trajectories is not conserved, "
            f"change= {change.max()} Hartree"
        )


# ---------------------------------------------------------------------------
# scan driver
# ---------------------------------------------------------------------------

def _hk_scan(params, bc, potential, state0, tracker0, t0, dt, nt,
             integ=None, with_m2=False):
    step_fn = rk4_step
    if integ is not None and isinstance(integ[0], HarmonicMap):
        # exact harmonic map: a drop-in per-step replacement for rk4_step
        # (constant affine map + Van Loan action form, see
        # propagation/exact_harmonic.py) — the plain scan body applies,
        # no side-channel or extra carry needed
        hmap = integ[0]
        step_fn = lambda st, pot, _dt: harmonic_step(hmap, st, pot)
        integ = None
    if integ is not None:
        # exact-Morse integrator: the scan carries only the phase pack
        # (th + residual + t_rel); the full TrajState is materialised
        # fresh each step from closed-form constants (no accumulating
        # trajectory error, 4x less carry memory traffic than the comp32
        # RK4 state) — see propagation/exact_morse.py.  RK4-routed rows
        # (unbound tail samples) contribute through their own small
        # pipeline on the side-channel sub-batch: `bc` is the masked
        # copy whose routed rows carry -inf log-weights, `bc_sub` the
        # gathered sub-row constants (pad rows likewise -inf-masked).
        pack, mcarry0, bc_sub = integ
        mono = state0.Mqq.dtype

        def body(carry, _):
            tracker, mcarry = carry
            state, en = morse_map_state(pack, mcarry, mono, potential)
            c2 = hk_prefactor_det(params, state)
            tracker = tracker.update(c2)
            c = jnp.sqrt(c2) * tracker.signs
            obs = hk_observables(params, bc, state, c, potential,
                                 with_m2=with_m2)
            if pack.has_sub:
                (tr_s,) = mcarry.sub_trackers
                c2s = hk_prefactor_det(params, mcarry.sub)
                tr_s = tr_s.update(c2s)
                cs = jnp.sqrt(c2s) * tr_s.signs
                # the routed rows are -inf-masked in `bc` and disjoint
                # from `bc_sub`'s live rows, so sums combine by addition
                # and the factored second moments by _m2_combine
                obs_s = hk_observables(params, bc_sub, mcarry.sub,
                                       cs, potential, with_m2=with_m2)
                obs = _obs_combine(obs, obs_s, with_m2)
                mcarry = replace(mcarry, sub_trackers=(tr_s,))
            mcarry = morse_map_advance(pack, mcarry, dt, potential)
            return (tracker, mcarry), obs + (en,)

        (tracker, mcarry), outs = lax.scan(body, (tracker0, mcarry0), None,
                                           length=nt)
        state_fin, _ = morse_map_state(pack, mcarry, mono, potential)
        state_fin = morse_map_merge(pack, mcarry, state_fin)
        if pack.has_sub:
            tracker = merge_tracker(tracker, mcarry.sub_trackers[0],
                                    pack.sub_idx)
        return (state_fin, tracker, t0 + nt * dt, mcarry), outs

    every = int(getattr(potential, "taylor_every", 1) or 1)
    if every > 1 and step_fn is rk4_step:
        # taylor_every re-expansion windows: ONE order-2 PES evaluation
        # per `every` steps; the window's frozen LocalQuadratic rides the
        # scan carry (see eom.make_taylor_window)
        if getattr(potential, "hessian_eval", "stage") != "taylor":
            # trace-time guard (cf. rk4_step's hessian_eval check): the
            # create() validation is bypassable via direct construction /
            # pytree replace(), and the window semantics silently replace
            # stage/step-parity forces with local quadratics
            raise ValueError(
                "taylor_every > 1 requires hessian_eval='taylor'")
        from semiclassical_jax.propagation.eom import make_taylor_window
        carry0_fn, wstep = make_taylor_window(potential, dt, every)

        def wbody(carry, _):
            state, tracker, t, sc = carry
            c2 = hk_prefactor_det(params, state)
            tracker = tracker.update(c2)
            c = jnp.sqrt(c2) * tracker.signs
            obs = hk_observables(params, bc, state, c, potential,
                                 with_m2=with_m2)
            new_state, en, sc = wstep(state, sc)
            return (new_state, tracker, t + dt, sc), obs + (en,)

        (state, tracker, t, _), outs = lax.scan(
            wbody, (state0, tracker0, t0, carry0_fn(state0)), None,
            length=nt)
        return (state, tracker, t, None), outs

    def body(carry, _):
        state, tracker, t = carry
        c2 = hk_prefactor_det(params, state)
        tracker = tracker.update(c2)
        c = jnp.sqrt(c2) * tracker.signs
        obs = hk_observables(params, bc, state, c, potential,
                             with_m2=with_m2)
        new_state, en = step_fn(state, potential, dt)
        return (new_state, tracker, t + dt), obs + (en,)

    (state, tracker, t), outs = lax.scan(body, (state0, tracker0, t0), None,
                                         length=nt)
    return (state, tracker, t, None), outs


_hk_scan_jit = jax.jit(_hk_scan, static_argnames=("nt", "with_m2"))


# ---------------------------------------------------------------------------
# device-side micro-batching
# ---------------------------------------------------------------------------

def _split_traj_tree(tree, n, k):
    """Reshape every per-trajectory leaf (leading axis n) into (k, n//k, ...)
    for lax.map; scalar batch-wide leaves are tiled to k copies so every
    mapped leaf carries the map axis.

    Every array leaf of the trees this sees (TrajState, BatchConstants,
    SignTracker) is per-trajectory by construction, so a non-scalar leaf
    whose leading axis is NOT n is an error — classifying by
    ``shape[0] == n`` alone would silently split a batch-wide constant
    whose leading dim coincidentally equals the trajectory count
    (e.g. a (d, ...) matrix when ntraj == d)."""
    m = n // k

    def f(leaf):
        leaf = jnp.asarray(leaf)
        if leaf.ndim == 0:
            return jnp.broadcast_to(leaf[None], (k,))
        if leaf.shape[0] != n:
            raise ValueError(
                f"micro-batch split saw a non-scalar leaf of shape "
                f"{leaf.shape} whose leading axis != ntraj={n}; only "
                f"per-trajectory leaves and scalars are supported — tile "
                f"batch-wide constants explicitly before _split_traj_tree")
        return leaf.reshape((k, m) + leaf.shape[1:])

    return jax.tree.map(f, tree)


def _merge_traj_tree(tree, n):
    """Inverse of _split_traj_tree for per-trajectory leaves: (k, m, ...) ->
    (n, ...); tiled batch-wide leaves collapse to their first copy."""
    def f(leaf):
        if leaf.ndim >= 2 and leaf.shape[0] * leaf.shape[1] == n:
            return leaf.reshape((n,) + leaf.shape[2:])
        return leaf[0]

    return jax.tree.map(f, tree)


def _m2_combine_axis(m2):
    """Vectorised _m2_combine across the micro-batch axis: (k, nt) factored
    moments -> (nt,)."""
    mxs, ssqs = m2
    mx = jnp.max(mxs, axis=0)
    den = jnp.where(mx > 0, mx, 1).astype(ssqs.dtype)
    return mx, jnp.sum(ssqs * (mxs / den[None]) ** 2, axis=0)


def _micro_scan(scan_fn, params, bc, potential, state0, trackers0, t0, dt,
                nt, k, with_m2):
    """Run the time scan as `lax.map` over k device-side sub-batches.

    Large batches of the WM derived chain are memory-bound: the per-step
    intermediates scale with the batch, and throughput can peak at a much
    smaller batch than the memory ceiling. lax.map serialises the
    sub-batches (unlike vmap, which would re-vectorise them back into
    full-width intermediates), so each sub-batch's step intermediates stay at the
    throughput-optimal size while the whole run remains ONE dispatch.

    The trajectory state is embarrassingly parallel, so per-trajectory
    results are exactly the monolithic ones; only the observable
    REDUCTIONS change association order (sub-batch partials then sum) —
    gated against the monolithic scan in tests/test_micro_batch.py.
    """
    n = state0.q.shape[0]
    if with_m2 == "pairs" and (n // k) % 2:
        raise ValueError(
            f"antithetic error bars need an even micro-batch size, got "
            f"{n // k} (= {n} trajectories / {k} sub-batches) — interleaved "
            "+-pairs must not straddle a sub-batch boundary")
    sub = _split_traj_tree((state0, bc, trackers0), n, k)

    def one(args):
        st, b, tr = args
        return scan_fn(params, b, potential, st, tr, t0, dt, nt,
                       None, with_m2)

    carries, outs = lax.map(one, sub)
    state_k, trackers_k, t_k = carries[0], carries[1], carries[2]
    state = _merge_traj_tree(state_k, n)
    trackers = _merge_traj_tree(trackers_k, n)
    carry = (state, trackers, t_k[0], None)

    if with_m2:
        cauto, kic, m2c, m2k, en = outs
        outs = (jnp.sum(cauto, axis=0), jnp.sum(kic, axis=0),
                _m2_combine_axis(m2c), _m2_combine_axis(m2k),
                jnp.mean(en, axis=0))
    else:
        cauto, kic, en = outs
        outs = (jnp.sum(cauto, axis=0), jnp.sum(kic, axis=0),
                jnp.mean(en, axis=0))
    return carry, outs


def _hk_scan_micro(params, bc, potential, state0, tracker0, t0, dt, nt,
                   k, with_m2=False):
    return _micro_scan(_hk_scan, params, bc, potential, state0, tracker0,
                       t0, dt, nt, k, with_m2)


_hk_scan_micro_jit = jax.jit(_hk_scan_micro,
                             static_argnames=("nt", "k", "with_m2"))


# ---------------------------------------------------------------------------
# fused initial-conditions program
# ---------------------------------------------------------------------------

# batch-constant builders by tag: the fused program takes the TAG as its
# static argument, not the function — a function-valued static lands its
# repr (with a memory address) in the persistent-compile-cache key, so
# the expensive fused program would recompile in every fresh process.
# wm.py registers its builder on import.
_BC_BUILDERS = {"hk": hk_batch_constants}


def _ic_draw(sampling, key, ntraj, method):
    from semiclassical_jax.sampling import sample_initial_conditions
    return sample_initial_conditions(sampling, key, ntraj, method=method)


def _ic_state(qi, pi, traj_dtype, mono_dtype, diag_monodromy, compensated):
    return TrajState.initial(
        qi, pi, dtype=traj_dtype, mono_dtype=mono_dtype,
        diag_monodromy=diag_monodromy, compensated=compensated)


def _ic_constants(bc_tag, sampling, params, potential, qi, pi, prob):
    from semiclassical_jax.sampling import _sampling_stats_core
    bc = _BC_BUILDERS[bc_tag](params, qi, pi, prob, potential=potential)
    # the moment diagnostic runs on the leading <= 65536 trajectories: its
    # readout saturates there (the comparison floor is sqrt(2/n)) while
    # the full-ensemble (n, 2d) f64 concat/center buffers are a large
    # peak-memory term at 1M trajectories
    n_stat = min(qi.shape[0], 65536)
    mean_dev, cov_dev = _sampling_stats_core(sampling, qi[:n_stat],
                                             pi[:n_stat])
    return bc, jnp.stack([mean_dev, cov_dev])


# Three jitted programs replace a ~30-execution eager setup (one dispatch
# per op). Three rather than one: a single fused program at 1M x 60 keeps
# the (n, 2 rank) f64 draw/transform intermediates alive alongside the
# state and the batch-constant outputs; the splits free each stage's
# temporaries at the program boundaries. The batch-constant builder is
# selected by a string TAG (a function-valued static would put its repr —
# a memory address — into the persistent-compile-cache key and force a
# fresh compile in every process).
_ic_draw_jit = jax.jit(_ic_draw, static_argnums=(2, 3))
_ic_state_jit = jax.jit(_ic_state, static_argnums=(2, 3, 4, 5))
_ic_constants_jit = jax.jit(_ic_constants, static_argnums=(0,))


# ---------------------------------------------------------------------------
# stateful wrapper (reference-shaped API)
# ---------------------------------------------------------------------------

class HermanKlukPropagator:
    """Stateful convenience wrapper over the functional HK core.

    Mirrors the reference API (initial_conditions / step / autocorrelation /
    ic_correlation / norm / wavefunction) for granular use and adds the fast
    path `propagate(potential, dt, nt)` that runs the whole time loop in one
    jitted scan.
    """

    def __init__(self, Gamma_i, Gamma_t, dtype=jnp.float64, traj_dtype=None,
                 integrator="rk4"):
        """
        Parameters
        ----------
        Gamma_i, Gamma_t : (d, d) width matrices of the frozen Gaussians
        dtype : precision of the parameter packs and all complex algebra
            (float32 -> complex64, float64 -> complex128)
        traj_dtype : precision of the trajectory state q, p, S (defaults to
            `dtype`). The mixed mode dtype=float32, traj_dtype=float64 is
            the accelerator default: full-precision classical dynamics
            with the monodromy matmuls and complex determinant in f32/c64.
        integrator : "rk4" (fixed-step Runge-Kutta, matches the reference
            trajectory-for-trajectory) or "exact" (zero time-
            discretization error at any dt; requires either a non-harmonic
            separable MorsePotential with bound orbits — the closed-form
            Morse action-angle map, propagation/exact_morse.py — or a
            constant-Hessian molecular harmonic potential — the exact
            affine normal-mode map, propagation/exact_harmonic.py).
        """
        if integrator not in ("rk4", "exact"):
            raise ValueError(f"unknown integrator {integrator!r} "
                             "(expected 'rk4' or 'exact')")
        self.integrator = integrator
        self._integ_invalidate()
        Gamma_i = np.asarray(Gamma_i, dtype=np.float64)
        Gamma_t = np.asarray(Gamma_t, dtype=np.float64)
        assert linalg.is_symmetric_non_negative(Gamma_i), (
            "Gamma_i has to be symmetric and positive semi-definite."
        )
        assert linalg.is_symmetric_non_negative(Gamma_t), (
            "Gamma_t has to be symmetric and positive semi-definite."
        )
        self.Gamma_i = Gamma_i
        self.Gamma_t = Gamma_t
        # device-side micro-batching: when > 0 and it divides the batch,
        # scans run as lax.map over sub-batches of this size (one dispatch;
        # keeps memory-bound step intermediates at the throughput-optimal
        # batch — the WM production lever, see _micro_scan)
        self.micro_batch = 0
        self.dtype = dtype
        self.traj_dtype = dtype if traj_dtype is None else traj_dtype
        # comp32: compensated-f32 trajectories (see TrajState) — sampling
        # and scalars run f64, the state is f32 + f32 residuals
        self.compensated = (isinstance(self.traj_dtype, str)
                            and self.traj_dtype == "comp32")
        if self.compensated and jnp.dtype(dtype) != jnp.float32:
            raise ValueError("comp32 trajectories require dtype=float32")

    @property
    def _scalar_dtype(self):
        """dtype of host-side time scalars entering jit."""
        return jnp.float64 if self.compensated else self.traj_dtype

    @property
    def _sample_dtype(self):
        """dtype of the initial-condition sampling (full precision in
        comp32 — the state split captures it)."""
        return jnp.float64 if self.compensated else self.traj_dtype

    # -- hooks shared with the WM subclass -----------------------------------

    def _make_params(self, Gamma_0, q0, p0, U, iGi0):
        return _build_hk_params(self.Gamma_i, self.Gamma_t, Gamma_0,
                                q0, p0, U, iGi0, self.dtype,
                                traj_dtype=self.traj_dtype)

    def _make_trackers(self, state):
        c2 = hk_prefactor_det(self.params, state)
        return {"prefactorC": SignTracker.fresh(c2)}

    def _integ(self, potential, dt):
        """Resolve the integrator for this scan: None selects RK4; for the
        exact Morse map, build (or reuse) the constant pack and the carried
        phase.  The pack is tied to (state, potential, dt) by object
        identity: a dt change, an externally assigned `self.state` (state
        surgery is a supported pattern), or a different potential object
        rebuilds it from the current state (the map is exact, so re-setup
        introduces no stepping error)."""
        if self.integrator != "exact":
            return None
        if supports_exact_harmonic(potential):
            # constant-Hessian molecular PES: the exact affine map — no
            # carried state, only (potential, dt, device dtypes) matter.
            # The potential is compared BY RETAINED IDENTITY (not id():
            # a freed potential's address can be recycled by a new one,
            # which would silently reuse the stale map's constants)
            key = (float(dt), self.state.q.dtype, self.state.Mqq.dtype)
            if self._hmap_key != key or self._hmap_pot_ref is not potential:
                self._hmap = build_harmonic_map(potential, dt, self.state)
                self._hmap_key = key
                self._hmap_pot_ref = potential
            return (self._hmap, None, None)
        if (self._integ_pack is None or self._integ_carry is None
                or self._integ_dt != float(dt)
                or self._integ_state_ref is not self.state
                or self._integ_pot_ref is not potential):
            if not supports_exact_morse(potential, self.state):
                raise ValueError(
                    "integrator='exact' requires a non-harmonic separable "
                    "MorsePotential (diagonal-monodromy state) or a "
                    "constant-Hessian molecular harmonic potential; use "
                    "integrator='rk4' for this potential")
            pack, carry = build_morse_map(self.state, potential, dt)
            if pack.has_sub:
                self._integ_bc_scan = self._mask_routed_rows(
                    self._bc, pack.row_bad)
                self._integ_bc_sub = self._gather_sub_rows(
                    self._bc, pack.sub_idx, pack.n_bad)
                carry = replace(
                    carry,
                    sub_trackers=self._sub_trackers(
                        carry.sub, self._integ_bc_sub, pack.sub_idx))
            else:
                self._integ_bc_scan = self._bc
                self._integ_bc_sub = None
            self._integ_pack, self._integ_carry = pack, carry
            self._integ_dt = float(dt)
            self._integ_state_ref = self.state
            self._integ_pot_ref = potential
        return (self._integ_pack, self._integ_carry, self._integ_bc_sub)

    def _integ_refresh_bc(self):
        """Rebuild the bc-derived exact-map fields from the current
        ``self._bc``.  Needed when `_require_nacq` replaces the batch
        constants *after* the pack was built (e.g. `initial_conditions`
        without a potential, then `step`, then `propagate`): the masked
        scan/sub constants captured the nacq-less bc and would silently
        zero k~ic(t).  The pack/carry stay valid — they depend only on
        (state, potential, dt), and the sub trackers are re-seeded from
        `self.trackers` at every build, never from the bc."""
        pack = self._integ_pack
        if pack is None:
            return
        if pack.has_sub:
            self._integ_bc_scan = self._mask_routed_rows(
                self._bc, pack.row_bad)
            self._integ_bc_sub = self._gather_sub_rows(
                self._bc, pack.sub_idx, pack.n_bad)
        else:
            self._integ_bc_scan = self._bc
            self._integ_bc_sub = None

    def _integ_invalidate(self):
        """Drop the cached exact-map pack/carry (the state was replaced
        from outside the scan — new batch or checkpoint restore)."""
        self._integ_pack = None
        self._integ_carry = None
        self._integ_dt = None
        self._integ_bc_scan = None
        self._integ_bc_sub = None
        self._integ_state_ref = None
        self._integ_pot_ref = None
        # exact harmonic map cache (dtype/dt-keyed + retained potential
        # identity; state-independent)
        self._hmap = None
        self._hmap_key = None
        self._hmap_pot_ref = None

    # -- exact-integrator side-channel helpers --------------------------------

    @staticmethod
    def _mask_batch_constants(bc: BatchConstants, mask) -> BatchConstants:
        """Zero the masked rows' observable contributions by driving their
        fused log-weights to -inf (exp(-inf) = 0 exactly — the scan never
        produces NaN because every routed row's closed-form column is a
        finite rest state, see exact_morse._setup_f64)."""
        ninf = jnp.asarray(-jnp.inf, dtype=bc.obs_re.dtype)
        return replace(
            bc,
            obs_re=jnp.where(mask, ninf, bc.obs_re),
            logw_norm=jnp.where(
                mask, ninf.astype(bc.logw_norm.dtype), bc.logw_norm))

    def _mask_routed_rows(self, bc, row_bad):
        return self._mask_batch_constants(bc, row_bad)

    def _gather_sub_rows(self, bc, sub_idx, n_bad):
        """Batch constants of the side-channel rows (pad rows -inf-masked)."""
        take = lambda a: jnp.take(a, sub_idx, axis=0, mode="fill",
                                  fill_value=0)
        sub = replace(
            bc, qi=take(bc.qi), pi=take(bc.pi), log_prob=take(bc.log_prob),
            weight=take(bc.weight), logw_norm=take(bc.logw_norm),
            vi=take(bc.vi), obs_re=take(bc.obs_re), obs_im=take(bc.obs_im),
            nacq=take(bc.nacq))
        pad = jnp.arange(sub_idx.shape[0]) >= n_bad
        return self._mask_batch_constants(sub, pad)

    def _sub_trackers(self, sub_state, bc_sub, sub_idx):
        """Side-channel sign trackers, seeded from the main trackers'
        routed rows (the authoritative, checkpointed branch-cut state)."""
        return (gather_tracker(self.trackers["prefactorC"], sub_idx),)

    def _micro_k(self):
        """Number of device-side sub-batches for the micro-batched scan
        (1 = monolithic). Active when `micro_batch` is set, divides the
        batch, and no exact-integrator pack is in play."""
        m = int(getattr(self, "micro_batch", 0) or 0)
        n = 0 if self.state is None else int(self.state.q.shape[0])
        if m <= 0 or n <= m:
            return 1
        if n % m:
            logger.warning(
                f"micro_batch={m} does not divide the batch ({n}); "
                "running monolithic")
            return 1
        return n // m

    def _scan(self, potential, dt, nt, with_m2=False):
        integ = self._integ(potential, dt)
        harmonic = integ is not None and isinstance(integ[0], HarmonicMap)
        bc = self._bc if (integ is None or harmonic) else self._integ_bc_scan
        k = self._micro_k()
        if k > 1 and integ is None:
            return _hk_scan_micro_jit(
                self.params, bc, potential, self.state,
                self.trackers["prefactorC"],
                jnp.asarray(self.t, dtype=self._scalar_dtype),
                jnp.asarray(dt, dtype=self._scalar_dtype), nt, k, with_m2)
        return _hk_scan_jit(
            self.params, bc, potential, self.state,
            self.trackers["prefactorC"],
            jnp.asarray(self.t, dtype=self._scalar_dtype),
            jnp.asarray(dt, dtype=self._scalar_dtype), nt,
            integ, with_m2,
        )

    def _store_scan_carry(self, carry):
        state, tracker, t, mcarry = carry
        self.state = state
        self.trackers["prefactorC"] = tracker
        self.t = float(t)
        if mcarry is not None:
            self._integ_carry = mcarry
            self._integ_state_ref = state  # carry and state advanced together

    # -- setup ---------------------------------------------------------------

    def initial_conditions(self, q0, p0, Gamma_0, ntraj=5000, key=None,
                           potential=None, mesh=None,
                           sampling_method="pseudo"):
        """Sample initial phase-space points and initialise the state.

        Parameters
        ----------
        q0, p0 : (d,) center and momentum of the initial wavepacket
        Gamma_0 : (d, d) width matrix of the initial wavepacket
        ntraj : number of trajectories (rounded up to a multiple of the mesh
            size when a mesh is given)
        key : jax PRNG key (or int seed); fresh entropy each call if omitted
        potential : optional; if given, the k~ic batch constants are built now
        mesh : optional jax.sharding.Mesh with a `traj` axis; the ensemble is
            sharded over it and the parameter packs replicated, making the
            scan SPMD across chips with psum'd observable reductions
        sampling_method : "pseudo" | "antithetic" | "sobol"
            variance-reduction mode of the initial-condition draw (see
            sampling._standard_normals). "antithetic" interleaves +-pairs
            in adjacent rows; the `error_bars` stderr machinery then
            treats each pair as ONE statistical sample (the members are
            anticorrelated by construction).
        """
        if key is None:
            key = int(np.random.SeedSequence().entropy % (2**63))
        if isinstance(key, int):
            key = jax.random.key(key)

        q0 = np.asarray(q0, dtype=np.float64)
        p0 = np.asarray(p0, dtype=np.float64)
        Gamma_0 = np.asarray(Gamma_0, dtype=np.float64)

        sampling = SamplingParams.create(q0, p0, Gamma_0, self.Gamma_i,
                                         dtype=self._sample_dtype)
        self.sampling = sampling
        self.params = self._make_params(
            Gamma_0, q0, p0, np.asarray(sampling.U), np.asarray(sampling.iGi0)
        )
        self.mesh = mesh
        if mesh is not None:
            from semiclassical_jax.parallel import replicate
            from semiclassical_jax.parallel.mesh import pad_to_multiple
            ntraj = pad_to_multiple(ntraj, mesh.devices.size)
            if sampling_method == "antithetic":
                # interleaved +-pairs must not straddle shard boundaries
                ntraj = pad_to_multiple(ntraj, 2 * mesh.devices.size)
            self.params = replicate(self.params, mesh)

        self.sampling_method = sampling_method
        logger.info("== Initial Conditions ==")
        logger.info(f"number of dimensions   :  {self.params.dim}")
        logger.info(f"zero dimensions        :  "
                    f"{self.params.dim - self.params.rank}")
        logger.info(f"number of trajectories :  {ntraj}")

        # Separable potential (diagonal Hessians at every geometry) =>
        # the monodromy stays exactly diagonal from the identity initial
        # condition — store only the (n, d) diagonals (see TrajState).
        # Detected abstractly: the Hessian CONTAINER type is trace-level
        # information, no device work.
        diag_mono = False
        if potential is not None:
            from semiclassical_jax.potentials.base import DiagHessian
            hess_t = jax.eval_shape(
                lambda q: potential.local_expansion(q)[2],
                jax.ShapeDtypeStruct((1, self.params.dim), jnp.float64))
            diag_mono = isinstance(hess_t, DiagHessian)

        self.ntraj = ntraj
        if mesh is None and sampling_method in ("pseudo", "antithetic"):
            # THREE fused programs for the whole setup (see _ic_draw /
            # _ic_state / _ic_constants) — sobol generates its points
            # host-side and keeps the eager path, as does the sharded
            # multi-chip setup
            qi, pi, prob = _ic_draw_jit(sampling, key, ntraj,
                                        sampling_method)
            self.state = _ic_state_jit(
                qi, pi, None if self.compensated else self.traj_dtype,
                self.dtype, diag_mono, self.compensated)
            self._bc, stats = _ic_constants_jit(
                type(self)._bc_tag, sampling, self.params, potential,
                qi, pi, prob)
            del qi, pi, prob
            both = np.asarray(stats)
            logger.info(f"max |<z> - z0| / sigma           :  "
                        f"{float(both[0]):.6f}")
            logger.info(f"max |cov(z) - analytic| / sigma2 :  "
                        f"{float(both[1]):.6f}")
        else:
            qi, pi, prob = sample_initial_conditions(
                sampling, key, ntraj, method=sampling_method)
            if mesh is not None:
                from semiclassical_jax.parallel import shard_ensemble
                qi, pi, prob = shard_ensemble((qi, pi, prob), mesh)
            from semiclassical_jax.sampling import log_sampling_statistics
            log_sampling_statistics(sampling, qi, pi)
            self.state = TrajState.initial(
                qi, pi,
                dtype=None if self.compensated else self.traj_dtype,
                mono_dtype=self.dtype, diag_monodromy=diag_mono,
                compensated=self.compensated)
            # batch constants are one-time: build them from the
            # full-precision samples (identical to state.q/p except in
            # comp32, where the state carries them as f32 + residual)
            self._bc = self._make_batch_constants(
                (qi if self.compensated else self.state.q),
                (pi if self.compensated else self.state.p),
                prob, potential)
        self._bc_has_nacq = potential is not None
        self.trackers = self._make_trackers(self.state)
        self.t = 0.0
        self._integ_invalidate()

    # registry tag of the module-level batch-constant builder consumed by
    # the fused initial-conditions program (_BC_BUILDERS / _ic_setup);
    # subclasses override both
    _bc_tag = "hk"

    def _make_batch_constants(self, qi, pi, prob, potential):
        return hk_batch_constants(self.params, qi, pi, prob,
                                  potential=potential)

    def _require_nacq(self, potential):
        if not self._bc_has_nacq:
            self._bc = with_nacq(self.params, self._bc, potential)
            self._bc_has_nacq = True
            self._integ_refresh_bc()

    # -- fast path ------------------------------------------------------------

    def propagate(self, potential, dt, nt, energy0_es=0.0, check_energy=True,
                  chunk=None, progress=None, error_bars=False,
                  micro_batch=None):
        """Run `nt` steps as jitted scans.

        Returns (autocorrelation (nt,), ic_correlation (nt,)) as numpy
        arrays sampled at t0, t0 + dt, ..., t0 + (nt-1) dt; the internal
        state advances by nt steps.

        `chunk` splits the time loop into scans of at most `chunk` steps
        with a host sync in between, bounding device memory for the stacked
        outputs and giving `progress` its readout points.

        `progress`, if given, is called after every chunk with
        (steps_done, nt, cauto_chunk) — the live readout of long runs
        (reference cli.py:400,432-433 shows a per-step tqdm; here one jitted
        scan covers a whole chunk, so the natural reporting unit is the
        chunk). The per-step batch-mean energies of the run are kept in
        `self.last_energies` for metrics.

        `error_bars=True` additionally accumulates the per-trajectory
        second moments in-scan (two fused reductions per step) and returns
        a 4-tuple (cauto, kic, cauto_stderr, kic_stderr): the per-step
        Monte-Carlo standard errors of the complex means,
        sigma = sqrt(sum_i |x_i|^2 - |sum_i x_i|^2 / n). They are invariant
        under the separable host phase. BEYOND-reference: the reference's
        only convergence diagnostic is the opt-in O(n^2) norm.

        `micro_batch`, if given, sets `self.micro_batch`: scans run as a
        device-side lax.map over sub-batches of that size (per-trajectory
        results identical; observable reductions re-associate — see
        _micro_scan). Ignored when an exact-integrator pack is active or
        the size does not divide the batch.
        """
        if micro_batch is not None:
            self.micro_batch = int(micro_batch)
        self._require_nacq(potential)
        t_start = self.t
        if chunk is None or chunk >= nt:
            segments = [nt]
        else:
            segments = [chunk] * (nt // chunk)
            if nt % chunk:
                segments.append(nt % chunk)
        # error-bars mode: antithetic ensembles fold each +-pair into one
        # statistical sample (see _m2_contrib). The exact-integrator
        # side-channel splits trajectories across two masked pipelines,
        # where a pair could straddle the split — fall back to the
        # (conservative) i.i.d. formula there.
        m2_mode = False
        if error_bars:
            antith = getattr(self, "sampling_method", "pseudo") == "antithetic"
            if antith and self.integrator == "exact":
                logger.warning(
                    "error_bars + antithetic sampling + integrator='exact': "
                    "per-trajectory (conservative) stderr formula used — "
                    "the side-channel split breaks pair bookkeeping")
                antith = False
            m2_mode = "pairs" if antith else True
        cauto_parts, kic_parts, energy_parts = [], [], []
        m2c_parts, m2k_parts = [], []
        done = 0
        for seg in segments:
            carry, outs = self._scan(potential, dt, seg,
                                     with_m2=m2_mode)
            if error_bars:
                cauto, kic, (mxc, ssqc), (mxk, ssqk), energies = outs
                # factored (mx, ssq) second moments: all squaring happens
                # on the host at f64 with the magnitude factored out —
                # the device values ride at 1/weight_scale and their
                # squares underflow f32 (see _m2_factored)
                m2c_parts.append((np.asarray(mxc, dtype=np.float64),
                                  np.asarray(ssqc, dtype=np.float64)))
                m2k_parts.append((np.asarray(mxk, dtype=np.float64),
                                  np.asarray(ssqk, dtype=np.float64)))
            else:
                cauto, kic, energies = outs
            self._store_scan_carry(carry)
            cauto_parts.append(from_device(cauto))
            kic_parts.append(from_device(kic))
            energy_parts.append(np.asarray(energies))
            done += seg
            if progress is not None:
                progress(done, nt, cauto_parts[-1] * self._bc.weight_scale)
        cauto = np.concatenate(cauto_parts)
        kic = np.concatenate(kic_parts)
        self.last_energies = np.concatenate(energy_parts)
        if check_energy:
            check_energy_conservation(self.last_energies)
        ts = t_start + float(dt) * np.arange(nt)
        phase = np.exp(1j / hbar * energy0_es * ts)
        scale = self._bc.weight_scale
        if error_bars:
            n = self.state.q.shape[0]
            if m2_mode == "pairs":
                n = n // 2          # one sample per antithetic pair

            def _stderr(parts, total_unscaled):
                # sigma = scale * mx * sqrt(ssq - (|sum|/mx)^2 / n): the
                # magnitude mx is factored out of every square so neither
                # the tiny device values (1/weight_scale) nor scale^2 are
                # ever squared directly
                mx = np.concatenate([p[0] for p in parts])
                ssq = np.concatenate([p[1] for p in parts])
                safe = np.where(mx > 0, mx, 1.0)
                rel = np.abs(total_unscaled) / safe
                var = np.maximum(ssq - rel**2 / n, 0.0)
                return np.where(mx > 0, scale * mx * np.sqrt(var), 0.0)

            err_c = _stderr(m2c_parts, cauto)
            err_k = _stderr(m2k_parts, kic)
            return cauto * scale * phase, kic * scale * phase, err_c, err_k
        return cauto * scale * phase, kic * scale * phase

    # -- granular (reference-shaped) API --------------------------------------

    def step(self, potential, dt):
        """Advance one time step t -> t + dt (updates all sign trackers)."""
        carry, _ = self._scan(potential, dt, 1)
        self._store_scan_carry(carry)

    def semiclassical_prefactor(self):
        """Sign-aligned HK prefactor C(t) at the *current* state, (n,) complex.

        Syncs the branch-cut tracker to the current state first (a no-op if
        already synced: the crossing condition is false for identical values).
        """
        c2 = hk_prefactor_det(self.params, self.state)
        tracker = self.trackers["prefactorC"].update(c2)
        self.trackers["prefactorC"] = tracker
        return jnp.sqrt(tracker.previous) * tracker.signs

    def autocorrelation(self, energy0_es=0.0):
        c = self.semiclassical_prefactor()
        cauto_qp = hk_autocorr_qp(self.params, self._bc, self.state, c)
        cauto = jnp.sum(cauto_qp)
        return (complex(from_device(cauto)) * self._bc.weight_scale
                * np.exp(1j / hbar * self.t * energy0_es))

    def ic_correlation(self, potential, energy0_es=0.0):
        self._require_nacq(potential)
        c = self.semiclassical_prefactor()
        _, kic = hk_observables(self.params, self._bc, self.state, c,
                                potential)
        return (complex(from_device(kic)) * self._bc.weight_scale
                * np.exp(1j / hbar * self.t * energy0_es))

    def coefficients(self):
        v = hk_coefficients(self.params, self._bc, self.state,
                            self.semiclassical_prefactor())
        return v * jnp.asarray(self._bc.weight_scale, dtype=real_dtype(v.dtype))

    def norm(self, sample_pairs=None, key=0):
        """|psi| of the frozen-Gaussian wavefunction (O(n^2), diagnostic).
        Single device: one jitted block-pair program; under a mesh: a
        shard_map systolic ring (SURVEY P4). Runs in log space
        (hk_log_coefficients) so the diagnostic stays finite at high mode
        counts, where the linear coefficients over/underflow the complex
        dtype (r4; same treatment as wm_norm).

        `sample_pairs` (opt-in, single-device): subsampled unbiased
        estimate over that many random off-diagonal block pairs — returns
        (norm, stderr) in O(n) block pairs instead of O(n^2/block^2); at
        high mode counts the exact diagnostic is variance-limited anyway
        (PARITY.md), so the error bar is the honest readout."""
        c = self.semiclassical_prefactor()
        log_v = hk_log_coefficients(self.params, self._bc, self.state, c)
        return pairwise_norm_log(self.params.csott, self.state.q,
                                 self.state.p, log_v, mesh=self.mesh,
                                 sample_pairs=sample_pairs, key=key)

    def log_coefficients(self):
        """(log |v|, arg v) as f64 numpy arrays — exact at any mode count
        (the linear coefficients() keeps the reference API and
        over/underflows the complex dtype exactly where the true
        magnitude does; cf. WaltonManolopoulosPropagator)."""
        c = self.semiclassical_prefactor()
        lr, li = hk_log_coefficients(self.params, self._bc, self.state, c)
        return np.asarray(lr), np.asarray(li)

    def wavefunction(self, x):
        """psi(x, t) on a spatial grid x of shape (nx, d). Runs in log
        space (r4): each trajectory's log |v| joins its Gaussian exponent
        and the trajectory sum is exponent-shifted, with the shift
        recombined at f64 on the host — valid at any mode count."""
        from semiclassical_jax.coherent import wavefunction_log

        c = self.semiclassical_prefactor()
        log_v = hk_log_coefficients(self.params, self._bc, self.state, c)
        psi, zmax = wavefunction_log(self.params.wf, self.state.q,
                                     self.state.p, log_v, jnp.asarray(x))
        return (from_device(psi).astype(np.complex128)
                * np.exp(np.asarray(zmax, dtype=np.float64)))

    def initial_positions_and_momenta(self):
        return self._bc.qi, self._bc.pi

    def current_positions_and_momenta(self):
        return self.state.q, self.state.p

    def classical_action(self):
        return self.state.S

    def monodromy_matrices(self):
        """Current monodromy blocks (Mqq, Mqp, Mpq, Mpp), each (n, d, d)
        with the trajectory axis leading (reference propagators.py:927-935
        returns (d, d, n) — the reference's trailing trajectory axis is this
        framework's leading one everywhere). The diagonal representation
        is expanded to dense blocks here — this accessor is API surface,
        not a hot path."""
        return self.state.dense_monodromy()
