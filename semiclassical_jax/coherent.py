# coding: utf-8
"""Coherent-state algebra.

Overlaps and wavefunctions of multidimensional frozen Gaussians

    <x|q,p,G> = (det(G)/pi^N)^{1/4}
                exp(-1/2 (x-q)^T G (x-q) + i/hbar p^T (x-q))

Capability parity with reference propagators.py:124-292
(CoherentStatesOverlap, CoherentStatesWavefunction). Design differences:

* all spectral work on the constant width matrices (pseudo-determinants,
  pseudo-inverses, ranks) happens once on the host at parameter-pack
  construction (`OverlapParams.create`); the rank is a static int;
* the device functions are pure and batched with the trajectory axis leading;
  `overlap_vector` covers the common <traj | phi(0)> case with O(n) work, the
  full O(ni nj) `overlap_matrix` is only used by the opt-in norm monitor.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from semiclassical_jax import linalg
# complex_exp is re-exported here (its historical home) for the
# propagators and tests; the implementation lives with the complex-safe
# helpers in linalg.
from semiclassical_jax.linalg import (complex_exp,  # noqa: F401
                                      real_dtype, times_i, to_device)
from semiclassical_jax.pytree import pytree_dataclass
from semiclassical_jax.units import hbar

__all__ = [
    "OverlapParams",
    "overlap_exponent_vector",
    "overlap_vector",
    "overlap_matrix",
    "complex_exp",
    "WavefunctionParams",
    "wavefunction",
]


@pytree_dataclass(meta=("rank",))
class OverlapParams:
    """Constants for evaluating <qi,pi,Gi|qj,pj,Gj> overlaps.

    All entries are derived from the two width matrices on the host
    (reference propagators.py:145-179).
    """

    Gi_iGij_Gj: jnp.ndarray  # (d, d)   Gi [Gi+Gj]^{-1} Gj
    iGij: jnp.ndarray        # (d, d)   pseudo-inverse of Gi+Gj
    Gj_iGij: jnp.ndarray     # (d, d)   Gj [Gi+Gj]^{-1}
    fac: jnp.ndarray         # ()       normalisation prefactor (complex)
    # (3, d) stack of the three matrices' diagonals when ALL of them are
    # exactly diagonal (diagonal widths): the exponent quadratic forms
    # then collapse to elementwise products + a mode sum, removing three
    # thin (n, d) @ (d, d) matmuls from the per-step observable path
    # (the same idea as the prefactor's permutation collapse, hk.py
    # HKParams.diag_ka). None otherwise.
    diag_w: jnp.ndarray | None = None
    rank: int = 0

    @staticmethod
    def create(Gi: np.ndarray, Gj: np.ndarray, dtype=jnp.float64,
               out_dtype=None):
        """`dtype` sets the precision of the exponent computation (use the
        trajectory precision — the quadratic forms reach ~1e2 and decide the
        overlap's accuracy), `out_dtype` the complex dtype of the returned
        overlaps (defaults to the complex dtype matching `dtype`)."""
        Gi = np.asarray(Gi, dtype=np.float64)
        Gj = np.asarray(Gj, dtype=np.float64)
        assert Gi.shape == Gj.shape, (
            "width matrices Gi and Gj have to have the same shape"
        )
        ei, _ = linalg.sym_eigh(Gi)
        ej, _ = linalg.sym_eigh(Gj)
        ranki = int(np.count_nonzero(np.abs(ei) > linalg.ZERO))
        rankj = int(np.count_nonzero(np.abs(ej) > linalg.ZERO))
        assert ranki == rankj, (
            "Gi and Gj have to have the same rank and null space."
        )
        detGi = np.prod(ei[np.abs(ei) > linalg.ZERO])
        detGj = np.prod(ej[np.abs(ej) > linalg.ZERO])

        Gij = Gi + Gj
        eij, Vij = linalg.sym_eigh(Gij)
        nz = np.abs(eij) > linalg.ZERO
        iGij = np.einsum("ij,j,kj->ik", Vij[:, nz], 1.0 / eij[nz], Vij[:, nz])
        detGij = np.prod(eij[nz])

        fac = np.sqrt(
            2.0**ranki * np.sqrt(detGi + 0j) * np.sqrt(detGj + 0j) / detGij
        )
        if out_dtype is None:
            out_dtype = (jnp.complex128 if dtype == jnp.float64
                         else jnp.complex64)
        cdtype = out_dtype
        m1, m2, m3 = Gi @ iGij @ Gj, iGij, Gj @ iGij
        offdiag = max(float(np.abs(m - np.diag(np.diag(m))).max())
                      for m in (m1, m2, m3))
        diag_w = (jnp.asarray(np.stack([np.diag(m) for m in (m1, m2, m3)]),
                              dtype=dtype) if offdiag == 0.0 else None)
        return OverlapParams(
            Gi_iGij_Gj=jnp.asarray(m1, dtype=dtype),
            iGij=jnp.asarray(m2, dtype=dtype),
            Gj_iGij=jnp.asarray(m3, dtype=dtype),
            fac=to_device(fac, cdtype),
            diag_w=diag_w,
            rank=ranki,
        )




def _overlap_exponent(ov: OverlapParams, dq, dp, pj):
    """(re, im) exponent parts for displacement arrays of shape (..., d).

    dq = qj - qi, dp = pj - pi, pj = ket momenta.
    (reference propagators.py:232-237)
    """
    t = ov.Gi_iGij_Gj.dtype
    dq, dp, pj = dq.astype(t), dp.astype(t), pj.astype(t)
    if ov.diag_w is not None:
        # diagonal widths: the three quadratic forms are elementwise
        # products + a mode sum (see OverlapParams.diag_w)
        w1, w2, w3 = ov.diag_w[0], ov.diag_w[1], ov.diag_w[2]
        re_part = (-0.5 * jnp.sum(dq * w1 * dq, axis=-1)
                   - (0.5 / hbar**2) * jnp.sum(dp * w2 * dp, axis=-1))
        im_part = (jnp.sum(dq * w3 * dp, axis=-1)
                   - jnp.sum(pj * dq, axis=-1)) / hbar
        return re_part, im_part
    re_part = (-0.5 * jnp.einsum("...a,ab,...b->...", dq, ov.Gi_iGij_Gj, dq)
               - (0.5 / hbar**2) * jnp.einsum("...a,ab,...b->...", dp,
                                              ov.iGij, dp))
    im_part = (jnp.einsum("...a,ab,...b->...", dq, ov.Gj_iGij, dp)
               - jnp.einsum("...a,...a->...", pj, dq)) / hbar
    return re_part, im_part


def overlap_exponent_vector(ov: OverlapParams, qi, pi, qj, pj):
    """(re, im) exponent parts of <qi(n),pi(n),Gi|qj,pj,Gj> at the pack's
    exponent precision — for callers that fold additional log-scale factors
    (Monte-Carlo weights) into the exponent before exponentiating."""
    dq = qj[None, :] - qi
    dp = pj[None, :] - pi
    pj_b = jnp.broadcast_to(pj[None, :], qi.shape)
    return _overlap_exponent(ov, dq, dp, pj_b)


def overlap_exponent_displaced(ov: OverlapParams, dq, dp, pj):
    """(re, im) exponent parts from precomputed displacements
    dq = qj - qi, dp = pj - pi (shape (n, d)) and ket momenta pj — for
    callers that form the displacements themselves (e.g. the comp32 mode,
    which folds compensation residuals into them)."""
    return _overlap_exponent(ov, dq, dp, pj)


def overlap_vector(ov: OverlapParams, qi, pi, qj, pj):
    """<qi(n),pi(n),Gi|qj,pj,Gj> for a batch of bra states and one ket.

    qi, pi : (n, d); qj, pj : (d,). Returns complex (n,) in the pack's
    output dtype.
    """
    re, im = overlap_exponent_vector(ov, qi, pi, qj, pj)
    return ov.fac * complex_exp(re, im, ov.fac.dtype)


def overlap_matrix(ov: OverlapParams, qi, pi, qj, pj):
    """Full overlap matrix <qi(i)|qj(j)> of shape (ni, nj).

    See overlap_exponent_matrix for the expansion strategy."""
    re, im = overlap_exponent_matrix(ov, qi, pi, qj, pj)
    return ov.fac * complex_exp(re, im, ov.fac.dtype)


def overlap_exponent_matrix(ov: OverlapParams, qi, pi, qj, pj):
    """(re, im) exponent parts of the full pair-overlap matrix (ni, nj) —
    for callers that fold additional log-scale factors (log-coefficients)
    into the exponent before exponentiating (the range-safe norm).

    The quadratic forms are *expanded* so the pairwise structure reduces to
    per-vector diagonals plus (ni, d) @ (d, nj) matmuls — O(ni nj d) matmul
    flops with O(ni nj) memory, instead of materialising the
    (ni, nj, d) displacement tensors of the naive formulation (which is what
    the reference's einsums do, propagators.py:232-237).
    """
    t = ov.Gi_iGij_Gj.dtype
    qi, pi = qi.astype(t), pi.astype(t)
    qj, pj = qj.astype(t), pj.astype(t)
    A = ov.Gi_iGij_Gj
    B = ov.iGij / hbar**2
    C = ov.Gj_iGij

    Aqj, Bpj, Cpj = qj @ A.T, pj @ B.T, pj @ C.T      # (nj, d)
    Cpi = pi @ C.T                                    # (ni, d)

    # -1/2 (qj-qi)^T A (qj-qi) - 1/(2 hbar^2) (pj-pi)^T B (pj-pi)
    aq_ii = jnp.einsum("nd,nd->n", qi, qi @ A.T)
    aq_jj = jnp.einsum("nd,nd->n", qj, Aqj)
    bp_ii = jnp.einsum("nd,nd->n", pi, pi @ B.T)
    bp_jj = jnp.einsum("nd,nd->n", pj, Bpj)
    re = (-0.5 * (aq_ii[:, None] + aq_jj[None, :] - 2.0 * qi @ Aqj.T)
          - 0.5 * (bp_ii[:, None] + bp_jj[None, :] - 2.0 * pi @ Bpj.T))

    # [-pj.(qj-qi) + (qj-qi)^T C (pj-pi)] / hbar, fully expanded:
    #   (qj C pj - qj pj)[j] + qi.pj[i,j] - (qj C pi)[j,i] - (qi C pj)[i,j]
    #   + (qi C pi)[i]
    qcp_jj = jnp.einsum("nd,nd->n", qj, Cpj)
    qcp_ii = jnp.einsum("nd,nd->n", qi, Cpi)
    qp_jj = jnp.einsum("nd,nd->n", qj, pj)
    im = ((qcp_jj - qp_jj)[None, :]
          + qi @ pj.T
          - (qj @ Cpi.T).T
          - qi @ Cpj.T
          + qcp_ii[:, None]) / hbar

    return re, im


@pytree_dataclass(meta=("rank",))
class WavefunctionParams:
    """Constants for evaluating superpositions of frozen Gaussians on grids
    (reference propagators.py:243-292)."""

    G: jnp.ndarray    # (d, d)
    fac: jnp.ndarray  # ()  (det G / pi^rank)^{1/4}
    rank: int

    @staticmethod
    def create(G: np.ndarray, dtype=jnp.float64):
        G = np.asarray(G, dtype=np.float64)
        e, _ = linalg.sym_eigh(G)
        nz = np.abs(e) > linalg.ZERO
        detG = np.prod(e[nz])
        rank = int(np.count_nonzero(nz))
        fac = (detG / np.pi**rank) ** 0.25
        return WavefunctionParams(
            G=jnp.asarray(G, dtype=dtype),
            fac=jnp.asarray(fac, dtype=dtype),
            rank=rank,
        )


def wavefunction(wf: WavefunctionParams, q, p, v, x):
    """phi(x) = sum_i v_i <x|q_i,p_i> on a spatial grid.

    q, p : (n, d); v : complex (n,); x : (nx, d). Returns complex (nx,).
    """
    dx = x[None, :, :] - q[:, None, :]                       # (n, nx, d)
    expo = (-0.5 * jnp.einsum("nxa,ab,nxb->nx", dx, wf.G, dx)
            + times_i(jnp.einsum("na,nxa->nx", p, dx) / hbar))
    gaussians = wf.fac * jnp.exp(expo)                       # (n, nx)
    return jnp.einsum("n,nx->x", v, gaussians)


def wavefunction_log(wf: WavefunctionParams, q, p, log_v, x):
    """phi(x) from log-coefficients — the range-safe grid evaluation:
    each trajectory's log |v| joins its Gaussian exponent, and the sum
    over trajectories is exponent-shifted, so the evaluation works at
    mode counts where the linear coefficients over/underflow (cf.
    wm_wavefunction). Returns (psi_shifted (nx,) complex, zmax (nx,)
    real): true phi = psi_shifted * exp(zmax), recombined on the HOST at
    f64 (the magnitude may sit below the device dtype's range)."""
    log_re, log_im = log_v
    rd = wf.G.dtype
    cdtype = jnp.complex128 if rd == jnp.float64 else jnp.complex64
    dx = x[None, :, :] - q[:, None, :]                       # (n, nx, d)
    re = -0.5 * jnp.einsum("nxa,ab,nxb->nx", dx, wf.G, dx)
    im = jnp.einsum("na,nxa->nx", p, dx) / hbar
    Zre = (log_re.astype(rd)[:, None] + re
           + jnp.log(jnp.abs(wf.fac)).astype(rd))
    Zim = log_im.astype(rd)[:, None] + im
    zmax = jnp.max(Zre, axis=0)                              # (nx,)
    psi = jnp.sum(complex_exp(Zre - zmax[None, :], Zim, cdtype), axis=0)
    return psi, zmax
