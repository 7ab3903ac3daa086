# coding: utf-8
"""Monte-Carlo sampling of initial phase-space conditions.

The probability for sampling the phase-space point (qi, pi) is proportional
to |<qi,pi,Gamma_i|q0,p0,Gamma_0>|^2. The singular covariance is factorised
through eigendecompositions of Gamma_i + Gamma_0 (momentum block) and
Gamma_i [Gamma_i+Gamma_0]^{-1} Gamma_0 (position block); zero-frequency modes
are excluded from sampling and all determinants are pseudo-determinants over
the non-zero subspace. Capability parity with reference
propagators.py:445-578, with two changes:

* the factorisation runs once on the host (ranks are static);
* randomness uses explicit `jax.random` keys threaded per batch instead of a
  global torch seed, so independent ensemble shards draw independent streams
  by construction.
"""

from __future__ import annotations

import logging

import numpy as np
import jax
import jax.numpy as jnp

from semiclassical_jax import linalg
from semiclassical_jax.pytree import pytree_dataclass

logger = logging.getLogger(__name__)

__all__ = ["SamplingParams", "sample_initial_conditions",
           "sampling_statistics", "log_sampling_statistics"]


@pytree_dataclass(meta=("dim", "rank"))
class SamplingParams:
    """Host-precomputed factorisation of the sampling distribution.

    The inverse of the (possibly singular) covariance matrix is
    cov^{-1} = Lz Lz^T with Lz = blockdiag(Lq, Lp); sampling transforms
    standard normals x via z = z0 + (Lz^{-1})^T x
    (reference propagators.py:493-555).
    """

    z0: jnp.ndarray       # (2 d,)   phase-space center (q0, p0)
    iLz: jnp.ndarray      # (2 rank, 2 d)  pseudo-inverse Lz^{-1}
    log_detLz: jnp.ndarray  # () f64  log pseudo-determinant of Lz
    U: jnp.ndarray        # (d, rank) non-zero subspace of Gamma_i + Gamma_0
    iGi0: jnp.ndarray     # (d, d)   pseudo-inverse of Gamma_i + Gamma_0
    dim: int
    rank: int

    @staticmethod
    def create(q0, p0, Gamma_0, Gamma_i, dtype=jnp.float64):
        q0 = np.asarray(q0, dtype=np.float64)
        p0 = np.asarray(p0, dtype=np.float64)
        G0 = np.asarray(Gamma_0, dtype=np.float64)
        Gi = np.asarray(Gamma_i, dtype=np.float64)
        assert G0.shape == Gi.shape, (
            "width parameter matrix Gamma_0 has wrong dimensions"
        )
        assert linalg.is_symmetric_non_negative(G0), (
            "Gamma_0 has to be symmetric and positive semi-definite."
        )
        d = q0.shape[0]

        Gi0 = G0 + Gi
        wp, Vp = linalg.sym_eigh(Gi0)
        nzp = wp > linalg.ZERO
        U = Vp[:, nzp]
        iGi0 = np.einsum("ij,j,kj->ik", Vp[:, nzp], 1.0 / wp[nzp], Vp[:, nzp])
        # 2 [Gi+G0]^{-1} = Lp Lp^T; pseudo-inverse Lp^{-1}
        iLp = np.einsum("i,ji->ij", np.sqrt(wp[nzp] / 2.0), Vp[:, nzp])

        # 2 Gi [Gi+G0]^{-1} G0 = Lq Lq^T; pseudo-inverse Lq^{-1}
        wq, Vq = linalg.sym_eigh(Gi @ iGi0 @ G0)
        nzq = wq > linalg.ZERO
        iLq = np.einsum("i,ji->ij", 1.0 / np.sqrt(2.0 * wq[nzq]), Vq[:, nzq])

        assert np.count_nonzero(nzp) == np.count_nonzero(nzq), (
            "number of non-zero modes for sampling of positions and momenta "
            "have to be the same"
        )
        rank = int(np.count_nonzero(nzp))

        # blockdiag pseudo-inverse and log pseudo-determinant of Lz — kept
        # in log space: the product of per-mode ratios under/overflows the
        # trajectory dtype for Gamma_i != Gamma_0 in many dimensions
        iLz = np.zeros((2 * rank, 2 * d))
        iLz[:rank, :d] = iLq
        iLz[rank:, d:] = iLp
        log_detLz = float(np.sum(
            np.log(2.0) + 0.5 * (np.log(wq[nzq]) - np.log(wp[nzp]))))

        return SamplingParams(
            z0=jnp.asarray(np.concatenate([q0, p0]), dtype=dtype),
            iLz=jnp.asarray(iLz, dtype=dtype),
            log_detLz=jnp.asarray(log_detLz, dtype=jnp.float64),
            U=jnp.asarray(U, dtype=dtype),
            iGi0=jnp.asarray(iGi0, dtype=dtype),
            dim=d,
            rank=rank,
        )


def _standard_normals(params: SamplingParams, key, ntraj: int, method: str):
    """(ntraj, 2 rank) standard-normal draws for the sampling transform.

    method:
    * "pseudo"     — i.i.d. jax.random stream (the reference's scheme,
                     propagators.py:537-555, torch.randn there).
    * "antithetic" — ntraj/2 i.i.d. draws plus their negations,
                     INTERLEAVED so each +-pair occupies adjacent rows
                     (pairs then stay together under any even-sized
                     contiguous split: ensemble sharding, micro-batching,
                     scan sub-batches). The Gaussian density is even, so
                     the estimator stays unbiased while every odd-in-x
                     error component cancels exactly within each pair.
    * "sobol"      — scrambled Sobol' quasi-Monte-Carlo points through the
                     inverse normal CDF (host-side scipy.stats.qmc; the
                     scramble seed derives from `key`, so independent keys
                     give independent randomisations and the estimator is
                     unbiased). Best-balanced at power-of-two ntraj.
    """
    shape = (ntraj, 2 * params.rank)
    dtype = params.iLz.dtype
    if method == "pseudo":
        return jax.random.normal(key, shape, dtype=dtype)
    if method == "antithetic":
        if ntraj % 2:
            raise ValueError(f"antithetic sampling needs an even number of "
                             f"trajectories, got {ntraj}")
        half = jax.random.normal(key, (ntraj // 2, 2 * params.rank),
                                 dtype=dtype)
        return jnp.stack([half, -half], axis=1).reshape(shape)
    if method == "sobol":
        from scipy.special import ndtri
        from scipy.stats import qmc
        seed = int(jax.random.randint(key, (), 0, np.int32(2**31 - 1)))
        sampler = qmc.Sobol(d=2 * params.rank, scramble=True, seed=seed)
        m = ntraj.bit_length() - 1
        if ntraj == 1 << m:
            u = sampler.random_base2(m)
        else:
            logger.warning(f"sobol sampling with non-power-of-two "
                           f"ntraj={ntraj}: balance properties degrade")
            u = sampler.random(ntraj)
        # the scrambled points are in [0, 1); clip away an exact 0 before
        # the inverse CDF (ndtri(0) = -inf)
        u = np.clip(u, 1e-16, 1.0 - 1e-16)
        return jnp.asarray(ndtri(u), dtype=dtype)
    raise ValueError(f"unknown sampling method {method!r} "
                     "(expected 'pseudo', 'antithetic' or 'sobol')")


def sample_initial_conditions(params: SamplingParams, key, ntraj: int,
                              method: str = "pseudo"):
    """Draw `ntraj` initial phase-space points and their sampling densities.

    Returns
    -------
    q : (ntraj, d) initial positions
    p : (ntraj, d) initial momenta
    log_prob : (ntraj,) f64  log of the sampling density log P(qi, pi)

    `method` selects the underlying standard-normal stream (see
    `_standard_normals`): plain pseudo-random, antithetic +-pairs, or
    scrambled-Sobol QMC — the two variance-reduction modes attack the
    Monte-Carlo error of the observable estimators directly at unchanged
    cost per trajectory; the density formula below is identical for all
    three (the antithetic/QMC points are valid draws of the same Gaussian).

    The density keeps the reference's 1/(2 pi)^dim convention (full dim, not
    rank) because the same factor appears in the phase-space volume element
    of every observable and cancels (reference propagators.py:552-566).

    The density is returned in *log* space: in many dimensions P spans
    hundreds of orders of magnitude (the reference's linear-scale P,
    propagators.py:555, silently under/overflows beyond ~150 dimensions),
    while log P stays
    O(100) in every precision.
    """
    d = params.dim
    x = _standard_normals(params, key, ntraj, method)
    z = params.z0[None, :] + x @ params.iLz                 # (n, 2 d)
    q, p = z[:, :d], z[:, d:]
    x64 = x.astype(jnp.float64)
    log_prob = (params.log_detLz
                - d * np.log(2.0 * np.pi)
                - 0.5 * jnp.sum(x64 * x64, axis=1))
    return q, p, log_prob


def _sampling_stats_core(params: SamplingParams, q, p):
    """Device part of sampling_statistics: (mean_dev, cov_dev) as jnp
    scalars — traceable, so the fused initial-conditions program
    (hk._ic_setup) can fold the diagnostic into its single dispatch."""
    z = jnp.concatenate([jnp.asarray(q, dtype=jnp.float64),
                         jnp.asarray(p, dtype=jnp.float64)], axis=1)
    n = z.shape[0]
    mean = jnp.mean(z, axis=0)
    # the covariance matmul runs f32: the diagnostic's own statistical
    # floor is sqrt(2/n) (~5e-3 at 98k trajectories) while the centered
    # f32 product adds ~1e-6
    dz = (z - mean[None, :]).astype(jnp.float32)
    cov = (dz.T @ dz).astype(jnp.float64) / max(n - 1, 1)
    iLz = jnp.asarray(params.iLz, dtype=jnp.float64)
    ana_cov = iLz.T @ iLz
    sigma = jnp.sqrt(jnp.diagonal(ana_cov))
    live = sigma > 0.0                      # zero modes are never sampled
    scale = jnp.where(live, sigma, 1.0)
    mean_dev = jnp.max(
        jnp.where(live, jnp.abs(mean - params.z0.astype(jnp.float64)), 0.0)
        / scale)
    pair_live = live[:, None] & live[None, :]
    cov_dev = jnp.max(
        jnp.where(pair_live, jnp.abs(cov - ana_cov), 0.0)
        / (scale[:, None] * scale[None, :]))
    return mean_dev, cov_dev


def sampling_statistics(params: SamplingParams, q, p):
    """Deviation of the sample moments from the analytic distribution.

    The sampled phase-space points are z = z0 + x iLz with x ~ N(0, 1), so
    the exact moments are E[z] = z0 and cov(z) = iLz^T iLz (singular on the
    zero modes, which are never sampled). Returns the maximum deviations in
    *standard-deviation units* — mean deviation over sigma_i, covariance
    deviation over sigma_i sigma_j, skipping zero modes — as floats, one
    device fetch. In these units a healthy sampler sits at ~sqrt(2/ntraj)
    regardless of how wildly the mode widths differ.

    This is the live Monte-Carlo sanity check the reference prints at every
    `initial_conditions` (reference propagators.py:570-578); a blown-up
    deviation at large ntraj flags a broken sampler or RNG stream long
    before the correlation functions look wrong.
    """
    mean_dev, cov_dev = _sampling_stats_core(params, q, p)
    # one host fetch for both scalars (each float() is a separate blocking
    # round-trip)
    both = np.asarray(jnp.stack([mean_dev, cov_dev]))
    return float(both[0]), float(both[1])


def log_sampling_statistics(params: SamplingParams, q, p):
    mean_dev, cov_dev = sampling_statistics(params, q, p)
    logger.info(f"max |<z> - z0| / sigma           :  {mean_dev:.6f}")
    logger.info(f"max |cov(z) - analytic| / sigma2 :  {cov_dev:.6f}")
    return mean_dev, cov_dev
