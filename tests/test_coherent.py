# coding: utf-8
"""Coherent-state overlap tests (reference tests/test_propagators.py:69-113)."""

import numpy as np
import jax.numpy as jnp

from semiclassical_jax.coherent import (
    OverlapParams,
    overlap_matrix,
    overlap_vector,
)


def _random_spd(rng, n):
    V, _ = np.linalg.qr(rng.random((n, n)))
    e = rng.random(n) + 0.5
    return V @ np.diag(e) @ V.T


def test_normalization():
    """<q,p,G|q,p,G> = 1 for any positive-definite G."""
    rng = np.random.default_rng(0)
    n = 5
    G = _random_spd(rng, n)
    q = rng.random((1, n))
    p = rng.random((1, n))
    ov = OverlapParams.create(G, G)
    olap = overlap_matrix(ov, jnp.asarray(q), jnp.asarray(p),
                          jnp.asarray(q), jnp.asarray(p))
    assert abs(complex(olap[0, 0]) - 1.0) < 1e-10


def test_zero_modes_invariance():
    """Embedding G into a larger singular space must not change overlaps."""
    rng = np.random.default_rng(1)
    n = 5
    G = _random_spd(rng, n)
    qi = rng.random((1, n))
    pi = rng.random((1, n))
    qj = rng.random((1, n))
    pj = rng.random((1, n))
    ov = OverlapParams.create(G, G)
    olap = complex(overlap_matrix(ov, jnp.asarray(qi), jnp.asarray(pi),
                                  jnp.asarray(qj), jnp.asarray(pj))[0, 0])

    G_ = np.zeros((n + 1, n + 1))
    G_[:n, :n] = G
    pad = lambda v: np.concatenate([v, np.zeros((1, 1))], axis=1)
    ov_ = OverlapParams.create(G_, G_)
    olap_ = complex(overlap_matrix(ov_, jnp.asarray(pad(qi)),
                                   jnp.asarray(pad(pi)),
                                   jnp.asarray(pad(qj)),
                                   jnp.asarray(pad(pj)))[0, 0])
    assert abs(olap - olap_) < 1e-12


def test_overlap_vector_matches_matrix():
    rng = np.random.default_rng(2)
    n, d = 7, 3
    Gi = _random_spd(rng, d)
    Gj = _random_spd(rng, d)
    qi = jnp.asarray(rng.random((n, d)))
    pi = jnp.asarray(rng.random((n, d)))
    q0 = jnp.asarray(rng.random(d))
    p0 = jnp.asarray(rng.random(d))
    ov = OverlapParams.create(Gi, Gj)
    vec = overlap_vector(ov, qi, pi, q0, p0)
    mat = overlap_matrix(ov, qi, pi, q0[None, :], p0[None, :])
    assert np.allclose(np.asarray(vec), np.asarray(mat[:, 0]))


def test_hermiticity():
    """<i|j> = <j|i>^* for identical width matrices."""
    rng = np.random.default_rng(3)
    n, d = 4, 3
    G = _random_spd(rng, d)
    q = jnp.asarray(rng.random((n, d)))
    p = jnp.asarray(rng.random((n, d)))
    ov = OverlapParams.create(G, G)
    O = np.asarray(overlap_matrix(ov, q, p, q, p))
    assert np.allclose(O, O.conj().T)
