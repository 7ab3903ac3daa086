# coding: utf-8
"""Unit tests for linear-algebra helpers (oracle: scipy, numpy)."""

import numpy as np
import pytest
import scipy.linalg as sla

import jax.numpy as jnp

from semiclassical_jax import linalg


def test_sym_sqrtm_vs_scipy():
    rng = np.random.default_rng(0)
    n = 5
    A = 5.0 * 2.0 * (rng.random((n, n)) - 0.5)
    A = A + A.T
    sqA, isqA = linalg.sym_sqrtm(A)
    sqA_scipy = sla.sqrtm(A)
    isqA_scipy = sla.inv(sla.sqrtm(A))
    assert np.allclose(sqA, sqA_scipy)
    assert np.allclose(isqA, isqA_scipy)


def test_sym_sqrtm_singular():
    """Pseudo-inverse of the root ignores the null space."""
    rng = np.random.default_rng(1)
    V, _ = np.linalg.qr(rng.random((4, 4)))
    e = np.array([2.0, 1.0, 0.5, 0.0])
    A = V @ np.diag(e) @ V.T
    sqA, isqA = linalg.sym_sqrtm(A)
    # sqA isqA should be the projector on the non-zero subspace
    proj = V[:, :3] @ V[:, :3].T
    assert np.allclose(sqA @ isqA, proj, atol=1e-10)


def test_is_symmetric_non_negative():
    rng = np.random.default_rng(2)
    n = 5
    e = rng.random(n) + 0.1
    V = 5.0 * 2.0 * (rng.random((n, n)) - 0.5)
    A = V @ np.diag(e) @ V.T
    assert linalg.is_symmetric_non_negative(A)
    A[0, 1] += 0.5
    assert not linalg.is_symmetric_non_negative(A)


def test_pseudo_det_and_inverse():
    rng = np.random.default_rng(3)
    V, _ = np.linalg.qr(rng.random((5, 5)))
    e = np.array([3.0, 2.0, 1.0, 0.5, 0.0])
    A = V @ np.diag(e) @ V.T
    assert np.isclose(linalg.pseudo_det(A), 3.0 * 2.0 * 1.0 * 0.5)
    assert np.isclose(linalg.pseudo_det(A, scale=2.0), 3.0 * 2.0 * 1.0 * 0.5 / 16.0)
    iA = linalg.pseudo_inverse(A)
    proj = V[:, :4] @ V[:, :4].T
    assert np.allclose(A @ iA, proj, atol=1e-10)


def test_nonzero_subspace():
    rng = np.random.default_rng(4)
    V, _ = np.linalg.qr(rng.random((5, 5)))
    e = np.array([3.0, 2.0, 1.0, 0.0, 0.0])
    A = V @ np.diag(e) @ V.T
    U = linalg.nonzero_subspace(A)
    assert U.shape == (5, 3)
    # U spans the range of A
    assert np.allclose(U @ U.T @ A, A, atol=1e-10)


def test_batched_det_inv_complex():
    rng = np.random.default_rng(5)
    A = (rng.standard_normal((32, 6, 6))
         + 1j * rng.standard_normal((32, 6, 6)) + 3 * np.eye(6))
    Aj = jnp.asarray(A)
    assert np.allclose(np.asarray(linalg.batched_det(Aj)), np.linalg.det(A))
    assert np.allclose(np.asarray(linalg.batched_inv(Aj)), np.linalg.inv(A))


def test_schur_det_inv():
    """Schur-recursion det/inv (the "jax" path) vs LAPACK, incl. odd sizes."""
    rng = np.random.default_rng(7)
    for r in (1, 2, 3, 5, 12, 60):
        A = (np.eye(r) + 0.5 * (rng.standard_normal((8, r, r))
                                + 1j * rng.standard_normal((8, r, r)))
             / np.sqrt(r))
        Aj = jnp.asarray(A)
        det, inv = linalg._det_inv_schur(Aj)
        assert np.allclose(np.asarray(det), np.linalg.det(A),
                           rtol=1e-10), r
        assert np.allclose(np.asarray(inv), np.linalg.inv(A),
                           atol=1e-10), r
        det2 = linalg._det_schur(Aj)
        assert np.allclose(np.asarray(det2), np.linalg.det(A), rtol=1e-10), r


def _complex_batch(rng, shape, m):
    """Well-conditioned complex128 matrices I + 0.5 N / sqrt(m)."""
    return (np.eye(m) + 0.5 * (rng.standard_normal(shape + (m, m))
                               + 1j * rng.standard_normal(shape + (m, m)))
            / np.sqrt(m))


# (leading batch dims, matrix size): m = 1 and 2 are the closed-form bases
# of the Schur recursion, 7 and 13 odd splits, two leading batch dims, and
# the 45 / 60 production widths (coumarin rank, 60-mode AS model)
_SHAPES = [((5,), 1), ((5,), 2), ((2, 3), 7), ((4,), 13), ((3,), 45),
           ((2,), 60)]


@pytest.fixture(params=["xla", "jax"])
def impl(request):
    old = linalg._LINALG_IMPL
    linalg.set_linalg_impl(request.param)
    yield request.param
    linalg.set_linalg_impl(old)


@pytest.mark.parametrize("batch,m", _SHAPES)
def test_batched_det_inv_solve_vs_lapack(impl, batch, m):
    """batched_det / _inv / _det_inv / _det_solve / _det_solve_t of each
    implementation against numpy complex128."""
    rng = np.random.default_rng(m)
    A = _complex_batch(rng, batch, m)
    B = (rng.standard_normal(batch + (m, 3))
         + 1j * rng.standard_normal(batch + (m, 3)))
    Aj, Bj = jnp.asarray(A), jnp.asarray(B)
    ref_det = np.linalg.det(A)
    ref_inv = np.linalg.inv(A)
    np.testing.assert_allclose(linalg.batched_det(Aj), ref_det, rtol=1e-10)
    np.testing.assert_allclose(linalg.batched_inv(Aj), ref_inv, atol=1e-10)
    det, inv = linalg.batched_det_inv(Aj)
    np.testing.assert_allclose(det, ref_det, rtol=1e-10)
    np.testing.assert_allclose(inv, ref_inv, atol=1e-10)
    det, Y = linalg.batched_det_solve(Aj, Bj)
    np.testing.assert_allclose(det, ref_det, rtol=1e-10)
    np.testing.assert_allclose(Y, np.linalg.solve(A, B), atol=1e-10)
    det, Y = linalg.batched_det_solve_t(Aj, Bj)
    np.testing.assert_allclose(det, ref_det, rtol=1e-10)
    np.testing.assert_allclose(
        Y, np.linalg.solve(np.swapaxes(A, -1, -2), B), atol=1e-10)


@pytest.mark.parametrize("m1,m2", [(1, 2), (3, 4), (5, 5), (45, 45)])
def test_batched_det_solve_blocks_vs_lapack(impl, m1, m2):
    """The 2x2-blocked det + solve (the WM A-matrix form), including a
    split at an odd width, against numpy on the assembled system."""
    rng = np.random.default_rng(m1 + 10 * m2)
    m = m1 + m2
    A = _complex_batch(rng, (6,), m)
    B = rng.standard_normal((6, m, 4)) + 1j * rng.standard_normal((6, m, 4))
    det, Y = linalg.batched_det_solve_blocks(
        *(jnp.asarray(x) for x in (A[:, :m1, :m1], A[:, :m1, m1:],
                                   A[:, m1:, :m1], A[:, m1:, m1:],
                                   B[:, :m1], B[:, m1:])))
    np.testing.assert_allclose(det, np.linalg.det(A), rtol=1e-10)
    np.testing.assert_allclose(Y, np.linalg.solve(A, B), atol=1e-10)


def test_batched_det_complex64_pivoting():
    """The "xla" path pivots: a matrix whose leading entry is zero (where
    an unpivoted elimination divides by zero) still gets its det."""
    A = np.array([[[0.0, 1.0, 2.0], [1.0, 0.0, 3.0], [4.0, 5.0, 0.0]]],
                 dtype=np.complex64)
    det = linalg._lu_det(jnp.asarray(A))[2]
    np.testing.assert_allclose(det, np.linalg.det(A), rtol=1e-6)


@pytest.mark.parametrize("backend", ["gpu", "cpu", "rocm"])
def test_resolve_impl_auto_per_backend(monkeypatch, backend):
    """`auto` is the pivoted-LU "xla" path on every backend (on the GPU it
    was the faster of the two passing implementations for the det and the
    blocked solve); an explicit choice or the module setting wins."""
    monkeypatch.setattr(linalg.jax, "default_backend", lambda: backend)
    assert linalg._resolve_impl("auto") == "xla"
    assert linalg._resolve_impl("jax") == "jax"
    assert linalg._resolve_impl("xla") == "xla"
    monkeypatch.setattr(linalg, "_LINALG_IMPL", "jax")
    assert linalg._resolve_impl() == "jax"
    linalg.set_linalg_impl("auto")
    assert linalg._resolve_impl() == "xla"


@pytest.mark.parametrize("name", ["lanes", "pallas", "cuda"])
def test_removed_impl_names_refused(monkeypatch, name):
    with pytest.raises(ValueError, match="unknown batched linear-algebra"):
        linalg.set_linalg_impl(name)
    monkeypatch.setattr(linalg, "_LINALG_IMPL", name)
    with pytest.raises(ValueError, match="expected one of"):
        linalg.batched_det(jnp.eye(3, dtype=jnp.complex64)[None])


def test_batched_mode_product():
    """Transcendental-free mode product (exponent-bitcast normalization +
    halving tree) vs the exact f64 product, both dtypes, odd mode counts,
    magnitudes spanning six decades, and an exact-zero factor.

    The HK/WM diag scans use the fused log+arctan2 form instead (XLA fuses
    the transcendentals into the surrounding elementwise chain); this gate
    keeps the primitive correct for range-critical uses."""
    import jax

    from semiclassical_jax.linalg import batched_mode_product

    rng = np.random.default_rng(7)
    for dtype, cd, tol in ((np.float32, jnp.complex64, 2e-5),
                           (np.float64, jnp.complex128, 1e-13)):
        for d in (1, 5, 60):
            mag = 10.0 ** rng.uniform(-3, 3, size=(500, d))
            ang = rng.uniform(-np.pi, np.pi, size=(500, d))
            zr = (mag * np.cos(ang)).astype(dtype)
            zi = (mag * np.sin(ang)).astype(dtype)
            exact = np.prod(zr.astype(np.float64)
                            + 1j * zi.astype(np.float64), axis=1)
            got = np.asarray(jax.jit(
                batched_mode_product, static_argnames="cdtype")(
                    jnp.asarray(zr), jnp.asarray(zi), cd))
            ok = (np.abs(exact) < 1e30) & (np.abs(exact) > 1e-30)
            rel = np.abs(got[ok] - exact[ok]) / np.abs(exact[ok])
            assert rel.max() < tol, (dtype, d, rel.max())
        zr[:, 0] = 0.0
        zi[:, 0] = 0.0
        got = np.asarray(batched_mode_product(jnp.asarray(zr),
                                              jnp.asarray(zi), cd))
        assert (got == 0).all()

    # factors whose |z|^2 under/overflows the dtype (|z| = 1e+-30 in f32:
    # |z|^2 = 1e+-60 is 0.0/inf) while the PRODUCT is representable — the
    # exponent pre-scaling must recover the exact result
    ang = np.array([[0.3] * 4 + [-0.2] * 4], dtype=np.float32)
    mag = np.array([[1e-30] * 4 + [1e30] * 4], dtype=np.float32)
    zr = (mag * np.cos(ang)).astype(np.float32)
    zi = (mag * np.sin(ang)).astype(np.float32)
    got = np.asarray(batched_mode_product(jnp.asarray(zr),
                                          jnp.asarray(zi), jnp.complex64))
    assert abs(got[0] - np.exp(0.4j)) < 1e-6, got
    zr64 = np.array([[1e-200] * 3 + [1e200] * 3], dtype=np.float64)
    got = np.asarray(batched_mode_product(
        jnp.asarray(zr64), jnp.asarray(np.zeros_like(zr64)), jnp.complex128))
    assert abs(got[0] - 1.0) < 1e-13, got
