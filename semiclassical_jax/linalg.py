# coding: utf-8
"""Linear algebra helpers.

Two categories, deliberately separated:

* **Host-side (numpy)** spectral decompositions of the small, *constant* width
  matrices Gamma (symmetric sqrtm, pseudo-inverses, pseudo-determinants,
  null-space projectors). In the reference these run on the device per
  propagator construction (reference propagators.py:25-82, 124-179, 493-531);
  here they run once on the host so that no eigendecomposition — and more
  importantly no *dynamic rank* — ever enters a jitted function. The rank of
  Gamma becomes a static Python int and the null-space projector U a fixed
  (d, r) matrix baked into the compiled program.

* **Device-side (jax)** batched determinants / inverses of small complex
  matrices over the trajectory axis — the per-step hot ops of the HK/WM
  prefactors (reference propagators.py:999, 1255, 1332, 1352-1359).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# small float, threshold for considering eigenvalues as 0
# (reference propagators.py:16)
ZERO = 1.0e-8

__all__ = [
    "ZERO",
    "times_i",
    "real_dtype",
    "to_device",
    "from_device",
    "phase_exp",
    "complex_exp",
    "logspace_mode_product",
    "batched_mode_product",
    "sym_eigh",
    "sym_sqrtm",
    "is_symmetric_non_negative",
    "pseudo_inverse",
    "pseudo_det",
    "pseudo_logdet",
    "nonzero_subspace",
    "batched_det",
    "batched_inv",
    "batched_det_inv",
    "batched_det_solve",
    "batched_det_solve_t",
    "batched_det_solve_blocks",
    "set_linalg_impl",
]


def real_dtype(cdtype):
    """float dtype matching a complex dtype."""
    return jnp.float32 if jnp.dtype(cdtype) == jnp.complex64 else jnp.float64


def to_device(x, dtype, sharding=None):
    """np -> jnp conversion at `dtype`, optionally placed by `sharding`.

    Complex inputs are shipped as two real arrays and combined with
    lax.complex on device; real inputs take the plain path with the cast
    done host-side.

    `sharding`, if given, places the transferred array (for complex inputs:
    each real plane, so the combine happens shard-local and no complex
    array is ever resharded).
    """
    dtype = jnp.dtype(dtype)
    x = np.asarray(x)

    def place(arr):
        if sharding is not None:
            return jax.device_put(arr, sharding)
        return jnp.asarray(arr)

    if jnp.issubdtype(dtype, jnp.complexfloating):
        rtype = np.float32 if dtype == jnp.complex64 else np.float64
        return jax.lax.complex(place(x.real.astype(rtype)),
                               place(x.imag.astype(rtype)))
    return place(x.astype(dtype.type))


def from_device(x):
    """Device -> host fetch of real or complex arrays (complex ones as
    their two real planes)."""
    x = jnp.asarray(x)
    if jnp.iscomplexobj(x):
        return np.asarray(x.real) + 1j * np.asarray(x.imag)
    return np.asarray(x)


def batched_mode_product(z_re, z_im, cdtype):
    """prod over the mode axis (axis 1) of z = z_re + i z_im (n, d) real
    planes, returned as `cdtype` (n,) — WITHOUT transcendentals.

    The log-space form (sum of log |z|^2 + sum of arctan2, then
    exp/cos/sin) is range-safe but evaluates two transcendentals per
    (trajectory, mode) element. Here each factor is instead scaled by
    an exact power of two read off its |z|^2 EXPONENT FIELD
    (j = floor(exponent/2), |z * 2^-j| in [1, 2)), the normalized complex
    product is taken by a static halving tree (exact phase, magnitude in
    [1, 2^d) — representable for any d <= 120 in f32), and the collected
    integer exponent re-enters as two power-of-two factors. Only integer
    ops and multiplies touch the (n, d) planes; the two exp2 calls act on
    (n,) scalars. Range contract: the RESULT magnitude must be
    representable in the real dtype — the same contract the previous
    complex_exp(log...) return value already imposed (prefactor dets are
    balanced/scaled to O(1) upstream: hk factors_diag, wm m_scale/Dbal).
    """
    rd = real_dtype(cdtype)
    if z_re.dtype == jnp.float64:
        ibits, mant, bias = jnp.int64, 52, 1023
    else:
        ibits, mant, bias = jnp.int32, 23, 127
    m2 = z_re * z_re + z_im * z_im
    # |z|^2 spans TWICE the exponent range of z: factors whose |z|^2
    # underflows (subnormal/zero, exponent field 0) or overflows (inf,
    # exponent field all-ones) would mis-normalise. Pre-scale those rows
    # by the exact power 2^{-+(bias-1)} and fold the shift into j — the
    # whole representable |z| range then normalises correctly (exact
    # zeros stay zero and zero the product, matching the log-space
    # form's -inf).
    pre = bias - 1                                 # even for f32 and f64
    field = (jax.lax.bitcast_convert_type(m2, ibits) >> mant)
    tiny = field == 0
    big = field == (2 * bias + 1)
    pscale = jnp.asarray(2.0, m2.dtype) ** pre
    adj = jnp.where(tiny, pscale, jnp.where(big, 1.0 / pscale, 1.0))
    zr0 = z_re * adj
    zi0 = z_im * adj
    m2 = zr0 * zr0 + zi0 * zi0
    k = (jax.lax.bitcast_convert_type(m2, ibits) >> mant) - bias
    # z = z_norm * 2^j: j = floor(k/2), shifted by the full pre-scale for
    # the adjusted rows (the 2^{-+pre} sits inside z_norm's normalisation)
    j = (k >> 1) - jnp.where(tiny, pre, 0) + jnp.where(big, pre, 0)
    # clamp so the constructed exponent field stays legal (only the exact-
    # zero rows hit the clamp, and any finite scale is correct for z = 0)
    js = jnp.clip((k >> 1), -(bias - 1), bias - 1)
    scale = jax.lax.bitcast_convert_type(
        (jnp.asarray(bias, ibits) - js) << mant, m2.dtype)
    zr = zr0 * scale
    zi = zi0 * scale
    sj = jnp.sum(j, axis=1)                        # (n,) int

    n, d = z_re.shape
    n2 = 1
    while n2 < d:
        n2 *= 2
    if n2 != d:                                    # pad with neutral 1+0i
        zr = jnp.concatenate(
            [zr, jnp.ones((n, n2 - d), zr.dtype)], axis=1)
        zi = jnp.concatenate(
            [zi, jnp.zeros((n, n2 - d), zi.dtype)], axis=1)
    h = n2 // 2
    while h >= 1:
        ar, ai = zr[:, :h], zi[:, :h]
        br, bi = zr[:, h:2 * h], zi[:, h:2 * h]
        zr, zi = ar * br - ai * bi, ar * bi + ai * br
        h //= 2
    zr, zi = zr[:, 0], zi[:, 0]

    # 2^sj in two exact halves: |sj| <= 2 * 60-ish + log2|result| stays
    # well inside the exponent range of each half
    a = sj >> 1
    fa = jnp.exp2(a.astype(m2.dtype))
    fb = jnp.exp2((sj - a).astype(m2.dtype))
    return jax.lax.complex(((zr * fa) * fb).astype(rd),
                           ((zi * fa) * fb).astype(rd))


def complex_exp(re, im, cdtype):
    """exp(re + i im) evaluated in the precision of re/im, returned as
    `cdtype`. Keeps large exponents accurate in f64 while the result is
    stored at the (possibly complex64) algebra precision."""
    rd = real_dtype(cdtype)
    mag = jnp.exp(re)
    return jax.lax.complex((mag * jnp.cos(im)).astype(rd),
                           (mag * jnp.sin(im)).astype(rd))


def logspace_mode_product(z_re, z_im, cdtype, axis=1):
    """prod of (z_re + i z_im) over the mode `axis`, in log space:
    magnitudes as a sum of logs, phases as a sum of angles — range-safe at
    any mode count.  The shared primitive behind both propagators'
    diagonal-path determinants (HK `hk_prefactor_det`, WM detA/detM); any
    range/branch fix lands here once.  For the transcendental-free
    alternative (and why it measured slower in the fused HK step) see
    `batched_mode_product`."""
    log_mag = 0.5 * jnp.sum(jnp.log(z_re**2 + z_im**2), axis=axis)
    ang = jnp.sum(jnp.arctan2(z_im, z_re), axis=axis)
    return complex_exp(log_mag, ang, cdtype)


def phase_exp(s, cdtype):
    """exp(i s) at the precision of `cdtype`, with the angle reduced mod 2 pi
    *before* any down-cast — for long propagations the action S grows to
    ~1e4 and a bare f64 -> f32 cast would cost ~1e-3 rad of phase."""
    rd = real_dtype(cdtype)
    if s.dtype != rd:
        two_pi = 2.0 * np.pi
        s = s - two_pi * jnp.round(s / two_pi)
        s = s.astype(rd)
    return jnp.exp(times_i(s))


def times_i(x):
    """1j * x without materialising a complex128 constant.

    With x64 enabled, the Python literal ``1j`` is a weakly-typed complex128
    scalar that can promote a complex64 computation. ``lax.complex`` keeps
    everything in the operand's precision (f32 -> c64, f64 -> c128).
    """
    if jnp.iscomplexobj(x):
        return jax.lax.complex(-x.imag, x.real)
    return jax.lax.complex(jnp.zeros_like(x), x)


# ---------------------------------------------------------------------------
# host-side spectral helpers (numpy, float64)
# ---------------------------------------------------------------------------

def sym_eigh(A: np.ndarray):
    """Eigendecomposition of a real symmetric matrix, ascending eigenvalues."""
    A = np.asarray(A, dtype=np.float64)
    return np.linalg.eigh(A)


def sym_sqrtm(A: np.ndarray):
    """Square root of a symmetric real matrix and pseudo-inverse of the root.

    Returns (A^{1/2}, A^{+(-1/2)}) as complex arrays; negative eigenvalues are
    handled by the complex square root, zero eigenvalues (|e| <= ZERO) are
    excluded from the pseudo-inverse. Mirrors reference propagators.py:25-59.
    """
    e, V = sym_eigh(A)
    non_zero = np.abs(e) > ZERO
    ec = e.astype(np.complex128)
    Vc = V.astype(np.complex128)
    sqA = np.einsum("ij,j,kj->ik", Vc, np.sqrt(ec), Vc)
    sqA_pinv = np.einsum(
        "ij,j,kj->ik",
        Vc[:, non_zero],
        1.0 / np.sqrt(ec[non_zero]),
        Vc[:, non_zero],
    )
    return sqA, sqA_pinv


def is_symmetric_non_negative(A: np.ndarray, eps: float = 1.0e-6) -> bool:
    """Check that A is symmetric and positive semi-definite.

    Mirrors reference propagators.py:61-82.
    """
    A = np.asarray(A, dtype=np.float64)
    relerr = np.sum(np.abs(A - A.T)) / np.sum(np.abs(A))
    if relerr > eps:
        return False
    e, _ = np.linalg.eigh(A)
    return bool((e >= -ZERO).all())


def pseudo_inverse(A: np.ndarray) -> np.ndarray:
    """Moore-Penrose pseudo-inverse of a symmetric matrix via eigh,
    dropping eigenvalues with |e| <= ZERO."""
    e, V = sym_eigh(A)
    nz = np.abs(e) > ZERO
    return np.einsum("ij,j,kj->ik", V[:, nz], 1.0 / e[nz], V[:, nz])


def pseudo_det(A: np.ndarray, scale: float = 1.0) -> float:
    """Pseudo-determinant: product of non-zero eigenvalues of symmetric A,
    each divided by `scale` (used to absorb pi / 2pi factors as in the
    reference WM propagator, propagators.py:1107-1125)."""
    e, _ = sym_eigh(A)
    nz = np.abs(e) > ZERO
    return float(np.prod(e[nz] / scale))


def pseudo_logdet(A: np.ndarray, scale: float = 1.0) -> float:
    """log of the pseudo-determinant of a PSD matrix (eigenvalues / scale).

    For d ~ 60+ modes the pseudo-determinants of the width matrices
    under/overflow even float64 (prod of ~1e-3 eigenvalues); WM's scalar
    prefactors are therefore combined in log space on the host.
    """
    e, _ = sym_eigh(A)
    nz = e > ZERO
    return float(np.sum(np.log(e[nz] / scale)))


def nonzero_subspace(A: np.ndarray, positive_only: bool = True) -> np.ndarray:
    """Orthonormal basis U (d, r) of the non-zero eigenspace of symmetric A.

    The reference keeps this projector for transforming prefactor matrices
    into the subspace complementary to the null space of Gamma
    (propagators.py:496-498, 994, 1246-1250). `r` is concrete here, so every
    downstream jitted shape is static.
    """
    e, V = sym_eigh(A)
    nz = (e > ZERO) if positive_only else (np.abs(e) > ZERO)
    return np.ascontiguousarray(V[:, nz])


# ---------------------------------------------------------------------------
# device-side batched small-matrix ops (jax)
# ---------------------------------------------------------------------------
#
# Two interchangeable implementations of the batched complex det / inverse /
# solve that carry the HK and WM prefactors:
#
# * "xla" — one pivoted LU per matrix (`lax.linalg.lu`: LAPACK on the CPU,
#   the vendor's batched LU on the GPU), with the determinant read off its
#   diagonal and every solve done by two triangular solves on that same
#   factorisation.
# * "jax" — the unpivoted block-Schur recursion below, built from batched
#   matmuls only.
#
# "auto" is "xla" on every backend: both pass chip_smoke.py's det_parity
# gates at production widths on the H100, where "xla" was the faster for
# the determinant and the blocked solve that the HK and WM scans run (the
# Schur inverse was faster only for the bare inverses of the diagnostics).
# `set_linalg_impl` or the SEMI_LINALG_IMPL environment variable force one.

import os as _os

_IMPLS = ("xla", "jax")

_LINALG_IMPL = _os.environ.get("SEMI_LINALG_IMPL", "auto")


def _check_impl(name: str) -> str:
    if name not in _IMPLS + ("auto",):
        raise ValueError(
            f"unknown batched linear-algebra implementation {name!r}: "
            f"expected one of {_IMPLS + ('auto',)}")
    return name


def set_linalg_impl(name: str):
    """Choose the batched det/inv/solve implementation: "xla", "jax" or
    "auto" (= "xla")."""
    global _LINALG_IMPL
    _LINALG_IMPL = _check_impl(name)


def _resolve_impl(impl: str | None = None) -> str:
    """The implementation the batched ops run with: `impl` (default: the
    module setting), with "auto" resolved to "xla"."""
    impl = _check_impl(_LINALG_IMPL if impl is None else impl)
    return "xla" if impl == "auto" else impl


# ---------------------------------------------------------------------------
# "xla": one pivoted LU, determinant and solves from the same factors.
# ---------------------------------------------------------------------------

def _lu_det(A: jax.Array):
    """(lu, permutation, det) of A (..., m, m); A[perm] = L U."""
    lu, pivots, perm = jax.lax.linalg.lu(A)
    m = A.shape[-1]
    swaps = jnp.sum(pivots != jnp.arange(m, dtype=pivots.dtype), axis=-1)
    sign = jnp.where(swaps % 2 == 0, 1.0, -1.0).astype(A.dtype)
    det = sign * jnp.prod(jnp.diagonal(lu, axis1=-2, axis2=-1), axis=-1)
    return lu, perm, det


def _lu_solve(lu, perm, B, trans: bool = False):
    """A^{-1} B (or A^{-T} B) from the factors of `_lu_det`."""
    tri = jax.lax.linalg.triangular_solve
    if not trans:
        y = jnp.take_along_axis(B, perm[..., None], axis=-2)
        y = tri(lu, y, left_side=True, lower=True, unit_diagonal=True)
        return tri(lu, y, left_side=True, lower=False)
    # A^T = U^T L^T P: solve U^T, then L^T, then undo the row permutation
    y = tri(lu, B, left_side=True, lower=False, transpose_a=True)
    y = tri(lu, y, left_side=True, lower=True, transpose_a=True,
            unit_diagonal=True)
    return jnp.take_along_axis(y, jnp.argsort(perm, axis=-1)[..., None],
                               axis=-2)


def _eye_like(A):
    return jnp.broadcast_to(jnp.eye(A.shape[-1], dtype=A.dtype), A.shape)


# ---------------------------------------------------------------------------
# "jax": Schur-complement recursion, batched det/inv built from matmuls only.
#
# det([[A, B], [C, D]]) = det(A) det(D - C A^{-1} B)
# inv via the block formulas. The recursion unrolls at trace time (static
# shapes), turning an (n, r, r) determinant into ~log2(r) levels of batched
# matmuls with 2x2 closed-form base cases. No pivoting: the propagator
# matrices are well-conditioned (identity at t=0, smooth evolution), and
# correctness is cross-checked against LAPACK in the test suite.
# ---------------------------------------------------------------------------

def _det_inv_schur(M):
    r = M.shape[-1]
    if r == 1:
        a = M[..., 0, 0]
        return a, (1.0 / a)[..., None, None]
    if r == 2:
        a, b = M[..., 0, 0], M[..., 0, 1]
        c, d = M[..., 1, 0], M[..., 1, 1]
        det = a * d - b * c
        inv = jnp.stack([
            jnp.stack([d, -b], axis=-1),
            jnp.stack([-c, a], axis=-1),
        ], axis=-2) / det[..., None, None]
        return det, inv
    r1 = r // 2
    A = M[..., :r1, :r1]
    B = M[..., :r1, r1:]
    C = M[..., r1:, :r1]
    D = M[..., r1:, r1:]
    detA, iA = _det_inv_schur(A)
    iA_B = iA @ B
    S = D - C @ iA_B
    detS, iS = _det_inv_schur(S)
    C_iA = C @ iA
    top_right = -iA_B @ iS
    inv = jnp.concatenate([
        jnp.concatenate([iA - top_right @ C_iA, top_right], axis=-1),
        jnp.concatenate([-iS @ C_iA, iS], axis=-1),
    ], axis=-2)
    return detA * detS, inv


def _det_schur(M):
    """det only — skips the inverse assembly of the trailing block."""
    r = M.shape[-1]
    if r == 1:
        return M[..., 0, 0]
    if r == 2:
        return (M[..., 0, 0] * M[..., 1, 1]
                - M[..., 0, 1] * M[..., 1, 0])
    r1 = r // 2
    A = M[..., :r1, :r1]
    B = M[..., :r1, r1:]
    C = M[..., r1:, :r1]
    D = M[..., r1:, r1:]
    detA, iA = _det_inv_schur(A)
    S = D - C @ (iA @ B)
    return detA * _det_schur(S)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def batched_det(A: jax.Array) -> jax.Array:
    """Determinant of a batch of small (complex) matrices, shape (..., r, r)."""
    if _resolve_impl() == "jax":
        return _det_schur(A)
    return _lu_det(A)[2]


def batched_det_inv(A: jax.Array):
    """(det, inv) of a batch of small (complex) matrices, shape
    (..., r, r) — any number of leading batch dims — from one
    factorisation, so callers needing both (the WM prefactor) pay for one.
    """
    if _resolve_impl() == "jax":
        return _det_inv_schur(A)
    lu, perm, det = _lu_det(A)
    return det, _lu_solve(lu, perm, _eye_like(A))


def batched_inv(A: jax.Array) -> jax.Array:
    """Inverse of a batch of small (complex) matrices, shape (..., r, r)."""
    return batched_det_inv(A)[1]


def batched_det_solve(A: jax.Array, B: jax.Array):
    """(det(A), A^{-1} B) for A (..., m, m), B (..., m, k)."""
    if _resolve_impl() == "jax":
        det, inv = _det_inv_schur(A)
        return det, inv @ B
    lu, perm, det = _lu_det(A)
    return det, _lu_solve(lu, perm, B)


def batched_det_solve_t(A: jax.Array, B: jax.Array):
    """(det(A), A^{-T} B) for A (..., m, m), B (..., m, k) — the form
    callers want when the inverse only ever appears as A^{-T} @ (tall
    block), such as the WM prefactor's Y = iAb^T P."""
    if _resolve_impl() == "jax":
        det, inv = _det_inv_schur(A)
        return det, jnp.swapaxes(inv, -1, -2) @ B
    lu, perm, det = _lu_det(A)
    return det, _lu_solve(lu, perm, B, trans=True)


def batched_det_solve_blocks(A11, A12, A21, A22, B1, B2):
    """(det, [Y1; Y2]) of the 2x2-blocked system [[A11, A12], [A21, A22]]
    [Y1; Y2] = [B1; B2], for callers that assemble the blocks natively
    (the WM A-matrix)."""
    A = jnp.concatenate([
        jnp.concatenate([A11, A12], axis=-1),
        jnp.concatenate([A21, A22], axis=-1)], axis=-2)
    return batched_det_solve(A, jnp.concatenate([B1, B2], axis=-2))
