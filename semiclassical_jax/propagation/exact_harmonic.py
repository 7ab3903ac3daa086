# coding: utf-8
"""Exact propagation map for constant-Hessian (harmonic) molecular PES.

The molecular harmonic potential (reference potentials.py:529-638) is a
global quadratic

    V(q) = E0 + g0.(q - r0) + 1/2 (q - r0)^T H (q - r0),

so Hamilton's equations for z = (dq, p), dq = q - r0, are LINEAR-affine:

    dz/dt = L z + c,     L = [[0, M^-1], [-H, 0]],   c = (0, -g0),

and one time step of ANY size is the exact affine map

    z(t + dt) = T z(t) + w,     [[T, w], [0, 1]] = expm(dt [[L, c], [0, 0]]).

The monodromy obeys dM/dt = L M, so M(t + dt) = T M(t) with the same T.
The classical action increment is the time integral of the quadratic form

    dS/dt = 1/2 p^T M^-1 p - V(q) = 1/2 zeta^T Qt zeta,
    zeta = (z, 1),  Qt = [[blockdiag(-H, M^-1), l], [l^T, 2 k]],
    l = (-g0, 0),   k = -(E0 - origin),

which along the exact flow zeta(s) = expm(s Lt) zeta(0) is itself a closed
form — Van Loan's (1978) block-matrix identity gives

    DeltaS = 1/2 zeta0^T W zeta0,
    W = int_0^dt expm(s Lt)^T Qt expm(s Lt) ds = F2^T G,
    expm(dt [[-Lt^T, Qt], [0, Lt]]) = [[F1, G], [0, F2]].

All constants (T, w, W) are computed ONCE on the host in f64 (scipy expm);
the device step is three thin matmuls per trajectory — no PES evaluation,
no eigendecomposition, no per-mode special-casing of zero/negative
frequencies (expm handles the translation/rotation null modes and saddle
directions uniformly). The map is exact at ANY dt up to f64 roundoff:
unlike RK4 (local O(dt^5)) there is no time-discretization error and no
secular energy drift, mirroring the closed-form Morse map
(propagation/exact_morse.py) for the molecular-harmonic PES family.

Numerics: the trajectory update uses the INCREMENT form
z' = z + (T - I) z + w with (T - I) formed exactly on the host — its
entries are O(omega dt), so a reduced-precision product costs
~eps |omega dt| |z| per step instead of ~eps |z| (the plain-f32 drift
mode), and comp32 states fold the increment through the usual exact
two-sum. The action form is evaluated at f64 (S is f64 everywhere).

Reference equivalence: this replaces the 4-stage RK4 loop of
propagators.py:86-119 for the constant-Hessian potential class; the
degree-4 truncated exponential the RK4 step realises (eom.rk4_step
ConstHessian branch) converges to this map as dt -> 0 (gated in
tests/test_exact_harmonic.py).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from semiclassical_jax.propagation.state import TrajState
from semiclassical_jax.pytree import pytree_dataclass

__all__ = ["HarmonicMap", "build_harmonic_map", "harmonic_step",
           "supports_exact_harmonic"]


@pytree_dataclass
class HarmonicMap:
    """Precomputed exact-step constants for a quadratic PES."""

    dT: jnp.ndarray      # (2d, 2d) expm(L dt) - I at the increment dtype
    w: jnp.ndarray       # (2d,) affine drift at the increment dtype
    T_mono: jnp.ndarray  # (2d, 2d) expm(L dt) at the monodromy dtype
    Wzz: jnp.ndarray     # (2d, 2d) action quadratic form, f64
    wz: jnp.ndarray      # (2d,) action linear form, f64
    w11: jnp.ndarray     # () action constant, f64
    pos0: jnp.ndarray    # (d,) expansion center, f64


def supports_exact_harmonic(potential) -> bool:
    """True when the potential is a global quadratic the map can represent
    (duck-typed on the MolecularHarmonicPotential parameter fields)."""
    return all(hasattr(potential, f)
               for f in ("pos0", "energy0", "grad0", "hess0", "origin"))


def build_harmonic_map(potential, dt, state: TrajState) -> HarmonicMap:
    """Host-side construction of the exact-step constants (f64 numpy).

    `state` only supplies the device dtypes (increment dtype = trajectory
    dtype, monodromy dtype = monodromy block dtype).
    """
    import scipy.linalg as sla

    if not supports_exact_harmonic(potential):
        raise ValueError(
            "integrator='exact' on a molecular path requires a "
            "constant-Hessian (harmonic) potential")
    if state.diag_monodromy:
        raise ValueError("exact harmonic map expects dense monodromy blocks")

    H = np.asarray(potential.hess0, dtype=np.float64)
    g0 = np.asarray(potential.grad0, dtype=np.float64)
    pos0 = np.asarray(potential.pos0, dtype=np.float64)
    e0c = float(np.asarray(potential.energy0)) - float(
        np.asarray(potential.origin))
    inv_m = 1.0 / np.asarray(potential.masses(), dtype=np.float64)
    d = H.shape[0]
    dt = float(dt)

    L = np.zeros((2 * d, 2 * d))
    L[:d, d:] = np.diag(inv_m)
    L[d:, :d] = -H

    # affine flow: [[T, w], [0, 1]] = expm(dt [[L, c], [0, 0]])
    Lt = np.zeros((2 * d + 1, 2 * d + 1))
    Lt[:2 * d, :2 * d] = L
    Lt[d:2 * d, 2 * d] = -g0
    F2 = sla.expm(dt * Lt)
    T = F2[:2 * d, :2 * d]
    w = F2[:2 * d, 2 * d]

    # action form: dS/dt = 1/2 zeta^T Qt zeta (see module docstring)
    Qt = np.zeros((2 * d + 1, 2 * d + 1))
    Qt[:d, :d] = -H
    Qt[d:2 * d, d:2 * d] = np.diag(inv_m)
    Qt[:d, 2 * d] = -g0
    Qt[2 * d, :d] = -g0
    Qt[2 * d, 2 * d] = -2.0 * e0c

    # Van Loan block identity: W = F2^T G = int_0^dt expm(s Lt)^T Qt expm(s Lt) ds
    n = 2 * d + 1
    C = np.zeros((2 * n, 2 * n))
    C[:n, :n] = -Lt.T
    C[:n, n:] = Qt
    C[n:, n:] = Lt
    E = sla.expm(dt * C)
    W = F2.T @ E[:n, n:]
    W = 0.5 * (W + W.T)

    # increments and the action's QUADRATIC form ride at the algebra
    # (monodromy) dtype — in the mixed mode that is f32: the increment
    # error is eps * |omega dt
    # z| per step (the (T - I) entries are O(omega dt) host-exact
    # constants), and the quadratic action terms are O(omega dt z^2)
    # corrections to the f64-exact linear + constant parts below
    mdt = state.Mqq.dtype
    eye = np.eye(2 * d)
    return HarmonicMap(
        dT=jnp.asarray(T - eye, dtype=mdt),
        w=jnp.asarray(w, dtype=mdt),
        T_mono=jnp.asarray(T, dtype=mdt),
        Wzz=jnp.asarray(W[:2 * d, :2 * d], dtype=mdt),
        wz=jnp.asarray(W[:2 * d, 2 * d], dtype=jnp.float64),
        w11=jnp.asarray(W[2 * d, 2 * d], dtype=jnp.float64),
        pos0=jnp.asarray(pos0, dtype=jnp.float64),
    )


def harmonic_step(hmap: HarmonicMap, state: TrajState, potential):
    """One exact step. Returns (new_state, mean_energy_at_step_start),
    the same contract as eom.rk4_step."""
    from semiclassical_jax.propagation.eom import _comp_accumulate

    q, p = state.q, state.p
    d = q.shape[1]

    # displacement from the expansion center at the trajectory precision;
    # comp32 folds BOTH residuals into the true values (q through the
    # displacement, p directly — the map consumes p itself, so dropping
    # pc would leave the compensation one-sided)
    dq = q - hmap.pos0.astype(q.dtype)[None, :]
    pt = p
    if state.compensated:
        dq = dq + state.qc
        pt = p + state.pc

    # energy guard at the step start (cheap: the PES is the potential's own
    # quadratic expansion; evaluated at the residual-folded true values)
    inv_m = (1.0 / potential.masses()).astype(q.dtype)
    tkin = 0.5 * jnp.sum(pt * pt * inv_m[None, :], axis=1)
    vpot, _, _ = potential.local_expansion(
        q + state.qc if state.compensated else q)
    mean_energy = jnp.mean(tkin + vpot.astype(tkin.dtype))

    # trajectory increment z' - z = (T - I) z + w at the map dtype (f32
    # in the mixed mode; the (T - I) entries are O(omega dt), so the
    # reduced-precision product costs eps * |omega dt| |z| per step)
    cdt = hmap.dT.dtype
    dqc = dq.astype(cdt)
    pc_ = pt.astype(cdt)
    dTaa, dTab = hmap.dT[:d, :d], hmap.dT[:d, d:]
    dTba, dTbb = hmap.dT[d:, :d], hmap.dT[d:, d:]
    inc_q = (dqc @ dTaa.T + pc_ @ dTab.T + hmap.w[None, :d]).astype(q.dtype)
    inc_p = (dqc @ dTba.T + pc_ @ dTbb.T + hmap.w[None, d:]).astype(q.dtype)

    if state.compensated:
        new_q, new_qc = _comp_accumulate(q, state.qc, inc_q)
        new_p, new_pc = _comp_accumulate(p, state.pc, inc_p)
    else:
        new_q = q + inc_q
        new_p = p + inc_p
        new_qc = new_pc = None

    # action increment: DeltaS = 1/2 z.Wzz z + wz.z + 1/2 w11. The
    # z-dependent quadratic part is an O(omega dt z^2) correction and
    # runs at the map dtype; the linear + constant anchors (which carry
    # the absolute-energy scale) stay f64.
    zc = jnp.concatenate([dqc, pc_], axis=1)                 # (n, 2d)
    quad = 0.5 * jnp.sum(zc * (zc @ hmap.Wzz.T), axis=1)
    z64 = jnp.concatenate([dq, pt], axis=1).astype(jnp.float64)
    ds = quad.astype(jnp.float64) + z64 @ hmap.wz + 0.5 * hmap.w11
    new_S = state.S + ds.astype(state.S.dtype)

    # monodromy: M' = T M as ONE constant-left product on the fully
    # row/column-stacked (n, 2d, 2d) blocks — same MACs as the 8
    # per-block products but K = 2d (twice the contraction depth) and a
    # single fused matmul
    mdt = state.Mqq.dtype
    Z = jnp.concatenate(
        [jnp.concatenate([state.Mqq, state.Mqp], axis=2),
         jnp.concatenate([state.Mpq, state.Mpp], axis=2)], axis=1)
    Z = jnp.einsum("ab,nbc->nac", hmap.T_mono.astype(mdt), Z)
    new_state = TrajState(
        q=new_q, p=new_p, S=new_S, qc=new_qc, pc=new_pc,
        Mqq=Z[:, :d, :d], Mqp=Z[:, :d, d:],
        Mpq=Z[:, d:, :d], Mpp=Z[:, d:, d:],
    )
    return new_state, mean_energy
