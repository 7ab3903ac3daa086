# coding: utf-8
"""Analytic model potentials.

Capability parity with reference potentials.py:25-397 (NonHarmonicPotential,
MorsePotential), redesigned as pure pytree dataclasses with closed-form
diagonal Hessians. All methods take batches with the trajectory axis leading:
q of shape (n, d).
"""

from __future__ import annotations

import logging

import jax.numpy as jnp
import numpy as np

from semiclassical_jax.potentials.base import DiagHessian
from semiclassical_jax.pytree import pytree_dataclass

logger = logging.getLogger(__name__)

__all__ = ["NonHarmonicPotential", "MorsePotential"]


@pytree_dataclass
class NonHarmonicPotential:
    """eps * Morse + (1 - eps) * harmonic oscillator (Herman-Kluk 1986 eqn. 7)

        V(x) = eps/(2 b^2) (1 - exp(-b x))^2 + (1 - eps) 1/2 x^2

    with the paper's parameters eps = 0.975, b = 12^{-1/2}.
    Unit masses; constant tau1 = 1, tau2 = 0
    (reference potentials.py:25-204).
    """

    eps: jnp.ndarray  # (d,)
    b: jnp.ndarray    # (d,)

    @staticmethod
    def create(eps=0.975, b=12.0 ** (-0.5), dim=1, dtype=jnp.float64):
        return NonHarmonicPotential(
            eps=jnp.full((dim,), eps, dtype=dtype),
            b=jnp.full((dim,), b, dtype=dtype),
        )

    def dimensions(self) -> int:
        return self.eps.shape[0]

    def masses(self) -> jnp.ndarray:
        return jnp.ones_like(self.eps)

    def local_expansion(self, q):
        """(V (n,), grad (n, d), DiagHessian (n, d)) at positions q (n, d).

        Computed at the parameter dtype (`create(dtype=...)`): with f32
        parameters and f64 trajectories the PES transcendentals run at f32
        while the integration state stays f64 — the PES
        noise (~1e-7 relative) sits far below the mixed-mode gate."""
        q = q.astype(self.eps.dtype)
        eps, b = self.eps[None, :], self.b[None, :]
        ex = jnp.exp(-b * q)
        v = jnp.sum(eps / (2 * b**2) * (1.0 - ex) ** 2 + (1 - eps) * 0.5 * q**2,
                    axis=1)
        grad = eps / b * (ex - ex**2) + (1 - eps) * q
        hdiag = eps * (2 * ex**2 - ex) + (1 - eps)
        return v, grad, DiagHessian(diag=hdiag)

    def derivative_coupling_1st(self, q):
        return jnp.ones_like(q)

    def derivative_coupling_2nd(self, q):
        return jnp.zeros_like(q)


@pytree_dataclass(meta=("harmonic", "hessian_eval", "taylor_every"))
class MorsePotential:
    """N separable Morse modes with anharmonicity chi (DOI 10.1063/1.5143212 eqn. 6).

        V(r) = sum_k D_k (1 - exp(-a_k r_k))^2
        a = sqrt(2 omega chi),  D = omega / (4 chi)

    chi = 0 modes are given a tiny anharmonicity (1e-4) so that all modes are
    describable by the same Morse form without changing results
    (reference potentials.py:243-255). Purely harmonic models (all chi = 0)
    use the closed-form harmonic branch, selected statically at construction.
    Unit masses; tau1 = nac (constant), tau2 = 0.
    """

    omega: jnp.ndarray  # (d,)
    a: jnp.ndarray      # (d,)
    D: jnp.ndarray      # (d,)
    nac: jnp.ndarray    # (d,)
    harmonic: bool      # static: all chi == 0
    # reduced-cost PES sampling, same contract as MolecularGDMLPotential:
    # "stage" (default, reference trajectory parity), "taylor" (one PES
    # evaluation per step, local-quadratic stage forces — 2nd order in
    # dt), optionally with taylor_every-step re-expansion windows. The
    # flagship benchmark keeps "stage" (its unit of work is the
    # reference RK4 loop); these are opt-in throughput modes.
    hessian_eval: str = "stage"
    taylor_every: int = 1

    @staticmethod
    def create(omega, chi, nac, dtype=jnp.float64, hessian_eval="stage",
               taylor_every=1):
        omega = np.asarray(omega, dtype=np.float64)
        chi = np.array(chi, dtype=np.float64, copy=True)
        nac = np.asarray(nac, dtype=np.float64)
        harmonic = bool((chi == 0.0).all())
        if harmonic:
            logger.info("Potential is harmonic.")
        else:
            chi[chi == 0.0] += 1.0e-4
        a = np.sqrt(2 * omega * chi)
        D = np.where(chi > 0, 0.25 * omega / np.where(chi > 0, chi, 1.0), 0.0)
        if hessian_eval not in ("stage", "step", "taylor"):
            raise ValueError(f"unknown hessian_eval {hessian_eval!r}")
        taylor_every = int(taylor_every)
        if taylor_every < 1:
            raise ValueError("taylor_every must be >= 1")
        if taylor_every > 1 and hessian_eval != "taylor":
            raise ValueError(
                "taylor_every > 1 requires hessian_eval='taylor'")
        return MorsePotential(
            omega=jnp.asarray(omega, dtype=dtype),
            a=jnp.asarray(a, dtype=dtype),
            D=jnp.asarray(D, dtype=dtype),
            nac=jnp.asarray(nac, dtype=dtype),
            harmonic=harmonic,
            hessian_eval=hessian_eval,
            taylor_every=taylor_every,
        )

    def dimensions(self) -> int:
        return self.omega.shape[0]

    def masses(self) -> jnp.ndarray:
        return jnp.ones_like(self.omega)

    def local_expansion(self, q):
        """Computed at the parameter dtype — see NonHarmonicPotential:
        f32 parameters give an f32 PES evaluation under f64
        trajectories."""
        q = q.astype(self.omega.dtype)
        if self.harmonic:
            om2 = (self.omega**2)[None, :]
            v = jnp.sum(0.5 * om2 * q**2, axis=1)
            grad = om2 * q
            hdiag = jnp.broadcast_to(om2, q.shape)
            return v, grad, DiagHessian(diag=hdiag)
        a, D = self.a[None, :], self.D[None, :]
        ex = jnp.exp(-a * q)
        v = jnp.sum(D * (1.0 - ex) ** 2, axis=1)
        grad = 2 * a * D * ex * (1.0 - ex)
        hdiag = 2 * a**2 * D * ex * (2 * ex - 1.0)
        return v, grad, DiagHessian(diag=hdiag)

    def derivative_coupling_1st(self, q):
        return jnp.broadcast_to(self.nac[None, :], q.shape)

    def derivative_coupling_2nd(self, q):
        return jnp.zeros_like(q)
