# coding: utf-8
"""Molecular potential energy surfaces.

Capability parity with reference potentials.py:400-744:

* `MolecularHarmonicPotential` — second-order Taylor PES from a Gaussian 16
  frequency checkpoint; constant Hessian, constant NAC (Condon approximation).
* `MolecularGDMLPotential` — sGDML machine-learned PES with analytic batched
  Hessians (pure JAX, see semiclassical_jax.gdml).
* `minimize` — Newton optimisation with Armijo backtracking line search to
  locate the PES minimum and fix the energy origin. Unlike the reference's
  mutating ``potential.minimize`` (potentials.py:435-526) this is a pure
  function returning a new potential with the origin set.
"""

from __future__ import annotations

import logging

import numpy as np
import jax
import jax.numpy as jnp

from semiclassical_jax.gdml import GDMLParams, gdml_forward
from semiclassical_jax.potentials.base import ConstHessian, DenseHessian
from semiclassical_jax.pytree import pytree_dataclass, replace

logger = logging.getLogger(__name__)

__all__ = ["MolecularHarmonicPotential", "MolecularGDMLPotential", "minimize"]


@pytree_dataclass(meta=("contract_dtype",))
class MolecularHarmonicPotential:
    """Harmonic expansion around a reference geometry (usually the minimum):

        V(r') = V0 + grad0^T (r' - r0) + 1/2 (r' - r0)^T hess0 (r' - r0)

    Built from a frequency checkpoint (geometry, gradient, cartesian force
    constants) and a checkpoint carrying the NAC vector
    (reference potentials.py:529-638).

    `contract_dtype` (e.g. "float32") evaluates the PES *contractions* at a
    reduced precision while the displacement r' - r0 keeps the trajectory
    precision — the mixed mode for this PES. The (n, d) @ (d, d) Hessian
    product then runs in f32; the scalar energy bookkeeping (energy0 -
    origin, absolute ~1e2 Ha) stays at the parameter dtype so the action
    phase keeps its accuracy.
    """

    pos0: jnp.ndarray     # (d,)
    energy0: jnp.ndarray  # ()
    grad0: jnp.ndarray    # (d,)
    hess0: jnp.ndarray    # (d, d)
    nac0: jnp.ndarray     # (d,)
    mass: jnp.ndarray     # (d,)
    origin: jnp.ndarray   # () energy origin set by `minimize`
    contract_dtype: str = ""

    @staticmethod
    def from_fchk(freq_fchk, nac_fchk, dtype=jnp.float64):
        pos0, energy0, grad0, hess0 = freq_fchk.harmonic_approximation()
        nac0 = nac_fchk.nonadiabatic_coupling()
        mass = freq_fchk.masses()
        logger.info(f"atomic masses (multiples of electron mass): {mass}")
        return MolecularHarmonicPotential(
            pos0=jnp.asarray(pos0, dtype=dtype),
            energy0=jnp.asarray(float(np.ravel(energy0)[0]), dtype=dtype),
            grad0=jnp.asarray(grad0, dtype=dtype),
            hess0=jnp.asarray(hess0, dtype=dtype),
            nac0=jnp.asarray(nac0, dtype=dtype),
            mass=jnp.asarray(mass, dtype=dtype),
            origin=jnp.asarray(0.0, dtype=dtype),
        )

    def dimensions(self) -> int:
        return self.pos0.shape[0]

    def masses(self) -> jnp.ndarray:
        return self.mass

    def total_energy(self):
        """Energy at the minimum (after `minimize`), Hartree."""
        return self.origin

    def local_expansion(self, q):
        # the displacement is a difference of large nearby Cartesians: take
        # it at the trajectory precision (pos0 cast to q's dtype so an f32
        # trajectory state does not silently promote the subtraction)
        dr = q - self.pos0[None, :].astype(q.dtype)       # (n, d)
        t = jnp.dtype(self.contract_dtype) if self.contract_dtype else dr.dtype
        drt = dr.astype(t)
        hdr = drt @ self.hess0.T.astype(t)                # (n, d) at t
        expans = (drt @ self.grad0.astype(t)
                  + 0.5 * jnp.sum(drt * hdr, axis=1))
        v = (self.energy0 - self.origin) + expans.astype(q.dtype)
        grad = self.grad0[None, :].astype(q.dtype) + hdr.astype(q.dtype)
        return v, grad, ConstHessian(mat=self.hess0.astype(t))

    def derivative_coupling_1st(self, q):
        return jnp.broadcast_to(self.nac0[None, :], q.shape)

    def derivative_coupling_2nd(self, q):
        return jnp.zeros_like(q)


@pytree_dataclass(meta=("hess_dtype", "hessian_eval", "taylor_every"))
class MolecularGDMLPotential:
    """sGDML machine-learned ground-state PES with constant NAC vector.

    (reference potentials.py:641-744; the batch layout is natively
    trajectory-leading here, so no permutes are needed)

    `hess_dtype` selects the mixed mode: f64 energies/gradients (the
    action phase needs them) with an f32 Hessian for the monodromy blocks.

    `hessian_eval` selects how often the integrator samples the PES:
    "stage" (default — every RK4 stage, trajectory-for-trajectory parity
    with the reference), "step" — gradients at all 4 stages but the Hessian
    once per step at the midpoint stage, frozen across the monodromy update
    (the analytic sGDML Hessian costs ~20x the gradient; trajectories are
    unchanged bit for bit), or "taylor" — ONE order-2 evaluation per step
    at the free-flight midpoint with all stage forces from the local
    quadratic expansion (1/4 of the expensive f64 energy/gradient
    evaluations; trajectories acquire an O(dt^2) local-harmonic error,
    gated in tests/test_hessian_eval.py — see eom.rk4_step).
    """

    gdml: GDMLParams
    nac0: jnp.ndarray    # (d,)
    mass: jnp.ndarray    # (d,)
    origin: jnp.ndarray  # ()
    hess_dtype: str
    hessian_eval: str = "stage"
    # taylor_every > 1: ONE order-2 evaluation per window of that many
    # steps — the scan carries the frozen LocalQuadratic and every step
    # inside the window runs the taylor machinery on it (requires
    # hessian_eval="taylor"; see eom.make_taylor_window)
    taylor_every: int = 1

    @staticmethod
    def create(model_pot, nac_fchk, dtype=jnp.float64, hess_dtype=None,
               hessian_eval="stage", taylor_every=1):
        gdml = GDMLParams.from_npz(model_pot, dtype=dtype)
        nac0 = nac_fchk.nonadiabatic_coupling()
        model_z = np.asarray(dict(model_pot)["z"])
        assert np.array_equal(model_z, nac_fchk.atomic_numbers()), (
            "GDML model and NAC checkpoint should describe the same molecule"
        )
        mass = nac_fchk.masses()
        logger.info(f"atomic masses (multiples of electron mass): {mass}")
        if hessian_eval not in ("stage", "step", "taylor"):
            raise ValueError(f"unknown hessian_eval {hessian_eval!r} "
                             "(expected 'stage', 'step' or 'taylor')")
        taylor_every = int(taylor_every)
        if taylor_every < 1:
            raise ValueError("taylor_every must be >= 1")
        if taylor_every > 1 and hessian_eval != "taylor":
            raise ValueError(
                "taylor_every > 1 requires hessian_eval='taylor'")
        return MolecularGDMLPotential(
            gdml=gdml,
            nac0=jnp.asarray(nac0, dtype=dtype),
            mass=jnp.asarray(mass, dtype=dtype),
            origin=jnp.asarray(0.0, dtype=dtype),
            hess_dtype="" if hess_dtype is None else jnp.dtype(hess_dtype).name,
            hessian_eval=hessian_eval,
            taylor_every=taylor_every,
        )

    def dimensions(self) -> int:
        return 3 * self.gdml.n_atoms

    def masses(self) -> jnp.ndarray:
        return self.mass

    def total_energy(self):
        return self.origin

    def local_expansion(self, q):
        v, grad, hess = gdml_forward(
            self.gdml, q, order=2,
            hess_dtype=self.hess_dtype or None)
        return v - self.origin, grad, DenseHessian(mat=hess)

    def value_grad(self, q):
        """Energy + gradient only (order-1 early exit) — the cheap stage
        evaluation for `hessian_eval = "step"` (the Hessian assembly is
        the dominant cost of the full expansion)."""
        v, grad = gdml_forward(self.gdml, q, order=1)
        return v - self.origin, grad

    def derivative_coupling_1st(self, q):
        return jnp.broadcast_to(self.nac0[None, :], q.shape)

    def derivative_coupling_2nd(self, q):
        return jnp.zeros_like(q)


def minimize(potential, r_guess, maxiter=200, rtol=1.0e-5, gtol=1.0e-7):
    """Locate the PES minimum near `r_guess` and fix the energy origin there.

    Newton steps dr = -hess^{-1} grad with a steepest-descent fallback and
    Armijo backtracking (reference potentials.py:435-526). The optimisation
    loop runs on the host (it is a handful of iterations on a single
    geometry); each PES evaluation is jitted.

    Returns a new potential with ``origin`` set to the minimum energy.
    """
    result_pot = potential
    potential = replace(potential, origin=jnp.zeros_like(potential.origin))

    @jax.jit
    def expansion(pot, r):
        v, g, h = pot.local_expansion(r[None, :])
        return v[0], g[0], h.dense()

    @jax.jit
    def energy_only(pot, r):
        v, _, _ = pot.local_expansion(r[None, :])
        return v[0]

    r = jnp.asarray(r_guess)
    for i in range(maxiter):
        energy, grad, hess = expansion(potential, r)
        # the Newton solve is a single small (d, d) system: do it on the
        # host — a device roundtrip per iteration buys nothing. Molecular
        # Hessians carry ~6 near-zero translational/rotational modes, so a
        # plain solve is ill-posed
        # (|dr| blows up along the null space and the line search dies);
        # the pseudo-inverse Newton step projects them out.
        grad_h = np.asarray(grad)
        hess_h = np.asarray(hess).reshape(grad_h.shape[0], grad_h.shape[0])

        evals, evecs = np.linalg.eigh(0.5 * (hess_h + hess_h.T))
        keep = np.abs(evals) > 1.0e-8 * np.abs(evals).max()
        dr = -(evecs[:, keep] / evals[keep]) @ (evecs[:, keep].T @ grad_h)
        delta_energy = float(np.sum(grad_h * dr))
        if delta_energy > 0.0:
            # not a descent direction -> steepest descent
            dr = -grad_h
            delta_energy = float(np.sum(grad_h * dr))

        grad_norm = float(np.linalg.norm(grad_h))
        disp_norm = float(np.linalg.norm(dr))
        logger.info(
            f"  iteration= {i:5}  energy= {float(energy):f} Hartree  "
            f"|gradient|= {grad_norm:e} (threshold= {gtol})  "
            f"|geometry change|= {disp_norm:e} (threshold= {rtol})"
        )
        if grad_norm < gtol or disp_norm < rtol:
            logger.info("  converged")
            break

        # Armijo backtracking line search (Nocedal & Wright, Algorithm 3.1)
        rho, c_armijo, lmax = 0.3, 1.0e-4, 100
        a = 1.0
        for _ in range(lmax):
            r_interp = r + a * dr
            if float(energy_only(potential, r_interp)) <= float(energy) + c_armijo * a * delta_energy:
                break
            a *= rho
        else:
            raise RuntimeError(
                "Linesearch failed! Could not find a step length that "
                "satisfies the sufficient decrease condition."
            )
        r = r_interp
    else:
        raise RuntimeError(f"Could not find minimum within {maxiter} iterations.")

    emin = float(energy_only(potential, r))
    logger.info(f"shift origin of energy axis to minimum energy = {emin} Hartree")
    return replace(result_pot,
                   origin=jnp.asarray(emin, dtype=result_pot.origin.dtype))
