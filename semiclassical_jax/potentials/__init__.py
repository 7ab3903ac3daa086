# coding: utf-8
"""Potential energy surfaces.

Every potential is an immutable pytree dataclass implementing the protocol
(capability parity with the duck-typed protocol of reference potentials.py):

  dimensions()            -> int                      (static)
  masses()                -> (d,) array
  local_expansion(q)      -> (V (n,), grad (n,d), hess HessianOp)
  derivative_coupling_1st(q) -> (n, d) array
  derivative_coupling_2nd(q) -> (n, d) array

`q` always has the trajectory axis leading: (n, d).

The Hessian is returned as a structured operator (`DiagHessian` for separable
potentials, `DenseHessian` otherwise) so that the monodromy products
H @ M cost O(n d^2) instead of O(n d^3) when the Hessian is diagonal —
the reference always materialises dense (d, d, n) Hessians
(reference potentials.py:119-134, 298-327).
"""

from semiclassical_jax.potentials.base import DenseHessian, DiagHessian
from semiclassical_jax.potentials.model import MorsePotential, NonHarmonicPotential
from semiclassical_jax.potentials.molecular import (
    MolecularGDMLPotential,
    MolecularHarmonicPotential,
    minimize,
)

__all__ = [
    "DiagHessian",
    "DenseHessian",
    "NonHarmonicPotential",
    "MorsePotential",
    "MolecularHarmonicPotential",
    "MolecularGDMLPotential",
    "minimize",
]
