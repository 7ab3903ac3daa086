# coding: utf-8
"""semiclassical_jax — semiclassical molecular dynamics on accelerators.

Computes internal-conversion (IC) rates for molecules from semiclassical
initial-value-representation (IVR) dynamics, with the same capabilities as the
reference torch implementation (humeniuka/semiclassical) but redesigned from
scratch in JAX, for one or several GPUs:

 * pure-functional propagators: the whole time loop is one `lax.scan` inside a
   single jit, no per-step host synchronisation
 * the trajectory ensemble is the leading array axis, vmapped/sharded over a
   `jax.sharding.Mesh` (data parallelism across devices)
 * complex128/float64 numerics by default (x64 enabled on import); optional
   reduced-precision trajectory path for speed
 * all constant linear algebra (eigendecompositions of width matrices,
   null-space projectors) is precomputed on the host so that nothing with
   dynamic rank ever enters jit

The package is organised as:

  units          atomic units and conversion factors
  linalg         host-side symmetric sqrtm/pseudo-inverse + batched device det/inv
  coherent       coherent-state overlaps and wavefunctions
  sampling       Monte-Carlo initial conditions (jax.random)
  potentials/    PES protocol + model, molecular-harmonic and sGDML potentials
  gdml           pure-JAX sGDML kernel-ridge predictor with analytic Hessians
  propagation/   equations of motion, RK4, HK and WM propagators, scan driver
  parallel/      mesh/sharding helpers for multi-chip ensembles
  io/            fchk reader, npz accumulation protocol, extxyz export
  analysis/      lineshapes and FFT rate pipeline
  cli            the `semi` command-line task runner
"""

__version__ = "0.1.0"

import jax as _jax

# The physics requires float64/complex128 (the semiclassical prefactor is a
# square root of a complex determinant whose branch tracking is sensitive to
# rounding). Enable x64 at import; individual arrays may still be float32.
_jax.config.update("jax_enable_x64", True)

# On the GPU, float32 matmuls may otherwise run in TF32 (10 mantissa bits,
# ~1e-3 relative error per element) — catastrophic for the semiclassical
# prefactor determinants, whose 60x60 products amplify it to percent level.
# "highest" keeps every float32 product in full float32.
_jax.config.update("jax_default_matmul_precision", "highest")

from semiclassical_jax import units  # noqa: E402,F401
