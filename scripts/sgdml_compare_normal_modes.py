#!/usr/bin/env python
# coding: utf-8
"""Compare normal modes and frequencies of an sGDML force field with the
quantum-chemistry reference (capability parity with the reference's
scripts/sgdml_compare_normal_modes.py).

The sGDML PES is minimised starting from the QM geometry, its analytic
Hessian is mass-weighted and diagonalised, and the resulting vibrational
frequencies are tabulated against the frequencies recomputed from the QM
checkpoint's force constants.

Usage:
    python sgdml_compare_normal_modes.py model.npz freq.fchk [out.dat]
"""

import sys

import numpy as np

import jax
import jax.numpy as jnp

from semiclassical_jax import units
from semiclassical_jax.gdml import GDMLParams, gdml_forward
from semiclassical_jax.io import FormattedCheckpointFile
from semiclassical_jax.potentials import MolecularGDMLPotential, minimize


def vibrational_frequencies(hess, masses):
    """Frequencies (Hartree) and mass-weighted modes from a cartesian
    Hessian; the 6 lowest (rigid-body) modes are included."""
    imsq = 1.0 / np.sqrt(masses)
    mwh = np.einsum("i,ij,j->ij", imsq, hess, imsq)
    w2, modes = np.linalg.eigh(mwh)
    freqs = np.sign(w2) * np.sqrt(np.abs(w2))
    return freqs, modes


def main(argv):
    if len(argv) < 3:
        print(__doc__)
        return 1
    model_file, fchk_file = argv[1], argv[2]
    out_file = argv[3] if len(argv) > 3 else "normal_mode_comparison.dat"

    model = np.load(model_file, allow_pickle=True)
    with open(fchk_file) as f:
        fchk = FormattedCheckpointFile(f)

    masses = fchk.masses()
    pos_qm, _, _, hess_qm = fchk.harmonic_approximation()

    potential = MolecularGDMLPotential.create(model, fchk)
    potential = minimize(potential, jnp.asarray(pos_qm))

    # re-minimise returns only the origin; get the optimised geometry by a
    # short Newton walk through the same expansion
    r = jnp.asarray(pos_qm)
    for _ in range(100):
        _, g, h = potential.local_expansion(r[None, :])
        step = jnp.linalg.solve(h.dense()[0], -g[0])
        r = r + step
        if float(jnp.linalg.norm(g[0])) < 1e-8:
            break

    hess_ml = np.asarray(gdml_forward(potential.gdml, r[None, :],
                                      order=2)[2][0])

    freqs_qm, modes_qm = vibrational_frequencies(hess_qm, masses)
    freqs_ml, modes_ml = vibrational_frequencies(hess_ml, masses)

    # mode overlap matrix |<qm_i|ml_j>| for assignment
    overlap = np.abs(modes_qm.T @ modes_ml)

    with open(out_file, "w") as f:
        f.write("# Normal-mode comparison: sGDML vs QM reference\n")
        f.write(f"# model: {model_file}\n# fchk:  {fchk_file}\n")
        f.write("# mode   freq_QM/cm-1   freq_sGDML/cm-1   diff/cm-1   "
                "best-overlap\n")
        for i in range(len(freqs_qm)):
            j = int(np.argmax(overlap[i]))
            f.write(
                f"{i:5d} "
                f"{freqs_qm[i] * units.hartree_to_wavenumbers:14.2f} "
                f"{freqs_ml[j] * units.hartree_to_wavenumbers:16.2f} "
                f"{(freqs_ml[j] - freqs_qm[i]) * units.hartree_to_wavenumbers:10.2f} "
                f"{overlap[i, j]:12.4f}\n")
    print(f"wrote {out_file}")

    rms = np.sqrt(np.mean(((freqs_ml[6:] - freqs_qm[6:])
                           * units.hartree_to_wavenumbers) ** 2))
    print(f"RMS frequency deviation (internal modes): {rms:.2f} cm-1")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
