# coding: utf-8
"""Minimal extended-XYZ trajectory writer (no ASE dependency).

Capability parity with the reference's trajectory export
(reference cli.py:478-517, which uses ase.io.extxyz): positions in Angstrom
and momenta per atom, one frame per trajectory.
"""

from __future__ import annotations

import numpy as np

from semiclassical_jax import units

__all__ = ["write_extxyz", "SYMBOLS"]

SYMBOLS = [
    "X", "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe",
]


def write_extxyz(filename, atomic_numbers, frames_q, frames_p, append=False):
    """Write trajectory frames in extended XYZ.

    Parameters
    ----------
    atomic_numbers : (nat,) int
    frames_q : iterable of (3 nat,) positions in bohr
    frames_p : iterable of (3 nat,) momenta (atomic units)
    append : open mode 'a' instead of 'w'
    """
    symbols = [SYMBOLS[z] for z in atomic_numbers]
    nat = len(symbols)
    mode = "a" if append else "w"
    with open(filename, mode) as f:
        for q, p in zip(frames_q, frames_p):
            pos = np.asarray(q).reshape(-1, 3) * units.bohr_to_angs
            mom = np.asarray(p).reshape(-1, 3)
            f.write(f"{nat}\n")
            f.write('Properties=species:S:1:pos:R:3:momenta:R:3\n')
            for s, r3, p3 in zip(symbols, pos, mom):
                f.write(
                    f"{s:3s} "
                    f"{r3[0]:20.12f} {r3[1]:20.12f} {r3[2]:20.12f} "
                    f"{p3[0]:20.12f} {p3[1]:20.12f} {p3[2]:20.12f}\n"
                )
