#!/usr/bin/awk -f
# Trim a Gaussian 16 formatted checkpoint file to the fields required by
# the semiclassical_jax readers (capability parity with the reference's
# scripts/trim_formatted_checkpoint_file.awk).
#
# Kept fields: header lines, Number of atoms, Atomic numbers, Real atomic
# weights, Current cartesian coordinates, Total Energy, Cartesian Gradient,
# Cartesian Force Constants, Nonadiabatic coupling, Number of Normal Modes,
# Vib-E2.
#
# Usage: awk -f trim_formatted_checkpoint_file.awk big.fchk > small.fchk

NR <= 2 { print; next }

/^[A-Z]/ {
    keep = 0
    if ($0 ~ /^Number of atoms/ ||
        $0 ~ /^Atomic numbers/ ||
        $0 ~ /^Real atomic weights/ ||
        $0 ~ /^Current cartesian coordinates/ ||
        $0 ~ /^Total Energy/ ||
        $0 ~ /^Cartesian Gradient/ ||
        $0 ~ /^Cartesian Force Constants/ ||
        $0 ~ /^Nonadiabatic coupling/ ||
        $0 ~ /^Number of Normal Modes/ ||
        $0 ~ /^Vib-E2/) {
        keep = 1
    }
    if (keep) print
    next
}

keep { print }
