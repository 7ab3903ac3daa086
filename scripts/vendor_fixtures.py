# coding: utf-8
"""Build the self-contained test fixture tree tests/data/refdata/.

The fast test tier reads physics fixtures (fchk files, the trained sGDML
model, QM correlation tables) from the read-only reference checkout when it
is mounted; this script vendors *trimmed* copies into the repo so the suite
is self-contained. Trimming:

* fchk files        -> scripts/trim_formatted_checkpoint_file.awk (only the
                       fields the readers consume)
* QM correlation    -> cropped to the time range the AS gates interpolate
                       over (t <= 8 fs of the 1000 fs table)
* sGDML model npz   -> only the fields GDMLParams.from_npz consumes
                       (drops training-set bookkeeping), recompressed
* golden npz        -> only the keys the golden gates compare
* AS model tables / example configs -> reparsed and re-emitted

Usage:  python scripts/vendor_fixtures.py  (requires /root/reference mounted)
"""

import json
import pathlib
import subprocess

import numpy as np

REF = pathlib.Path("/root/reference/tests/DATA")
REPO = pathlib.Path(__file__).resolve().parents[1]
OUT = REPO / "tests" / "data" / "refdata"
AWK = REPO / "scripts" / "trim_formatted_checkpoint_file.awk"


def trim_fchk(src: pathlib.Path, dst: pathlib.Path):
    dst.parent.mkdir(parents=True, exist_ok=True)
    with open(dst, "w") as f:
        subprocess.run(["awk", "-f", str(AWK), str(src)], stdout=f,
                       check=True)
    print(f"fchk  {src.name}: {src.stat().st_size} -> {dst.stat().st_size} B")


def main():
    assert REF.is_dir(), f"{REF} not mounted"

    # ------------------------------------------------------------------
    # AnharmonicAS/5modes: model tables + QM correlation oracle
    # ------------------------------------------------------------------
    as_out = OUT / "AnharmonicAS" / "5modes"
    as_out.mkdir(parents=True, exist_ok=True)
    for chi in ("0.00", "0.02"):
        src = REF / "AnharmonicAS" / "5modes" / f"AS_model_chi{chi}.dat"
        data = np.loadtxt(src)
        np.savetxt(
            as_out / src.name, np.atleast_2d(data), fmt="%.12g",
            header="omega/cm^-1  Huang-Rhys_S  NAC  chi "
                   "(5-mode AS model parameters; vendored from the "
                   "reference data set)")
    # the AS gates interpolate k~ic(t) on t <= 150/40 fs = 3.75 fs; crop
    # the 1000 fs table to t <= 8 fs (headroom for coarser future gates)
    src = REF / "AnharmonicAS" / "5modes" / "ic_correlation_chi0.02_T0.001.dat"
    tab = np.loadtxt(src)
    tab = tab[tab[:, 0] <= 8.0]
    np.savetxt(as_out / src.name, tab, fmt="%.12g",
               header="t/fs  Re[k_ic]  Im[k_ic]  (QM oracle, cropped to "
                      "t<=8 fs of the full table)")
    print(f"AS correlation table: {len(np.loadtxt(src))} -> {len(tab)} rows")

    # ------------------------------------------------------------------
    # GDML: coumarin geometry + trained sGDML model (predictor fields only)
    # ------------------------------------------------------------------
    gdml_out = OUT / "GDML"
    gdml_out.mkdir(parents=True, exist_ok=True)
    xyz = (REF / "GDML" / "coumarin.xyz").read_text()
    (gdml_out / "coumarin.xyz").write_text(xyz)
    src = (REF / "GDML"
           / "coumarin_forces_au-wB97XD_def2SVP-train200-sym1.npz")
    model = np.load(src, allow_pickle=True)
    keep = {k: model[k] for k in
            ("sig", "c", "std", "z", "perms", "tril_perms_lin",
             "R_desc", "R_d_desc_alpha")}
    np.savez_compressed(gdml_out / src.name, **keep)
    print(f"sGDML model: {src.stat().st_size} -> "
          f"{(gdml_out / src.name).stat().st_size} B "
          f"({len(model.files)} -> {len(keep)} fields)")

    # ------------------------------------------------------------------
    # Gaussian16: coumarin S0/S1 checkpoints (trimmed)
    # ------------------------------------------------------------------
    for name in ("coumarin_s0.fchk", "coumarin_s1.fchk"):
        trim_fchk(REF / "Gaussian16" / name, OUT / "Gaussian16" / name)

    # ------------------------------------------------------------------
    # examples/methylium_AH: end-to-end golden example
    # ------------------------------------------------------------------
    ex_out = OUT / "examples" / "methylium_AH"
    ex_out.mkdir(parents=True, exist_ok=True)
    ex_src = REF / "examples" / "methylium_AH"
    for name in ("opt_freq_s0.fchk", "opt_freq_s1.fchk"):
        trim_fchk(ex_src / name, ex_out / name)
    (ex_out / "geom").write_text((ex_src / "geom").read_text())
    # reparse + re-emit the task config
    config = json.loads((ex_src / "semi.json").read_text())
    (ex_out / "semi.json").write_text(json.dumps(config, indent=1) + "\n")
    # golden npz: only the keys the gates compare
    check = np.load(ex_src / "correlations.npz.CHECK")
    keep = {k: check[k] for k in
            ("times", "autocorrelation", "ic_correlation", "ic_rate")}
    # np.savez appends ".npz" when the name lacks it — write via a handle
    with open(ex_out / "correlations.npz.CHECK", "wb") as f:
        np.savez_compressed(f, **keep)
    print(f"golden npz: {(ex_src / 'correlations.npz.CHECK').stat().st_size}"
          f" -> {(ex_out / 'correlations.npz.CHECK').stat().st_size} B")

    total = sum(p.stat().st_size for p in OUT.rglob("*") if p.is_file())
    print(f"vendored tree: {total / 1024:.0f} KiB at {OUT}")


if __name__ == "__main__":
    main()
