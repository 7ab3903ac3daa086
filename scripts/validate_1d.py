# coding: utf-8
"""Standalone long-form 1D validation study: HK and WM vs exact QM.

Framework analogue of the reference's long-form validation script
(reference tests/test_HK_WM_1d.py): propagate a displaced Gaussian on the
1D anharmonic potential of Herman & Kluk (1986, eqn. 7) for several
oscillation periods with both semiclassical propagators, compare the
autocorrelation C(t) = <phi(0)|phi(t)>, the IC correlation k~ic(t), the
wavefunction psi(x, t) at snapshot times, and the final norm against an
independent split-operator quantum propagation; print an error summary
and optionally write comparison figures.

Unlike the in-suite gates (tests/test_propagators_1d.py, which run the
40x-reduced reference test scale), this script is meant for *long*
interactive studies — the default covers 3 periods and finishes in a few
minutes on a laptop CPU; `--periods 12 --nt 4000 --ntraj 50000`
reproduces the reference study's full extent.

Usage:
    python scripts/validate_1d.py [--ntraj 20000] [--periods 3]
        [--nt 300] [--propagators HK WM] [--plot OUTDIR]
"""

import argparse
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))  # the split-operator oracle

# This is a float64/complex128 validation study (like the reference's) — it
# runs on the CPU backend; the reduced-precision gates on the card live in
# the GPU test tier (tests/test_gpu_smoke.py). The config update must
# precede first backend use.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from qm_oracle import (  # noqa: E402
    gaussian_wavepacket,
    momentum_operator,
    split_operator_correlations,
    split_operator_wavefunctions,
)

from semiclassical_jax.potentials import NonHarmonicPotential  # noqa: E402
from semiclassical_jax.propagation import (  # noqa: E402
    HermanKlukPropagator,
    WaltonManolopoulosPropagator,
)


def build_study(periods, nt, nx=10000):
    """The HK-paper 1D setup: potential, grids, initial wavepacket, QM
    reference correlations (identical physics to tests/test_propagators_1d)."""
    omega = 1.0
    t_max = periods * 2.0 * np.pi / omega
    times = np.linspace(0.0, t_max, nt)
    x = np.linspace(-10.0, 40.0, nx)

    eps, b = 0.975, 12.0 ** (-0.5)
    v = (eps / (2 * b ** 2) * (1.0 - np.exp(-b * x)) ** 2
         + (1 - eps) * 0.5 * omega * x ** 2)

    alpha = 0.5 * omega
    q0, p0 = 7.3, 0.0
    phi0 = gaussian_wavepacket(x, q0, p0, alpha)

    print("running split-operator QM reference "
          f"({nx} grid points, {nt} steps) ...")
    t0 = time.time()
    autocorrelation_qm = split_operator_correlations(v, x, times, phi0)
    # interaction-prepared |psi(0)> = V+|phi(0)>, V_eg = hbar^2/m nac d/dx
    psi0 = momentum_operator(phi0, x)
    en0 = 0.5 * omega
    ic_correlation_qm = (split_operator_correlations(v, x, times, psi0)
                         * np.exp(1j * times * en0))
    print(f"  QM reference done in {time.time() - t0:.1f} s")

    return {
        "times": times, "x": x, "v": v, "phi0": phi0, "en0": en0,
        "autocorrelation_qm": autocorrelation_qm,
        "ic_correlation_qm": ic_correlation_qm,
        "potential": NonHarmonicPotential.create(),
        "q0": np.array([q0]), "p0": np.array([p0]),
        "Gamma_i": np.array([[2 * 2.5]]),
        "Gamma_0": np.array([[omega]]),
    }


def run_semiclassical(name, s, ntraj, key, snapshots):
    """Propagate one semiclassical propagator through the study window,
    collecting C(t), k~ic(t) and psi(x, t) at the snapshot steps."""
    if name == "HK":
        prop = HermanKlukPropagator(s["Gamma_i"], s["Gamma_i"])
    else:
        prop = WaltonManolopoulosPropagator(s["Gamma_i"], s["Gamma_i"],
                                            alpha=100.0, beta=100.0)
    prop.initial_conditions(s["q0"], s["p0"], s["Gamma_0"], ntraj=ntraj,
                            key=key, potential=s["potential"])
    times = s["times"]
    dt = times[1] - times[0]
    x_grid = s["x"][::10][:, None]

    cauto_parts, kic_parts, psi_sc = [], [], {}
    t0 = time.time()
    prev = 0
    for step in sorted(set(snapshots) | {len(times)}):
        if step > prev:
            ca, ki = prop.propagate(s["potential"], dt, step - prev,
                                    energy0_es=0.0)
            cauto_parts.append(ca)
            kic_parts.append(ki)
            prev = step
        if step < len(times):
            psi_sc[step] = prop.wavefunction(x_grid)
    wall = time.time() - t0
    cauto = np.concatenate(cauto_parts)
    kic = np.concatenate(kic_parts) * np.exp(1j * times * s["en0"])
    norm = float(np.real(prop.norm()))
    print(f"  {name}: {ntraj} trajectories x {len(times)} steps "
          f"in {wall:.1f} s, final norm {norm:.4f}")
    return {"cauto": cauto, "kic": kic, "psi": psi_sc, "norm": norm}


def summarize(name, s, r, snapshots, psi_qm):
    """Print the error summary block for one propagator; returns pass/fail."""
    dc = np.abs(r["cauto"] - s["autocorrelation_qm"])
    kic_scale = np.abs(s["ic_correlation_qm"]).max()
    dk = np.abs(r["kic"] - s["ic_correlation_qm"]) / kic_scale
    x_sub = s["x"][::10]
    dx = x_sub[1] - x_sub[0]
    print(f"\n=== {name} vs exact QM ===")
    print(f"  max |C_sc(t) - C_qm(t)|          : {dc.max():.4f}")
    print(f"  max |k_sc(t) - k_qm(t)| / max|k| : {dk.max():.4f}")
    for step in sorted(snapshots):
        diff = r["psi"][step] - psi_qm[step][::10]
        l2 = float(np.sqrt(np.sum(np.abs(diff) ** 2) * dx))
        print(f"  ||psi_sc - psi_qm|| at step {step:5d} : {l2:.4f}")
    print(f"  final norm (exact: 1)            : {r['norm']:.4f}")
    ok = (dc.max() < 0.1 and dk.max() < 0.15 and abs(r["norm"] - 1) < 0.1)
    print(f"  => {'PASS' if ok else 'FAIL'} "
          "(gates: |dC| < 0.1, |dk|/max < 0.15, |norm - 1| < 0.1)")
    return ok


def write_plots(outdir, s, results, snapshots, psi_qm):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    times = s["times"]

    fig, axes = plt.subplots(2, 1, figsize=(9, 7), sharex=True)
    axes[0].plot(times, np.abs(s["autocorrelation_qm"]), "k-", lw=2,
                 label="QM (split operator)")
    axes[1].plot(times, np.abs(s["ic_correlation_qm"]), "k-", lw=2,
                 label="QM (split operator)")
    for name, r in results.items():
        axes[0].plot(times, np.abs(r["cauto"]), "--", label=name)
        axes[1].plot(times, np.abs(r["kic"]), "--", label=name)
    axes[0].set_ylabel(r"$|C(t)|$")
    axes[1].set_ylabel(r"$|\tilde{k}_{ic}(t)|$")
    axes[1].set_xlabel("time / a.u.")
    for ax in axes:
        ax.legend(frameon=False)
    fig.tight_layout()
    path = os.path.join(outdir, "correlations_1d.png")
    fig.savefig(path, dpi=150)
    print(f"wrote {path}")

    x_sub = s["x"][::10]
    ncol = len(snapshots)
    fig, axes = plt.subplots(1, ncol, figsize=(4 * ncol, 3.2), sharey=True)
    for ax, step in zip(np.atleast_1d(axes), sorted(snapshots)):
        ax.plot(x_sub, np.abs(psi_qm[step][::10]) ** 2, "k-", lw=2,
                label="QM")
        for name, r in results.items():
            ax.plot(x_sub, np.abs(r["psi"][step]) ** 2, "--", label=name)
        ax.set_title(f"step {step} (t = {s['times'][step]:.1f})")
        ax.set_xlabel("x / a.u.")
        ax.set_xlim(-5, 25)
    np.atleast_1d(axes)[0].set_ylabel(r"$|\psi(x,t)|^2$")
    np.atleast_1d(axes)[0].legend(frameon=False)
    fig.tight_layout()
    path = os.path.join(outdir, "wavefunctions_1d.png")
    fig.savefig(path, dpi=150)
    print(f"wrote {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="1D anharmonic validation study: HK/WM vs exact QM")
    ap.add_argument("--ntraj", type=int, default=20000,
                    help="Monte-Carlo trajectories per propagator")
    ap.add_argument("--periods", type=float, default=3.0,
                    help="study length in oscillation periods")
    ap.add_argument("--nt", type=int, default=300, help="number of steps")
    ap.add_argument("--propagators", nargs="+", default=["HK", "WM"],
                    choices=["HK", "WM"])
    ap.add_argument("--key", type=int, default=0, help="RNG key")
    ap.add_argument("--plot", metavar="OUTDIR", default="",
                    help="write comparison figures into this directory")
    args = ap.parse_args(argv[1:] if argv is not None else None)

    s = build_study(args.periods, args.nt)
    snapshots = [0, args.nt // 3, 2 * args.nt // 3, args.nt - 1]

    results = {}
    for name in args.propagators:
        results[name] = run_semiclassical(name, s, args.ntraj, args.key,
                                          snapshots)

    # one split-operator QM wavefunction propagation shared by every
    # summary block and the plots (it costs as much as a propagator run)
    psi_qm = split_operator_wavefunctions(s["v"], s["x"], s["times"],
                                          s["phi0"], set(snapshots))

    all_ok = True
    for name, r in results.items():
        all_ok &= summarize(name, s, r, snapshots, psi_qm)

    if args.plot:
        write_plots(args.plot, s, results, snapshots, psi_qm)

    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
