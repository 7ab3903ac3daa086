# coding: utf-8
"""1D anharmonic-oscillator validation of HK and WM against exact QM.

This is the minimum end-to-end physics gate: the potential of Herman & Kluk
(1986) eqn. 7, a displaced Gaussian wavepacket, C(t) = <phi(0)|phi(t)> and
the IC correlation k~ic(t) compared to split-operator quantum propagation.
Mirrors the accuracy gates of reference tests/test_propagators.py:116-328
(rtol/atol 0.05, ntraj = 50000, final norm within 0.05 of 1).
"""

import numpy as np
import pytest

from semiclassical_jax.potentials import NonHarmonicPotential
from semiclassical_jax.propagation import (
    HermanKlukPropagator,
    WaltonManolopoulosPropagator,
)

from qm_oracle import (
    gaussian_wavepacket,
    momentum_operator,
    split_operator_correlations,
    split_operator_wavefunctions,
)

NTRAJ = 20000


@pytest.fixture(scope="module")
def setup_1d():
    # time grid: 12/40 oscillation periods, 100 steps (the reference's
    # 40x-reduced test scale, tests/test_propagators.py:126-134)
    nt = 4000 // 40
    omega = 1.0
    t_max = (12.0 / 40) * 2.0 * np.pi / omega
    times = np.linspace(0.0, t_max, nt)
    dt = times[1] - times[0]

    # spatial grid
    nx = 10000
    x = np.linspace(-10.0, 40.0, nx)

    eps, b = 0.975, 12.0 ** (-0.5)
    v = eps / (2 * b**2) * (1.0 - np.exp(-b * x)) ** 2 + (1 - eps) * 0.5 * omega * x**2

    alpha = 0.5 * omega
    x0, p0 = 7.3, 0.0
    phi0 = gaussian_wavepacket(x, x0, p0, alpha)

    autocorrelation_qm = split_operator_correlations(v, x, times, phi0)

    # interaction-prepared wavefunction |psi(0)> = V+ |phi(0)> with
    # V_eg = hbar^2/m nac d/dx, nac = 1
    psi0 = momentum_operator(phi0, x)
    en0 = 0.5 * omega
    ic_correlation_qm = (split_operator_correlations(v, x, times, psi0)
                         * np.exp(1j * times * en0))

    return {
        "times": times, "dt": dt, "nt": nt,
        "x": x, "v": v, "phi0": phi0,
        "autocorrelation_qm": autocorrelation_qm,
        "ic_correlation_qm": ic_correlation_qm,
        "potential": NonHarmonicPotential.create(),
        "q0": np.array([7.3]), "p0": np.array([0.0]),
        "Gamma_i": np.array([[2 * 2.5]]),
        "Gamma_0": np.array([[omega]]),
        "en0": en0,
    }


def _run(prop, s):
    prop.initial_conditions(s["q0"], s["p0"], s["Gamma_0"], ntraj=NTRAJ,
                            key=0, potential=s["potential"])
    cauto, kic = prop.propagate(s["potential"], s["dt"], s["nt"],
                                energy0_es=0.0)
    # the IC correlation carries the excited-state phase (en0 = omega/2)
    kic = kic * np.exp(1j * s["times"] * s["en0"])
    return cauto, kic


def test_herman_kluk_vs_qm(setup_1d):
    s = setup_1d
    prop = HermanKlukPropagator(s["Gamma_i"], s["Gamma_i"])
    cauto, kic = _run(prop, s)
    assert np.allclose(cauto, s["autocorrelation_qm"], rtol=0.05, atol=0.05)
    assert np.allclose(kic, s["ic_correlation_qm"], rtol=0.05, atol=0.05)
    assert abs(prop.norm() - 1.0) < 0.05


def test_walton_manolopoulos_vs_qm(setup_1d):
    s = setup_1d
    prop = WaltonManolopoulosPropagator(s["Gamma_i"], s["Gamma_i"],
                                        alpha=100.0, beta=100.0)
    cauto, kic = _run(prop, s)
    assert np.allclose(cauto, s["autocorrelation_qm"], rtol=0.05, atol=0.05)
    assert np.allclose(kic, s["ic_correlation_qm"], rtol=0.1, atol=0.1 * np.abs(s["ic_correlation_qm"]).max())
    assert abs(prop.norm() - 1.0) < 0.05


def _wavefunction_evolution_errors(prop, s, save_steps):
    """Propagate with the granular API and compare psi(x, t) on a subgrid
    against the split-operator wavefunction at the requested steps
    (reference tests/test_HK_WM_1d.py:89-102 records exactly these
    snapshots). Returns the L2 errors ||psi_SC - psi_QM|| per snapshot."""
    stride = 10
    x_sub = s["x"][::stride][:, None]
    dx_sub = x_sub[1, 0] - x_sub[0, 0]
    psi_qm = split_operator_wavefunctions(s["v"], s["x"], s["times"],
                                          s["phi0"], save_steps)
    prop.initial_conditions(s["q0"], s["p0"], s["Gamma_0"], ntraj=NTRAJ,
                            key=0, potential=s["potential"])
    errors = []
    prev = 0
    for step in sorted(save_steps):
        if step > prev:
            prop.propagate(s["potential"], s["dt"], step - prev)
            prev = step
        psi_sc = prop.wavefunction(x_sub)
        diff = psi_sc - psi_qm[step][::stride]
        errors.append(float(np.sqrt(np.sum(np.abs(diff) ** 2) * dx_sub)))
    return errors


def test_hk_wavefunction_evolution_vs_qm(setup_1d):
    """|psi_HK(x,t) - psi_QM(x,t)| stays small along the propagation —
    the wavefunction itself, not just its norm at t=0."""
    s = setup_1d
    prop = HermanKlukPropagator(s["Gamma_i"], s["Gamma_i"])
    save = [0, s["nt"] // 3, 2 * s["nt"] // 3, s["nt"] - 1]
    errors = _wavefunction_evolution_errors(prop, s, save)
    # ||psi|| = 1, so these are relative errors
    assert max(errors) < 0.1, errors


def test_wm_wavefunction_evolution_vs_qm(setup_1d):
    """Same gate for the WM wavefunction (wm_wavefunction path)."""
    s = setup_1d
    prop = WaltonManolopoulosPropagator(s["Gamma_i"], s["Gamma_i"],
                                        alpha=100.0, beta=100.0)
    save = [0, s["nt"] // 3, 2 * s["nt"] // 3, s["nt"] - 1]
    errors = _wavefunction_evolution_errors(prop, s, save)
    assert max(errors) < 0.1, errors


def test_wm_norm_impl_cross_check(setup_1d):
    """wm_norm must give the same value on the Schur ('jax') path as on
    the pivoted-LU ('xla') path — `auto` may pick either per backend."""
    from semiclassical_jax import linalg as L

    s = setup_1d
    prop = WaltonManolopoulosPropagator(s["Gamma_i"], s["Gamma_i"],
                                        alpha=100.0, beta=100.0)
    prop.initial_conditions(s["q0"], s["p0"], s["Gamma_0"], ntraj=512,
                            key=3, potential=s["potential"])
    prop.propagate(s["potential"], s["dt"], 5)
    try:
        L.set_linalg_impl("xla")
        n_xla = prop.norm()
        L.set_linalg_impl("jax")
        n_jax = prop.norm()
    finally:
        L.set_linalg_impl("auto")
    assert abs(n_xla - n_jax) < 1e-8 * max(1.0, abs(n_xla))


def test_hk_wavefunction_norm_on_grid(setup_1d):
    """The grid-evaluated HK wavefunction integrates to ~1 at t=0."""
    s = setup_1d
    prop = HermanKlukPropagator(s["Gamma_i"], s["Gamma_i"])
    prop.initial_conditions(s["q0"], s["p0"], s["Gamma_0"], ntraj=20000,
                            key=1, potential=s["potential"])
    x = np.linspace(-5.0, 20.0, 2000)[:, None]
    psi = prop.wavefunction(x)
    dx = x[1, 0] - x[0, 0]
    norm = np.sqrt(np.sum(np.abs(psi) ** 2) * dx)
    assert abs(norm - 1.0) < 0.05
