# coding: utf-8
"""5-mode adiabatic-shift (AS) model validation
(reference tests/test_propagators.py:330-513).

Oracles:
* harmonic case (chi = 0): closed-form analytic k~ic(t) computed in-test
  (eqns. 15-27 of the SI of DOI 10.1039/c9sc05012d);
* anharmonic case (chi = 0.02): precomputed QM correlation table from the
  reference data directory.
"""

import numpy as np
import pytest

from semiclassical_jax import units
from semiclassical_jax.potentials import MorsePotential
from semiclassical_jax.propagation import (
    HermanKlukPropagator,
    WaltonManolopoulosPropagator,
)

NTRAJ = 20000


def _load_as_model(ref_data, anharmonicity):
    data_dir = ref_data / "AnharmonicAS" / "5modes"
    model_file = data_dir / f"AS_model_chi{anharmonicity:.2f}.dat"
    if not model_file.exists():
        pytest.skip(f"{model_file} not available")
    data = np.loadtxt(model_file)
    if data.ndim == 1:
        data = data.reshape(1, -1)

    omega = data[:, 0] / units.hartree_to_wavenumbers
    S = data[:, 1]
    nac = data[:, 2]
    chi = data[:, 3]
    assert (chi == anharmonicity).all()

    dQ = np.sqrt(2.0 * np.abs(S) / omega) * np.sign(S)
    S = np.abs(S)

    nt = 4000 // 40
    t_max = 150.0 / units.autime_to_fs / 40.0
    times = np.linspace(0.0, t_max, nt)
    dt = times[1] - times[0]

    en0 = float(np.sum(0.5 * omega))
    potential = MorsePotential.create(omega, chi, nac)

    if anharmonicity == 0.0:
        # closed-form k~ic(t) for the harmonic AS model
        A = nac * np.sqrt(omega / (2 * S)) * np.sign(dQ)
        B = -nac * np.sqrt(omega * S / 2) * np.sign(dQ)
        ic_qm = np.zeros(nt, dtype=complex)
        for t in range(nt):
            Xt = S * np.exp(-1j * omega * times[t])
            ic_qm[t] = (np.prod(np.exp(-S + Xt))
                        * (np.sum(A * Xt + B) ** 2 + np.sum(A**2 * Xt)))
    else:
        corr_file = data_dir / f"ic_correlation_chi{anharmonicity:.2f}_T0.001.dat"
        if not corr_file.exists():
            pytest.skip(f"{corr_file} not available")
        ic_data = np.loadtxt(corr_file)
        tgrid = ic_data[:, 0] / units.autime_to_fs
        ic_qm = (np.interp(times, tgrid, ic_data[:, 1])
                 + 1j * np.interp(times, tgrid, ic_data[:, 2]))

    return {
        "omega": omega, "dQ": dQ, "times": times, "dt": dt, "nt": nt,
        "potential": potential, "en0": en0, "ic_qm": ic_qm,
    }


def _run(prop_name, s, key=0):
    Gamma = np.diag(s["omega"])
    if prop_name == "WM":
        prop = WaltonManolopoulosPropagator(Gamma, Gamma, alpha=500.0,
                                            beta=500.0)
    else:
        prop = HermanKlukPropagator(Gamma, Gamma)
    q0 = s["dQ"]
    p0 = np.zeros_like(q0)
    prop.initial_conditions(q0, p0, Gamma, ntraj=NTRAJ, key=key,
                            potential=s["potential"])
    cauto, kic = prop.propagate(s["potential"], s["dt"], s["nt"],
                                energy0_es=s["en0"])
    return cauto, kic


@pytest.mark.parametrize("prop_name", ["HK", "WM"])
def test_harmonic_as(ref_data, prop_name):
    s = _load_as_model(ref_data, 0.0)
    cauto, kic = _run(prop_name, s)
    assert abs(cauto[0] - 1.0) < (1e-3 if prop_name == "HK" else 2e-2)
    assert np.allclose(kic, s["ic_qm"], rtol=0.1,
                       atol=0.02 * np.abs(s["ic_qm"]).max())


@pytest.mark.parametrize("prop_name", ["HK", "WM"])
def test_anharmonic_as(ref_data, prop_name):
    s = _load_as_model(ref_data, 0.02)
    cauto, kic = _run(prop_name, s)
    assert np.allclose(kic, s["ic_qm"], rtol=0.1,
                       atol=0.02 * np.abs(s["ic_qm"]).max())
