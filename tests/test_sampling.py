# coding: utf-8
"""Initial-condition sampling statistics (reference logs these diagnostics
at propagators.py:570-578; here they are asserted)."""

import numpy as np
import jax

from semiclassical_jax.sampling import SamplingParams, sample_initial_conditions


def test_sampling_moments_full_rank():
    d = 3
    rng = np.random.default_rng(0)
    V, _ = np.linalg.qr(rng.random((d, d)))
    e = rng.random(d) + 0.5
    G0 = V @ np.diag(e) @ V.T
    Gi = G0
    q0 = rng.random(d)
    p0 = rng.random(d)

    params = SamplingParams.create(q0, p0, G0, Gi)
    assert params.rank == d
    q, p, log_prob = sample_initial_conditions(params, jax.random.key(0),
                                               200000)
    q, p = np.asarray(q), np.asarray(p)

    # sample means
    assert np.allclose(q.mean(0), q0, atol=0.02)
    assert np.allclose(p.mean(0), p0, atol=0.02)

    # analytic covariances: cov(q) = [2 Gi (Gi+G0)^{-1} G0]^{-1},
    # cov(p) = (Gi+G0)/2
    cov_q_expected = np.linalg.inv(2 * Gi @ np.linalg.inv(Gi + G0) @ G0)
    cov_p_expected = (Gi + G0) / 2
    assert np.allclose(np.cov(q.T), cov_q_expected, atol=0.03)
    assert np.allclose(np.cov(p.T), cov_p_expected, atol=0.03)

    # log densities are finite and O(d)
    assert np.isfinite(np.asarray(log_prob)).all()


def test_sampling_statistics_runtime_diagnostic(caplog):
    """The live mean/cov deviation readout must be small for a healthy
    sampler and appear in the initial_conditions log."""
    import logging

    from semiclassical_jax.sampling import sampling_statistics

    d = 2
    G0 = np.diag([1.0, 0.6])
    q0 = np.array([0.3, -0.2])
    p0 = np.array([0.1, 0.0])
    params = SamplingParams.create(q0, p0, G0, G0)
    q, p, _ = sample_initial_conditions(params, jax.random.key(3), 100000)
    mean_dev, cov_dev = sampling_statistics(params, q, p)
    assert mean_dev < 0.02
    assert cov_dev < 0.03

    # surfaced at run time by initial_conditions (reference
    # propagators.py:570-578)
    from semiclassical_jax.potentials import MorsePotential
    from semiclassical_jax.propagation import HermanKlukPropagator

    pot = MorsePotential.create(np.array([0.01, 0.008]),
                                np.array([0.02, 0.02]),
                                np.array([0.5, -0.3]))
    Gamma = np.diag([0.01, 0.008])
    prop = HermanKlukPropagator(Gamma, Gamma)
    with caplog.at_level(logging.INFO):
        prop.initial_conditions(q0, p0, Gamma, ntraj=512, key=0,
                                potential=pot)
    assert "cov(z) - analytic" in caplog.text


def test_sampling_zero_modes():
    """Zero-frequency modes are excluded: samples stay at the center."""
    d = 4
    rng = np.random.default_rng(1)
    V, _ = np.linalg.qr(rng.random((d, d)))
    e = np.array([1.0, 0.7, 0.5, 0.0])
    G0 = V @ np.diag(e) @ V.T
    q0 = rng.random(d)
    p0 = np.zeros(d)

    params = SamplingParams.create(q0, p0, G0, G0)
    assert params.rank == 3
    q, p, log_prob = sample_initial_conditions(params, jax.random.key(0),
                                               5000)
    # displacement along the zero mode is identically zero
    null_vec = V[:, 3]
    dq = np.asarray(q) - q0
    assert np.abs(dq @ null_vec).max() < 1e-10
    assert np.abs(np.asarray(p) @ null_vec).max() < 1e-10
