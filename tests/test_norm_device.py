# coding: utf-8
"""Device-side O(n^2) norm: the block-pair loop as
ONE jitted program (hk.blocked_pair_sum / _pair_sum_device) and, under a
mesh, as a shard_map systolic ring over the `traj` axis
(hk._pair_sum_ring) — SURVEY P4. The host-loop fallback (uneven blocks)
is the round-3 behaviour and serves as the oracle."""

import numpy as np
import jax
import pytest

from semiclassical_jax.parallel import ensemble_mesh
from semiclassical_jax.potentials import MorsePotential
from semiclassical_jax.propagation import (HermanKlukPropagator,
                                           WaltonManolopoulosPropagator)
from semiclassical_jax.propagation.hk import pairwise_norm
from semiclassical_jax.propagation.wm import wm_norm


def _pot(d=3):
    rng = np.random.default_rng(1)
    omega = rng.uniform(0.004, 0.01, size=d)
    nac = rng.uniform(-1.0, 1.0, size=d)
    return MorsePotential.create(omega, np.full(d, 0.02), nac)


def _hk(ntraj=512, key=5, mesh=None, nt=8):
    pot = _pot()
    Gamma = np.diag(np.asarray(pot.omega))
    d = pot.dimensions()
    prop = HermanKlukPropagator(Gamma, Gamma)
    prop.initial_conditions(np.full(d, 0.2), np.zeros(d), Gamma,
                            ntraj=ntraj, key=key, potential=pot, mesh=mesh)
    if nt:
        prop.propagate(pot, 1.0, nt, energy0_es=0.05)
    return prop


def test_hk_device_blocked_equals_host_loop():
    prop = _hk()
    v = prop.coefficients()
    args = (prop.params.csott, prop.state.q, prop.state.p, v)
    n_dev = pairwise_norm(*args, block=128)   # single-jit device loop
    n_host = pairwise_norm(*args, block=100)  # uneven blocks -> host loop
    assert abs(n_dev - n_host) < 1e-10
    assert np.isfinite(n_dev) and n_dev > 0
    # (no |psi| ~ 1 assertion: norm estimates at tiny ensembles are
    # MC-noise dominated — project numerics notes; the host-loop oracle
    # equality above is the contract under test, the physics gates live
    # in tests/test_propagators_1d.py at 50k trajectories)


def test_hk_ring_matches_single_device():
    assert len(jax.devices()) == 8
    mesh = ensemble_mesh()
    p_mesh = _hk(mesh=mesh)
    p_solo = _hk(mesh=None)
    n_ring = p_mesh.norm()
    n_solo = p_solo.norm()
    assert abs(n_ring - n_solo) < 1e-10


def test_hk_ring_blocked_within_shard():
    """Ring path with multiple blocks per shard (n_loc = 128, block 32)."""
    mesh = ensemble_mesh()
    prop = _hk(ntraj=1024, mesh=mesh)
    v = prop.coefficients()
    args = (prop.params.csott, prop.state.q, prop.state.p, v)
    n_ring = pairwise_norm(*args, block=32, mesh=mesh)
    n_dev = pairwise_norm(*args, block=128)
    assert abs(n_ring - n_dev) < 1e-10


def _wm(ntraj=256, key=5, mesh=None, nt=8):
    pot = _pot()
    Gamma = np.diag(np.asarray(pot.omega))
    d = pot.dimensions()
    prop = WaltonManolopoulosPropagator(Gamma, Gamma, 1e4, 1e4)
    prop.initial_conditions(np.full(d, 0.2), np.zeros(d), Gamma,
                            ntraj=ntraj, key=key, potential=pot, mesh=mesh)
    if nt:
        prop.propagate(pot, 1.0, nt, energy0_es=0.05)
    return prop


def test_wm_device_blocked_equals_host_loop():
    prop = _wm()
    log_v, derived = prop._log_coefficients_and_derived()
    args = (prop.params, prop._bc, prop.state, derived, log_v)
    n_dev = wm_norm(*args, block=64)
    n_host = wm_norm(*args, block=100)  # uneven blocks -> host loop
    assert abs(n_dev - n_host) < 1e-10
    assert np.isfinite(n_dev) and n_dev > 0


def test_wm_ring_matches_single_device():
    mesh = ensemble_mesh()
    p_mesh = _wm(mesh=mesh)
    p_solo = _wm(mesh=None)
    assert abs(p_mesh.norm() - p_solo.norm()) < 1e-10


# --- log-space HK norm (r4): range-safe at high mode counts ---


def test_hk_log_coefficients_match_linear():
    """Where the linear scale is finite, exp(log v) must equal
    hk_coefficients to roundoff (the formula is exact bookkeeping)."""
    from semiclassical_jax.propagation.hk import hk_log_coefficients

    prop = _hk()
    c = prop.semiclassical_prefactor()
    lr, li = hk_log_coefficients(prop.params, prop._bc, prop.state, c)
    v_lin = np.asarray(prop.coefficients())
    v_log = np.exp(np.asarray(lr) + 1j * np.asarray(li))
    np.testing.assert_allclose(v_log, v_lin, rtol=1e-12, atol=1e-14)


def test_hk_log_norm_equals_linear_norm():
    from semiclassical_jax.propagation.hk import (hk_log_coefficients,
                                                  pairwise_norm_log)

    prop = _hk()
    v = prop.coefficients()
    n_lin = pairwise_norm(prop.params.csott, prop.state.q, prop.state.p, v,
                          block=128)
    c = prop.semiclassical_prefactor()
    log_v = hk_log_coefficients(prop.params, prop._bc, prop.state, c)
    n_log = pairwise_norm_log(prop.params.csott, prop.state.q,
                              prop.state.p, log_v, block=128)
    assert abs(n_log - n_lin) < 1e-10
    # the propagator's norm() routes through the log path
    assert abs(prop.norm() - n_lin) < 1e-10


def test_hk_log_norm_high_mode_count_mixed_vs_f64():
    """60 modes (the flagship dimensionality): the normalised MC weights
    span exp(+-O(100)) — the linear coefficients() scale is fragile there
    (f32-stored weights can overflow to inf/NaN), while the log-space
    norm combines ONE exponent per pair term and stays a well-defined
    float. NOTE the VALUE at small ensembles is still estimator-variance
    dominated (a single heavy-weight pair dominates the O(n^2) sum —
    project numerics notes: "tiny-n norms are garbage for HK and WM
    alike"; the f64 oracle itself returns ~1e16 here). The contract
    gated is therefore ARITHMETIC: finite, and mixed tracks the f64
    oracle on identical draws."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    d = 60
    from semiclassical_jax.potentials import MorsePotential
    omega = rng.uniform(0.001, 0.014, size=d)
    pot = MorsePotential.create(omega, np.full(d, 0.02),
                                rng.uniform(-1, 1, size=d))
    Gamma = np.diag(omega)

    q0 = rng.uniform(0.1, 0.5, size=d)

    def norm0(dtype, traj_dtype):
        pp = (jax.tree.map(lambda x: x.astype(dtype), pot)
              if dtype == jnp.float32 else pot)
        prop = HermanKlukPropagator(Gamma, Gamma, dtype=dtype,
                                    traj_dtype=traj_dtype)
        prop.initial_conditions(q0, np.zeros(d), Gamma, ntraj=512, key=2,
                                potential=pp)
        return prop.norm()

    n64 = norm0(jnp.float64, jnp.float64)
    nmx = norm0(jnp.float32, jnp.float64)
    assert np.isfinite(n64) and np.isfinite(nmx)
    # estimator-variance-dominated value: gate the arithmetic agreement
    # (one heavy pair dominates both sums identically), not |psi| ~ 1
    assert abs(nmx - n64) / n64 < 5e-2


def test_hk_log_norm_ring_matches_single():
    mesh = ensemble_mesh()
    p_mesh = _hk(mesh=mesh)
    p_solo = _hk(mesh=None)
    assert abs(p_mesh.norm() - p_solo.norm()) < 1e-10


def test_hk_log_wavefunction_matches_linear():
    """The log-space grid evaluation (coherent.wavefunction_log +
    exponent-shift host recombination) must reproduce the linear path
    where the linear coefficients are finite."""
    from semiclassical_jax.coherent import wavefunction

    prop = _hk(ntraj=256)
    d = 3
    rng = np.random.default_rng(8)
    x = rng.normal(0.25, 0.3, size=(12, d))
    psi_log = prop.wavefunction(x)
    v = prop.coefficients()
    import jax.numpy as jnp
    psi_lin = np.asarray(wavefunction(prop.params.wf, prop.state.q,
                                      prop.state.p, v, jnp.asarray(x)))
    np.testing.assert_allclose(psi_log, psi_lin, rtol=1e-10, atol=1e-13)


def test_ring_block_count_selection():
    """The ring must never fall back to one whole-shard block when the
    shard EXCEEDS the requested block size (that materialises an
    (n_loc, n_loc) pair intermediate): a non-dividing shard in
    (block, 2*block] must still use the divisor search."""
    from semiclassical_jax.propagation.hk import _ring_block_count

    assert _ring_block_count(8192, 4096) == 2     # exact multiple
    assert _ring_block_count(4096, 4096) == 1     # exactly one block
    assert _ring_block_count(1000, 4096) == 1     # small shard, one block
    assert _ring_block_count(6144, 4096) == 2     # divisor 3072, NOT nb=1
    assert _ring_block_count(40960, 4096) == 10
    assert _ring_block_count(5000, 4096) == 2     # divisor 2500
    with pytest.raises(ValueError, match="divide"):
        _ring_block_count(4097, 4096)             # 17*241: no usable divisor


def test_blocked_pair_sum_dispatch_chunking_matches():
    """Splitting the pair grid across dispatches (the bound on one
    execution's length) must not change the sum."""
    from semiclassical_jax.propagation.hk import (_hk_norm_block_term,
                                                  blocked_pair_sum)

    prop = _hk()
    v = prop.coefficients()
    args = (prop.params.csott,
            (prop.state.q, prop.state.p, v))
    full = blocked_pair_sum(_hk_norm_block_term, args[0], args[1],
                            block=64, max_pairs_per_dispatch=10**9)
    split = blocked_pair_sum(_hk_norm_block_term, args[0], args[1],
                             block=64, max_pairs_per_dispatch=7)
    assert abs(full - split) < 1e-10 * max(1.0, abs(full))


# ---------------------------------------------------------------------------
# subsampled variance-characterized norm
# ---------------------------------------------------------------------------

def test_hk_subsampled_norm_exhaustive_equals_exact():
    """sample_pairs >= P degenerates to the exact sum with stderr 0."""
    prop = _hk(ntraj=512)
    exact = prop.norm()
    est, err = prop.norm(sample_pairs=10**6, key=0)
    # the subsampled route picks its own block size; values agree to
    # reduction-association roundoff
    assert abs(est - exact) < 1e-9 * max(abs(exact), 1.0)
    assert err == 0.0


def test_hk_subsampled_norm_within_error_bar():
    """Unbiasedness + honest stderr: across independent subsample keys the
    estimates scatter around the exact norm consistently with the
    reported error bars."""
    from semiclassical_jax.propagation.hk import (hk_log_coefficients,
                                                  pairwise_norm_log)

    prop = _hk(ntraj=2048)
    exact = prop.norm()
    c = prop.semiclassical_prefactor()
    log_v = hk_log_coefficients(prop.params, prop._bc, prop.state, c)

    pulls = []
    for key in range(8):
        est, err = pairwise_norm_log(
            prop.params.csott, prop.state.q, prop.state.p, log_v,
            block=128, sample_pairs=40, key=key)
        assert err > 0.0
        pulls.append((est - exact) / err)
    pulls = np.asarray(pulls)
    # 8 standardized pulls: |mean| < 2 and at least ~half inside 2 sigma
    assert abs(pulls.mean()) < 2.0, pulls
    assert (np.abs(pulls) < 3.0).mean() >= 0.75, pulls


def test_wm_subsampled_norm():
    prop = _wm(ntraj=512)
    exact = prop.norm()
    est_full, err_full = prop.norm(sample_pairs=10**6)
    assert abs(est_full - exact) < 1e-9 * max(abs(exact), 1.0)
    assert err_full == 0.0
    # a genuinely subsampled run needs several blocks: call wm_norm with
    # an explicit small block (the ORDERED off-diagonal grid, 8*7 pairs)
    log_v, derived = prop._log_coefficients_and_derived()
    est, err = wm_norm(prop.params, prop._bc, prop.state, derived, log_v,
                       block=64, sample_pairs=20, key=3)
    assert err > 0.0
    assert abs(est - exact) < 5.0 * err, (est, exact, err)
