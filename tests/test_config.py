# coding: utf-8
"""Task-schema validation tests."""

import pytest

from semiclassical_jax.config import ConfigurationError, validate_task


def _dyn_task(**over):
    task = {
        "task": "dynamics",
        "potential": {"type": "anharmonic AS", "model_file": "model.dat"},
        "num_steps": 100,
        "time_step_fs": 0.005,
        "results": {"correlations": "c.npz"},
    }
    task.update(over)
    return task


def test_valid_dynamics():
    validate_task(_dyn_task())


def test_valid_rates():
    validate_task({"task": "rates", "broadening": "gaussian"})


def test_unknown_task_type():
    with pytest.raises(ConfigurationError):
        validate_task({"task": "dance"})


def test_missing_required():
    with pytest.raises(ConfigurationError):
        validate_task(_dyn_task(num_steps=None) | {"num_steps": 100,
                                                   "potential": {"type": "harmonic"}})


def test_wrong_type():
    with pytest.raises(ConfigurationError):
        validate_task(_dyn_task(num_steps="many"))


def test_bad_propagator():
    with pytest.raises(ConfigurationError):
        validate_task(_dyn_task(propagator="XYZ"))


def test_bad_broadening():
    with pytest.raises(ConfigurationError):
        validate_task({"task": "rates", "broadening": "boxcar"})


def test_gdml_without_optional_hess_dtype_is_valid():
    # regression: hess_dtype is resolved with .get at the use site
    # (cli.py _build_potential) and must not be demanded by the schema
    validate_task(_dyn_task(potential={
        "type": "gdml", "ground": "model.npz", "excited": "s1.fchk",
        "coupling": "nacs.fchk"}))


def test_gdml_with_hess_dtype_still_valid():
    validate_task(_dyn_task(potential={
        "type": "gdml", "ground": "model.npz", "excited": "s1.fchk",
        "coupling": "nacs.fchk", "hess_dtype": "float32"}))


@pytest.mark.parametrize("mode,ok", [("f64", True), ("ozaki", False),
                                     ("bf16", False)])
def test_gdml_eg_mode_only_f64(mode, ok):
    """sGDML energies/gradients always run in float64: a config asking for
    another arithmetic is refused, never silently run in f64."""
    task = _dyn_task(potential={
        "type": "gdml", "ground": "model.npz", "excited": "s1.fchk",
        "coupling": "nacs.fchk", "eg_mode": mode})
    if ok:
        validate_task(task)
    else:
        with pytest.raises(ConfigurationError, match="eg_mode"):
            validate_task(task)


def test_gdml_missing_required_ground():
    with pytest.raises(ConfigurationError):
        validate_task(_dyn_task(potential={
            "type": "gdml", "excited": "s1.fchk", "coupling": "nacs.fchk"}))


def test_unknown_key_warns(caplog):
    import logging

    with caplog.at_level(logging.WARNING):
        validate_task(_dyn_task(num_trajectoriess=100))
    assert "num_trajectoriess" in caplog.text
    assert "num_trajectories" in caplog.text  # close-match hint


def test_example_configs_validate():
    """Every committed example config must pass schema validation — keeps
    the documented production commands from drifting out of sync with
    config.py (a key rename that misses an example would otherwise only
    surface on a user's machine)."""
    import glob
    import json
    import os

    from semiclassical_jax.config import validate_task

    root = os.path.join(os.path.dirname(__file__), "..", "examples")
    files = sorted(glob.glob(os.path.join(root, "**", "semi*.json"),
                             recursive=True))
    assert files, "no example configs found"
    for fn in files:
        with open(fn) as f:
            cfg = json.load(f)
        assert "semi" in cfg, fn
        for task in cfg["semi"]:
            validate_task(task)
