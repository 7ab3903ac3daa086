# coding: utf-8
"""Test configuration.

Two tiers:

* default — CPU backend with 8 virtual devices, so multi-device sharding is
  exercised without a GPU. The flags must be set before the first backend
  use (jax itself may already be imported by the environment).
* ``SEMI_GPU_TESTS=1`` — the GPU tier: the backend is left as the
  environment provides it and ONLY tests marked ``@pytest.mark.gpu`` run;
  the CPU suite is skipped. Usage, on a machine with an NVIDIA GPU:

      SEMI_GPU_TESTS=1 python -m pytest tests/ -q -m gpu

  (`python chip_smoke.py` runs the same tests in its own process.) The
  full-scale methylium parity gate additionally wants
  ``SEMI_FULL_PARITY=1`` (50k trajectories x 2000 steps).

Whether a GPU is present is decided in the ``on_gpu`` session fixture,
never while a module is imported or collected.
"""

import os
import pathlib
import sys

GPU_TIER = os.environ.get("SEMI_GPU_TESTS") == "1"

if not GPU_TIER:
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from semiclassical_jax import hostcache  # noqa: E402

if GPU_TIER:
    hostcache.use_compile_cache()
else:
    jax.config.update("jax_platforms", "cpu")
    # NO persistent compilation cache on the CPU tier: the suite crashed
    # reproducibly inside the cache's executable (de)serialization (see
    # semiclassical_jax.hostcache.disable_persistent_cache)
    hostcache.disable_persistent_cache()
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# Reference test fixtures (fchk files, sGDML model, QM correlation tables).
# Preferred source: the read-only reference checkout when mounted (or
# SEMI_REF_DATA). Fallback: the vendored trimmed tree tests/data/refdata
# (built by scripts/vendor_fixtures.py), which makes the suite
# self-contained — only the torch-parity tests, which need the reference
# *code*, still skip without the mount.
REF_DATA = pathlib.Path(
    os.environ.get("SEMI_REF_DATA", "/root/reference/tests/DATA")
)
VENDORED_DATA = pathlib.Path(__file__).parent / "data" / "refdata"


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled programs between test modules on the CPU tier.

    The full suite accumulates thousands of distinct XLA CPU executables
    in one process; past a threshold the NEXT compilation segfaults
    inside XLA (observed deterministically late in the suite in
    test_sharding's WM scan, while any subset of the suite passes — the
    same class of in-process compiler-state fragility as the persistent-
    cache crashes, hostcache.py). Recompiles within a module are cheap on
    CPU; between-module clearing keeps the live-executable count bounded."""
    yield
    if not GPU_TIER:
        jax.clear_caches()


@pytest.fixture(scope="session")
def on_gpu():
    """True when the JAX backend of this session is a GPU."""
    return jax.default_backend() == "gpu"


@pytest.fixture(autouse=True)
def _tier(request):
    """Run each test in its tier only: `gpu`-marked tests on a GPU under
    SEMI_GPU_TESTS=1, everything else on the CPU tier."""
    if request.node.get_closest_marker("gpu") is None:
        if GPU_TIER:
            pytest.skip("CPU suite is skipped under SEMI_GPU_TESTS=1")
        return
    if not GPU_TIER:
        pytest.skip("GPU tier — run with SEMI_GPU_TESTS=1 on a machine "
                    "with an NVIDIA GPU (or python chip_smoke.py)")
    if not request.getfixturevalue("on_gpu"):
        pytest.skip(f"needs a GPU backend, have {jax.default_backend()}")
    if (request.node.get_closest_marker("full_parity") is not None
            and os.environ.get("SEMI_FULL_PARITY") != "1"):
        pytest.skip("full-scale parity gate — additionally set "
                    "SEMI_FULL_PARITY=1")


@pytest.fixture(scope="session")
def ref_data():
    if REF_DATA.is_dir():
        return REF_DATA
    if VENDORED_DATA.is_dir():
        return VENDORED_DATA
    pytest.skip(f"neither {REF_DATA} nor the vendored fixture tree "
                f"{VENDORED_DATA} is available")
