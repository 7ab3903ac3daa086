# coding: utf-8
"""Tracing / profiling / metrics.

The reference has no profiling subsystem (SURVEY §5: tqdm progress and ad-hoc
wall-clock logs only). This module provides the equivalent:

* `trace(logdir)` — context manager around the JAX/XLA profiler; the
  resulting trace opens in TensorBoard/XProf and shows per-kernel device
  time (fusion boundaries, kernel durations);
* `PhaseTimer` — wall-clock accounting per phase (sample / compile / scan /
  reduce / io) with a throughput summary in trajectory-steps/sec/chip, the
  benchmark metric;
* `RunMetrics` — structured per-run metrics (energy drift, |C(t)| extrema,
  NaN flags) gathered once per batch on the host, never per step;
* `device_info` — what a measurement ran on, for every printed number.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field

import numpy as np

logger = logging.getLogger(__name__)

__all__ = ["trace", "PhaseTimer", "RunMetrics", "device_info"]

NVIDIA_SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader")


def device_info():
    """JAX's platform, device kind and device count, and each card's name
    and power limit as `nvidia-smi` reports them (None without it). A card
    set below its maximum power runs slower under load, so every timing is
    kept beside these."""
    import subprocess

    import jax

    devs = jax.devices()
    try:
        smi = subprocess.run(list(NVIDIA_SMI_QUERY), capture_output=True,
                             text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = None
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "nvidia_smi": smi}


@contextlib.contextmanager
def trace(logdir):
    """Capture a JAX profiler trace into `logdir` (view with xprof/TensorBoard)."""
    import jax

    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Accumulates wall-clock per phase; computes the throughput metric."""

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0)

    def throughput(self, ntraj, nsteps, nchips=1, phase="scan"):
        """trajectory-steps/sec/chip for the given phase."""
        wall = self.phases.get(phase, 0.0)
        if wall <= 0:
            return float("nan")
        return ntraj * nsteps / wall / nchips

    def summary(self):
        return dict(self.phases)

    def log(self, ntraj=None, nsteps=None, nchips=1):
        for name, wall in sorted(self.phases.items()):
            logger.info(f"  phase {name:10s}: {wall:9.3f} s")
        if ntraj and nsteps:
            logger.info(
                f"  throughput: "
                f"{self.throughput(ntraj, nsteps, nchips):,.0f} "
                "traj-steps/s/chip")


@dataclass
class RunMetrics:
    """Structured per-batch physics diagnostics (SURVEY §5 observability)."""

    energy_drift_max: float = float("nan")
    c0_deviation: float = float("nan")
    abs_c_max: float = float("nan")
    abs_kic_max: float = float("nan")
    nan_detected: bool = False
    norm_samples: dict = field(default_factory=dict)

    @staticmethod
    def from_run(energies, cauto, kic):
        energies = np.asarray(energies)
        cauto = np.asarray(cauto)
        kic = np.asarray(kic)
        drift = np.abs(np.diff(energies)).max() if energies.size > 1 else 0.0
        return RunMetrics(
            energy_drift_max=float(drift),
            c0_deviation=float(abs(cauto[0] - 1.0)),
            abs_c_max=float(np.abs(cauto).max()),
            abs_kic_max=float(np.abs(kic).max()),
            nan_detected=bool(np.isnan(cauto).any() or np.isnan(kic).any()
                              or np.isnan(energies).any()),
        )

    def to_json(self):
        d = self.__dict__.copy()
        return json.dumps(d)

    def log(self):
        logger.info(f"  metrics: {self.to_json()}")
