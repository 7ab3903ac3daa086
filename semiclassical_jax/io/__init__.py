# coding: utf-8
"""I/O: quantum-chemistry file readers, result accumulation, trajectory export."""

from semiclassical_jax.io.fchk import FormattedCheckpointFile

__all__ = ["FormattedCheckpointFile"]
