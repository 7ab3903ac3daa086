# coding: utf-8
"""Semiclassical IVR propagators (Herman-Kluk, Walton-Manolopoulos).

The propagation is pure-functional: a `TrajState` pytree (trajectory axis
leading) is advanced by an RK4 step inside one `lax.scan` over time, emitting
the autocorrelation C(t) and the IC correlation k~ic(t) per step. No host
synchronisation happens inside the time loop.
"""

from semiclassical_jax.propagation.state import TrajState, SignTracker
from semiclassical_jax.propagation.eom import rk4_step
from semiclassical_jax.propagation.hk import HermanKlukPropagator
from semiclassical_jax.propagation.wm import WaltonManolopoulosPropagator

__all__ = [
    "TrajState",
    "SignTracker",
    "rk4_step",
    "HermanKlukPropagator",
    "WaltonManolopoulosPropagator",
]
