"""sph_jax — a PCISPH framework on JAX (Electrofluid / contractile SPH).

A from-scratch JAX/XLA/Pallas re-design of the OpenWorm Electrofluid
simulator's capabilities: PCISPH fluid, elastic spring matter, triangular
membranes, muscle activation, scene generation/IO, checkpointing, and
multi-chip spatial sharding.
"""
from .config import DEFAULT_PARAMS, SimParams
from .constants import (
    BOUNDARY_PARTICLE,
    ELASTIC_PARTICLE,
    LIQUID_PARTICLE,
    MAX_NEIGHBORS,
    MUSCLE_COUNT,
)
from .core.state import FluidState, Membranes, Springs, make_state
from .core.step import SceneLayout, multi_step, simulation_step

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_PARAMS",
    "SimParams",
    "FluidState",
    "Springs",
    "Membranes",
    "SceneLayout",
    "make_state",
    "simulation_step",
    "multi_step",
    "LIQUID_PARTICLE",
    "ELASTIC_PARTICLE",
    "BOUNDARY_PARTICLE",
    "MAX_NEIGHBORS",
    "MUSCLE_COUNT",
]
