from .mesh import make_mesh, pad_scene_to_devices
from .sharded import make_sharded_step, shard_state
from .halo import (
    make_halo_fast_multi_step,
    make_halo_session,
    measure_halo_pad,
    measure_migration_pad,
)

__all__ = [
    "make_mesh",
    "pad_scene_to_devices",
    "make_sharded_step",
    "make_halo_fast_multi_step",
    "make_halo_session",
    "measure_halo_pad",
    "measure_migration_pad",
    "shard_state",
]
