"""Data-parallel training over ``torch.distributed``: the counterpart of the
JAX package's ``parallel/`` (a mesh of devices there, one process a rank
here)."""

from .mesh import Mesh, launch, make_mesh  # noqa: F401
from .shard import (  # noqa: F401
    shard_pack_cap,
    sharded_density_grid_step,
    sharded_train_step,
)
from .swr_shard import make_swr_sharded_step  # noqa: F401
