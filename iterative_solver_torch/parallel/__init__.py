"""The distribution layer of the port (iterative_solver_tpu/parallel): a
1-D mesh over a ``torch.distributed`` process group, explicit collectives,
and the sharded packed and block-sparse actions. One process per shard
(SPMD); see ``mesh.py`` for the model."""

from . import collectives
from .mesh import (
    DATA_AXIS,
    Mesh,
    Sharding,
    block_sharding,
    init_process_group,
    make_mesh,
    matrix_row_sharding,
    pad_to_multiple,
    replicated,
    vector_sharding,
)
from .sharded_bsr import ShardedBSR, ShardedBSRInt8
from .sharded_symm import ShardedSymmetric

__all__ = [
    "DATA_AXIS",
    "make_mesh",
    "block_sharding",
    "vector_sharding",
    "matrix_row_sharding",
    "replicated",
    "collectives",
    "ShardedBSR",
    "ShardedBSRInt8",
    "ShardedSymmetric",
    "Mesh",
    "Sharding",
    "init_process_group",
    "pad_to_multiple",
]
