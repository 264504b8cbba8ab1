"""Domain decomposition over a mesh of devices and processes (counterpart of
``lb2d_tpu.parallel``): the halo exchange, the multi-process runtime on
``torch.distributed`` and the sharded models, through K9, K6h and K7h
(``SimulationRunner.shard_over`` runs :class:`ShardedRunner`)."""

from .distributed import global_mesh, init_distributed, is_initialized
from .halo import (
    Mesh,
    exchange_bands,
    exchange_halo_2d,
    extend_with_halo,
    gather_bands,
    ring_shift,
)
from .sharded import (
    ShardedCoupled,
    ShardedDiffusion,
    ShardedMultifield,
    ShardedPipeFlow,
    ShardedRunner,
    make_mesh,
    make_sharded_pipe_step,
    make_sharded_temporal_step,
)

__all__ = ["Mesh", "ring_shift", "extend_with_halo", "exchange_halo_2d",
           "exchange_bands", "gather_bands", "ShardedRunner",
           "init_distributed", "global_mesh", "is_initialized", "make_mesh",
           "make_sharded_pipe_step", "make_sharded_temporal_step",
           "ShardedPipeFlow", "ShardedDiffusion", "ShardedMultifield",
           "ShardedCoupled"]
