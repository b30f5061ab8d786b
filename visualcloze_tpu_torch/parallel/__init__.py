"""Multi-card parallelism of the port over torch.distributed (counterpart of
visualcloze_tpu/parallel/): the mesh, the DiT's sharding, GPipe over the
single trunk, and the differentiable collectives they run on."""

from .mesh import AXES, Mesh, auto_mesh, batch_sharding, create_mesh, initialize_distributed, replicated
from .sharding import (constrain_batch, flux_param_spec, make_flux_shardings, replicate_tree,
                       shard_large_params, shard_lora, shard_micro_batches, shard_params)

__all__ = [
    "AXES", "Mesh", "auto_mesh", "batch_sharding", "create_mesh", "initialize_distributed", "replicated",
    "constrain_batch", "flux_param_spec", "make_flux_shardings", "replicate_tree", "shard_large_params",
    "shard_lora", "shard_micro_batches", "shard_params",
]
