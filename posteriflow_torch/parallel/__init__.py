"""The port's process grid over torch.distributed (parallel/mesh.py)."""

from posteriflow_torch.parallel.mesh import (init_distributed, make_mesh,
                                             shard_batch)

__all__ = ["init_distributed", "make_mesh", "shard_batch"]
