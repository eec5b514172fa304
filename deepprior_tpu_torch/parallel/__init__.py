"""Scale-out: device meshes, the distributed trainer, sharded serving
(counterpart of deepprior_tpu/parallel/).

The reference trains and serves on one GPU.  This package runs the port on
many devices, one process per device under ``torch.distributed``
(multihost.py; torchrun launches them): data-parallel batches and
tensor-parallel FC layers over a ``DeviceMesh`` (mesh.py), the training
loop over it (train_dist.py) and bulk serving over several devices
(serve.py).
"""

from deepprior_tpu_torch.parallel.mesh import (
    batch_axes,
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
)
from deepprior_tpu_torch.parallel.serve import ShardedEstimator
from deepprior_tpu_torch.parallel.train_dist import DistributedTrainer

__all__ = [
    "make_mesh",
    "batch_axes",
    "batch_sharding",
    "param_shardings",
    "replicated",
    "DistributedTrainer",
    "ShardedEstimator",
]
