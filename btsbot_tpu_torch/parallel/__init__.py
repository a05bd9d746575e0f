"""The (data, model) mesh: data parallelism over ranks and big weights
sharded on the model axis (port of btsbot_tpu.parallel).

``run_training(mesh=)``, ``AlertScorer(mesh=)``, ``predict_dataset`` /
``evaluate(mesh=)``, ``make_train_step(mesh=)`` and ``cli.train --mesh``
take a mesh; ``multihost_check`` and ``dryrun`` drive it across processes.
"""

from .mesh import (
    Mesh,
    batch_sharding,
    initialize_distributed,
    make_mesh,
    replicated,
)
from .sharding import module_shardings, param_spec, shard_module

__all__ = ["Mesh", "batch_sharding", "initialize_distributed", "make_mesh",
           "replicated", "module_shardings", "param_spec", "shard_module"]
