"""Data- and point-parallel execution across processes.

Counterpart of ``cloud_transformers_tpu/parallel``.  The JAX package lays a
``('data', 'points')`` mesh over its devices and lets GSPMD insert the
collectives; the port runs one process per device (or several on one card,
over gloo) in a ``torch.distributed`` process group and needs no ``Mesh``
object.  JAX package -> port:

* ``distributed_init`` (``jax.distributed.initialize``) ->
  ``distributed_init`` (``torch.distributed.init_process_group``), from
  the command lines' ``--coordinator/--num-processes/--process-id``
  (``add_cli_flags``, ``init_from_args``; ``torchrun``'s environment too);
* ``make_mesh(n_data)`` -> the process group, one rank a data shard;
* ``shard_batch`` -> ``data.DataLoader(process_index, process_count)``:
  rank p takes the rows [p*bs, (p+1)*bs) of each global batch;
* ``replicate`` -> ``Trainer`` broadcasts parameters and buffers from
  rank 0;
* ``data_sharding`` -> nothing: a tensor lives on its rank's device;
* GSPMD's gradient all-reduce -> ``Trainer.average_gradients``;
* GSPMD's global BatchNorm statistics -> ``nn.norm.BatchNorm``;
* ``parallel/point_sharded.py`` -> ``parallel/point_sharded.py`` over a
  process ``group``;
* ``parallel/constrain.py`` -> nothing: it works around an XLA
  partitioner bug that eager PyTorch does not meet;
* the serving mesh (``serve.py``) -> ``InferenceEngine(devices=[...])``,
  one replica a device.
"""

from cloud_transformers_tpu_torch.parallel.distributed import (
    add_cli_flags,
    distributed_init,
    init_from_args,
    is_distributed,
    is_main_process,
    process_device,
    rank,
    world_size,
)
from cloud_transformers_tpu_torch.parallel.point_sharded import (
    chamfer_point_sharded,
    f_score_point_sharded,
    slice_grid_point_sharded,
    splat_max_point_sharded,
)

__all__ = ["add_cli_flags", "distributed_init", "init_from_args",
           "is_distributed", "is_main_process", "process_device", "rank",
           "world_size", "chamfer_point_sharded", "f_score_point_sharded",
           "slice_grid_point_sharded", "splat_max_point_sharded"]
