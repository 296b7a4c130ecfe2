"""Data- and point-parallel execution across processes.

Counterpart of ``cloud_transformers_tpu/parallel``.  The JAX package lays a
``('data', 'points')`` mesh over its devices and lets GSPMD insert the
collectives; the port runs one process per device (or several on one card,
over gloo) in a ``torch.distributed`` process group, laid out as a data x
points grid where the points are split too (``parallel/mesh.py``), and
makes the collectives itself.  JAX package -> port:

* ``distributed_init`` (``jax.distributed.initialize``) ->
  ``distributed_init`` (``torch.distributed.init_process_group``), from
  the command lines' ``--coordinator/--num-processes/--process-id``
  (``add_cli_flags``, ``init_from_args``; ``torchrun``'s environment too);
* ``make_mesh(n_data, n_points)`` -> ``parallel/mesh.make_mesh``: the
  (data, points) grid of ranks and its process groups; ``with mesh:``
  makes it ambient for the model code;
* ``shard_batch`` -> ``data.DataLoader(process_index, process_count)``:
  a data row's ranks take the rows [d*bs, (d+1)*bs) of each global batch
  (``distributed.process_rows``), and ``mesh.shard_batch`` this rank's
  block of the points (``Trainer(mesh=...)``);
* ``replicate`` -> ``Trainer`` broadcasts parameters and buffers from
  rank 0 (``mesh.replicate``);
* ``data_sharding`` -> nothing: a tensor lives on its rank's device;
* GSPMD's gradient all-reduce -> ``Trainer.average_gradients``;
* GSPMD's global BatchNorm statistics -> ``nn.norm.BatchNorm``;
* ``parallel/point_sharded.py`` -> ``parallel/point_sharded.py`` over a
  process ``group``;
* ``parallel/constrain.py`` -> ``parallel/constrain.py``: where the
  model crosses between per-point and replicated tensors under a points
  axis (the splat's max all-reduce, the replicated BatchNorms and
  dropout), with every collective's backward the sum of the ranks'
  cotangents, so that no gradient is counted ``n_points`` times (the
  XLA partitioner's fault that the JAX module pins);
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
from cloud_transformers_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    shard_batch,
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
           "slice_grid_point_sharded", "splat_max_point_sharded",
           "make_mesh", "replicate", "shard_batch"]
