"""The ('data', 'points') process grid.

Counterpart of ``cloud_transformers_tpu/parallel/mesh.py``.  The JAX
package lays a ``Mesh`` of shape (n_data, n_points) over its devices and
shards the batch rows over 'data' and each cloud's points over 'points';
the port runs one process a grid cell in a ``torch.distributed`` group:

* ``make_mesh(n_data, n_points)`` -> ``Mesh``: world rank
  ``data_index * n_points + points_index`` (the JAX package's
  ``devices.reshape(n_data, n_points)``), with one process group per data
  row (its points ranks, ``points_group``) and one per points column (its
  data ranks, ``data_group``);
* ``shard_batch(mesh, batch, points_axis)`` -> this rank's block: the rows
  of its data index and, along ``points_axis``, the contiguous block of
  its points index (blocks in rank order, as a gather concatenates them);
* ``replicate(mesh, tensors)`` -> a broadcast from rank 0;
* ``with mesh:`` makes the mesh ambient (``current()``), as the JAX
  package's ``with mesh:`` does for its model code
  (``parallel/constrain._ambient_mesh``).  The model code reads it at
  call time: the splat's max all-reduce over the points group, the
  statistics of the normalisations, the Chamfer loss, the replicated
  dropout draws (``parallel/constrain.py`` says how).  With no ambient
  mesh, or one of ``n_points == 1``, every module runs its path without a
  points axis, bit for bit.

The ambient mesh is process-wide, not per thread: autograd runs the
backward (and the recompute of a checkpointed region, ``nn/remat.py``) on
threads of its own, which must see the mesh of the forward.
"""

import numpy as np
import torch
import torch.distributed as dist

from cloud_transformers_tpu_torch.parallel import distributed as pdist

_ambient = []   # the meshes entered by ``with``, the innermost last


class Mesh:
    """This rank's place in an (n_data, n_points) grid of ranks and the
    grid's process groups (``None`` without a process group)."""

    def __init__(self, n_data, n_points, data_index, points_index,
                 points_group=None, data_group=None):
        self.n_data, self.n_points = int(n_data), int(n_points)
        self.data_index, self.points_index = int(data_index), \
            int(points_index)
        self.points_group, self.data_group = points_group, data_group
        self._seed = 0
        self._generators = {}

    @property
    def points_root(self):
        """The world rank of this data row's first points rank."""
        return self.data_index * self.n_points

    def __enter__(self):
        _ambient.append(self)
        return self

    def __exit__(self, *exc):
        _ambient.pop()

    def seed(self, seed):
        """Seed the draws that every points rank of a data row makes alike
        (``constrain.replicated_dropout``) from ``seed`` and the data
        index."""
        self._seed = int(seed) * 1000003 + self.data_index
        self._generators = {}

    def generator(self, device):
        """The data row's generator on ``device``."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        g = self._generators.get(device)
        if g is None:
            g = torch.Generator(device=device).manual_seed(self._seed)
            self._generators[device] = g
        return g

    def __repr__(self):
        return (f"Mesh(data={self.n_data}, points={self.n_points}; rank at "
                f"({self.data_index}, {self.points_index}))")


def make_mesh(n_data=None, n_points=1):
    """The (n_data, n_points) grid over the world (``n_data`` by default
    the world size over ``n_points``).  Every rank must call it, in the
    same order as any other group it makes.  Without a process group of
    more than one rank, the grid of one."""
    world, rank = pdist.world_size(), pdist.rank()
    n_points = int(n_points)
    n_data = world // n_points if n_data is None else int(n_data)
    if n_data * n_points != world:
        raise ValueError(f"a mesh of {n_data} x {n_points} ranks needs a "
                         f"world of {n_data * n_points}, not {world}")
    d, p = divmod(rank, n_points)
    points_group = data_group = None
    if pdist.is_distributed():
        for i in range(n_data):
            g = dist.new_group([i * n_points + j for j in range(n_points)])
            if i == d:
                points_group = g
        for j in range(n_points):
            g = dist.new_group([i * n_points + j for i in range(n_data)])
            if j == p:
                data_group = g
    return Mesh(n_data, n_points, d, p, points_group, data_group)


def current():
    """The ambient mesh (the innermost ``with mesh:``), or ``None``."""
    return _ambient[-1] if _ambient else None


def points_mesh():
    """The ambient mesh where it has a points axis of more than one rank,
    else ``None``: the test every module makes before it runs its
    points-axis path."""
    mesh = current()
    return mesh if mesh is not None and mesh.n_points > 1 else None


def _block(x, axis, index, count, what):
    n = x.shape[axis]
    if n % count:
        raise ValueError(f"{what}: {n} along axis {axis} does not divide "
                         f"into {count} blocks")
    k = n // count
    out = x[(slice(None),) * axis + (slice(index * k, (index + 1) * k),)]
    if isinstance(out, torch.Tensor):
        return out.contiguous()
    return np.ascontiguousarray(out)


def shard_batch(mesh, batch, points_axis=None, global_rows=True):
    """This rank's block of ``batch`` (a dict of numpy arrays or tensors):
    with ``global_rows`` the rows (axis 0) of its data index out of the
    global batch's, and, where ``points_axis`` is given, the contiguous
    block of its points index along that axis of every array that has it.
    Raises where a count does not divide."""
    def take(x):
        if global_rows:
            x = _block(x, 0, mesh.data_index, mesh.n_data, "batch rows")
        if points_axis is not None and x.ndim > points_axis:
            x = _block(x, points_axis, mesh.points_index, mesh.n_points,
                       "points")
        return x
    return {k: take(v) for k, v in batch.items()}


def replicate(mesh, tensors):
    """Every rank's ``tensors`` (a list) as rank 0's, in place; -> the
    list."""
    return pdist.broadcast_tensors_(list(tensors), src=0)


def broadcast_row(mesh, batch):
    """The numpy ``batch`` (a dict of arrays) of this data row's first
    points rank, on every points rank of the row: the points ranks of a
    row then split one batch, however each built its own (an augmentation
    that is not reproducible item for item, threads that share one
    generator)."""
    if mesh.n_points == 1 or not pdist.is_distributed():
        return batch
    keys = list(batch)
    arrays = [np.asarray(batch[k]) for k in keys]
    device = pdist.collective_device()
    tensors = [torch.as_tensor(np.ascontiguousarray(
        a.astype(np.uint8) if a.dtype == bool else a)).to(device)
        for a in arrays]
    pdist.broadcast_tensors_(tensors, src=mesh.points_root,
                             group=mesh.points_group)
    return {k: t.cpu().numpy().astype(a.dtype)
            for k, t, a in zip(keys, tensors, arrays)}
