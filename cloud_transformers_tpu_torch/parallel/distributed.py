"""Multi-process initialisation and the collectives the port builds on.

Counterpart of ``cloud_transformers_tpu/parallel/distributed.py``: where the
JAX package calls ``jax.distributed.initialize`` from the command lines'
``--coordinator/--num-processes/--process-id``, the port calls
``torch.distributed.init_process_group`` with the same three values.
Under ``torchrun`` (``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` in the
environment) the command lines take them from there, through the
launcher's own store (``env://``).

The default backend is NCCL on CUDA and gloo on the CPU; ``backend`` names
either.  The rendezvous has a finite ``timeout``, so a rank that dies makes
its peers fail instead of hanging them, and a failed rendezvous raises: no
caller carries on as a single process.

The port's collectives are built on ``all_reduce`` and ``broadcast`` only,
so that one code path runs over NCCL and over gloo with CUDA tensors (two
processes on one card, where NCCL refuses two ranks on one device).  An
all-gather is an all-reduce SUM of a zeroed buffer that each rank fills in
its own block: adding zeros is exact.  Every helper is the identity where
no process group of more than one rank is active.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600


def distributed_init(coordinator, num_processes, process_id, backend=None,
                     device="cuda", timeout_s=DEFAULT_TIMEOUT_S):
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``.

    ``coordinator`` is ``host:port`` (a TCP rendezvous whose rank 0 listens
    there) or a URL that ``init_process_group`` takes as it is
    (``file:///path``, ``env://``).  ``backend``: ``"nccl"`` or ``"gloo"``;
    by default NCCL where ``device`` is a CUDA device, gloo otherwise.  On
    CUDA the rank's device becomes the current one before the group is
    made.  -> the rank's device (``process_device(device)``)."""
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dev = process_device(device, rank=process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=url, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


def is_distributed():
    """Whether a process group of more than one rank is active."""
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def rank():
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def world_size():
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def is_main_process():
    return rank() == 0


def local_rank(global_rank=None):
    """The rank among this host's processes: ``LOCAL_RANK`` where a
    launcher set it, else the global rank modulo the host's CUDA devices
    (ranks numbered host by host, one card each; several ranks share a
    card where there are fewer cards than ranks)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    r = rank() if global_rank is None else int(global_rank)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return r % max(n, 1)


def process_device(kind="cuda", rank=None):
    """This process's device: the CPU for ``"cpu"``, the device itself for
    an indexed one (``"cuda:1"``), else ``cuda:{local_rank}``."""
    dev = torch.device(kind)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", local_rank(rank))


def process_rows():
    """``data.DataLoader``'s ``process_index`` and ``process_count`` for
    this process."""
    return {"process_index": rank(), "process_count": world_size()}


# --- the command lines' flags ------------------------------------------------

def add_cli_flags(ap):
    """The JAX command lines' multi-host flags, and the backend's."""
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous (or a URL such "
                         "as file:///path); with --num-processes and "
                         "--process-id")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl on CUDA, gloo on the CPU")


def init_from_args(args):
    """Join the group that the command line names (``--coordinator``, or
    ``torchrun``'s environment); -> the device this process trains on
    (``args.device`` with the local rank's index)."""
    coordinator, n, pid = args.coordinator, args.num_processes, \
        args.process_id
    if coordinator is None and "RANK" in os.environ and \
            "WORLD_SIZE" in os.environ:
        coordinator, n, pid = ("env://", int(os.environ["WORLD_SIZE"]),
                               int(os.environ["RANK"]))
    if coordinator is None:
        return process_device(args.device)
    if n is None or pid is None:
        raise ValueError("--coordinator needs --num-processes and "
                         "--process-id")
    return distributed_init(coordinator, n, pid, backend=args.dist_backend,
                            device=args.device)


# --- collectives on all_reduce and broadcast ---------------------------------

def all_reduce_(t, op="sum", group=None):
    """In-place all-reduce of ``t`` (``"sum"``, ``"max"`` or ``"mean"``);
    -> ``t``.  The identity without a group of more than one rank."""
    if not is_distributed():
        return t
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    dist.all_reduce(t, op=red, group=group)
    if op == "mean":
        t.div_(dist.get_world_size(group))
    return t


def broadcast_tensors_(tensors, src=0, group=None):
    """Broadcast a list of tensors from ``src`` (one collective per dtype);
    -> the list, overwritten in place on the other ranks."""
    if not is_distributed():
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.broadcast(flat, src=src, group=group)
        i = 0
        for t in same:
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()
    return tensors


def gather_sizes(n, device, group=None):
    """Every rank's ``n`` (an int), in rank order, on every rank."""
    if not is_distributed():
        return [int(n)]
    sizes = torch.zeros(dist.get_world_size(group), dtype=torch.int64,
                        device=device)
    sizes[dist.get_rank(group)] = int(n)
    all_reduce_(sizes, "sum", group)
    return [int(s) for s in sizes.tolist()]


def _gather_rows(x, dim, group):
    """(the ranks' ``x`` concatenated along ``dim`` in rank order, where
    this rank's block starts)."""
    sizes = gather_sizes(x.shape[dim], x.device, group)
    r = dist.get_rank(group)
    shape = list(x.shape)
    shape[dim] = sum(sizes)
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    start = sum(sizes[:r])
    out.narrow(dim, start, sizes[r]).copy_(x)
    return all_reduce_(out, "sum", group), start


def all_gather_rows(x, dim=0, group=None):
    """The ranks' ``x`` concatenated along ``dim`` in rank order (blocks may
    differ in length along ``dim``), on every rank: an all-reduce SUM of a
    zeroed buffer in which each rank fills its own block.  Not
    differentiable (``AllGatherRows`` is)."""
    if not is_distributed():
        return x
    return _gather_rows(x, dim, group)[0]


class AllGatherRows(torch.autograd.Function):
    """``all_gather_rows`` with its transpose as the backward: each rank's
    block of the summed cotangent (the gathered tensor is used differently
    on each rank, so each holds a partial cotangent)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.n, ctx.start = dim, group, x.shape[dim], 0
        if not is_distributed():
            return x.view_as(x)
        out, ctx.start = _gather_rows(x, dim, group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = all_reduce_(g.contiguous().clone(), "sum", ctx.group)
        return g.narrow(ctx.dim, ctx.start, ctx.n), None, None


class AllReduceSum(torch.autograd.Function):
    """The sum over ranks of a per-rank partial, replicated on every rank.
    Its backward sums the cotangent over ranks too: every rank's loss
    reads the replicated sum, so each rank's partial feeds all of them
    (the gradient of the sum of the ranks' losses)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), "sum", ctx.group), None


def barrier(group=None):
    if is_distributed():
        dist.barrier(group=group)


def destroy():
    """Leave the process group, where there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def collective_device():
    """Where a host value goes for a collective: the current CUDA device
    under NCCL, the CPU under gloo."""
    if is_distributed() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_array(a, op="sum", group=None):
    """``all_reduce_`` of a copy of the numpy array ``a`` (float64 kept);
    -> a numpy array, ``a`` itself without a group of more than one
    rank."""
    if not is_distributed():
        return a
    t = torch.tensor(a, device=collective_device())
    return all_reduce_(t, op, group).cpu().numpy()


def all_gather_array(a, group=None):
    """``all_gather_rows`` of a numpy array along its first axis; -> a
    numpy array, ``a`` itself without a group of more than one rank."""
    if not is_distributed():
        return a
    a = np.asarray(a)
    t = torch.tensor(a.astype(np.uint8) if a.dtype == bool else a,
                     device=collective_device())
    return all_gather_rows(t, 0, group).cpu().numpy().astype(a.dtype)
