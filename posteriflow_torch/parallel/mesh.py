"""The process grid (torch.distributed): process groups, a ('data', 'model')
DeviceMesh, a batch's rows by rank, and the collectives the sharded paths
differentiate through.

Port of posteriflow_tpu/parallel/mesh.py. JAX shards one program over the
devices of a Mesh and lets GSPMD insert the collectives; torch runs one
process a device (NCCL on cards, gloo on the CPU) and every sharded path
calls its collectives itself:

  - "data" splits the batch: each rank simulates and trains its rows,
    and the gradients are summed over the group (`all_reduce_grads`);
  - "model" splits the long-BNS token sequence (models/long_bns.py):
    queries stay local, keys and values are gathered (`all_gather_seq`),
    and the pooled context is averaged over the group (`all_reduce_sum`).

Ranks are laid out process-major, as JAX lays out devices: rank r sits at
(r // model_parallel, r % model_parallel). JAX's `batch_sharding` and
`replicated` return shardings for jit to place arrays by; a torch tensor
has no placement to annotate, so they have no counterpart here:
`shard_batch` hands each rank its rows instead.
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.utils._pytree import tree_map

log = logging.getLogger("posteriflow.parallel")

BUCKET_ELEMS = 1 << 24     # entries of one all-reduce in all_reduce_grads


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str = "cuda",
                     backend: Optional[str] = None) -> int:
    """Join the default process group (idempotent); returns the world size.

    The arguments default to torch's launcher environment (torchrun sets
    MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK and LOCAL_RANK).
    `coordinator_address` is an init_method URL (tcp://host:port or
    file:///path) or a bare host:port. The backend is NCCL on "cuda", each
    rank bound to cuda:LOCAL_RANK (the process id where no LOCAL_RANK is
    set), and gloo on "cpu"; `backend="gloo"` on "cuda" keeps every rank on
    the current card (NCCL takes no two ranks on one card). With nothing
    configured it returns 1 and creates no group."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env \
            and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return 1
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_distributed needs an address, the number of "
                         "processes and this process's id (or torchrun's "
                         "environment)")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)))
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)
    log.info("torch.distributed (%s): rank %d of %d", backend, process_id,
             num_processes)
    return num_processes


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("data", "model"),
              model_parallel: int = 1) -> DeviceMesh:
    """A DeviceMesh over every rank of the default group, of shape
    (world / model_parallel, model_parallel), ranks process-major.
    n_devices must be None or the world size (a mesh that left a rank out
    would leave that process without a coordinate), and the world size
    must divide by model_parallel. Needs `init_distributed` first (a
    one-process run joins a group of one)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed (or run under torchrun) first")
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(
            f"a multi-process mesh must use all {n} ranks; got "
            f"n_devices={n_devices} (a truncated mesh would drop some "
            "process's device)")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // model_parallel,
                                          model_parallel),
                            mesh_dim_names=tuple(axis_names))


def shard_rows(n: int, mesh: DeviceMesh, axis: str = "data") -> slice:
    """This rank's rows of a leading dim of n along `axis`: its block of
    the axis's equal blocks, in rank order. JAX's GSPMD pads a dim that
    does not divide; the port's shards are equal, so it raises there."""
    size = mesh[axis].size()
    if n % size:
        raise ValueError(f"a leading dim of {n} does not divide over the "
                         f"{size} ranks of the {axis!r} axis (the JAX "
                         "package shards it unevenly; the port's shards "
                         "are equal)")
    loc = n // size
    i = mesh.get_local_rank(axis)
    return slice(i * loc, (i + 1) * loc)


def shard_batch(mesh: DeviceMesh, tree):
    """This rank's rows along "data" of every tensor of a tree (tensors,
    tuples, NamedTuples, lists, dicts) with a leading batch dim; 0-d
    tensors and other leaves are kept."""
    def rows(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        return x[shard_rows(x.shape[0], mesh)]
    return tree_map(rows, tree)


class _AllReduceSum(torch.autograd.Function):
    """Σ over the group's ranks; its backward sums the incoming gradients
    over the group (each rank's output depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """The group's shards concatenated along `dim` in rank order; its
    backward gives each rank its slice of the gradient summed over the
    group."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        ctx.rank = dist.get_rank(group)
        ctx.size = x.shape[dim]
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return (g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None,
                None)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ of x over the group's ranks, differentiable (JAX's psum)."""
    return _AllReduceSum.apply(x, group)


def all_gather_seq(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The group's shards of x concatenated along `dim`, differentiable
    (JAX's all_gather(..., tiled=True))."""
    return _AllGather.apply(x, group, dim)


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.Tensor], group):
    """Sum every parameter's .grad over the group in place (a missing one
    counts as zeros). The gradients are flattened into buckets of at most
    BUCKET_ELEMS entries of one dtype, one all-reduce a bucket, and copied
    back: the parameters, and so their names, stay the model's."""
    grads: List[torch.Tensor] = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    buckets: dict = {}
    filled: dict = {}
    for g in grads:
        lists = buckets.setdefault(g.dtype, [[]])
        if lists[-1] and filled[g.dtype] + g.numel() > BUCKET_ELEMS:
            lists.append([])
            filled[g.dtype] = 0
        lists[-1].append(g)
        filled[g.dtype] = filled.get(g.dtype, 0) + g.numel()
    for lists in buckets.values():
        for bucket in lists:
            flat = torch.cat([g.reshape(-1) for g in bucket])
            dist.all_reduce(flat, group=group)
            parts = flat.split([g.numel() for g in bucket])
            torch._foreach_copy_(bucket, [v.view_as(g) for v, g in
                                          zip(parts, bucket)])


def barrier(mesh: Optional[DeviceMesh]):
    """Wait for every rank of the mesh (nothing without one)."""
    if mesh is not None:
        dist.barrier()


def _spawned(rank: int, fn, n: int, device: str, backend, init_file: str,
             args):
    init_distributed(f"file://{init_file}", n, rank, device, backend)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, nprocs: int, device: str = "cuda", args=(),
              backend: Optional[str] = None, tmpdir=None) -> bool:
    """Run fn(rank, *args) on nprocs ranks, unless this process is one
    already: returns False at once when a process group exists or a
    launcher (torchrun) set WORLD_SIZE, so that the caller joins the group
    and does its rank's part itself. Otherwise it starts nprocs processes
    joined in one group (init_distributed over a file rendezvous in
    `tmpdir`, a fresh temporary directory by default; NCCL with one card a
    rank on "cuda", gloo on "cpu" or where `backend` says so), waits for
    them and returns True. fn must be importable by name (the processes
    start fresh). Raises when NCCL asks for more ranks than cards."""
    if dist.is_initialized() or "WORLD_SIZE" in os.environ:
        return False
    nccl = backend in (None, "nccl") and torch.device(device).type == "cuda"
    if nccl and nprocs > torch.cuda.device_count():
        raise ValueError(f"{nprocs} ranks need {nprocs} cards; this machine "
                         f"shows {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory(dir=tmpdir) as tmp:
        torch.multiprocessing.start_processes(
            _spawned, args=(fn, nprocs, device, backend, f"{tmp}/rendezvous",
                            args),
            nprocs=nprocs, start_method="spawn")
    return True
