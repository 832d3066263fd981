"""Device meshes, process groups and the collectives of the ``parallel``
subpackage.

Counterpart of ``tinygp_tpu/parallel/mesh.py``. The JAX package runs one
process over many devices and lets ``shard_map`` emit XLA collectives. The
port runs one process per device, the PyTorch idiom: a group made by
:func:`initialize_distributed` (NCCL on the card, gloo on the CPU), a
:class:`~torch.distributed.device_mesh.DeviceMesh` with named dimensions
from :func:`make_mesh`, and the collectives below, which every module of
the subpackage uses and which no other module replaces by direct calls to
``torch.distributed``.

**Gradients.** ``torch.distributed`` records nothing for autograd, so each
collective here is an ``autograd.Function`` with its adjoint:

- a group sum (:func:`group_sum`): the group sum of the cotangents;
- an all-gather (:func:`gather`): this rank's slice of the group sum of
  the cotangents;
- a broadcast (:func:`broadcast`): the sum of the cotangents, on its
  source rank only;
- a value that every rank holds whole and hands to rank-local work
  (:func:`replicate`: the identity): the group sum of the cotangents, so
  that each rank ends with the whole gradient.

A rank's backward pass covers its own work, and every rank of a group runs
it, through every collective it took part in, in the order they ran
(:func:`tie` keeps in those whose results the rank does not use). An output that every rank of the group holds whole is one value, and
its cotangent counts once: ``group_sum(..., replicated=True)`` takes the
mean of the ranks' cotangents.

**gloo on the card.** A gloo group can hold ranks on one card, which NCCL
refuses; gloo does not reduce or gather CUDA tensors. So for a gloo group
only, the collectives stage a CUDA tensor through host memory and copy
the result back; under NCCL every collective runs on the card.
"""

from __future__ import annotations

__all__ = [
    "make_mesh",
    "chain_axis",
    "data_axis",
    "local_chunk",
    "initialize_distributed",
]

import math
import os
import socket
from collections.abc import Sequence
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tinygp_tpu_torch.helpers import mapped_module, resolve_device

chain_axis = "chains"
"""The canonical mesh-axis name for chain/particle data parallelism."""

data_axis = "data"
"""The canonical mesh-axis name for sequence (time-axis) parallelism."""


def _mesh_sizes(
    n: int, axis_names: Sequence[str], axis_sizes: Sequence[int] | None
) -> list[int]:
    """The JAX package's size rules: everything on the first axis by
    default, at most one ``-1`` absorbing what is left, and a product equal
    to the ``n`` ranks."""
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    sizes = list(axis_sizes)
    if len(sizes) != len(axis_names):
        raise ValueError(f"{len(axis_names)} axis names but {len(sizes)} sizes")
    holes = [i for i, s in enumerate(sizes) if s == -1]
    if len(holes) > 1:
        raise ValueError("at most one axis size may be -1")
    if holes:
        known = math.prod(s for s in sizes if s != -1)
        if known == 0 or n % known != 0:
            raise ValueError(
                f"cannot infer axis '{axis_names[holes[0]]}': {n} devices "
                f"do not divide by the fixed sizes {sizes}"
            )
        sizes[holes[0]] = n // known
    if math.prod(sizes) != n:
        raise ValueError(
            f"mesh {dict(zip(axis_names, sizes))} needs {math.prod(sizes)} devices, have {n}"
        )
    return sizes


def make_mesh(
    num_devices: int | None = None,
    *,
    axis_names: Sequence[str] = (chain_axis,),
    axis_sizes: Sequence[int] | None = None,
    device: Any = None,
) -> DeviceMesh:
    """A device mesh with named axes over the ranks of the default group.

    Args:
        num_devices: Use only the first this many ranks (default: all).
            Every rank of the default group calls this, also those left
            out, which hold no coordinate in the mesh.
        axis_names: Mesh axis names, e.g. ``("chains",)`` or
            ``("chains", "data")``.
        axis_sizes: Size per axis; at most one ``-1``, which absorbs what is
            left. Defaults to every rank on the first axis and 1 elsewhere.
        device: The mesh's device type: the card unless ``"cpu"``; a CUDA
            mesh raises where there is no card.

    The default group must exist (:func:`initialize_distributed`); rank
    ``i`` of the mesh, in row-major order, is rank ``i`` of that group.
    """
    device = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed first")
    world = dist.get_world_size()
    n = world if num_devices is None else min(num_devices, world)
    sizes = _mesh_sizes(n, axis_names, axis_sizes)
    ranks = torch.arange(n).reshape(sizes)
    return DeviceMesh(device.type, ranks, mesh_dim_names=tuple(axis_names))


def free_port() -> int:
    """A free TCP port on this host, for a coordinator address."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device: Any = None,
) -> tuple[int, int]:
    """Join (or start) the default process group; one process per device.

    With no arguments the launcher's environment is read: ``MASTER_ADDR``
    and ``MASTER_PORT`` for the coordinator, ``WORLD_SIZE`` and ``RANK``
    (as ``torchrun`` sets them); a lone process with none of them starts a
    one-rank group on a free local port. ``coordinator_address`` is
    ``"host:port"`` (or ``"tcp://host:port"``). The group is NCCL on the
    card, each process on card ``LOCAL_RANK`` (default: its rank modulo
    the cards), and gloo for ``device="cpu"``.

    Returns:
        ``(rank, world_size)``. Safe to call when already initialized
        (returns the current values).
    """
    if not dist.is_initialized():
        device = resolve_device(device)
        if coordinator_address is None and "MASTER_ADDR" in os.environ:
            coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        if num_processes is None:
            num_processes = int(os.environ.get("WORLD_SIZE", 1))
        if process_id is None:
            process_id = int(os.environ.get("RANK", 0))
        if coordinator_address is None:
            if num_processes != 1:
                raise ValueError("a group of several processes needs a coordinator address")
            coordinator_address = f"127.0.0.1:{free_port()}"
        if not coordinator_address.startswith("tcp://"):
            coordinator_address = "tcp://" + coordinator_address
        if device.type == "cuda":
            local = os.environ.get("LOCAL_RANK")
            torch.cuda.set_device(
                int(local) if local is not None else process_id % torch.cuda.device_count()
            )
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=coordinator_address,
            world_size=num_processes,
            rank=process_id,
        )
    return dist.get_rank(), dist.get_world_size()


def local_chunk(total: int, mesh: DeviceMesh, axis: str = chain_axis) -> int:
    """The per-device extent of ``total`` items sharded over ``axis``."""
    size = axis_size(mesh, axis)
    if total % size != 0:
        raise ValueError(
            f"{total} items do not shard evenly over mesh axis '{axis}' of size {size}"
        )
    return total // size


# ---------------------------------------------------------------------------
# Axis groups and the collectives.
# ---------------------------------------------------------------------------


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The number of ranks along ``axis``."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_group(mesh: DeviceMesh, axis: str) -> dist.ProcessGroup:
    """The process group of this rank's line along ``axis``: what a JAX
    axis name stands for inside ``shard_map``."""
    return mesh.get_group(axis)


def group_rank(group: dist.ProcessGroup) -> int:
    """This rank's index in ``group`` (JAX's ``axis_index``)."""
    return dist.get_rank(group)


def group_size(group: dist.ProcessGroup) -> int:
    """The number of ranks in ``group``."""
    return dist.get_world_size(group)


def _staged(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``x`` where ``group``'s backend can reach it: host memory for a CUDA
    tensor in a gloo group, else ``x`` itself."""
    if x.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        return x.cpu()
    return x


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    buf = _staged(x, group).clone().contiguous()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(x.device)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    # Flags travel as bytes: not every backend gathers booleans.
    local = _staged(x, group).contiguous()
    local = local.to(torch.uint8) if x.dtype == torch.bool else local
    parts = [torch.empty_like(local) for _ in range(group_size(group))]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=dim).to(device=x.device, dtype=x.dtype)


def _broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    buf = _staged(x, group).clone().contiguous()
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return buf.to(x.device)


def _reduce(x: torch.Tensor, dst: int, group) -> torch.Tensor:
    """The group sum of ``x`` on group rank ``dst``; zeros elsewhere."""
    buf = _staged(x, group).clone().contiguous()
    dist.reduce(buf, dst=dist.get_global_rank(group, dst), group=group)
    if group_rank(group) != dst:
        buf.zero_()
    return buf.to(x.device)


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, replicated):
        ctx.group, ctx.replicated = group, replicated
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        if ctx.replicated:
            g = g / group_size(ctx.group)
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        return g.narrow(ctx.dim, group_rank(ctx.group) * ctx.size, ctx.size), None, None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        return _broadcast(x, src, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.src, ctx.group), None, None


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *others):
        ctx.others = [(o.shape, o.dtype, o.device) for o in others]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(*shape, dtype=dtype, device=device)
                     for shape, dtype, device in ctx.others))


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def group_sum(x: torch.Tensor, group, *, replicated: bool = False) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``, on every rank (JAX's
    ``psum``). With ``replicated`` the result is an output every rank
    returns whole, whose cotangent counts once (the module docstring)."""
    return _GroupSum.apply(x, group, replicated)


def group_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (JAX's ``pmean``)."""
    return group_sum(x, group) / group_size(group)


def group_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group`` (JAX's ``pmax``);
    not differentiable."""
    return _all_reduce(x.detach(), group, op=dist.ReduceOp.MAX)


def gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x``, concatenated along ``dim`` in group-rank order
    (JAX's ``all_gather(..., tiled=True)``)."""
    return _Gather.apply(x, group, dim)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank; the others' ``x`` gives the
    shape and dtype only."""
    return _Broadcast.apply(x, src, group)


def replicate(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, a value every rank of ``group`` holds whole, as the input of
    rank-local work: the identity, whose adjoint sums the ranks' gradients."""
    return _Replicate.apply(x, group)


def tie(x: torch.Tensor, *others: torch.Tensor) -> torch.Tensor:
    """``x``, whose backward also reaches ``others`` with zero cotangents.

    Every rank of a group must run each collective's adjoint, which is a
    collective too; a backward pass runs only the nodes that its output
    reaches. So an output ties in the results of the collectives that
    this rank took part in but does not use."""
    return _Tie.apply(x, *others)


def replicate_module(module: torch.nn.Module, *groups) -> torch.nn.Module:
    """A copy of ``module`` whose tensors pass through :func:`replicate`
    over each of ``groups`` in turn."""

    def fn(t):
        for group in groups:
            t = replicate(t, group)
        return t

    return mapped_module(module, fn)
