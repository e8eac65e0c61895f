"""The collectives of the multi-device layer, on ``torch.distributed``.

What ``jax.lax.ppermute`` / ``psum`` are to the JAX package's ``shard_map``
bodies, these functions are to the port's per-rank code.  Each is an
autograd function, so gradients run back through rings, halos and
pipelines as JAX's transposes do:

* :func:`ppermute` sends each rank's tensor along ``perm`` (pairs of group
  ranks ``(src, dst)``); a rank that no pair reaches receives zeros.  Its
  backward sends the cotangents along the inverse permutation.
* :func:`psum` all-reduces.  Its backward is a ``psum`` of the cotangents:
  every rank uses the sum in its own shard's work (the GroupNorm moments
  of the sequence-parallel extractor), so the sum's cotangent is the sum
  of theirs.  This is the *sharded* convention: each rank's loss is its
  shard's part, and the whole loss is their sum.
* :func:`copy_to`, :func:`gather_from` and :func:`scatter_to` are the
  *replicated* convention (each rank holds the same value and the same
  cotangent of a replicated tensor) of the sequence-parallel parameters
  and the pipeline's data axis: identity forward and all-reduce backward;
  all-gather forward and own-slice backward; own-slice forward and
  all-gather backward.
* :func:`halo_from_right` and :func:`halo` are the halo exchanges of the
  time-sharded STFT and of the sequence-parallel convolutions.

**Host staging.**  Gloo's point-to-point operations take CPU tensors only.
When the group's backend is ``gloo`` and the tensor lies on a CUDA device
(two ranks sharing one card, which NCCL refuses), the tensor is copied
through pinned host memory and back; :data:`STAGED_BYTES` counts the bytes
copied each way.  The choice goes by the group's backend, never by
catching a failure.  NCCL groups take CUDA tensors as they are; a group of
one rank communicates nothing.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

__all__ = ["STAGED_BYTES", "axis_group", "mesh_device", "placements",
           "as_sharded", "ppermute", "psum", "copy_to",
           "gather_from", "scatter_to", "halo_from_right",
           "halo", "params_swapped"]

#: bytes copied between a CUDA device and pinned host memory for gloo
STAGED_BYTES = 0


def axis_group(mesh, axis: str) -> Tuple[object, int, int]:
    """``(process group, this rank's index, size)`` of ``mesh[axis]``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a DeviceMesh (parallel.make_mesh), got "
                        f"{type(mesh).__name__}")
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has no axis {axis!r} "
                         f"(axes {mesh.mesh_dim_names})")
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's part of ``mesh`` lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def placements(mesh: DeviceMesh, axis: str, dim: int) -> list:
    """``Shard(dim)`` on ``axis``, replicated over the mesh's other axes."""
    return [Shard(dim) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def as_sharded(out: torch.Tensor, mesh: DeviceMesh, axis: str,
               dim: int) -> DTensor:
    """This rank's ``out`` as its shard of a DTensor split evenly along
    ``dim`` over ``axis``."""
    _, _, n = axis_group(mesh, axis)
    shape = list(out.shape)
    shape[dim] *= n
    return DTensor.from_local(out, mesh, placements(mesh, axis, dim),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _size(group) -> int:
    return dist.get_world_size(group)


def _rank(group) -> int:
    return dist.get_rank(group)


def _staged(group, x: torch.Tensor) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    global STAGED_BYTES
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    STAGED_BYTES += x.numel() * x.element_size()
    return host


def _to_device(host: torch.Tensor, device) -> torch.Tensor:
    global STAGED_BYTES
    STAGED_BYTES += host.numel() * host.element_size()
    return host.to(device, non_blocking=True)


# ---- raw collectives (no autograd) --------------------------------------

def _ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], group):
    group = group if group is not None else dist.group.WORLD
    me = _rank(group)
    x = x.contiguous()
    sends = [d for s, d in perm if s == me and d != me]
    srcs = [s for s, d in perm if d == me]
    if len(srcs) > 1:
        raise ValueError(f"rank {me} receives from {srcs}: not a "
                         "permutation")
    if srcs and srcs[0] == me:
        out = x.clone()
    else:
        out = torch.zeros_like(x)
    if not sends and not (srcs and srcs[0] != me):
        return out
    stage = _staged(group, x)
    payload = _to_host(x) if stage and sends else x
    recv = (torch.zeros(x.shape, dtype=x.dtype, pin_memory=True)
            if stage else out)
    ops = [dist.P2POp(dist.isend, payload, dist.get_global_rank(group, d),
                      group) for d in sends]
    if srcs and srcs[0] != me:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, srcs[0]), group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if stage and srcs and srcs[0] != me:
        out = _to_device(recv, x.device)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    if _size(group) == 1:
        return x.clone()
    if _staged(group, x):
        host = _to_host(x)
        dist.all_reduce(host, group=group)
        return _to_device(host, x.device)
    out = x.clone().contiguous()
    dist.all_reduce(out, group=group)
    return out


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x.clone()
    stage = _staged(group, x)
    src = _to_host(x) if stage else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return _to_device(out, x.device) if stage else out


def _own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                         f"split over {n} ranks")
    return x.chunk(n, dim)[_rank(group)].contiguous()


def _broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    if _size(group) == 1:
        return x.clone()
    group = group if group is not None else dist.group.WORLD
    stage = _staged(group, x)
    buf = _to_host(x) if stage else x.clone().contiguous()
    dist.broadcast(buf, dist.get_global_rank(group, src), group=group)
    return _to_device(buf, x.device) if stage else buf


# ---- autograd functions -------------------------------------------------

class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, group):
        ctx.perm, ctx.group = perm, group
        return _ppermute(x, perm, group)

    @staticmethod
    def backward(ctx, g):
        inv = [(d, s) for s, d in ctx.perm]
        return _ppermute(g, inv, ctx.group), None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.dim, ctx.group), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group=None) -> torch.Tensor:
    """``lax.ppermute``: rank ``dst`` receives ``src``'s ``x`` for each
    pair of ``perm`` (group ranks); ranks no pair reaches get zeros."""
    return _PPermute.apply(x, tuple(tuple(p) for p in perm), group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``lax.psum`` over ``group`` (sharded convention: the backward sums
    the cotangents too)."""
    return _PSum.apply(x, group)


def copy_to(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward; the backward all-reduces the cotangents (a
    replicated tensor that each rank uses for its own part)."""
    return _CopyTo.apply(x, group)


def gather_from(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """All-gather along ``dim`` into a replicated tensor; the backward
    keeps this rank's slice of the cotangent."""
    return _GatherFrom.apply(x, dim, group)


def scatter_to(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """This rank's slice along ``dim`` of a replicated tensor; the backward
    all-gathers the slices' cotangents."""
    return _ScatterTo.apply(x, dim, group)


def halo_from_right(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """Each rank receives the leading ``halo`` samples (last axis) of its
    right neighbour; the last rank receives zeros."""
    n = _size(group)
    perm = [(i, i - 1) for i in range(1, n)]
    return ppermute(x[..., :halo], perm, group)


def halo(x: torch.Tensor, left: int, right: int, group=None,
         dim: int = 1) -> torch.Tensor:
    """``x (..., T_local, ...)`` → ``left`` trailing frames of the left
    neighbours + ``x`` + ``right`` leading frames of the right neighbours
    along ``dim``, zeros at the ends of the axis (the zero padding the
    unsharded op sees).  A halo wider than one shard takes several hops."""
    n = _size(group)
    tl = x.shape[dim]
    parts = []
    hops = -(-left // tl) if left > 0 else 0
    for j in range(hops, 0, -1):                   # farthest first
        take = min(left - (j - 1) * tl, tl)
        perm = [(i, i + j) for i in range(max(n - j, 0))]
        parts.append(ppermute(x.narrow(dim, tl - take, take), perm, group))
    parts.append(x)
    hops = -(-right // tl) if right > 0 else 0
    for j in range(1, hops + 1):                   # nearest first
        take = min(right - (j - 1) * tl, tl)
        perm = [(i, i - j) for i in range(min(j, n), n)]
        parts.append(ppermute(x.narrow(dim, 0, take), perm, group))
    return torch.cat(parts, dim=dim) if len(parts) > 1 else x


@contextlib.contextmanager
def params_swapped(module: torch.nn.Module, fn):
    """Within the block, every parameter ``p`` of ``module`` (recursively)
    reads as ``fn(name, p)``: a plain attribute in place of the parameter,
    so the module's own code computes with it and gradients flow back to
    ``p`` through ``fn``.  The parameters are restored on exit."""
    swapped = []
    try:
        for name, p in list(module.named_parameters()):
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name) if owner_name \
                else module
            new = fn(name, p)
            if new is p:
                continue
            owner._parameters.pop(leaf)
            object.__setattr__(owner, leaf, new)
            swapped.append((owner, leaf, p))
        yield module
    finally:
        for owner, leaf, p in reversed(swapped):
            object.__delattr__(owner, leaf)
            owner._parameters[leaf] = p
