"""Pipeline parallelism: the GPipe schedule over a mesh axis.

Port of ``torchaudio_contrib_tpu/parallel/pp.py``.  Contiguous blocks of
layers live on the ranks of the ``pipe`` axis (:func:`stack_pipeline`,
:func:`pipeline_shard`); microbatches stream through them
(:func:`microbatch`), one hop down the ring per step
(:func:`._comm.ppermute`): stage 0 feeds microbatch ``t`` at step ``t``
and the last stage writes microbatch ``t − (n_stages − 1)``, so the
schedule drains after ``n_microbatches + n_stages − 1`` steps (keep
``n_microbatches ≫ n_stages``).  A stage skips the steps that hold no
microbatch (the bubble).  Activations are pytrees: per-microbatch state
(masks, biases) travels with them.

The contract is the JAX package's: :func:`pipeline_apply` is a plain
callable that equals applying ``layer_fn`` over all layers in order on the
whole batch, and ``loss.backward()`` through it runs the reverse schedule
(the ring's ``ppermute`` sends the cotangents back up).  That is why the
schedule is written here and not taken from
``torch.distributed.pipelining``, whose schedules own the backward pass.

Gradients follow the replicated convention: the result is replicated
along ``pipe`` (sent from the last stage to every stage), and every rank
backpropagates the same loss of it.  The input's gradient is then the
whole one on every rank, and each stage's parameters get theirs.  With
``data_axis`` (a 2-D mesh such as ``("pipe", "data")``) each rank runs its
slice of every microbatch; the result is gathered over ``data``, and the
stage's parameters (replicated over ``data``) get their gradients summed
over it, as the JAX transpose does.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import _pytree as pytree

from ._comm import _all_reduce as _raw_all_reduce
from ._comm import _broadcast as _raw_broadcast
from ._comm import _ppermute as _raw_ppermute
from ._comm import axis_group, gather_from, mesh_device, scatter_to

__all__ = ["stack_pipeline", "unstack_pipeline", "pipeline_shard",
           "microbatch", "unmicrobatch", "build_pipeline",
           "pipeline_apply"]


def _tmap(fn, tree):
    return pytree.tree_map(
        lambda a: fn(a) if isinstance(a, torch.Tensor) else a, tree)


def stack_pipeline(layers, n_stages: int):
    """The per-layer list → ``n_stages`` blocks of ``len(layers) //
    n_stages`` consecutive layers (an ``nn.ModuleList`` of ``ModuleList``
    s when the layers are modules, else a list of lists)."""
    n = len(layers)
    if n_stages < 1 or n % n_stages:
        raise ValueError(
            f"{n} layers do not split into {n_stages} equal stages")
    per = n // n_stages
    blocks = [list(layers[s * per:(s + 1) * per]) for s in range(n_stages)]
    if all(isinstance(layer, nn.Module) for layer in layers):
        return nn.ModuleList(nn.ModuleList(b) for b in blocks)
    return blocks


def unstack_pipeline(stacked):
    """Inverse of :func:`stack_pipeline`: the per-layer list (of the
    stages this rank holds, after :func:`pipeline_shard`)."""
    return [layer for block in stacked if block is not None
            for layer in block]


def pipeline_shard(stacked, mesh, axis: str = "pipe"):
    """Keep this rank's stage, on the mesh's device; the other stages'
    places hold ``None``, so that each rank holds only its own weights."""
    _, idx, n = axis_group(mesh, axis)
    if len(stacked) != n:
        raise ValueError(f"stacked params carry {len(stacked)} stages but "
                         f"mesh axis {axis!r} has {n}")
    dev = mesh_device(mesh)
    block = stacked[idx]
    if isinstance(block, nn.Module):
        block = block.to(dev)
    else:
        block = [_tmap(lambda a: a.to(dev), layer) for layer in block]
    return [block if s == idx else None for s in range(n)]


def microbatch(tree, n_microbatches: int):
    """Split every tensor leaf's batch axis into ``(n_microbatches, mb,
    ...)``."""
    def _split(a):
        if a.shape[0] % n_microbatches:
            raise ValueError(
                f"batch {a.shape[0]} not divisible into "
                f"{n_microbatches} microbatches")
        return a.reshape(n_microbatches, a.shape[0] // n_microbatches,
                         *a.shape[1:])
    return _tmap(_split, tree)


def unmicrobatch(tree):
    """Inverse of :func:`microbatch` (merge the leading two axes)."""
    return _tmap(lambda a: a.reshape(a.shape[0] * a.shape[1],
                                     *a.shape[2:]), tree)


def _block_params(block) -> list:
    """The tensors of a stage that take gradients."""
    if isinstance(block, nn.Module):
        return [p for p in block.parameters() if p.requires_grad]
    leaves = pytree.tree_leaves(block)
    return [a for a in leaves
            if isinstance(a, torch.Tensor) and a.requires_grad]


def _floating(a) -> bool:
    return isinstance(a, torch.Tensor) and a.is_floating_point()


class _GPipe(torch.autograd.Function):
    """The per-rank GPipe schedule, forward and reverse.  The forward keeps
    each step's graph (the stage's layers on a detached input); the
    backward walks the steps in reverse, takes each step's VJP and sends
    the input's cotangent one stage up the ring.  Every collective is
    issued here, in the same order on every rank."""

    @staticmethod
    def forward(ctx, cfg, n_leaves, *tensors):
        (layer_fn, block, spec, group, idx, n_stages, n_micro,
         data_group) = cfg
        micro = list(tensors[:n_leaves])
        last = n_stages - 1
        perm = [(i, i + 1) for i in range(n_stages - 1)]
        zero = [torch.zeros_like(a[0]) for a in micro]
        steps, outs = {}, [None] * n_micro
        act = zero
        with torch.enable_grad():
            for t in range(n_micro + n_stages - 1):
                recv = ([_raw_ppermute(a, perm, group) for a in act]
                        if n_stages > 1 else act)
                m = t - idx
                if not 0 <= m < n_micro:
                    act = zero
                    continue
                src = [a[m] for a in micro] if idx == 0 else recv
                y_in = [a.detach().requires_grad_(_floating(a))
                        for a in src]
                y = pytree.tree_unflatten(y_in, spec)
                for layer in block:
                    y = layer_fn(layer, y)
                y_out = pytree.tree_leaves(y)
                steps[t] = (y_in, y_out)
                act = [a.detach() for a in y_out]
                if idx == last:
                    outs[m] = act
        if idx == last:
            out = [torch.stack([o[i] for o in outs])
                   for i in range(n_leaves)]
        else:
            out = [torch.zeros_like(a) for a in micro]
        ctx.cfg, ctx.steps = cfg, steps
        ctx.micro_like = [(a.shape, a.dtype, a.device) for a in micro]
        return tuple(_raw_broadcast(a, last, group) for a in out)

    @staticmethod
    def backward(ctx, *g_out):
        (layer_fn, block, spec, group, idx, n_stages, n_micro,
         data_group) = ctx.cfg
        params = _block_params(block)
        last = n_stages - 1
        inv = [(i + 1, i) for i in range(n_stages - 1)]
        g_micro = [torch.zeros(shape, dtype=dtype, device=device)
                   for shape, dtype, device in ctx.micro_like]
        g_params = [torch.zeros_like(p) for p in params]
        g_act = [torch.zeros_like(a[0]) for a in g_micro]
        for t in range(n_micro + n_stages - 2, -1, -1):
            m = t - idx
            send = [torch.zeros_like(a) for a in g_act]
            if 0 <= m < n_micro:
                y_in, y_out = ctx.steps.pop(t)
                cot = [g[m] for g in g_out] if idx == last else g_act
                pairs = [(o, c) for o, c in zip(y_out, cot)
                         if o.requires_grad]
                want = [a for a in y_in if a.requires_grad] + params
                if pairs and want:
                    grads = torch.autograd.grad(
                        [o for o, _ in pairs], want,
                        [c for _, c in pairs], allow_unused=True)
                    g_in = iter(grads[:len(want) - len(params)])
                    for i, a in enumerate(y_in):
                        g = next(g_in) if a.requires_grad else None
                        if g is not None:
                            send[i] = g
                    for gp, g in zip(g_params, grads[len(want)
                                                     - len(params):]):
                        if g is not None:
                            gp.add_(g)
                if idx == 0:
                    for gm, g in zip(g_micro, send):
                        gm[m] += g
            if n_stages > 1:
                g_act = [_raw_ppermute(a, inv, group) for a in send]
        g_micro = [_raw_all_reduce(g, group) if ctx.needs_input_grad[2 + i]
                   else None for i, g in enumerate(g_micro)]
        if data_group is not None:
            g_params = [_raw_all_reduce(g, data_group) for g in g_params]
        return (None, None, *g_micro, *g_params)


def _schedule(layer_fn, block, micro, group, idx, n_stages, n_micro,
              data_group):
    """``micro`` leaves are ``(n_micro, mb, ...)``; returns the last
    stage's outputs, replicated on the axis."""
    leaves, spec = pytree.tree_flatten(micro)
    if not all(isinstance(a, torch.Tensor) for a in leaves):
        raise TypeError("pipeline activations must be pytrees of tensors")
    cfg = (layer_fn, block, spec, group, idx, n_stages, n_micro, data_group)
    out = _GPipe.apply(cfg, len(leaves), *leaves, *_block_params(block))
    return pytree.tree_unflatten(list(out), spec)


def build_pipeline(layer_fn, mesh, axis: str = "pipe",
                   data_axis: Optional[str] = None,
                   n_microbatches: int = 8):
    """The pipelined stack as a callable ``run(stacked, microbatches)`` →
    microbatched outputs (see :func:`stack_pipeline`, :func:`microbatch`).
    ``layer_fn(layer, act) -> act`` applies ONE layer to an activation
    pytree (the same structure in and out).  Differentiable; a second
    call with the same arguments returns the same callable."""
    if data_axis is not None and data_axis not in (mesh.mesh_dim_names
                                                   or ()):
        raise ValueError(f"mesh has no axis {data_axis!r}")
    return _build(layer_fn, mesh, axis, data_axis, n_microbatches)


@functools.lru_cache(maxsize=32)
def _build(layer_fn, mesh, axis, data_axis, n_microbatches):
    group, idx, n_stages = axis_group(mesh, axis)
    data_group = None
    if data_axis is not None:
        data_group = axis_group(mesh, data_axis)[0]

    def run(stacked, micro):
        if len(stacked) != n_stages:
            raise ValueError(
                f"stacked params carry {len(stacked)} stages but mesh "
                f"axis {axis!r} has {n_stages}")
        if data_group is not None:
            micro = _tmap(lambda a: scatter_to(a, 1, data_group), micro)
        out = _schedule(layer_fn, stacked[idx], micro, group, idx,
                        n_stages, n_microbatches, data_group)
        if data_group is not None:
            out = _tmap(lambda a: gather_from(a, 1, data_group), out)
        return out

    return run


def pipeline_apply(layer_fn, stacked_params, x, *, mesh,
                   axis: str = "pipe", data_axis: Optional[str] = None,
                   n_microbatches: int = 8):
    """Microbatch ``x`` (a pytree of batch-leading tensors, the same on
    every rank), stream it through the stages and merge the result back to
    batch-leading, replicated on every rank.  Equals applying ``layer_fn``
    over all layers in order."""
    _, _, n_stages = axis_group(mesh, axis)
    if len(stacked_params) != n_stages:
        raise ValueError(
            f"stacked params carry {len(stacked_params)} stages but mesh "
            f"axis {axis!r} has {n_stages}")
    run = build_pipeline(layer_fn, mesh, axis, data_axis, n_microbatches)
    return unmicrobatch(run(stacked_params, microbatch(x, n_microbatches)))
