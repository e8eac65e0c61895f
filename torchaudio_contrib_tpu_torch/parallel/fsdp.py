"""Fully sharded data parallelism (the ZeRO-3 layout) for the model zoo.

Port of ``torchaudio_contrib_tpu/parallel/fsdp.py`` on FSDP2
(``torch.distributed.fsdp.fully_shard``): each weight is stored sharded
over the ``data`` axis, the batch is split over the same axis, and each
layer's weights are all-gathered just before use and their gradients
reduce-scattered (averaged over the ranks, so a mean loss over each rank's
rows gives the whole batch's mean gradient).

The layout rule is the JAX package's, stated on the port's layouts: shard
the largest dim that divides the axis, ties going to the output dim (torch
dim 0 of a ``Linear`` or conv kernel, which is JAX's last dim of the same
kernel stored transposed); a base spec (tensor parallelism's, on a 2-D
``(data, model)`` mesh) keeps its dims and FSDP takes another; ``override``
wins.  A spec is a tuple naming, for each tensor dim, the mesh axis that
shards it or ``None`` (trailing ``None`` s dropped, ``()`` replicated).

**Divergence (by design).**  FSDP2 shards every parameter it manages.
A leaf that the rule replicates (under ``min_size`` elements, or with no
divisible dim) is therefore sharded on dim 0 by :func:`fsdp_shard` (FSDP2
pads an uneven shard), at the cost of the gather the JAX layout avoids;
:func:`fsdp_specs` still reports the rule's ``()``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ._comm import axis_group

__all__ = ["fsdp_specs", "fsdp_shard", "fsdp_init", "fsdp_state_specs",
           "fsdp_min_size"]

# leaves smaller than this replicate: sharding a 128-float LayerNorm scale
# saves nothing and costs a gather
fsdp_min_size = 1024


def _as_spec(base, ndim: int, mesh, axis: str) -> list:
    """A base entry (a spec tuple, or a placement of tensor parallelism on
    the mesh's other axis) as a list of per-dim axis names."""
    spec = [None] * ndim
    if isinstance(base, Shard):
        others = [a for a in mesh.mesh_dim_names if a != axis]
        if len(others) != 1:
            raise ValueError(
                f"a placement in base_specs needs a 2-D mesh, whose other "
                f"axis it shards (axes {mesh.mesh_dim_names}); give a spec "
                f"tuple naming the axis instead")
        spec[base.dim] = others[0]
    elif isinstance(base, (tuple, list)):
        spec[:len(base)] = list(base)
    elif base is not None and not isinstance(base, Replicate):
        raise TypeError(f"unknown spec {base!r}")
    return spec


def _trimmed(spec) -> tuple:
    spec = list(spec)
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def _uses(entry, axis: str) -> bool:
    return entry == axis or (isinstance(entry, tuple) and axis in entry)


def fsdp_specs(model: nn.Module, mesh, axis: str = "data",
               base_specs: Optional[dict] = None,
               override: Optional[Callable] = None,
               min_size: Optional[int] = None) -> dict:
    """``{parameter name: spec}`` giving every large parameter a dim
    sharded over ``axis``.

    ``base_specs`` (the same names; e.g. from
    :func:`.tp.tensor_parallel_specs`, whose placements are on the mesh's
    other axis) gives each parameter's starting spec; the FSDP dim goes on
    a dim the base left free (a base that already uses ``axis`` is left
    as it is, so the call is idempotent).  ``override(name, param)`` may
    return a whole spec (``None`` defers).  Parameters under ``min_size``
    elements (default :data:`fsdp_min_size`) replicate."""
    if min_size is None:
        min_size = fsdp_min_size
    _, _, size = axis_group(mesh, axis)
    named = list(model.named_parameters())
    if base_specs is not None and set(base_specs) != {n for n, _ in named}:
        raise ValueError(
            "base_specs names mismatch: params "
            f"{sorted(n for n, _ in named)} vs base {sorted(base_specs)}")
    specs = {}
    for name, p in named:
        if override is not None:
            forced = override(name, p)
            if forced is not None:
                specs[name] = _trimmed(forced)
                continue
        spec = _as_spec(None if base_specs is None else base_specs[name],
                        p.ndim, mesh, axis)
        if (p.numel() < min_size or size == 1
                or any(_uses(e, axis) for e in spec)):
            specs[name] = _trimmed(spec)
            continue
        best = None          # largest free dim dividing the axis; ties → 0
        for d in range(p.ndim):
            if spec[d] is None and p.shape[d] % size == 0:
                if best is None or p.shape[d] > p.shape[best]:
                    best = d
        if best is not None:
            spec[best] = axis
        specs[name] = _trimmed(spec)
    return specs


def _units(model: nn.Module) -> list:
    """The layers that get a ``fully_shard`` each: the elements of the
    outermost ``ModuleList`` s, save those holding a parameter that the
    model reads outside its owner's forward (``_shared_params``; they stay
    with the model's own unit)."""
    shared = getattr(model, "_shared_params", ())
    units, inside = [], set()
    for name, mod in model.named_modules():
        if any(name.startswith(u + ".") for u in inside):
            continue
        if isinstance(mod, nn.ModuleList):
            for i, child in enumerate(mod):
                path = f"{name}.{i}" if name else str(i)
                if any(True for _ in child.parameters()) and not any(
                        s.startswith(path + ".") for s in shared):
                    units.append(child)
                    inside.add(path)
    return units


def fsdp_shard(model: nn.Module, mesh, axis: str = "data",
               base_specs: Optional[dict] = None,
               override: Optional[Callable] = None,
               min_size: Optional[int] = None) -> nn.Module:
    """``fully_shard`` each layer (the elements of the model's outermost
    ``ModuleList`` s), then the model, over ``mesh[axis]``, every parameter
    on the dim :func:`fsdp_specs` gives it (dim 0 where the rule
    replicates; see the module docstring).  Compose with tensor
    parallelism by calling :func:`.tp.shard_params` on the ``model`` axis
    of the same 2-D mesh first and passing its specs as ``base_specs``.
    Returns ``model``."""
    from torch.distributed.fsdp import fully_shard

    specs = fsdp_specs(model, mesh, axis, base_specs, override, min_size)
    dims = {}
    for name, p in model.named_parameters():
        spec = specs[name]
        dims[id(p)] = spec.index(axis) if axis in spec else 0

    def place(p):
        return Shard(dims.get(id(p), 0))

    sub = mesh[axis]
    for unit in _units(model):
        fully_shard(unit, mesh=sub, shard_placement_fn=place)
    fully_shard(model, mesh=sub, shard_placement_fn=place)
    return model


def fsdp_state_specs(optimizer: torch.optim.Optimizer,
                     model: nn.Module) -> dict:
    """``{parameter name: {state key: spec}}`` of an optimizer's state on
    the sharded parameters: moments shaped as their parameter carry its
    placements (``DTensor`` s), everything else (step counts) is
    replicated, ``()``.  Torch optimizers make their state at the first
    step; call this after it."""
    names = {id(p): n for n, p in model.named_parameters()}
    out = {}
    for p, state in optimizer.state.items():
        entry = {}
        for key, v in state.items():
            if isinstance(v, DTensor):
                entry[key] = _dtensor_spec(v)
            else:
                entry[key] = ()
        out[names.get(id(p), str(id(p)))] = entry
    return out


def _dtensor_spec(t: DTensor) -> tuple:
    """A DTensor's placements as a spec tuple over its dims."""
    spec = [None] * t.ndim
    for mesh_dim, place in enumerate(t.placements):
        if isinstance(place, Shard):
            name = t.device_mesh.mesh_dim_names[mesh_dim]
            prev = spec[place.dim]
            spec[place.dim] = name if prev is None else (
                (prev,) if not isinstance(prev, tuple) else prev) + (name,)
    return _trimmed(spec)


def fsdp_init(init_fn: Callable, model: nn.Module) -> torch.optim.Optimizer:
    """The optimizer ``init_fn(parameters)`` (e.g. ``lambda ps:
    torch.optim.Adam(ps, 1e-3)``) over the model's sharded parameters:
    its state, made at the first step, lands on the parameters' shards
    (:func:`fsdp_state_specs`).  The model must have been through
    :func:`fsdp_shard`."""
    if not any(isinstance(p, DTensor) for p in model.parameters()):
        raise ValueError("fsdp_init needs a model sharded by fsdp_shard")
    return init_fn(list(model.parameters()))
