"""Tensor-parallel parameter layouts for the model zoo.

Port of ``torchaudio_contrib_tpu/parallel/tp.py``.  The JAX package picks
each leaf's layout by its name (Megatron style) and lets GSPMD partition
the ops: expanding GEMMs (``wqkv``, ``w1``, ``wi``, embeddings, the
positional conv) shard their output dim over the ``model`` axis,
contracting ones (``wo``, ``w2``, ``proj``, conv ``w``) their input dim;
recurrent ``wh`` and everything 1-D replicate, and so does a dim that does
not divide the axis.

The port states the same rules on its own parameter names (the HF and
torchaudio names that ``utils.convert``'s ``*_from_jax_params`` map the
JAX leaves to) and on its own layouts: ``nn.Linear.weight`` is ``(out,
in)``, ``Conv1d`` ``(cout, cin, k)``, ``Conv2d`` ``(cout, cin, kh, kw)``,
``nn.Embedding`` ``(V, d)`` and ``nn.LSTM``'s ``weight_ih`` ``(4h, in)``.
So JAX's last dim of an expanding kernel is torch dim 0 (1 for an
embedding), and the contraction dim is torch dim 1.

:func:`shard_params` stores each sharded parameter as a DTensor on
``mesh[axis]`` and computes with the shards through torch's
``parallelize_module``:

* a sharded ``nn.Linear`` or ``nn.Embedding`` gets ``ColwiseParallel``
  (weight ``Shard(0)``; ``Shard(1)`` for an embedding) or
  ``RowwiseParallel`` (the other dim), taking and giving replicated
  activations;
* Megatron's pairs (:data:`TP_PAIRS`: wav2vec2's q/k/v with
  ``out_proj``, ``intermediate_dense`` with ``output_dense``) keep the
  inner width sharded between the two GEMMs, so an attention block holds
  its rank's heads and a block costs one all-reduce; a block pairs only
  when the pair holds all of its parameters (WavLM's gates and bucket
  table read every head, so its attention does not) and its
  ``num_heads`` divides the axis;
* any other module with a sharded parameter (convolutions, LSTMs,
  ``nn.MultiheadAttention``) gathers it for its forward: DTensor has no
  convolution rule for a sharded kernel (torch 2.13 runs the local
  shapes and raises ``Given groups=1, weight of size [8, 4, 3], expected
  input[2, 8, 20] to have 4 channels``).

Biases stay replicated, as the rules say.
"""
from __future__ import annotations

import re
from typing import Callable, Optional

from torch import nn
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.parallel import (ColwiseParallel,
                                               RowwiseParallel,
                                               parallelize_module)

from ._comm import axis_group, params_swapped

__all__ = ["tensor_parallel_specs", "shard_params", "EXPAND_KEYS",
           "CONTRACT_KEYS", "TP_RULES"]

# the JAX package's naming convention: expanding vs contracting kernels
EXPAND_KEYS = frozenset({
    "wqkv", "wq", "wk", "wv", "wi", "w1", "emb", "label_emb",
    "pos_conv", "wg"})
# recurrent "wh" replicates: a sharded contraction inside a recurrence
# would put a collective on every step
CONTRACT_KEYS = frozenset({"wo", "w2", "proj", "w"})

#: (pattern on the port's parameter name, the JAX leaf's key, the torch
#: dim that key's rule shards), first match wins; the names are those of
#: ``utils.convert``'s maps
TP_RULES = (
    # wav2vec2 / WavLM (``wav2vec2_from_jax_params``)
    (r"attention\.[qkv]_proj\.weight$", "wqkv", 0),
    (r"attention\.out_proj\.weight$", "wo", 1),
    (r"feed_forward\.intermediate_dense\.weight$", "w1", 0),
    (r"feed_forward\.output_dense\.weight$", "w2", 1),
    (r"feature_projection\.projection\.weight$", "w", 1),
    (r"feature_extractor\.conv_layers\.\d+\.conv\.weight$", "w", 1),
    (r"pos_conv_embed\.conv\.weight$", "pos_conv", 0),
    (r"(^|\.)aux\.weight$", "w", 1),
    # Conformer and its transcriber (``conformer_from_jax_params``)
    (r"self_attn\.in_proj_weight$", "wqkv", 0),
    (r"self_attn\.out_proj\.weight$", "wo", 1),
    (r"ffn[12]\.sequential\.1\.weight$", "w1", 0),
    (r"ffn[12]\.sequential\.4\.weight$", "w2", 1),
    (r"input_projection\.weight$", "proj", 1),
    (r"(^|\.)output_linear\.weight$", "w", 1),
    # RNN-T (``conformer_rnnt_from_jax_params``)
    (r"predictor\.embedding\.weight$", "emb", 1),
    (r"predictor\.lstm\.weight_ih_l\d+$", "wi", 0),
    (r"predictor\.linear\.weight$", "w", 1),
    (r"(^|\.)enc_proj\.weight$", "w", 1),
    (r"joiner\.linear\.weight$", "w", 1),
    # HiFi-GAN (``hifigan_from_jax_params``)
    (r"conv_(pre|post)\.weight$", "w", 1),
    (r"upsampler\.\d+\.weight$", "w", 1),
    (r"resblocks\.\d+\.convs1?\.\d+\.weight$", "w1", 0),
    (r"resblocks\.\d+\.convs2\.\d+\.weight$", "w2", 1),
)


def tensor_parallel_specs(model: nn.Module, mesh, axis: str = "model",
                          override: Optional[Callable] = None) -> dict:
    """``{parameter name: Shard(dim) or Replicate()}`` on ``mesh[axis]``.

    ``override(name, param)`` may return a placement to force (``None``
    defers to the rules).  A dim that does not divide the axis size
    replicates."""
    _, _, size = axis_group(mesh, axis)
    specs = {}
    for name, p in model.named_parameters():
        forced = override(name, p) if override is not None else None
        if forced is not None:
            specs[name] = forced
            continue
        specs[name] = Replicate()
        if p.ndim < 2:
            continue
        for pattern, _, dim in TP_RULES:
            if re.search(pattern, name):
                if p.shape[dim] % size == 0:
                    specs[name] = Shard(dim)
                break
    return specs


#: (block name pattern, column-sharded children, row-sharded child,
#: whether the inner width is heads); the port's names, as ``TP_RULES``
TP_PAIRS = (
    (r"(^|\.)attention$", ("q_proj", "k_proj", "v_proj"), "out_proj",
     True),
    (r"(^|\.)feed_forward$", ("intermediate_dense",), "output_dense",
     False),
)


def _paired(model: nn.Module, specs: dict, n: int) -> set:
    """Names of the linears whose pair keeps its inner width sharded."""
    out = set()
    for name, block in model.named_modules():
        for pattern, cols, row, heads in TP_PAIRS:
            if not re.search(pattern, name):
                continue
            pre = name + "."
            kids = cols + (row,)
            if not all(isinstance(getattr(block, k, None), nn.Linear)
                       for k in kids):
                continue
            if any(specs[pre + k + ".weight"] != Shard(0) for k in cols) \
                    or specs[pre + row + ".weight"] != Shard(1):
                continue
            if any(p.split(".")[0] not in kids
                   for p, _ in block.named_parameters()):
                continue
            h = getattr(block, "num_heads", None)
            if heads and (not h or h % n):
                continue
            out.update(pre + k for k in kids)
    return out


def _style(mod: nn.Module, place: Shard, paired: bool):
    """The ``parallelize_module`` style of a linear or embedding whose
    weight has ``place``."""
    if place.dim == (1 if isinstance(mod, nn.Embedding) else 0):
        return ColwiseParallel() if paired \
            else ColwiseParallel(output_layouts=Replicate())
    return RowwiseParallel() if paired \
        else RowwiseParallel(input_layouts=Replicate())


def _gather_in_forward(mod: nn.Module) -> None:
    """``mod``'s own forward computes with its sharded parameters
    gathered (each gradient is the rank's slice of the full one)."""
    def full(name, p):
        return p.full_tensor() if "." not in name and \
            isinstance(p, DTensor) else p

    open_ = []

    def pre(m, args):
        ctx = params_swapped(m, full)
        ctx.__enter__()
        open_.append(ctx)

    def post(m, args, out):
        open_.pop().__exit__(None, None, None)

    mod.register_forward_pre_hook(pre)
    mod.register_forward_hook(post, always_call=True)


def shard_params(model: nn.Module, mesh, axis: str = "model",
                 override: Optional[Callable] = None) -> nn.Module:
    """Shard ``model``'s parameters in place by
    :func:`tensor_parallel_specs` and make its forward compute with the
    shards (see the module docstring); returns ``model``.  The model's
    parameters are taken as the same on every rank (rank 0's are kept).
    """
    _, _, n = axis_group(mesh, axis)
    sub = mesh[axis]
    specs = tensor_parallel_specs(model, mesh, axis, override)
    paired = _paired(model, specs, n) if n > 1 else set()
    plan, others = {}, []
    for name, mod in model.named_modules():
        own = {leaf: specs[f"{name}.{leaf}" if name else leaf]
               for leaf, _ in mod.named_parameters(recurse=False)}
        sharded = [p for p in own.values() if isinstance(p, Shard)]
        if not sharded:
            continue
        if type(mod) in (nn.Linear, nn.Embedding) and sharded == [
                own["weight"]]:
            plan[name] = _style(mod, own["weight"], name in paired)
        else:
            others.append((name, mod))
    parallelize_module(model, sub, plan)
    # the styles shard a column-parallel bias; the rules replicate it
    for name in plan:
        mod = model.get_submodule(name)
        bias = getattr(mod, "bias", None)
        if isinstance(bias, DTensor) and bias.placements != (Replicate(),):
            mod.bias = nn.Parameter(
                bias.redistribute(placements=[Replicate()]).detach(),
                requires_grad=bias.requires_grad)
    for name, mod in others:
        for leaf, p in list(mod.named_parameters(recurse=False)):
            place = specs[f"{name}.{leaf}" if name else leaf]
            if isinstance(place, Shard):
                mod.register_parameter(leaf, nn.Parameter(
                    distribute_tensor(p.detach(), sub, [place]),
                    requires_grad=p.requires_grad))
        _gather_in_forward(mod)
    return model
