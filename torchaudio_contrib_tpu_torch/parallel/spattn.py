"""Sequence-parallel (time-sharded) attention for the encoders.

Port of ``torchaudio_contrib_tpu/parallel/spattn.py``.  The time axis that
:mod:`.timeshard` splits for the front end runs on through the Conformer
and wav2vec2 encoders, so a minutes-long recording never holds a whole
``T×T`` attention, or the whole ``T`` activations, on one rank.

* :func:`ring_attention`: each rank keeps its query shard; the key/value
  block travels the ring (``n − 1`` hops of :func:`._comm.ppermute`).  The
  softmax is accumulated online (running max ``m``, normaliser ``l``,
  unnormalised output ``o``), always in float32 whatever the inputs' dtype
  (the JAX package's accumulators take ``q.dtype``, so its bfloat16 runs
  accumulate in bfloat16); the result is cast back to ``q.dtype``.  Masked
  keys take the models' ``-1e30``, so a row with no valid key is uniform,
  not NaN.  Position biases and padding come from global indices.
* Local ops (norms, FFNs, pointwise convs) run on the shard; the
  depthwise conv, the wav2vec2 extractor and the positional conv get
  two-sided halos (:func:`._comm.halo`); the BASE extractor's GroupNorm
  takes its moments over global time from two summed passes.  WavLM's
  gated bias rides the ring: the gate needs only the local queries, the
  bucket only the global offset ``k − q``.

The ``sp_*`` functions run the model's own modules on the shard; its
parameters are read through :func:`._comm.copy_to`, so after
``loss.backward()`` every rank holds the whole gradient (the sum of the
shards' parts, as the JAX transpose sums over the axis).  The loss of a
rank is its shard's part: each rank backpropagates a loss of its own
output rows.  Inputs are the whole tensor on every rank (each takes its
chunk) or a DTensor sharded on time; outputs are DTensors sharded on time.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..models._common import _fp32_cudnn
from ._comm import (as_sharded, axis_group, copy_to, halo, params_swapped,
                    ppermute, psum)

__all__ = ["ring_attention", "sp_conformer_apply", "sp_wav2vec2_apply"]

_NEG = -1e30


# ---------------------------------------------------------------- ring

def ring_attention(q, k, v, group=None, *,
                   lengths: Optional[torch.Tensor] = None,
                   bias_fn: Optional[Callable] = None,
                   scale: Optional[float] = None):
    """Time-sharded multi-head attention (per-rank code).

    ``q, k, v (B, T_local, H, dh)`` are this rank's time shard; ``group``
    is the ring's process group (``mesh.get_group(axis)``; the JAX
    ``axis_name``).  ``lengths (B,)`` are GLOBAL valid lengths; keys past
    them are masked with ``-1e30``.  ``bias_fn(q_idx (Tq,), k_idx (Tk,))``
    returns a logit bias ``(H, Tq, Tk)`` or ``(B, H, Tq, Tk)`` from global
    indices.  Returns ``(B, T_local, H, dh)`` in ``q.dtype``; the running
    max, normaliser and output are float32.
    """
    B, Tl, H, dh = q.shape
    idx, n = dist.get_rank(group), dist.get_world_size(group)
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    dev = q.device
    q_idx = idx * Tl + torch.arange(Tl, device=dev)
    qf = q.float()
    m = torch.full((B, H, Tl), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Tl), dtype=torch.float32, device=dev)
    o = torch.zeros((B, H, Tl, dh), dtype=torch.float32, device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    kb, vb = k, v
    for step in range(n):
        owner = (idx - step) % n                 # whose block this is
        k_idx = owner * Tl + torch.arange(Tl, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        if bias_fn is not None:
            bias = bias_fn(q_idx, k_idx).float()
            s = s + (bias if bias.ndim == 4 else bias[None])
        if lengths is not None:
            valid = k_idx[None] < lengths[:, None].to(dev)      # (B, Tk)
            s = s.masked_fill(~valid[:, None, None, :], _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                vb.float())
        m = m_new
        if step != n - 1:
            kb = ppermute(kb, perm, group)
            vb = ppermute(vb, perm, group)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).to(q.dtype)             # (B, Tl, H, dh)


# ---------------------------------------------------------------- helpers

def _local_time(x: torch.Tensor, dim: int, idx: int, n: int):
    if isinstance(x, DTensor):
        return x.to_local()
    return x.narrow(dim, idx * (x.shape[dim] // n), x.shape[dim] // n)


def _mask(x, pad_mask):
    return torch.where(pad_mask[..., None], x, 0.0)


# ---------------------------------------------------------------- Conformer

def _conformer_attention(att, y, lengths, group):
    B, Tl, d = y.shape
    h, maxd = att.h, att.max_distance
    q, k, v = F.linear(y, att.in_proj_weight, att.in_proj_bias) \
        .unflatten(-1, (3, h, d // h)).unbind(2)
    rel = att.rel_bias

    def bias_fn(q_idx, k_idx):
        off = (k_idx[None, :] - q_idx[:, None]).clamp(-maxd, maxd)
        return rel[off + maxd].permute(2, 0, 1)               # (H, Tq, Tk)

    out = ring_attention(q, k, v, group, lengths=lengths, bias_fn=bias_fn)
    return att.out_proj(out.reshape(B, Tl, d))


def _conformer_conv(cm, x, pad_mask, group):
    seq = cm.sequential
    y = cm.layer_norm(x)
    if pad_mask is not None:
        y = _mask(y, pad_mask)
    y = seq[1](seq[0](y.transpose(1, 2))).transpose(1, 2)     # GLU
    dw = seq[2]
    pad = dw.kernel_size[0] // 2
    yp = halo(y, pad, pad, group, dim=1)
    y = F.conv1d(yp.transpose(1, 2), dw.weight, dw.bias,
                 groups=dw.groups).transpose(1, 2)
    y = seq[4](seq[3](y))
    return x + seq[6](seq[5](y.transpose(1, 2)).transpose(1, 2))


def _conformer_shard(model, xl, lengths, group, idx):
    B, Tl, _ = xl.shape
    pos = idx * Tl + torch.arange(Tl, device=xl.device)
    pad_mask = pos[None, :] < lengths[:, None]
    x = model.input_projection(xl)
    for layer in model.conformer_layers:
        x = layer.ffn1(x)

        def attention(x):
            return x + layer.self_attn_dropout(_conformer_attention(
                layer.self_attn, layer.self_attn_layer_norm(x), lengths,
                group))

        if layer.convolution_first:
            x = attention(_conformer_conv(layer.conv_module, x, pad_mask,
                                          group))
        else:
            x = _conformer_conv(layer.conv_module, attention(x), pad_mask,
                                group)
        x = layer.final_layer_norm(layer.ffn2(x))
        x = _mask(x, pad_mask)
    return x


@_fp32_cudnn
def sp_conformer_apply(model, x, lengths=None, *, mesh, axis: str = "data"):
    """The :class:`~..models.Conformer` forward with TIME split over
    ``mesh[axis]``: ring attention and the haloed depthwise conv; each
    rank holds ``T/n`` frames and no ``T×T`` score matrix exists.  ``x
    (B, T, input_dim)`` with ``T`` divisible by the axis size; returns
    ``(B, T, d_model)`` as a DTensor sharded on time."""
    group, idx, n = axis_group(mesh, axis)
    T = x.shape[1]
    if T % n:
        raise ValueError(f"time length {T} must divide the "
                         f"'{axis}' axis size {n}; pad the tail")
    xl = _local_time(x, 1, idx, n)
    dev = xl.device
    if lengths is None:
        lengths = torch.full((x.shape[0],), T, dtype=torch.long)
    lengths = torch.as_tensor(lengths, device=dev).long()
    with params_swapped(model, lambda _, p: copy_to(p, group)):
        out = _conformer_shard(model, xl, lengths, group, idx)
    return as_sharded(out, mesh, axis, 1)


# ---------------------------------------------------------------- Wav2Vec2

def _group_norm_global(y, norm, own, group):
    """``nn.GroupNorm(C, C)`` over global time: ``y (B, C, t)`` holds this
    rank's frames, ``own (t,)`` marks the frames it owns that exist
    globally; the moments are two summed passes (mean, then the squared
    deviations: ``E[x²] − E[x]²`` cancels in float32)."""
    w8 = own.to(y.dtype)[None, None, :]
    cnt = psum(w8.sum(-1), group)                             # (1, 1)
    mu = psum((y * w8).sum(-1), group) / cnt                  # (B, C)
    d = (y - mu[..., None]) * w8
    var = psum((d * d).sum(-1), group) / cnt
    y = (y - mu[..., None]) * torch.rsqrt(var[..., None] + norm.eps)
    return y * norm.weight[:, None] + norm.bias[:, None]


def _w2v2_extract(model, wl, group, idx, n):
    B, Tl = wl.shape
    rf, st = 1, 1
    for _, kk, ss in model.extractor:
        rf = rf + (kk - 1) * st
        st = st * ss
    t_glob = Tl * n
    # the last rank's zero halo yields phantom frames past the globally
    # existing ones; the padding mask retires them
    y = halo(wl[:, None, :], 0, rf - st, group, dim=2)         # (B, 1, t)
    cum, rf_cur = 1, 1
    for layer, (_, kk, ss) in zip(model.feature_extractor.conv_layers,
                                  model.extractor):
        y = layer.conv(y)
        rf_cur = rf_cur + (kk - 1) * cum
        cum *= ss
        if layer.norm == "layer_norm":
            y = layer.layer_norm(y.transpose(1, 2)).transpose(1, 2)
        elif layer.norm == "group_norm":
            here = y.shape[-1]
            offs = idx * (Tl // cum) + torch.arange(here, device=y.device)
            n_glob = (t_glob - rf_cur) // cum + 1
            own = (torch.arange(here, device=y.device) < Tl // cum) \
                & (offs < n_glob)
            y = _group_norm_global(y, layer.layer_norm, own, group)
        y = F.gelu(y)
    return y.transpose(1, 2)                                  # (B, Tf, C)


def _wavlm_bias_fn(model, att, y, offsets, t_glob):
    B, Tf, d = y.shape
    h = model.num_heads
    gates = torch.sigmoid(att.gru_rel_pos_linear(
        y.view(B, Tf, h, d // h)).view(B, Tf, h, 2, 4).sum(-1))
    gate = (gates[..., 0] * (gates[..., 1] * att.gru_rel_pos_const.view(h)
                             - 1.0) + 2.0).transpose(1, 2)    # (B, H, Tq)
    table = model.encoder.layers[0].attention.rel_attn_embed.weight

    def bias_fn(q_idx, k_idx):
        bucket = offsets[k_idx[None, :] - q_idx[:, None] + t_glob - 1]
        return gate[..., None] * table[bucket].permute(2, 0, 1)[None]

    return bias_fn


def _w2v2_attention(model, att, y, lengths, group, offsets, t_glob):
    B, Tf, d = y.shape
    h = model.num_heads
    q, k, v = (lin(y).view(B, Tf, h, d // h)
               for lin in (att.q_proj, att.k_proj, att.v_proj))
    bias_fn = (_wavlm_bias_fn(model, att, y, offsets, t_glob)
               if offsets is not None else None)
    out = ring_attention(q, k, v, group, lengths=lengths, bias_fn=bias_fn)
    return att.out_proj(out.reshape(B, Tf, d))


def _w2v2_shard(model, wl, lengths, group, idx, n):
    feats = _w2v2_extract(model, wl, group, idx, n)
    B, Tf, _ = feats.shape
    dev = feats.device
    pos_g = idx * Tf + torch.arange(Tf, device=dev)
    out_lengths = model.output_length(lengths)
    pad_mask = pos_g[None, :] < out_lengths[:, None]
    feats = _mask(feats, pad_mask)
    fp = model.feature_projection
    x = _mask(fp.projection(fp.layer_norm(feats)), pad_mask)
    k = model.pos_k
    xh = halo(x, k // 2, (k - 1) // 2, group, dim=1)
    pos = model.encoder.pos_conv_embed.conv(xh.transpose(1, 2))
    x = x + F.gelu(pos.transpose(1, 2))
    if not model.layer_norm_first:
        x = model.encoder.layer_norm(x)
    x = _mask(x, pad_mask)

    offsets, t_glob = None, Tf * n
    if getattr(model, "num_buckets", None) is not None:
        from ..models.wav2vec2 import wavlm_buckets
        offsets = torch.from_numpy(wavlm_buckets(
            np.arange(-(t_glob - 1), t_glob), model.num_buckets,
            model.max_distance)).to(dev)

    def attention(layer, y):
        return _w2v2_attention(model, layer.attention, y, out_lengths,
                               group, offsets, t_glob)

    for layer in model.encoder.layers:
        if model.layer_norm_first:
            x = x + attention(layer, layer.layer_norm(x))
            x = x + layer.feed_forward(layer.final_layer_norm(x))
        else:
            x = layer.layer_norm(x + attention(layer, x))
            x = layer.final_layer_norm(x + layer.feed_forward(x))
        x = _mask(x, pad_mask)
    if model.layer_norm_first:
        x = _mask(model.encoder.layer_norm(x), pad_mask)
    if model.aux_out is not None:
        x = model.aux(x)
    return x, out_lengths


@_fp32_cudnn
def sp_wav2vec2_apply(model, waveforms, lengths=None, *, mesh,
                      axis: str = "data"):
    """The :class:`~..models.Wav2Vec2` (or ``WavLM``) forward with TIME
    split over ``mesh[axis]`` end to end: haloed extractor convs (the BASE
    GroupNorm's moments summed over the ranks), haloed positional conv,
    ring attention in every layer.  ``waveforms (B, T)`` with ``T`` a
    multiple of ``n · total_stride`` (320·n for the published extractor);
    returns ``(out (B, T', d or aux) as a DTensor sharded on time,
    out_lengths)``.  Frames past ``output_length(T)`` (the last rank's
    phantoms) are zeros or the head's bias."""
    group, idx, n = axis_group(mesh, axis)
    st = 1
    for _, _, s in model.extractor:
        st *= s
    B, T = waveforms.shape
    if T % (n * st):
        raise ValueError(
            f"sample count {T} must be a multiple of axis size x "
            f"total extractor stride = {n * st}; pad the tail")
    wl = _local_time(waveforms, 1, idx, n)
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.long)
    lengths = torch.as_tensor(lengths, device=wl.device).long()
    with params_swapped(model, lambda _, p: copy_to(p, group)):
        out, out_lengths = _w2v2_shard(model, wl, lengths, group, idx, n)
    return as_sharded(out, mesh, axis, 1), out_lengths
