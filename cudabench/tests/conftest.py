"""The toy stand-in of ``w2v2_asr_serve`` (a three-convolution extractor,
two layers of width 16), added to ``toy``'s tables, so that ``toy.write``
finds a toy for every cell of ``BENCHMARK.json``.  Its configuration names
the bundle ``W2V2_TOY``, a ``Wav2Vec2ASRBundle`` of the toy's geometry put
into ``pipelines`` for each test, so that the toy is built the way the
cell's model is."""
import functools

import pytest

from cudabench.tests import toy

TOY_ARGS = {"extractor_conv_layers": [[8, 10, 5], [8, 3, 2], [8, 2, 2]],
            "d_model": 16, "num_layers": 2, "num_heads": 2, "ff_dim": 32,
            "pos_conv_kernel": 8, "pos_conv_groups": 4, "aux_out": 5,
            "extractor_mode": "group_norm", "conv_bias": False,
            "layer_norm_first": False}

toy.CONFIGS.setdefault("tw2v2", {
    "source": "toy", "system": "wav2vec2_asr", "bundle": "W2V2_TOY",
    "args": dict(TOY_ARGS, sample_rate=8000),
    "precision": {"tf32": False}, "reduced": []})
toy.MIXES.setdefault("tasr", {
    "driver": "asr_serve", "clips": 3, "channels": 1,
    "clip_seconds": [0.1, 0.5], "pool": 2, "length_seed": 0,
    "amplitude": 0.1, "keep": 3, "keep_span": 6})
toy.CELLS.setdefault("w2v2_asr_serve", ("tw2v2", "tasr"))


@pytest.fixture(autouse=True)
def toy_bundle(monkeypatch):
    from torchaudio_contrib_tpu_torch import pipelines
    from torchaudio_contrib_tpu_torch.models import Wav2Vec2
    args = {k: v for k, v in TOY_ARGS.items() if k != "aux_out"}
    args["extractor_conv_layers"] = tuple(
        tuple(layer) for layer in args["extractor_conv_layers"])
    bundle = pipelines.Wav2Vec2ASRBundle(
        functools.partial(Wav2Vec2, **args), sample_rate=8000,
        labels=tuple("-abcd"))
    monkeypatch.setattr(pipelines, "W2V2_TOY", bundle, raising=False)
