"""The toy stand-in of ``rnnt_stream`` (an Emformer-RNNT of two layers of
width 24 serving 6 slots of 0.3–1.2 s clips), added to
``tests/toy.py``'s tables, so that ``toy.write`` finds a toy for every
cell of ``BENCHMARK.json``.  Its configuration names the bundle
``RNNT_TOY``, an ``RNNTBundle`` of the toy's geometry put into
``pipelines`` for each test under ``cudabench/``, so that the toy is built
and served the way the cell's model is."""
import dataclasses

import pytest

from cudabench.tests import toy

TOY_ARGS = {"sample_rate": 16000, "n_mels": 80, "fft_length": 400,
            "hop_length": 160, "time_reduction_input_dim": 6,
            "time_reduction_stride": 4, "d_model": 24, "num_layers": 2,
            "num_heads": 2, "ffn_dim": 16, "left_context_length": 5,
            "segment_length": 4, "right_context_length": 1,
            "max_memory_size": 0, "encoding_dim": 24,
            "predictor_embed_dim": 8, "predictor_hidden_dim": 8,
            "predictor_layers": 2, "lstm_layer_norm_eps": 0.001,
            "num_symbols": 11, "blank": 0, "max_symbols": 4}

toy.CONFIGS.setdefault("trnnt", {
    "source": "toy", "system": "emformer_rnnt", "bundle": "RNNT_TOY",
    "args": TOY_ARGS, "precision": {"tf32": False}, "reduced": []})
toy.MIXES.setdefault("tstream", {
    "driver": "stream_serve", "clips": 6, "channels": 1,
    "clip_seconds": [0.3, 1.2], "pool": 5, "length_seed": 0,
    "amplitude": 0.1, "keep": 3, "keep_span": 24})
toy.CELLS.setdefault("rnnt_stream", ("trnnt", "tstream"))


@pytest.fixture(autouse=True)
def rnnt_toy_bundle(monkeypatch):
    from torchaudio_contrib_tpu_torch import pipelines
    from torchaudio_contrib_tpu_torch.models import emformer_rnnt_model

    @dataclasses.dataclass(frozen=True)
    class ToyBundle(pipelines.RNNTBundle):
        def _model(self, device, generator):
            a = TOY_ARGS
            return emformer_rnnt_model(
                input_dim=a["n_mels"], encoding_dim=a["encoding_dim"],
                num_symbols=a["num_symbols"],
                segment_length=self.segment_length,
                right_context_length=self.right_context_length,
                left_context_length=a["left_context_length"],
                num_heads=a["num_heads"], ffn_dim=a["ffn_dim"],
                num_layers=a["num_layers"], max_memory_size=0,
                predictor_embed_dim=a["predictor_embed_dim"],
                predictor_hidden_dim=a["predictor_hidden_dim"],
                predictor_layers=a["predictor_layers"],
                time_reduction_input_dim=a["time_reduction_input_dim"],
                time_reduction_stride=a["time_reduction_stride"],
                transformer_activation="gelu", lstm_layer_norm=True,
                lstm_layer_norm_epsilon=a["lstm_layer_norm_eps"],
                device=device, generator=generator)

    monkeypatch.setattr(pipelines, "RNNT_TOY",
                        ToyBundle(num_symbols=TOY_ARGS["num_symbols"]),
                        raising=False)
