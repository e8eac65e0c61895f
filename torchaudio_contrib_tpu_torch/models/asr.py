"""Classic ASR model families: Wav2Letter and DeepSpeech.

Port of ``torchaudio_contrib_tpu/models/asr.py`` as ``nn.Module`` s whose
``state_dict`` names are torchaudio's (``acoustic_model…`` for
Wav2Letter; ``fc{1..4}.fc``, ``bi_rnn`` and ``out`` for DeepSpeech), so
that the JAX package's importers load them (``import_wav2letter``,
``import_deepspeech``) and ``utils.convert`` loads the JAX models'
parameters into them.  Inputs and outputs keep the JAX models' layouts:
batch-first, ``(B, T', classes)`` out, ready for ``ops.ctc_loss``.

Both take ``device=`` (the card unless the caller asks for the CPU) and
initialise their weights as the JAX models do (Glorot-uniform, zero
biases; the recurrent kernel at half scale) from ``generator``.  Their
convolutions and products follow PyTorch's global precision flags: on
the card ``torch.backends.cudnn.allow_tf32`` (True by default) runs
Wav2Letter's convolutions and the RNN in TF32; set it, and
``torch.backends.cuda.matmul.allow_tf32``, to False for float32 products.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ._common import _glorot_

__all__ = ["Wav2Letter", "DeepSpeech"]


class _PadConv1d(nn.Conv1d):
    """``Conv1d`` with the JAX model's asymmetric padding
    ``((k-1)//2, k//2)`` (``nn.Conv1d`` pads both sides alike)."""

    def __init__(self, cin, cout, k, stride):
        super().__init__(cin, cout, k, stride, padding=0)
        self.pads = ((k - 1) // 2, k // 2)

    def forward(self, x):
        return super().forward(F.pad(x, self.pads))


class Wav2Letter(nn.Module):
    """Wav2Letter conv stack (Collobert et al. 2016).

    ``forward(x)``: ``x`` is ``(B, time)`` for ``input_type="waveform"``
    or ``(B, num_features, T)`` for ``"power_spectrum"`` / ``"mfcc"``.
    Returns ``(B, T', num_classes)`` frame activations.

    ``compat="tpu"`` (default): asymmetric SAME padding, raw activations
    out.  ``compat="torchaudio"``: the published geometry — symmetric
    paddings 45/23/3/16/0, a ReLU after every conv (the last one too) and
    a log-softmax over classes, torchaudio's ``models.Wav2Letter``.
    """

    # (kernel, stride, channels) per conv block, after the input conv
    _BODY = [(7, 1, 250)] * 7 + [(32, 1, 2000), (1, 1, 2000)]
    # torchaudio's symmetric Conv1d paddings by kernel size
    _TORCH_PAD = {250: 45, 48: 23, 7: 3, 32: 16, 1: 0}

    def __init__(self, num_classes: int = 40,
                 input_type: str = "waveform", num_features: int = 1,
                 compat: str = "tpu", *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        if input_type not in ("waveform", "power_spectrum", "mfcc"):
            raise ValueError(f"unknown input_type {input_type!r}")
        if input_type == "waveform" and num_features != 1:
            raise ValueError("waveform input implies num_features=1")
        if compat not in ("tpu", "torchaudio"):
            raise ValueError("compat must be 'tpu' or 'torchaudio', "
                             f"got {compat!r}")
        self.num_classes = num_classes
        self.input_type = input_type
        self.num_features = num_features
        self.compat = compat

        def block(k, stride, cin, cout, relu=True):
            if compat == "torchaudio":
                conv = nn.Conv1d(cin, cout, k, stride,
                                 padding=self._TORCH_PAD[k])
            else:
                conv = _PadConv1d(cin, cout, k, stride)
            _glorot_(conv.weight, k * cin, k * cout, generator)
            nn.init.zeros_(conv.bias)
            return [conv, nn.ReLU()] if relu else [conv]

        cin = 250 if input_type == "waveform" else num_features
        layers = block(48, 2, cin, 250)
        cin = 250
        for k, stride, cout in self._BODY:
            layers += block(k, stride, cin, cout)
            cin = cout
        layers += block(1, 1, cin, num_classes, relu=compat == "torchaudio")
        acoustic = nn.Sequential(*layers)
        if input_type == "waveform":
            head = nn.Sequential(*block(250, 160, 1, 250))
            self.acoustic_model = nn.Sequential(head, acoustic)
        else:
            self.acoustic_model = acoustic
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.input_type == "waveform":
            if x.ndim != 2:
                raise ValueError("waveform input must be (batch, time)")
            x = x[:, None, :]
        elif x.ndim != 3 or x.shape[1] != self.num_features:
            raise ValueError(
                f"input must be (batch, {self.num_features}, time)")
        y = self.acoustic_model(x).transpose(1, 2)       # (B, T', classes)
        if self.compat == "torchaudio":
            y = torch.log_softmax(y, -1)
        return y


class _FullyConnected(nn.Module):
    """torchaudio's ``FullyConnected``: Linear, then hardtanh(0, 20)."""

    def __init__(self, cin: int, cout: int, dropout: float, generator):
        super().__init__()
        self.fc = nn.Linear(cin, cout)
        _glorot_(self.fc.weight, cin, cout, generator)
        nn.init.zeros_(self.fc.bias)
        self.dropout = dropout

    def forward(self, x):
        x = F.hardtanh(self.fc(x), 0.0, 20.0)
        return F.dropout(x, self.dropout, self.training) if self.dropout \
            else x


class DeepSpeech(nn.Module):
    """DeepSpeech (Hannun et al. 2014): 3 clipped-ReLU FC layers, one
    bidirectional vanilla ReLU RNN (``nn.RNN``, the two directions'
    outputs summed — torchaudio's layout), a clipped FC and a linear head.

    ``forward(x, log_probs=False)``: ``x`` ``(B, T, n_feature)`` →
    ``(B, T, n_class)`` raw activations; ``log_probs=True`` applies the
    final log-softmax torchaudio's forward returns.  ``dropout`` acts in
    training mode after each clipped FC layer, as torchaudio's (the JAX
    model has none; the default 0 matches it).
    """

    def __init__(self, n_feature: int, n_hidden: int = 2048,
                 n_class: int = 40, dropout: float = 0.0, *, device="cuda",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.n_feature = n_feature
        self.n_hidden = n_hidden
        self.n_class = n_class
        h = n_hidden
        self.fc1 = _FullyConnected(n_feature, h, dropout, generator)
        self.fc2 = _FullyConnected(h, h, dropout, generator)
        self.fc3 = _FullyConnected(h, h, dropout, generator)
        self.bi_rnn = nn.RNN(h, h, num_layers=1, nonlinearity="relu",
                             bidirectional=True, batch_first=True)
        for sfx in ("", "_reverse"):
            _glorot_(getattr(self.bi_rnn, f"weight_ih_l0{sfx}"), h, h,
                     generator)
            _glorot_(getattr(self.bi_rnn, f"weight_hh_l0{sfx}"), h, h,
                     generator, 0.5)
            nn.init.zeros_(getattr(self.bi_rnn, f"bias_ih_l0{sfx}"))
            nn.init.zeros_(getattr(self.bi_rnn, f"bias_hh_l0{sfx}"))
        self.fc4 = _FullyConnected(h, h, dropout, generator)
        self.out = nn.Linear(h, n_class)
        _glorot_(self.out.weight, h, n_class, generator)
        nn.init.zeros_(self.out.bias)
        self.to(device)

    def forward(self, x: torch.Tensor, log_probs: bool = False):
        if x.ndim != 3 or x.shape[-1] != self.n_feature:
            raise ValueError(f"x must be (batch, time, {self.n_feature})")
        y = self.fc3(self.fc2(self.fc1(x)))
        y, _ = self.bi_rnn(y)
        y = y[..., :self.n_hidden] + y[..., self.n_hidden:]
        y = self.out(self.fc4(y))
        return torch.log_softmax(y, -1) if log_probs else y
