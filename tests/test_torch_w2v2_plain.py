"""The port's ``models/wav2vec2.py`` against the benchmark's plain
reference (``cudabench/reference/wav2vec2.py``), in float64 on the CPU;
``ops.ctc_greedy_decode`` against the reference's plain collapse; the
``tac::w2v2.*`` and ``tac::ctc.greedy`` spans and the ``W2V2_FRAMES``
counter.

Toy widths: a three-convolution extractor of 16 channels, d 32, 2 layers,
4 heads, FFN 64, positional kernel 8 (or 9) in 4 groups, 5 labels.  Every
parameter is moved by 0.1 of a normal draw, so that no bias is zero (a
zero bias hides a padding leak).  Only valid frames are compared (the
port zeroes padded frames after every layer; the reference, as
torchaudio, does not).  Bar: 1e-10 of the logits' peak, float64 summed in
two orders.
"""
import pytest
import torch

from cudabench.reference import wav2vec2 as R
from torchaudio_contrib_tpu_torch.models import Wav2Vec2
from torchaudio_contrib_tpu_torch.ops import ctc_greedy_decode
from torchaudio_contrib_tpu_torch.utils import trace

torch.set_num_threads(2)

TOY = dict(extractor_conv_layers=((16, 10, 5), (16, 3, 2), (16, 2, 2)),
           d_model=32, num_layers=2, num_heads=4, ff_dim=64,
           pos_conv_groups=4, aux_out=5)
SAMPLES = 1600                        # 79 frames
LENGTHS = [1600, 1000, 430]           # 79, 49 and 21 frames
BAR = 1e-10
# name -> (model arguments, lengths given)
CASES = {
    "BASE: group_norm, post-LN, kernel 8, padded": (
        dict(extractor_mode="group_norm", layer_norm_first=False,
             pos_conv_kernel=8), LENGTHS),
    "BASE: group_norm, post-LN, kernel 8, whole": (
        dict(extractor_mode="group_norm", layer_norm_first=False,
             pos_conv_kernel=8), None),
    "LARGE-lv60k: layer_norm, conv bias, pre-LN, kernel 9, padded": (
        dict(extractor_mode="layer_norm", layer_norm_first=True,
             pos_conv_kernel=9), LENGTHS),
}


def _args(kw):
    a = dict(TOY, **kw)
    a["conv_bias"] = a["extractor_mode"] == "layer_norm"
    return a


def _model(kw, seed=0):
    g = torch.Generator().manual_seed(seed)
    model = Wav2Vec2(**_args(kw), device="cpu", generator=g).double()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=g,
                                     dtype=torch.float64))
    return model.eval()


def _batch(lengths, seed=1):
    g = torch.Generator().manual_seed(seed)
    x = 0.1 * torch.randn(3, SAMPLES, generator=g, dtype=torch.float64)
    if lengths is None:
        return x, None
    n = torch.tensor(lengths)
    return torch.where(torch.arange(SAMPLES)[None] < n[:, None], x, 0.0), n


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_equals_plain_reference(case):
    kw, lengths = CASES[case]
    model = _model(kw)
    x, n = _batch(lengths)
    with torch.no_grad():
        y, out_len = model(x, n)
        ref, ref_len = R.forward(model.state_dict(), x, n, _args(kw))
    assert out_len.tolist() == ref_len.tolist()
    if lengths is not None:
        assert ref_len.tolist() == [79, 49, 21]
    peak = ref.abs().max()
    for i, t in enumerate(ref_len.tolist()):
        assert (y[i, :t] - ref[i, :t]).abs().max() <= BAR * peak, i
    # the padded batch is no batch of whole clips: GroupNorm's statistics
    # run over the padded length, so a request alone answers otherwise
    if lengths is not None and kw["extractor_mode"] == "group_norm":
        with torch.no_grad():
            alone, _ = R.forward(model.state_dict(), x[2:, :430], None,
                                 _args(kw))
        assert (alone[0] - ref[2, :21]).abs().max() > 1e-3 * peak


def test_greedy_decode_equals_plain_collapse():
    kw, lengths = CASES["BASE: group_norm, post-LN, kernel 8, padded"]
    model = _model(kw, seed=2)
    x, n = _batch(lengths, seed=3)
    with torch.no_grad():
        y, out_len = model(x, n)
    log_probs = y.log_softmax(-1)
    tokens, token_len, _ = ctc_greedy_decode(log_probs, out_len)
    path = log_probs.max(-1).indices
    answers = [R.collapse(path[i, :t]) for i, t in enumerate(out_len)]
    assert max(map(len, answers)) > 3
    for i, want in enumerate(answers):
        assert token_len[i] == len(want)
        assert tokens[i, :len(want)].tolist() == want
        assert (tokens[i, len(want):] == -1).all()


NAMES = {"tac::w2v2.forward", "tac::w2v2.extract", "tac::w2v2.project",
         "tac::w2v2.pos_conv", "tac::w2v2.layer", "tac::w2v2.attention",
         "tac::w2v2.ffn", "tac::w2v2.head", "tac::ctc.greedy"}


def test_spans_and_frame_counter():
    """A toy forward and decode under the CPU profiler: every new span,
    a layer span per encoder layer with one attention and one FFN each;
    ``W2V2_FRAMES`` moves by ``batch · T'`` a call, profiled or not."""
    from torch.profiler import ProfilerActivity, profile
    kw, lengths = CASES["BASE: group_norm, post-LN, kernel 8, padded"]
    model = _model(kw)
    x, n = _batch(lengths)
    before = trace.W2V2_FRAMES
    with torch.no_grad():
        model(x, n)
    assert trace.W2V2_FRAMES - before == 3 * 79
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.no_grad():
        y, out_len = model(x, n)
        ctc_greedy_decode(y.log_softmax(-1), out_len)
    assert trace.W2V2_FRAMES - before == 2 * 3 * 79
    seen = [e.name for e in prof.events() if e.name.startswith("tac::")]
    assert set(seen) == NAMES
    for name, count in (("tac::w2v2.layer", 2), ("tac::w2v2.attention", 2),
                        ("tac::w2v2.ffn", 2), ("tac::w2v2.forward", 1),
                        ("tac::ctc.greedy", 1)):
        assert seen.count(name) == count, name
