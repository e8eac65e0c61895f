"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device.  The
file imports no JAX (the GPU machine has none), so it runs there without
``tests/conftest.py``, which imports JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import copy
import functools

import numpy as np
import pytest
import torch

from torchaudio_contrib_tpu_torch import ops as tops
from torchaudio_contrib_tpu_torch.ops import fused as tfused
from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as tgl
import torchaudio_contrib_tpu_torch as tat

PARITY = 1e-5    # max |kernel - plain| / max |plain|: both are f32 chains
GRAD_PARITY = 1e-4   # the same for gradients (the BASELINE bar)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    """max |got - want| / max |want|, on the CPU."""
    got, want = got.detach().cpu(), want.detach().cpu()
    return ((got - want).abs().max() / want.abs().max()).item()


def _inputs(seed, shape, mels, sr, fft):
    x = np.random.default_rng(seed).standard_normal(shape)
    fb = tops.create_mel_filter(mels, sr, 0.0, None, fft // 2 + 1)
    return torch.from_numpy(x.astype(np.float32)), fb


# config 2, Whisper, stereo with ragged frames, to_db=False, center=True,
# a shorter window, the smallest fft, the most mels
CASES = [
    ((2, 88200), 2048, 512, 128, 22050, {}),
    ((2, 48000), 400, 160, 80, 16000, {}),
    ((2, 2, 7000), 256, 64, 40, 16000, {}),
    ((2, 20000), 512, 128, 64, 16000, {"to_db": False}),
    ((3, 9000), 512, 200, 64, 16000, {"center": True}),
    ((2, 9000), 512, 128, 64, 16000, {"win_length": 300}),
    ((1, 100), 2, 1, 1, 16000, {}),
    # the largest mel accumulator the kernel's shared memory holds (704
    # padded mels), at ~2.9 linear bins per band like Whisper's 2.5
    ((1, 40000), 4096, 1024, 700, 16000, {"db_ref": 0.5}),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,fft,hop,mels,sr,kw", CASES)
def test_kernel_matches_plain(cuda_device, shape, fft, hop, mels, sr, kw):
    x, fb = _inputs(len(shape) * fft + hop, shape, mels, sr, fft)
    want = tops.fused_melspectrogram(x, fb, fft, hop, **kw)
    before = tfused.KERNEL_LAUNCHES
    with torch.inference_mode():
        got = tops.fused_melspectrogram(x.to(cuda_device),
                                        fb.to(cuda_device), fft, hop, **kw)
        torch.cuda.synchronize()
    assert tfused.KERNEL_LAUNCHES == before + 1
    got = got.cpu()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert err <= PARITY, err


def _grads(x, fb, fft, hop, g, need=(True, True), **kw):
    """(out, dx, dfb) of ``sum(fused_melspectrogram(x, fb) * g)``."""
    x = x.detach().clone().requires_grad_(need[0])
    fb = fb.detach().clone().requires_grad_(need[1])
    out = tops.fused_melspectrogram(x, fb, fft, hop, **kw)
    (out * g).sum().backward()
    return out.detach(), x.grad, fb.grad


def _launches():
    return (tfused.KERNEL_LAUNCHES, tfused.BWD_KERNEL_LAUNCHES,
            tfused.BWD_DFRAMES_LAUNCHES)


def _dfb_launches():
    return tfused.BWD_DFB_LAUNCHES, tfused.BWD_DFB_ONE_READ_LAUNCHES


def _one_read(mels):
    """The dFB pass reads the residual once up to 128 padded mels."""
    return int(-(-mels // 64) * 64 <= 128)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,fft,hop,mels,sr,kw", CASES)
def test_backward_kernel_matches_plain(cuda_device, shape, fft, hop, mels,
                                       sr, kw):
    """Kernel gradients against autograd of the plain chain (on the CPU),
    the filterbank's also against the chain in float64; two backward runs
    bitwise equal; each ran the dFB pass once, reading the residual once
    up to 128 padded mels (the Nyquist bin folded at fft 256, 2048 and
    4096; fft 400's 201 bins a tile and a partial one; 704 mels in 64-mel
    tiles)."""
    x, fb = _inputs(len(shape) * fft + hop + 1, shape, mels, sr, fft)
    with torch.no_grad():
        out = tops.fused_melspectrogram(x, fb, fft, hop, **kw)
    g = torch.from_numpy(np.random.default_rng(hop).standard_normal(
        tuple(out.shape)).astype(np.float32))
    _, want_dx, want_dfb = _grads(x, fb, fft, hop, g, **kw)
    _, _, dfb64 = _grads(x.double(), fb.double(), fft, hop, g.double(),
                         need=(False, True), **kw)
    xd, fbd, gd = x.to(cuda_device), fb.to(cuda_device), g.to(cuda_device)
    before, dfb_before = _launches(), _dfb_launches()
    runs = [_grads(xd, fbd, fft, hop, gd, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert _launches() == tuple(b + 2 for b in before)
    assert _dfb_launches() == (dfb_before[0] + 2,
                               dfb_before[1] + 2 * _one_read(mels))
    (_, dx, dfb), (_, dx2, dfb2) = runs
    assert torch.equal(dx, dx2) and torch.equal(dfb, dfb2)
    for got, want in ((dx.cpu(), want_dx), (dfb.cpu(), want_dfb),
                      (dfb.cpu().double(), dfb64)):
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        # relative to the peak; exact where the plain gradient is all zero
        # (fft 2 with one mel: the filter is empty, every mel is clamped)
        err = (got - want).abs().max().item()
        assert err <= GRAD_PARITY * want.abs().max().item(), err


@pytest.mark.cuda
def test_filterbank_only_skips_frame_passes(cuda_device):
    x, fb = _inputs(5, (2, 1, 16000), 64, 16000, 512)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 1, 64, 122)).astype(np.float32))
    _, _, want = _grads(x, fb, 512, 128, g, need=(False, True))
    _, _, want64 = _grads(x.double(), fb.double(), 512, 128, g.double(),
                          need=(False, True))
    before, dfb_before = _launches(), _dfb_launches()
    _, dx, got = _grads(x.to(cuda_device), fb.to(cuda_device), 512, 128,
                        g.to(cuda_device), need=(False, True))
    assert _launches() == (before[0] + 1, before[1] + 1, before[2])
    assert _dfb_launches() == (dfb_before[0] + 1, dfb_before[1] + 1)
    assert dx is None
    err = ((got.cpu() - want).abs().max() / want.abs().max()).item()
    assert err <= GRAD_PARITY, err
    assert _peak_err(got.cpu().double(), want64) <= GRAD_PARITY


@pytest.mark.cuda
def test_silence_gives_exactly_zero_gradients(cuda_device):
    x = torch.zeros((2, 8192), device=cuda_device)
    fb = tops.create_mel_filter(32, 16000, 0.0, None, 257, device=cuda_device)
    g = torch.randn((2, 32, 61), device=cuda_device)
    _, dx, dfb = _grads(x, fb, 512, 128, g)
    assert not dx.any() and not dfb.any()


@pytest.mark.cuda
def test_kernel_gradients_flow(cuda_device):
    """Gradients through the op on the card launch the forward kernel with
    its residual and the backward kernel; without a gradient the forward
    runs alone."""
    x = torch.randn((1, 4096), device=cuda_device)
    fb = tops.create_mel_filter(16, 16000, 0.0, None, 129,
                                device=cuda_device).requires_grad_(True)
    before = _launches()
    tops.fused_melspectrogram(x, fb, 256, 128).sum().backward()
    assert _launches() == (before[0] + 1, before[1] + 1, before[2])
    assert fb.grad is not None and bool(torch.isfinite(fb.grad).all())
    with torch.no_grad():
        assert tops.fused_melspectrogram(x, fb, 256, 128).shape == (1, 16, 31)
    assert _launches()[1] == before[1] + 1


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    """What the kernel does not take raises; ``power != 2`` is not among
    it: the JAX package's rule sends it to the plain chain on the card,
    decided before any launch, and no launch is counted."""
    x = torch.randn((1, 4096), device=cuda_device)
    fb = tops.create_mel_filter(16, 16000, 0.0, None, 129,
                                device=cuda_device)
    before = _launches()
    got = tops.fused_melspectrogram(x, fb, 256, 128, power=1.0)
    assert _launches() == before
    want = tfused._reference(x, fb, 256, 128, "hann", 1.0, True, 1.0, 1e-7)
    assert got.is_cuda and _rel(got, want) <= PARITY
    with pytest.raises(ValueError, match="num_mels"):
        tops.fused_melspectrogram(
            x, torch.zeros((129, 800), device=cuda_device), 256, 128)
    with pytest.raises(ValueError, match="filterbank on"):
        tops.fused_melspectrogram(x, fb.cpu(), 256, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_classifier_on_card_matches_cpu(cuda_device, fused):
    """Logits, then one ``train_step`` (filterbank trainable): the loss
    within 1e-5 relative and every parameter within ``GRAD_PARITY`` of
    the largest change the CPU step made to it."""
    model = tat.MelFrontendClassifier(
        fused=fused, generator=torch.Generator().manual_seed(1)).eval()
    card = copy.deepcopy(model).to(cuda_device)
    x, _ = _inputs(7, (4, 1, 16000), 64, 16000, 512)
    labels = torch.tensor([1, 3, 5, 7])
    with torch.inference_mode():
        want = model(x)
        before = tfused.KERNEL_LAUNCHES
        got = card(x.to(cuda_device)).cpu()
    assert tfused.KERNEL_LAUNCHES == before + (1 if fused else 0)
    assert (got - want).abs().max().item() <= 1e-4

    start = {k: v.clone() for k, v in model.state_dict().items()}
    before = _launches()
    loss = card.train_step(x.to(cuda_device), labels.to(cuda_device)).item()
    want_loss = model.train_step(x, labels).item()
    # the waveform needs no gradient: the backward runs without its
    # frame passes
    assert _launches() == tuple(b + int(fused) * (i < 2)
                                for i, b in enumerate(before))
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for name, value in model.state_dict().items():
        update = (value - start[name]).abs().max().item()
        err = (card.state_dict()[name].cpu() - value).abs().max().item()
        assert err <= GRAD_PARITY * update, (name, err, update)


# ---- the FFT route of the fused mel kernels against the DFT route -----------

def _fft_counts():
    return (tfused.KERNEL_LAUNCHES, tfused.FFT_KERNEL_LAUNCHES,
            tfused.BWD_KERNEL_LAUNCHES, tfused.BWD_FFT_LAUNCHES)


# fft, hop, samples, mels, window, win_length: every size the FFT kernels
# are built for; odd and even frame counts, hop > fft/2, a shorter window,
# another window, 64 / 128 / 192 padded mels (both mel tilings); for the
# dFB pass, 3 rows (below one chunk of 16), 318 rows in two splits and
# 9 354 rows in 37 (neither a multiple of the chunk or the split), the
# Nyquist bin folded at every size
FFT_CASES = [
    (256, 64, 7000, 40, "hann", None),
    (512, 300, 9000, 64, "hamming", 300),
    (1024, 256, 11025, 80, "hann", None),
    (2048, 512, 44100, 128, "hann", None),
    (2048, 1100, 30000, 130, "hann", None),
    (512, 128, 600, 64, "hann", None),
    (512, 64, 200000, 40, "hann", None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("fft,hop,samples,mels,window,wl", FFT_CASES)
def test_fft_route_matches_dft_route_and_plain(cuda_device, fft, hop,
                                               samples, mels, window, wl):
    """Both forward kernels and both frame-gradient passes at one shape:
    each within 1e-5 (gradients 1e-4) of its plain version, the FFT
    kernels also of their step-by-step plain version; the filterbank
    gradient within 1e-5 of the plain dFB in float64 from the same
    operands; the residual's padded bins exactly zero on both routes; the
    output with the residual bitwise equal to without; two backward runs
    bitwise equal, each one dFB pass."""
    x, fb = _inputs(fft + hop, (3, samples), mels, 16000, fft)
    x, fb = x.to(cuda_device), fb.to(cuda_device)
    args = (fft, hop, window, wl, True, 1.0, 1e-7)
    n_freqs = fft // 2 + 1
    want_out, want_reim = tfused._fwd_res_plain(x, fb, *args, save_spec=True)
    step_out, step_reim = tfused._fwd_fft_plain(x, fb, *args, save_spec=True)
    rows = want_reim.shape[0] * want_reim.shape[1]
    dmel = torch.from_numpy(np.random.default_rng(hop).standard_normal(
        (rows, -(-mels // 64) * 64)).astype(np.float32)).to(cuda_device)
    dmel[:, mels:] = 0.0
    bargs = (fb, fft, window, wl, True, True)
    reim2 = want_reim.reshape(rows, -1)
    want_df, want_dfb = tfused._bwd_plain(dmel, reim2, *bargs)
    step_df, _ = tfused._bwd_fft_plain(dmel, reim2, *bargs)
    _, dfb64 = tfused._dfb_dreim_plain(dmel.double(), reim2.double(),
                                       fb.double(), False, True)
    dfb_before = _dfb_launches()
    for route in ("fft", "dft"):
        out, reim = tfused._fused_mel_fwd_cuda(x, fb, *args, save_spec=True,
                                               _route=route)
        serve, none = tfused._fused_mel_fwd_cuda(x, fb, *args, _route=route)
        df, dfb = tfused._fused_mel_bwd_cuda(dmel, reim2, *bargs,
                                             _route=route)
        df2, dfb2 = tfused._fused_mel_bwd_cuda(dmel, reim2, *bargs,
                                               _route=route)
        torch.cuda.synchronize()
        assert none is None and torch.equal(out, serve)
        assert torch.equal(df, df2) and torch.equal(dfb, dfb2)
        assert _peak_err(out, want_out) <= PARITY
        assert _peak_err(reim, want_reim) <= PARITY
        tiles = reim.view(3, -1, reim.shape[-1] // 128, 2, 64)
        bins = tiles.transpose(-2, -3).reshape(3, -1, 2, reim.shape[-1] // 2)
        assert not bins[..., n_freqs:].any()
        assert _peak_err(df, want_df) <= GRAD_PARITY
        assert _peak_err(dfb, want_dfb) <= GRAD_PARITY
        assert _peak_err(dfb.double(), dfb64) <= PARITY
        if route == "fft":
            assert _peak_err(out, step_out) <= PARITY
            assert _peak_err(reim, step_reim) <= PARITY
            assert _peak_err(df, step_df) <= GRAD_PARITY
    assert _dfb_launches() == (dfb_before[0] + 4,
                               dfb_before[1] + 4 * _one_read(mels))


@pytest.mark.cuda
@pytest.mark.parametrize("fft,takes_fft", [(256, True), (512, True),
                                           (1024, True), (2048, True),
                                           (400, False), (128, False),
                                           (4096, False)])
def test_route_counters(cuda_device, fft, takes_fft):
    """The op on the card takes the FFT kernels for a power of two from
    256 to 2048 and the DFT-product kernels otherwise, forward and frame
    gradient alike; the counters say which."""
    x, fb = _inputs(fft, (2, 4 * fft), 32, 16000, fft)
    g = torch.ones((2, 32, 1 + (3 * fft) // (fft // 4)))
    before = _fft_counts()
    _grads(x.to(cuda_device), fb.to(cuda_device), fft, fft // 4,
           g.to(cuda_device))
    torch.cuda.synchronize()
    moved = tuple(a - b for a, b in zip(_fft_counts(), before))
    assert moved == (1, int(takes_fft), 1, int(takes_fft))
    if not takes_fft:
        with pytest.raises(ValueError, match="power of two"):
            tfused._fused_mel_fwd_cuda(
                x.to(cuda_device), fb.to(cuda_device), fft, fft // 4, "hann",
                None, True, 1.0, 1e-7, _route="fft")


# ---- the frame pass's overlap-add epilogue: dx written by B2 ----------------

# fft, hop: every size of the FFT route at a quarter, a half and a whole
# frame's hop, a hop that does not divide the frame, the smallest hop the
# epilogue takes (fft / 17)
DX_CASES = [(n, n // d) for n in (256, 512, 1024, 2048) for d in (4, 2, 1)]
DX_CASES += [(1024, 300), (2048, 121)]


@pytest.mark.cuda
@pytest.mark.parametrize("streams", [1, 33])
@pytest.mark.parametrize("fft,hop", DX_CASES)
def test_frame_pass_overlap_adds_dx(cuda_device, monkeypatch, fft, hop,
                                    streams):
    """The frame pass writing ``dx`` against ``_overlap_add`` of the plain
    frame gradient (1e-4 of peak) and of the kernel's own (1e-5): 37
    frames a stream, so two tiles of 16 and a partial one; samples past
    the last full frame, exactly zero; ``dx`` written whole (every buffer
    the wrapper allocates starts as NaN) and bitwise equal over two runs;
    ``BWD_DX_FUSED_LAUNCHES`` one a launch."""
    from torchaudio_contrib_tpu_torch.ops.stft import _overlap_add
    n_frames, mels = 37, 40
    full = (n_frames - 1) * hop + fft
    n_samples = full + hop // 2 + 1
    x, fb = _inputs(fft + hop, (streams, n_samples), mels, 16000, fft)
    x, fb = x.to(cuda_device), fb.to(cuda_device)
    _, reim = tfused._fused_mel_fwd_cuda(x, fb, fft, hop, "hann", None, True,
                                         1.0, 1e-7, save_spec=True)
    rows = streams * n_frames
    reim2 = reim.reshape(rows, -1)
    dmel = torch.from_numpy(np.random.default_rng(hop).standard_normal(
        (rows, 64)).astype(np.float32)).to(cuda_device)
    dmel[:, mels:] = 0.0
    bargs = (fb, fft, "hann", None, True, False)
    wants = [_overlap_add(frames.view(streams, n_frames, fft), fft, hop, full)
             for frames in (tfused._bwd_plain(dmel, reim2, *bargs)[0],
                            tfused._fused_mel_bwd_cuda(dmel, reim2,
                                                       *bargs)[0])]
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: empty(*a, **k).fill_(float("nan")))
    before = tfused.BWD_DX_FUSED_LAUNCHES
    runs = []
    for _ in range(2):
        got, dfb = tfused._fused_mel_bwd_cuda(dmel, reim2, *bargs,
                                              hop_length=hop,
                                              n_samples=n_samples)
        assert got.shape == (streams, n_samples) and dfb is None
        runs.append(got)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert tfused.BWD_DX_FUSED_LAUNCHES == before + 2
    dx, dx2 = runs
    assert torch.equal(dx, dx2)
    assert not dx[:, full:].any()
    assert _peak_err(dx[:, :full], wants[0]) <= GRAD_PARITY
    assert _peak_err(dx[:, :full], wants[1]) <= PARITY


@pytest.mark.cuda
def test_frame_pass_refuses_dx_outside_its_rule(cuda_device):
    """The frame pass writes ``dx`` only on the FFT route at a hop from
    fft / 17 to fft, for frames that are the rows, and with the waveform
    gradient asked for."""
    fb = tops.create_mel_filter(32, 16000, 0.0, None, 513,
                                device=cuda_device)
    dmel = torch.zeros((10, 64), device=cuda_device)
    reim = torch.zeros((10, 9 * 128), device=cuda_device)
    bargs = (fb, 1024, "hann", None)
    for hop, route, need_dx, what in ((60, None, True, "overlap-adds"),
                                      (1025, None, True, "overlap-adds"),
                                      (256, "dft", True, "overlap-adds"),
                                      (256, None, False, "overlap-adds"),
                                      (200, None, True, "rows")):
        with pytest.raises(ValueError, match=what):
            tfused._fused_mel_bwd_cuda(dmel, reim, *bargs, need_dx, True,
                                       _route=route, hop_length=hop,
                                       n_samples=1024 + 4 * 256)


# fft, hop, whether the frame pass writes dx: both edges of the hop rule,
# the DFT route
DX_RULE = [(1024, 256, True), (1024, 1024, True), (1024, 1100, False),
           (1024, 61, True), (1024, 60, False), (2048, 121, True),
           (2048, 120, False), (400, 160, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("fft,hop,fused", DX_RULE)
def test_dx_epilogue_where_the_rule_says(cuda_device, fft, hop, fused, need):
    """Gradients through the op on the card: ``BWD_DX_FUSED_LAUNCHES``
    moves by one a backward where the rule holds and the waveform gradient
    is asked for, by none otherwise (the filterbank gradient alone, the
    DFT route, a hop outside the rule); every gradient within 1e-4 of
    peak of autograd of the plain chain on the CPU."""
    x, fb = _inputs(fft + hop, (2, 1, 20 * hop + fft + 7), 48, 16000, fft)
    with torch.no_grad():
        out = tops.fused_melspectrogram(x, fb, fft, hop)
    g = torch.from_numpy(np.random.default_rng(fft).standard_normal(
        tuple(out.shape)).astype(np.float32))
    _, want_dx, want_dfb = _grads(x, fb, fft, hop, g, need=need)
    before = tfused.BWD_DX_FUSED_LAUNCHES
    _, dx, dfb = _grads(x.to(cuda_device), fb.to(cuda_device), fft, hop,
                        g.to(cuda_device), need=need)
    torch.cuda.synchronize()
    assert tfused.BWD_DX_FUSED_LAUNCHES - before == int(fused and need[0])
    for got, want in ((dx, want_dx), (dfb, want_dfb)):
        assert (got is None) == (want is None)
        if got is not None:
            assert _peak_err(got.cpu(), want) <= GRAD_PARITY


@pytest.mark.cuda
@pytest.mark.parametrize("route,fused", [(None, True), ("fft", True),
                                         ("dft", False)])
def test_dx_epilogue_follows_the_route_taken(cuda_device, route, fused):
    """The op's backward on the card with a route named (as
    ``chip_smoke.py`` names one) at a size and hop the rule takes: the
    frame pass writes ``dx`` on the FFT route and the host overlap-adds on
    the DFT route, and both give the plain chain's gradients."""
    fft, hop = 1024, 256
    x, fb = _inputs(fft + hop, (2, 20 * hop + fft + 7), 48, 16000, fft)
    with torch.no_grad():
        out = tops.fused_melspectrogram(x, fb, fft, hop)
    g = torch.from_numpy(np.random.default_rng(fft).standard_normal(
        tuple(out.shape)).astype(np.float32))
    _, want_dx, want_dfb = _grads(x, fb, fft, hop, g)
    xd = x.to(cuda_device).requires_grad_()
    fbd = fb.to(cuda_device).requires_grad_()
    before = tfused.BWD_DX_FUSED_LAUNCHES
    got = tfused._fused_apply(
        xd, fbd, fft, hop, "hann", None, True, 1.0, 1e-7,
        functools.partial(tfused._fused_mel_fwd_cuda, _route=route),
        functools.partial(tfused._op_bwd_cuda, _route=route))
    (got * g.to(cuda_device)).sum().backward()
    torch.cuda.synchronize()
    assert tfused.BWD_DX_FUSED_LAUNCHES - before == int(fused)
    assert _peak_err(xd.grad.cpu(), want_dx) <= GRAD_PARITY
    assert _peak_err(fbd.grad.cpu(), want_dfb) <= GRAD_PARITY


# ---- the banded mel products: band pass, both products, the card's counts ---

# config 2's and config 3's fft, hop, mels and rate on fewer streams: the
# kernels' blocks are 16 frames whatever the batch
BAND_CASES = [(4, 5 * 22050, 2048, 512, 128, 22050),
              (8, 2 * 16000, 512, 128, 64, 16000)]
BAND_IDS = ["config2", "config3"]


def _card_moves(before):
    """What the band counters moved since ``before`` (``_launches``)."""
    from torchaudio_contrib_tpu_torch.ops import _launches
    torch.cuda.synchronize()
    moved = _launches.delta(before)
    return tuple(moved["fused." + n] for n in ("MEL_BAND_LAUNCHES",
                                               *tfused.CARD_COUNTERS))


def _counts_now():
    from torchaudio_contrib_tpu_torch.ops import _launches
    torch.cuda.synchronize()
    return _launches.counts()


def _band_inputs(case, seed):
    streams, samples, fft, hop, mels, sr = case
    x, fb = _inputs(seed, (streams, samples), mels, sr, fft)
    return x.cuda(), fb.cuda(), (fft, hop, "hann", None, True, 1.0, 1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BAND_CASES, ids=BAND_IDS)
@pytest.mark.parametrize("layout", ["contiguous", "transposed"])
def test_band_pass_writes_the_plain_tables(cuda_device, case, layout):
    """``mel_band_kernel`` against ``_fb_bands`` and the padded copies, for
    a filterbank in either memory layout: every table and copy equal."""
    _, _, fft, _, mels, sr = case
    fb = tops.create_mel_filter(mels, sr, 0.0, None, fft // 2 + 1,
                                device=cuda_device)
    if layout == "transposed":
        fb = fb.t().contiguous().t()
    ft, m_pad = fft // 128 + 1, -(-mels // 64) * 64
    padded = tfused._fb_padded(fb, ft, m_pad)
    for with_fbp in (True, False):
        buf, ptrs = tfused._mel_bands(
            fb, ft, m_pad, with_fbp, torch.cuda.current_stream().cuda_stream)
        fbp, fbt, mel_band, bin_band = tfused._band_parts(buf, ft, m_pad,
                                                          with_fbp)
        torch.cuda.synchronize()
        assert (ptrs[0] is None) is not with_fbp
        want = tfused._fb_bands(fb, m_pad)
        assert torch.equal(mel_band, want[0]) and torch.equal(bin_band,
                                                              want[1])
        assert torch.equal(fbt, padded.t())
        assert fbp is None or torch.equal(fbp, padded)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BAND_CASES, ids=BAND_IDS)
def test_banded_and_dense_products_agree(cuda_device, case):
    """Forced banded, forced dense and the tables' choice: the forward's
    output and the waveform and filterbank gradients each within 1e-5
    (gradients 1e-4) of the plain versions and of each other, the choice
    bitwise the banded run; the banded dp leaves out only exact zero
    terms of the dense one's sums, so ``dx`` is bitwise the dense run's;
    every run bitwise repeatable."""
    from torchaudio_contrib_tpu_torch.ops.stft import _overlap_add
    x, fb, args = _band_inputs(case, 11)
    streams, samples, fft, hop = case[:4]
    want, reim = tfused._fwd_res_plain(x, fb, *args, save_spec=True)
    n_frames = want.shape[-1]
    rows = streams * n_frames
    g = torch.randn(want.shape, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2))
    dmel = tfused._dmel_from(g, want, True, 1.0, 1e-7)
    reim2 = reim.reshape(rows, -1)
    bargs = (fb, fft, "hann", None, True, True)
    dframes, want_dfb = tfused._bwd_plain(dmel, reim2, *bargs)
    full = (n_frames - 1) * hop + fft
    want_dx = torch.zeros_like(x)
    want_dx[:, :full] = _overlap_add(dframes.view(streams, n_frames, fft),
                                     fft, hop, full)
    runs = {}
    for banded in (None, True, False, None, True, False):
        out, _ = tfused._fused_mel_fwd_cuda(x, fb, *args, save_spec=True,
                                            _banded=banded)
        dx, dfb = tfused._fused_mel_bwd_cuda(dmel, reim2, *bargs,
                                             hop_length=hop,
                                             n_samples=samples,
                                             _banded=banded)
        torch.cuda.synchronize()
        if banded in runs:
            assert all(torch.equal(a, b) for a, b in zip(runs[banded],
                                                         (out, dx, dfb)))
        runs[banded] = (out, dx, dfb)
    for out, dx, dfb in runs.values():
        assert _peak_err(out, want) <= PARITY
        assert _peak_err(dx, want_dx) <= GRAD_PARITY
        assert _peak_err(dfb, want_dfb) <= GRAD_PARITY
    assert all(torch.equal(a, b) for a, b in zip(runs[None], runs[True]))
    assert _peak_err(runs[True][0], runs[False][0]) <= PARITY
    assert torch.equal(runs[True][1], runs[False][1])
    assert torch.equal(runs[True][2], runs[False][2])


@pytest.mark.cuda
@pytest.mark.parametrize("case", BAND_CASES, ids=BAND_IDS)
def test_bands_follow_a_filterbank_changed_in_place(cuda_device, case):
    """Nothing is kept from one call to the next: a mel filterbank
    overwritten in place by a dense one (an optimizer step, ``copy_``)
    takes the dense products at the next call, and the mel one again the
    banded ones; each call matches the plain version of the filterbank it
    saw."""
    x, fb, args = _band_inputs(case, 12)
    mel_fb = fb.clone()
    dense = torch.rand(fb.shape, device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(3))
    for now, banded in ((mel_fb, 1), (dense, 0), (mel_fb, 1)):
        fb.copy_(now)
        before = _counts_now()
        with torch.no_grad():
            out, _ = tfused._fused_mel_fwd_cuda(x, fb, *args)
        assert _card_moves(before) == (1, banded, 0)
        want, _ = tfused._fwd_res_plain(x, now, *args)
        assert _peak_err(out, want) <= PARITY


@pytest.mark.cuda
def test_banded_call_replays_from_a_cuda_graph(cuda_device):
    """The band pass and both banded products capture into a CUDA graph;
    each replay runs the band pass again, so it sees the filterbank as it
    is then (changed in place between replays), the card counts each
    replay's banded launches, and a replay equals the eager call."""
    case = BAND_CASES[0]
    x, fb, args = _band_inputs(case, 13)
    streams, samples, fft, hop = case[:4]
    mel_fb = fb.clone()
    dense = torch.rand(fb.shape, device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(4))
    with torch.no_grad():
        _, reim = tfused._fused_mel_fwd_cuda(x, fb, *args, save_spec=True)
    rows = reim.shape[0] * reim.shape[1]
    reim2 = reim.reshape(rows, -1)
    dmel = torch.randn((rows, 128), device=cuda_device)

    def call():
        out, _ = tfused._fused_mel_fwd_cuda(x, fb, *args)
        dx, _ = tfused._fused_mel_bwd_cuda(dmel, reim2, fb, fft, "hann",
                                           None, True, False,
                                           hop_length=hop, n_samples=samples)
        return out, dx

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.no_grad():
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph), torch.no_grad():
        got = call()
    for now, banded in ((mel_fb, 1), (dense, 0), (mel_fb, 1)):
        fb.copy_(now)
        before = _counts_now()
        graph.replay()
        assert _card_moves(before) == (0, banded, banded)
        with torch.no_grad():
            want = call()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_band_counters_move_with_the_products(cuda_device):
    """Through the op: fwd + both gradients run two band passes and both
    banded products; the filterbank gradient alone runs the forward's
    band pass only (the dFB pass reads no filterbank); serving runs one
    band pass and the banded forward; a dense learned filterbank runs the
    band passes and neither banded product."""
    x, fb, _ = _band_inputs(BAND_CASES[1], 14)
    fft, hop = BAND_CASES[1][2:4]

    def moves(fn):
        before = _counts_now()
        fn()
        return _card_moves(before)

    def grads(filterbank, need):
        xg = x.clone().requires_grad_(need[0])
        fg = filterbank.clone().requires_grad_(need[1])
        tops.fused_melspectrogram(xg, fg, fft, hop).sum().backward()

    dense = torch.rand(fb.shape, device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(5))
    assert moves(lambda: grads(fb, (True, True))) == (2, 1, 1)
    assert moves(lambda: grads(fb, (False, True))) == (1, 1, 0)
    with torch.inference_mode():
        assert moves(lambda: tops.fused_melspectrogram(x, fb, fft, hop)) == (
            1, 1, 0)
    assert moves(lambda: grads(dense, (True, True))) == (2, 0, 0)


# ---- fused Griffin-Lim: the solve's kernels vs their plain version ---------

# fft, hop, samples, window, center: the JAX package's four eligible
# shapes, one only this port's rule admits, center=False, another window
GL_CASES = [
    (1024, 256, 11025, "hann", True),
    (2048, 512, 22050, "hann", True),
    (1024, 512, 11025, "hann", True),
    (1024, 1024, 11025, "hann", True),
    (400, 160, 16000, "hann", True),
    (1024, 256, 11025, "hann", False),
    (512, 128, 6000, "hamming", True),
]


def _gl_mag(seed, shape, fft, hop, window="hann", center=True):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))
    return tops.stft(x, fft, hop, window=window, center=center).abs()


def _peak_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def _l2_err(got, want):
    return (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("tile_major", [False, True],
                         ids=["row_major", "tile_major"])
@pytest.mark.parametrize("fft,hop,samples,window,center", GL_CASES)
def test_gl_kernels_match_plain(cuda_device, fft, hop, samples, window,
                                center, tile_major):
    """On the route the size takes and, where that is the FFT route, on
    the DFT route too (the FFT kernels also against the plain version that
    repeats their arithmetic step by step).
    One iteration from a generic state: the products (``prev``) within
    1e-5 of peak and the projected state within 1e-4 (the projection
    divides by |upd|); the 4-iteration waveform within 1e-4 of peak.  With
    no overlap (hop = fft, Hann) the spectrum stays almost real from the
    zero-phase start, and a bin whose real part passes through zero gets
    its sign from rounding: the state and the waveform are held in l2,
    to 5e-3, there."""
    err_of, bar = (_l2_err, 5e-3) if hop == fft else (_peak_err, 1e-4)
    mag = _gl_mag(fft + hop, (2, samples), fft, hop, window,
                  center).to(cuda_device)
    ops = tgl._gl_prepare(mag, fft, hop, window, None, tile_major)[:5]
    start, _ = tgl._gl_solve_plain(*ops, fft, hop, 2, 0.99, tile_major)
    ops = (start,) + ops[1:]
    want_state, want_prev = tgl._gl_solve_plain(*ops, fft, hop, 1, 0.99,
                                                tile_major)
    length = tops.stft_output_length(mag.shape[-1], fft, hop, center=center)
    args = (mag, fft, hop, window, 4, 0.99, length, center)
    want = tgl._gl_plain(*args, tile_major=tile_major)
    takes = tfused._route_for(fft, None)
    for route in dict.fromkeys((takes, "dft")):
        if route == "fft":
            ops = (start,) + tgl._gl_prepare(mag, fft, hop, window, None,
                                             tile_major, "fft")[1:5]
        before = (tgl.GL_KERNEL_LAUNCHES, tgl.GL_TILE_MAJOR_LAUNCHES,
                  tgl.GL_FFT_LAUNCHES)
        state, prev = tgl._gl_solve_cuda(*ops, fft, hop, 1, 0.99, tile_major,
                                         _route=route)
        assert (tgl.GL_KERNEL_LAUNCHES, tgl.GL_TILE_MAJOR_LAUNCHES,
                tgl.GL_FFT_LAUNCHES) == (
            before[0] + 1, before[1] + int(tile_major),
            before[2] + int(route == "fft"))
        assert _peak_err(prev, want_prev) <= PARITY
        assert err_of(state, want_state) <= bar
        if route == "fft":
            step_state, step_prev = tgl._gl_solve_fft_plain(
                *ops, fft, hop, 1, 0.99, tile_major)
            assert _peak_err(prev, step_prev) <= PARITY
            assert err_of(state, step_state) <= bar
            ops = (start,) + tgl._gl_prepare(mag, fft, hop, window, None,
                                             tile_major)[1:5]
        solve = functools.partial(tgl._gl_solve_cuda, _route=route)
        got = tgl._gl_run(solve, route, *args, None, tile_major)
        assert got.shape == (2, length) and bool(torch.isfinite(got).all())
        assert err_of(got, want) <= bar
    # the op takes the route of the size
    before = tgl.GL_KERNEL_LAUNCHES, tgl.GL_FFT_LAUNCHES
    got = tgl._gl_fused(*args, tile_major=tile_major)
    assert (tgl.GL_KERNEL_LAUNCHES, tgl.GL_FFT_LAUNCHES) == (
        before[0] + 1, before[1] + int(takes == "fft"))
    assert err_of(got, want) <= bar


@pytest.mark.cuda
def test_gl_layouts_and_bisect_full_agree(cuda_device):
    """Tile-major gives row-major's waveform (on the FFT route, which the
    op takes at this size, bit for bit); on both routes the stage bisect's
    ``full`` variant is the solve bit for bit, and every other variant is
    not."""
    mag = _gl_mag(3, (2, 2, 6000), 512, 128).to(cuda_device)
    args = (mag, 512, 128, "hann", 8, 0.99, 6000, True)
    rows, tiles = tgl._gl_fused(*args), tgl._gl_fused(*args, tile_major=True)
    assert rows.shape == (2, 2, 6000)
    assert torch.equal(tiles, rows)
    for route in ("fft", "dft"):
        ops = tgl._gl_prepare(mag, 512, 128, "hann", route=route)[:5]
        solve = tgl._gl_solve_cuda(*ops, 512, 128, 4, 0.99, _route=route)
        for variant in tgl.VARIANTS:
            got = tgl._gl_solve_cuda(*ops, 512, 128, 4, 0.99, False, variant,
                                     _route=route)
            same = (torch.equal(got[0], solve[0])
                    and torch.equal(got[1], solve[1]))
            assert same == (variant == "full"), (route, variant)


@pytest.mark.cuda
def test_griffin_lim_pallas_on_card(cuda_device):
    """The op on a CUDA tensor launches the solve once, converges like the
    plain version (32 iterations, within 1e-3) and no worse than the matmul
    loop plus 0.05; a random start converges too."""
    mag = _gl_mag(4, (2, 22050), 1024, 256).to(cuda_device)

    def conv(y):
        got = tops.stft(y, 1024, 256).abs()
        return (torch.linalg.norm(got - mag) / torch.linalg.norm(mag)).item()

    before = tgl.GL_KERNEL_LAUNCHES, tgl.GL_FFT_LAUNCHES
    y = tops.griffin_lim(mag, 1024, 256, n_iter=32, length=22050,
                         method="pallas")
    assert (tgl.GL_KERNEL_LAUNCHES, tgl.GL_FFT_LAUNCHES) == (before[0] + 1,
                                                             before[1] + 1)
    plain = tgl._gl_plain(mag, 1024, 256, "hann", 32, 0.99, 22050, True)
    loop = tops.griffin_lim(mag, 1024, 256, n_iter=32, length=22050,
                            method="matmul")
    assert y.shape == (2, 22050) and bool(torch.isfinite(y).all())
    assert abs(conv(y) - conv(plain)) <= 1e-3
    assert conv(y) <= conv(loop) + 0.05
    rand = tops.griffin_lim(mag, 1024, 256, n_iter=32, length=22050,
                            method="pallas",
                            generator=torch.Generator().manual_seed(0))
    assert not torch.equal(rand, y) and conv(rand) <= conv(loop) + 0.05


@pytest.mark.cuda
def test_mel_to_audio_and_round_trip_on_card(cuda_device):
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 2, 8192)).astype(np.float32)).to(cuda_device)
    back = tops.istft(tops.stft(x, 1024, 256), 256, length=8192)
    assert (back - x).abs().max().item() <= 1e-4
    mel = tops.melspectrogram(x, num_mels=80, sample_rate=22050, f_max=8000.0,
                              power=1.0, fft_length=1024, hop_length=256)
    before = tgl.GL_KERNEL_LAUNCHES
    wave = tops.mel_to_audio(mel, num_mels=80, sample_rate=22050,
                             f_max=8000.0, fft_length=1024, hop_length=256,
                             n_iter=8, power=1.0, method="pallas")
    assert tgl.GL_KERNEL_LAUNCHES == before + 1
    assert wave.shape == (2, 2, 8192) and bool(torch.isfinite(wave).all())


@pytest.mark.cuda
def test_gl_kernels_refuse_what_they_do_not_take(cuda_device):
    mag = _gl_mag(6, (1, 6000), 512, 128).to(cuda_device)
    before = tgl.GL_KERNEL_LAUNCHES
    for route in ("fft", "dft"):
        ops = tgl._gl_prepare(mag, 512, 128, "hann", route=route)[:5]
        other = "dft" if route == "fft" else "fft"
        with pytest.raises(ValueError, match="unknown variant"):
            tgl._gl_solve_cuda(*ops, 512, 128, 1, 0.99, False, "nodma",
                               _route=route)
        with pytest.raises(ValueError, match="do not fit"):
            tgl._gl_solve_cuda(*ops, 512, 128, 1, 0.99, True, _route=route)
        # one route's operands on the other route
        with pytest.raises(ValueError, match="do not fit"):
            tgl._gl_solve_cuda(*ops, 512, 128, 1, 0.99, _route=other)
        with pytest.raises(ValueError, match="float32 CUDA"):
            tgl._gl_solve_cuda(ops[0].cpu(), *ops[1:], 512, 128, 1, 0.99,
                               _route=route)
    with pytest.raises(ValueError, match="power of two"):
        mag400 = _gl_mag(6, (1, 6000), 400, 160).to(cuda_device)
        tgl._gl_solve_cuda(*tgl._gl_prepare(mag400, 400, 160, "hann")[:5],
                           400, 160, 1, 0.99, _route="fft")
    assert tgl.GL_KERNEL_LAUNCHES == before


@pytest.mark.cuda
def test_stft_conv_is_full_float32_on_card(cuda_device):
    """``method="conv"`` holds to ``method="fft"`` at 1e-5 of peak on the
    card even where the process allows TF32 convolutions."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 2, 16000)).astype(np.float32)).to(cuda_device)
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for fft, hop in ((1024, 256), (400, 160)):
            got = tops.stft(x, fft, hop, method="conv")
            want = tops.stft(x, fft, hop, method="fft")
            assert got.shape == want.shape
            assert ((got - want).abs().max()
                    / want.abs().max()).item() <= 1e-5
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = was


@pytest.mark.cuda
def test_gl_zero_iterations_launch_nothing(cuda_device):
    mag = _gl_mag(8, (1, 6000), 512, 128).to(cuda_device)
    for route in ("fft", "dft"):
        ops = tgl._gl_prepare(mag, 512, 128, "hann", route=route)[:5]
        before = tgl.GL_KERNEL_LAUNCHES, tgl.GL_FFT_LAUNCHES
        state, prev = tgl._gl_solve_cuda(*ops, 512, 128, 0, 0.99,
                                         _route=route)
        assert (tgl.GL_KERNEL_LAUNCHES, tgl.GL_FFT_LAUNCHES) == before
        assert torch.equal(state, ops[0]) and not prev.any()


# ---- the slab loop: more streams (clips) than a grid dimension holds ---------

@pytest.mark.cuda
def test_forward_kernel_runs_past_the_grid_limit(cuda_device):
    """65 600 streams (two slabs) equal the same input run as two calls,
    bitwise, with one launch counted."""
    x = torch.randn((65600, 1024), device=cuda_device)
    fb = tops.create_mel_filter(16, 16000, 0.0, None, 129,
                                device=cuda_device)
    with torch.inference_mode():
        before = tfused.KERNEL_LAUNCHES
        got = tops.fused_melspectrogram(x, fb, 256, 64)
        assert tfused.KERNEL_LAUNCHES == before + 1
        parts = [tops.fused_melspectrogram(x[a:b], fb, 256, 64)
                 for a, b in ((0, 65535), (65535, 65600))]
    assert torch.equal(got, torch.cat(parts))


@pytest.mark.cuda
def test_gl_kernels_run_past_the_grid_limit(cuda_device):
    mag = torch.rand((65600, 129, 4), device=cuda_device)
    for route in ("fft", "dft"):
        ops = tgl._gl_prepare(mag, 256, 64, "hann", route=route)[:5]
        before = tgl.GL_KERNEL_LAUNCHES
        state, prev = tgl._gl_solve_cuda(*ops, 256, 64, 2, 0.99,
                                         _route=route)
        assert tgl.GL_KERNEL_LAUNCHES == before + 1
        for a, b in ((0, 65535), (65535, 65600)):
            part = tgl._gl_solve_cuda(ops[0][a:b].contiguous(),
                                      ops[1][a:b].contiguous(), *ops[2:],
                                      256, 64, 2, 0.99, _route=route)
            assert torch.equal(part[0], state[a:b])
            assert torch.equal(part[1], prev[a:b])


# ---- the corpus path and the ops with no kernel, on the card ----------------

@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["float32", "int16", "mulaw8"])
def test_corpus_on_card_matches_cpu(cuda_device, wire):
    from torchaudio_contrib_tpu_torch import parallel as tpar
    clips = np.random.default_rng(3).standard_normal(
        (5, 1, 8000)).astype(np.float32)
    kw = dict(clip_samples=8000, batch_size=4, wire_format=wire,
              num_workers=2, use_fused=True, fft_length=512,
              hop_length=128, num_mels=32, sample_rate=16000)
    rows = {}
    for dev in ("cpu", "cuda"):
        rows[dev] = {}
        pre = tpar.CorpusPreprocessor(
            lambda i: clips[i], device=dev,
            sink=lambda i, m, d=dev: rows[d].__setitem__(i, torch.tensor(m)),
            **kw)
        before = tfused.KERNEL_LAUNCHES
        stats = pre.run(range(5))
        assert stats.files_done == 5
    assert tfused.KERNEL_LAUNCHES == before + 2       # one per batch
    for i in range(5):
        assert (rows["cuda"][i] - rows["cpu"][i]).abs().max() <= 1e-4


@pytest.mark.cuda
def test_new_ops_on_card_match_cpu(cuda_device):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 16000)).astype(np.float32))
    xc = x.to(cuda_device)
    assert _rel(tops.deemphasis(xc), tops.deemphasis(x)) <= 1e-4
    assert _rel(tops.convolve(xc, xc[:, :65]), tops.convolve(x, x[:, :65])) \
        <= PARITY
    assert _rel(tops.cqt(xc, 16000, 256, 36, 65.0),
                tops.cqt(x, 16000, 256, 36, 65.0)) <= PARITY
    spec = torch.stft(x.view(2, 16000), 256, 64,
                      window=torch.hann_window(256), return_complex=True)
    mc = spec.view(1, 2, 129, -1)
    w = tops.mvdr_weights_souden(tops.psd(mc), tops.psd(mc) * 0.5 + 1e-3)
    wc = tops.mvdr_weights_souden(tops.psd(mc.to(cuda_device)),
                                  tops.psd(mc.to(cuda_device)) * 0.5 + 1e-3)
    assert _rel(wc, w) <= 1e-4


# ---- the IIR family and its neighbours: the card against the CPU copy -------

SCAN_PARITY = 1e-4   # scans and log-domain outputs, card vs CPU copy


@pytest.mark.cuda
@pytest.mark.parametrize("order", [1, 2, 4, 10])
def test_lfilter_and_filtfilt_on_card(cuda_device, order):
    import scipy.signal as sps
    b, a = sps.butter(order, 0.1)
    x = torch.from_numpy(np.random.default_rng(order).standard_normal(
        (3, 2, 48000)).astype(np.float32))
    xc = x.to(cuda_device).requires_grad_()
    got = tops.lfilter(xc, a, b)
    assert _rel(got, tops.lfilter(x, a, b)) <= SCAN_PARITY
    ref = sps.lfilter(b, a, x.numpy().astype(np.float64), axis=-1)
    assert _rel(got, torch.from_numpy(ref)) <= PARITY
    got.square().sum().backward()
    xg = x.clone().requires_grad_()
    tops.lfilter(xg, a, b).square().sum().backward()
    assert _rel(xc.grad, xg.grad) <= SCAN_PARITY
    assert _rel(tops.filtfilt(xc.detach(), a, b),
                tops.filtfilt(x, a, b)) <= SCAN_PARITY


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(decay=0.4), dict(decay=0.9),
                                dict(decay=0.99, sinusoidal=False)])
def test_phaser_on_card(cuda_device, kw):
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 2, 44100)).astype(np.float32) * 0.3)
    assert _rel(tops.phaser(x.to(cuda_device), 44100, **kw),
                tops.phaser(x, 44100, **kw)) <= SCAN_PARITY


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(), dict(regen=50.0),
                                dict(regen=-50.0, interpolation="quadratic",
                                     delay=1.0)])
def test_flanger_on_card(cuda_device, kw):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 2, 22050)).astype(np.float32) * 0.3)
    assert _rel(tops.flanger(x.to(cuda_device), 44100, **kw),
                tops.flanger(x, 44100, **kw)) <= SCAN_PARITY


@pytest.mark.cuda
def test_vad_loudness_and_kaldi_pitch_on_card(cuda_device):
    """Onsets and pitch tracks equal, on voiced clips: equal harmonics of
    150 Hz (a pure tone's flat NCCF peak leaves neighbouring lags within
    rounding of each other)."""
    rng = np.random.default_rng(3)
    t = np.arange(32000) / 16000
    voice = sum(np.sin(2 * np.pi * 150.0 * k * t + 0.7 * k)
                for k in range(1, 7))
    speech = 0.05 * voice * (t > 1.0)
    x = torch.from_numpy((speech + 0.01 * rng.standard_normal((4, 32000)))
                         .astype(np.float32))
    xc = x.to(cuda_device)
    assert torch.equal(tops.vad_onset(xc, 16000).cpu(),
                       tops.vad_onset(x, 16000))
    lk = tops.loudness(xc.view(2, 2, -1), 16000).cpu()
    assert (lk - tops.loudness(x.view(2, 2, -1), 16000)).abs().max() <= 1e-3
    got = tops.compute_kaldi_pitch(xc, 16000).cpu()
    want = tops.compute_kaldi_pitch(x, 16000)
    assert torch.equal(got[..., 1], want[..., 1])
    assert _rel(got[..., 0], want[..., 0]) <= SCAN_PARITY


@pytest.mark.cuda
def test_room_and_a_weighting_take_the_card_for_lists(cuda_device):
    """A list or array input goes to the card; a tensor keeps its device."""
    room, src, mics = [4.0, 3.0, 2.5], [1.0, 1.5, 1.0], [[3.0, 1.0, 2.0]]
    rir = tops.simulate_rir_ism(room, src, mics, max_order=2)
    assert rir.device.type == "cuda"
    want = tops.simulate_rir_ism(room, src, torch.tensor(mics), max_order=2)
    assert _rel(rir.cpu(), want) <= SCAN_PARITY
    hist = tops.ray_tracing(room, src, mics, 500, time_thres=0.05)
    assert hist.device.type == "cuda" and float(hist.sum()) > 0
    assert tops.a_weighting([100.0, 1000.0]).device.type == "cuda"


# ---- the ASR path: losses, alignment, decoders and models ------------------

def _asr_emissions(seed, b, t, c):
    x = np.random.default_rng(seed).standard_normal((b, t, c)) * 2
    x = x - np.log(np.exp(x).sum(-1, keepdims=True))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.cuda
def test_ctc_loss_and_alignment_on_card(cuda_device):
    """Values, gradients, the Viterbi path and the edit distance: a CUDA
    tensor in, a CUDA tensor out, as on the CPU copy."""
    lp = _asr_emissions(4, 3, 60, 7)
    tg = torch.from_numpy(np.random.default_rng(5).integers(1, 7, (3, 12)))
    il, tl = torch.tensor([60, 41, 25]), torch.tensor([12, 8, 3])
    want, want_g = [], []
    for dev in ("cpu", cuda_device):
        x = lp.to(dev).detach().requires_grad_(True)
        loss = tops.ctc_loss(x, tg.to(dev), il.to(dev), tl.to(dev))
        loss.backward()
        assert loss.device == x.device
        want.append(loss.detach().cpu())
        want_g.append(x.grad.cpu())
    assert _rel(want[1], want[0]) <= PARITY
    assert _rel(want_g[1], want_g[0]) <= GRAD_PARITY
    ca, cs = tops.forced_align(lp.to(cuda_device), tg.to(cuda_device),
                               il.to(cuda_device), tl.to(cuda_device))
    pa, ps = tops.forced_align(lp, tg, il, tl)
    assert ca.device.type == "cuda" and torch.equal(ca.cpu(), pa)
    assert (cs.cpu() - ps).abs().max() <= 1e-5
    d = tops.edit_distance_batched(tg.to(cuda_device), ca, tl.to(cuda_device))
    assert d.device.type == "cuda"
    assert torch.equal(d.cpu(), tops.edit_distance_batched(tg, pa, tl))


@pytest.mark.cuda
def test_ctc_decoders_on_card(cuda_device):
    lp = _asr_emissions(6, 3, 40, 6)
    il = torch.tensor([40, 30, 9])
    got = tops.ctc_greedy_decode(lp.to(cuda_device), il.to(cuda_device))
    want = tops.ctc_greedy_decode(lp, il)
    assert all(g.device.type == "cuda" for g in got)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    got = tops.ctc_beam_decode(lp.to(cuda_device), il.to(cuda_device),
                               beam_width=8)
    want = tops.ctc_beam_decode(lp, il, beam_width=8)
    fin = torch.isfinite(want[2])
    assert torch.equal(torch.isfinite(got[2].cpu()), fin)
    assert torch.equal(got[0].cpu()[fin], want[0][fin])
    assert (got[2].cpu()[fin] - want[2][fin]).abs().max() <= 1e-5
    from torchaudio_contrib_tpu_torch.models import ctc_decoder
    tokens = ["-", "|", "a", "b", "c", "d"]
    host = ctc_decoder(["ab a b", "ba b a", "cad c a d", "dab d a b"],
                       tokens, beam_size=6, nbest=3,
                       beam_threshold=float("inf"))
    dev = tops.device_ctc_decoder(host)
    lp6 = _asr_emissions(7, 2, 20, 6)
    got, want = dev(lp6.to(cuda_device)), host(lp6)
    for gb, wb in zip(got, want):
        assert [h.words for h in gb] == [h.words for h in wb]
        assert [h.tokens for h in gb] == [h.tokens for h in wb]
        for g, w in zip(gb, wb):
            assert abs(g.score - w.score) <= 1e-5 * max(1.0, abs(w.score))


@pytest.mark.cuda
def test_rnnt_losses_on_card(cuda_device):
    rng = np.random.default_rng(8)
    b, t, u, j, v = 3, 30, 6, 16, 9
    enc = torch.from_numpy(rng.standard_normal((b, t, j)).astype(np.float32))
    pred = torch.from_numpy(rng.standard_normal((b, u + 1, j))
                            .astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((j, v)) / 4).astype(np.float32))
    bias = torch.zeros(v)
    tg = torch.from_numpy(rng.integers(0, v - 1, (b, u)))
    ll, tl = torch.tensor([30, 22, 9]), torch.tensor([6, 4, 0])
    vals, grads = [], []
    for dev in ("cpu", cuda_device):
        e = enc.to(dev).detach().requires_grad_(True)
        joint = torch.relu(e[:, :, None] + pred.to(dev)[:, None]) \
            @ w.to(dev) + bias.to(dev)
        plain = tops.rnnt_loss(joint, tg.to(dev), ll.to(dev), tl.to(dev))
        fused = tops.rnnt_loss_fused(
            e, pred.to(dev), {"w": w.to(dev), "b": bias.to(dev)}, tg.to(dev),
            logit_lengths=ll.to(dev), target_lengths=tl.to(dev),
            time_chunk=7)
        assert fused.device == e.device
        (g,) = torch.autograd.grad(fused, e)
        vals += [plain.detach().cpu(), fused.detach().cpu()]
        grads.append(g.cpu())
    assert all(_rel(v_, vals[0]) <= PARITY for v_ in vals[1:])
    assert _rel(grads[1], grads[0]) <= GRAD_PARITY


@pytest.mark.cuda
def test_asr_models_on_card(cuda_device):
    from torchaudio_contrib_tpu_torch.models import DeepSpeech, Wav2Letter
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 13, 60)).astype(np.float32))
    for compat in ("tpu", "torchaudio"):
        cpu = Wav2Letter(29, "mfcc", 13, compat, device="cpu",
                         generator=torch.Generator().manual_seed(1))
        card = copy.deepcopy(cpu).to(cuda_device)
        got = card(x.to(cuda_device))
        assert got.device.type == "cuda"
        assert _rel(got, cpu(x)) <= PARITY
    assert next(Wav2Letter(5, "mfcc", 13).parameters()).device.type \
        == "cuda"
    ds = DeepSpeech(13, 64, 29, device="cpu",
                    generator=torch.Generator().manual_seed(2))
    xs = x.transpose(1, 2).contiguous()
    got = copy.deepcopy(ds).to(cuda_device)(xs.to(cuda_device), True)
    assert _rel(got, ds(xs, True)) <= PARITY


# toy transducers: the torchaudio-layout Emformer-RNNT at stride 2 and a
# Conformer-RNNT (2 layers, 16-32 wide, 11-13 symbols)
_EMF_RNNT = dict(input_dim=6, encoding_dim=20, num_symbols=13,
                 segment_length=4, right_context_length=2, num_heads=2,
                 ffn_dim=24, num_layers=2, left_context_length=3,
                 max_memory_size=0, predictor_embed_dim=10,
                 predictor_hidden_dim=12, predictor_layers=2,
                 time_reduction_input_dim=8, time_reduction_stride=2,
                 lstm_layer_norm=True, lstm_layer_norm_epsilon=1e-3)
_CONF_RNNT = dict(input_dim=6, encoding_dim=20, time_reduction_stride=2,
                  conformer_input_dim=16, conformer_ffn_dim=32,
                  conformer_num_layers=2, conformer_num_heads=2,
                  conformer_depthwise_conv_kernel_size=5, num_symbols=11,
                  symbol_embedding_dim=10, num_lstm_layers=2,
                  lstm_hidden_dim=12)


@pytest.mark.cuda
def test_transducers_on_card(cuda_device):
    """Joint logits, the fused loss and its gradients, greedy grids and
    both beams of the toy transducers on the card against their CPU
    copies; the factories and the bundle put their models on the card."""
    from torchaudio_contrib_tpu_torch import models as M
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((2, 18, 6)).astype(np.float32))
    lengths = torch.tensor([16, 10])
    tg = torch.from_numpy(rng.integers(1, 11, (2, 5)))
    tl = torch.tensor([5, 3])
    for build, cfg in ((M.emformer_rnnt_model, _EMF_RNNT),
                       (M.conformer_rnnt_model, _CONF_RNNT)):
        cpu = build(**cfg, device="cpu",
                    generator=torch.Generator().manual_seed(3)).eval()
        card = copy.deepcopy(cpu).to(cuda_device)
        xs = x if build is M.emformer_rnnt_model else x[:, :16]
        args = (xs, tg, lengths, tl)
        on = [a.to(cuda_device) for a in args]
        got, _ = card(*on)
        assert got.device.type == "cuda"
        assert _rel(got, cpu(*args)[0]) <= PARITY
        loss = card.loss(*on, time_chunk=3)
        loss.backward()
        want = cpu.loss(*args, time_chunk=3)
        want.backward()
        assert _rel(loss, want) <= PARITY
        peak = max(p.grad.abs().max().item() for p in cpu.parameters())
        err = max((a.grad.cpu() - b.grad).abs().max().item() for a, b in
                  zip(card.parameters(), cpu.parameters()))
        assert err / peak <= GRAD_PARITY
        with torch.no_grad():
            enc, ol = card.transcribe(on[0], on[2])
        grid = card._greedy_on_enc(enc, ol, 3, card.greedy_init_state(2))[0]
        want_grid = cpu._greedy_on_enc(enc.cpu(), ol.cpu(), 3,
                                       cpu.greedy_init_state(2))[0]
        assert torch.equal(grid.cpu(), want_grid)
        search = M.RNNTBeamSearch(card, beam_width=3, max_symbols=2)
        host, _ = search.infer(enc, ol, search.init_state(2))
        batched, _ = search.infer_batched(
            enc, ol, search.init_batched_state(2, 2 * enc.shape[1]))
        for h, b in zip(host, batched):
            assert [t for t, _ in h] == [t for t, _ in b]
            np.testing.assert_allclose([s for _, s in h], [s for _, s in b],
                                       atol=1e-4)
    model = M.conformer_rnnt_base(generator=torch.Generator())
    assert next(model.parameters()).device.type == "cuda"


@pytest.mark.cuda
def test_emformer_bundle_streams_on_card(cuda_device):
    """The bundle's model on the card, fed its extractor's features a
    segment at a time, equals its one-shot encodings."""
    from torchaudio_contrib_tpu_torch.pipelines import \
        EMFORMER_RNNT_BASE_LIBRISPEECH as bundle
    model = bundle.get_model(torch.Generator().manual_seed(4)).eval()
    assert next(model.parameters()).device.type == "cuda"
    wave = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (2, 16000)).astype(np.float32)).to(cuda_device) * 0.1
    with torch.inference_mode():
        feats = bundle.get_feature_extractor()(wave)[:, :100]   # T = 96
        full, _ = model.transcribe(feats)
        state, outs = model.transcriber.init_state(2), []
        for i in range(6):
            chunk = torch.cat([feats[:, 16 * i:16 * i + 16],
                               feats[:, min(16 * i + 16, 96):][:, :4]], 1)
            out, _, state = model.stream_transcribe(chunk, state)
            outs.append(out)
    assert _rel(torch.cat(outs, 1), full) <= 1e-4


_W2V2 = dict(extractor_conv_layers=((8, 10, 5), (8, 3, 2), (8, 2, 2)),
             d_model=16, num_layers=2, num_heads=2, ff_dim=32,
             pos_conv_kernel=8, pos_conv_groups=4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["group_norm", "layer_norm", "wavlm"])
def test_wav2vec2_family_on_card(cuda_device, kind):
    """Toy Wav2Vec2 (both extractor modes) and WavLM on the card against
    their CPU copies: a padded batch with a clip of ``output_length`` 0,
    the SSL hooks and every parameter's gradient."""
    from torchaudio_contrib_tpu_torch import models as M
    cls = M.WavLM if kind == "wavlm" else M.Wav2Vec2
    kw = dict(num_buckets=8, max_distance=20) if kind == "wavlm" else {}
    mode = "layer_norm" if kind == "layer_norm" else "group_norm"
    cpu = cls(**_W2V2, **kw, extractor_mode=mode,
              layer_norm_first=mode == "layer_norm", aux_out=5,
              device="cpu", generator=torch.Generator().manual_seed(6))
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((3, 400)).astype(np.float32))
    lengths = torch.tensor([400, 250, 15])
    mask = torch.from_numpy(rng.random((3, 19)) < 0.3)
    emb = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    got, gl = card(x.to(cuda_device), lengths.to(cuda_device),
                   frame_mask=mask.to(cuda_device),
                   mask_embedding=emb.to(cuda_device))
    want, wl = cpu(x, lengths, frame_mask=mask, mask_embedding=emb)
    assert gl.tolist() == wl.tolist() == [19, 12, 0]
    assert torch.isfinite(got).all() and _rel(got, want) <= PARITY
    got.square().sum().backward()
    want.square().sum().backward()
    peak = max(p.grad.abs().max().item() for p in cpu.parameters())
    err = max((a.grad.cpu() - b.grad).abs().max().item()
              for a, b in zip(card.parameters(), cpu.parameters()))
    assert err / peak <= GRAD_PARITY


@pytest.mark.cuda
def test_ssl_models_on_card(cuda_device):
    """HuBERT's loss with a span mask drawn for the card, the Conformer and
    Emformer SSL variants on the card against CPU copies, and the Emformer
    variant streamed on the card against its one-shot output."""
    from torchaudio_contrib_tpu_torch import models as M
    gen = torch.Generator().manual_seed(7)
    cpu = M.HuBERTPretrainModel(M.Wav2Vec2(**_W2V2, device="cpu",
                                           generator=gen),
                                num_classes=5, final_dim=8, device="cpu",
                                generator=gen)
    card = copy.deepcopy(cpu).to(cuda_device)
    x = torch.randn((2, 400), generator=gen)
    labels = torch.randint(0, 5, (2, 19), generator=gen)
    mask = M.span_mask(torch.Generator().manual_seed(1), 2, 19, None, 0.2, 4,
                       device=cuda_device)
    assert mask.device.type == "cuda"
    loss = card.loss(x.to(cuda_device), labels.to(cuda_device), None, mask)
    want = cpu.loss(x, labels, None, mask.cpu())
    assert abs(loss.item() - want.item()) <= PARITY * abs(want.item())
    feats = torch.randn((2, 28, 6), generator=gen)
    for model in (M.ConformerWav2Vec2(feature_dim=6, stride=2, d_model=16,
                                      num_layers=2, num_heads=2, ff_ratio=2,
                                      conv_kernel=3, device="cpu",
                                      generator=gen),
                  M.EmformerHuBERT(feature_dim=6, stride=2, d_model=16,
                                   num_heads=2, ffn_dim=32, num_layers=2,
                                   segment_length=4, left_context_length=3,
                                   right_context_length=2,
                                   max_memory_size=2, device="cpu",
                                   generator=gen)):
        model = model.eval()
        on = copy.deepcopy(model).to(cuda_device)
        with torch.no_grad():
            got, _ = on(feats.to(cuda_device), torch.tensor([28, 20]))
            assert _rel(got, model(feats, torch.tensor([28, 20]))[0]) \
                <= PARITY
    with torch.no_grad():
        full, _ = on(feats.to(cuda_device))
        state, outs = on.init_state(2), []
        for i in range(3):
            o, _, state = on.infer(feats[:, 8 * i:8 * i + 12]
                                   .to(cuda_device), state)
            outs.append(o)
    assert _rel(torch.cat(outs, 1), full) <= 1e-4


@pytest.mark.cuda
def test_w2v2_bundles_on_card(cuda_device):
    """The bundles' models default to the card; the forced-alignment
    emissions (star column) and spans of a toy base on the card equal the
    CPU path's."""
    from torchaudio_contrib_tpu_torch import models as M
    from torchaudio_contrib_tpu_torch import pipelines as P

    class Tiny(P.Wav2Vec2FABundle):
        def _build(self, device, generator):
            return M.Wav2Vec2(**_W2V2, aux_out=28, device=device,
                              generator=generator)

    fa = Tiny().get_model(generator=torch.Generator().manual_seed(8))
    assert next(fa.parameters()).device.type == "cuda"
    cpu = copy.deepcopy(fa).cpu()
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1, 800)).astype(np.float32))
    with torch.no_grad():
        em, _ = fa(x.to(cuda_device))
        want, _ = cpu(x)
    assert em.shape == (1, 39, 29) and not em[..., -1].any()
    assert _rel(em, want) <= PARITY
    tokens = [3, 5, 5, 9]
    aligner = P.MMS_FA.get_aligner()
    got = aligner(want[0].to(cuda_device), tokens)
    assert [(s.token, s.start, s.end) for s in got] == \
        [(s.token, s.start, s.end) for s in aligner(want[0], tokens)]
    asr = P.Wav2Vec2ASRBundle(lambda aux_out, device, generator: M.Wav2Vec2(
        **_W2V2, aux_out=aux_out, device=device, generator=generator))
    model = asr.get_model(torch.Generator().manual_seed(9))
    assert next(model.parameters()).device.type == "cuda"


@pytest.fixture()
def default_flags(cuda_device):
    """The card with PyTorch's default precision flags (cuDNN TF32 on,
    cuBLAS TF32 off), restored after the test."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda_device
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


def _default_flag_case(name, g):
    """(model on the CPU, its inputs) at widths where TF32 convolutions
    land well past 1e-4 of peak."""
    from torchaudio_contrib_tpu_torch import models as M
    x = lambda *s: torch.randn(*s, generator=g)
    if name == "wav2letter":
        return (tat.Wav2Letter(num_classes=29, input_type="mfcc",
                               num_features=13, device="cpu", generator=g),
                (x(2, 13, 400),))
    if name == "wav2vec2":
        return M.wav2vec2_base(device="cpu", generator=g), (x(2, 32000),)
    if name == "conformer":
        return (M.Conformer(80, d_model=144, num_layers=4, num_heads=4,
                            device="cpu", generator=g), (x(2, 300, 80),))
    if name == "hifigan":
        return M.hifigan_vocoder_v3(device="cpu", generator=g), \
            (x(2, 80, 40),)
    if name == "conv_tasnet":
        return M.conv_tasnet_base(device="cpu", generator=g), \
            (x(2, 16000),)
    if name in ("hdemucs_ta", "hdemucs"):
        compat = "torchaudio" if name == "hdemucs_ta" else None
        return (M.hdemucs_high(compat=compat, device="cpu", generator=g),
                (x(1, 2, 44100),))
    if name in ("squim_objective_ta", "squim_objective"):
        compat = "torchaudio" if name == "squim_objective_ta" else None
        return (M.squim_objective_base(compat, device="cpu", generator=g),
                (x(2, 16000),))
    if name == "squim_subjective":
        return (M.squim_subjective_base(device="cpu", generator=g),
                (x(2, 16000), x(2, 12000)))
    if name == "vggish":
        return M.VGGish(device="cpu", generator=g), (x(4, 96, 64),)
    return (M.Tacotron2(n_symbols=38, device="cpu", generator=g).eval(),
            (torch.randint(1, 38, (2, 30), generator=g),
             torch.tensor([30, 17]), x(2, 80, 12)))


_DEFAULT_FLAG_CASES = ["wav2letter", "wav2vec2", "conformer", "hifigan",
                       "tacotron2", "conv_tasnet", "hdemucs_ta", "hdemucs",
                       "squim_objective_ta", "squim_objective",
                       "squim_subjective", "vggish"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _DEFAULT_FLAG_CASES)
def test_models_hold_the_bar_at_default_flags(default_flags, name):
    """C1: with ``cudnn.allow_tf32`` True (PyTorch's default) the models
    still run their convolutions and RNNs in FP32: 1e-4 of peak against
    the CPU copy."""
    model, args = _default_flag_case(name, torch.Generator().manual_seed(0))
    card = copy.deepcopy(model).to(default_flags)
    with torch.no_grad():
        want = model(*args)
        got = card(*(a.to(default_flags) for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        if w is None:
            assert g is None, name
        elif w.is_floating_point():
            assert _rel(g, w) <= GRAD_PARITY, name
        else:
            assert torch.equal(g.cpu(), w), name
    assert torch.backends.cudnn.allow_tf32


def _grads_at(model, args, tf32: bool) -> dict:
    """The gradients of a fixed weighting of every floating output of
    ``model(*args)`` with ``cudnn.allow_tf32`` at ``tf32`` (cuBLAS TF32
    off)."""
    torch.backends.cudnn.allow_tf32 = tf32
    model.zero_grad(set_to_none=True)
    out = model(*args)
    out = out if isinstance(out, tuple) else (out,)
    g = torch.Generator(device=args[0].device).manual_seed(1)
    loss = sum((o * torch.randn(o.shape, generator=g, device=o.device)).sum()
               for o in out if o is not None and o.is_floating_point()
               and o.requires_grad)
    loss.backward()
    assert torch.backends.cudnn.allow_tf32 == tf32
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()
            if p.grad is not None}


@pytest.mark.cuda
@pytest.mark.parametrize("name", _DEFAULT_FLAG_CASES)
def test_model_gradients_hold_the_bar_at_default_flags(default_flags, name):
    """C2: a backward pass through a model's outputs at PyTorch's default
    flags runs cuDNN in FP32 as the forward does: the gradients within
    1e-4 of the whole gradient's peak of those taken with TF32 off, and the
    flag True again after the pass."""
    model, args = _default_flag_case(name, torch.Generator().manual_seed(0))
    card = copy.deepcopy(model).to(default_flags)
    if name == "tacotron2":
        card.train()        # cuDNN runs an RNN's backward in training mode only
    args = tuple(a.to(default_flags) for a in args)
    want = _grads_at(card, args, tf32=False)
    got = _grads_at(card, args, tf32=True)
    assert got.keys() == want.keys() and got, name
    peak = max(v.abs().max().item() for v in want.values())
    err = max((got[k] - want[k]).abs().max().item() for k in want)
    assert err <= GRAD_PARITY * peak, (name, err, peak)
    assert torch.backends.cudnn.allow_tf32


@pytest.mark.cuda
def test_vggish_processor_on_card(cuda_device):
    """The VGGish front end runs on the waveform's device: the card's
    patches against the CPU's."""
    x = torch.randn(2, 40000, generator=torch.Generator().manual_seed(0))
    proc = tat.VGGishInputProcessor()
    got = proc(x.to(cuda_device))
    assert got.device.type == "cuda"
    assert _rel(got, proc(x)) <= GRAD_PARITY


@pytest.mark.cuda
def test_istft_drops_the_edge_bins_imaginary_parts_on_card(cuda_device):
    """cuFFT's ``irfft`` reads the imaginary parts of the DC and Nyquist
    bins, the CPU's drops them: ``ops.istft`` drops them on both, so a
    model's spectrum (``HDemucsTA``'s) inverts alike."""
    g = torch.Generator().manual_seed(0)
    z = torch.complex(torch.randn(2, 1025, 40, generator=g),
                      torch.randn(2, 1025, 40, generator=g))
    want = tops.istft(z, 512, window="hann", normalized=True)
    got = tops.istft(z.to(cuda_device), 512, window="hann", normalized=True)
    assert _rel(got, want) <= PARITY


# ---- the file and namespace surfaces -----------------------------------------

@pytest.mark.cuda
def test_native_codecs_are_in_use(cuda_device):
    """The card's machine builds both codecs with g++: the numbers of
    chip_smoke.py phase 25 are the native decoders'."""
    from torchaudio_contrib_tpu_torch import io as tio
    assert tio.have_native() and tio.have_native_flac()


@pytest.mark.cuda
def test_load_returns_a_tensor_on_the_card(cuda_device, tmp_path):
    x = np.random.default_rng(0).uniform(-0.9, 0.9, (2, 3000)) \
        .astype(np.float32)
    for ext, bits in ((".wav", 16), (".wav", 32), (".flac", 24)):
        path = str(tmp_path / f"c{bits}{ext}")
        tat.save(path, torch.from_numpy(x).to(cuda_device), 16000,
                 bits_per_sample=bits)
        got, sr = tat.load(path)
        want, _ = tat.load(path, device="cpu")
        assert got.device.type == "cuda" and sr == 16000
        assert torch.equal(got.cpu(), want)
        assert tat.info(path)["num_frames"] == 3000


@pytest.mark.cuda
def test_sox_chain_on_card_matches_cpu(cuda_device):
    """A chain runs on its waveform's device: the card against the CPU
    copy (1e-4 of peak for the chains through the float64 biquad scans,
    as chip_smoke.py phase 19; 1e-2 through the phase vocoder, phase 18's
    bar: its output moves ~3 000 times as far as its input, below)."""
    from torchaudio_contrib_tpu_torch import sox_effects as tse
    x = torch.randn(2, 32000, generator=torch.Generator().manual_seed(1))
    chains = [
        ([["speed", "1.1"], ["rate", "16000"], ["gain", "-n", "-3"],
          ["highpass", "80"], ["lowpass", "7000"],
          ["fade", "0.1", "10", "0.1"]], 1e-4),
        ([["tempo", "1.2"], ["pitch", "200"], ["reverse"]], 1e-2),
        ([["phaser"], ["overdrive", "10"], ["channels", "1"]], 1e-4),
    ]
    for chain, bar in chains:
        got, sr = tse.apply_effects_tensor(x.to(cuda_device), 16000, chain)
        want, want_sr = tse.apply_effects_tensor(x, 16000, chain)
        assert got.device.type == "cuda" and sr == want_sr
        assert _rel(got, want) <= bar, chain


@pytest.mark.cuda
def test_phase_vocoder_on_card_matches_cpu_on_a_long_clip(cuda_device):
    """C4: the phases of a 10 s clip are summed in float64 on both devices.
    Summed in float32, the card's order landed 0.41 of peak from the CPU's
    (a running sum reaches ~1e5 rad at the top bins); in float64 what is
    left is the function's own conditioning: on the CPU, a 4.9e-7 relative
    perturbation of this spectrogram moves the output 1.6e-3 of peak
    (phases integrate the angle errors of a bin's weak frames), so the
    card's FFT rounding is held to phase 18's 1e-2."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 160000, generator=g)
    spec = tops.stft(x, 1024, 256)
    adv = tops.compute_phase_advance(513, 256, 1024)
    want = tops.phase_vocoder(spec, 1.1, adv)
    got = tops.phase_vocoder(spec.to(cuda_device), 1.1, adv.to(cuda_device))
    assert _rel(torch.view_as_real(got), torch.view_as_real(want)) <= 1e-2


# -- the multi-device layer at world size 1 (parallel/) --------------------

def _one_rank_mesh():
    from torchaudio_contrib_tpu_torch.parallel import make_mesh
    return make_mesh()          # starts a one-rank NCCL group if none


@pytest.mark.cuda
def test_make_mesh_is_one_nccl_rank_on_card(cuda_device):
    import torch.distributed as dist
    mesh = _one_rank_mesh()
    assert dist.get_backend() == "nccl"
    assert mesh.device_type == "cuda" and mesh.size(0) == mesh.size(1) == 1


@pytest.mark.cuda
def test_data_parallel_fused_layer_on_card_is_the_layer(cuda_device):
    from torchaudio_contrib_tpu_torch.models import FusedMelspectrogram
    from torchaudio_contrib_tpu_torch.parallel import data_parallel
    layer = FusedMelspectrogram(num_mels=128, sample_rate=22050,
                                fft_length=2048, hop_length=512).cuda()
    x = torch.randn(4, 1, 88200, device="cuda")
    before = tfused.FFT_KERNEL_LAUNCHES
    with torch.inference_mode():
        out = data_parallel(layer, _one_rank_mesh())(x)
    assert tfused.FFT_KERNEL_LAUNCHES == before + 1
    with torch.inference_mode():
        assert torch.equal(out.to_local(), layer(x))


@pytest.mark.cuda
def test_time_sharded_mel_runs_the_fused_kernel_on_card(cuda_device):
    from torchaudio_contrib_tpu_torch.parallel import \
        time_sharded_melspectrogram
    x = torch.randn(2, 512 * 400, device="cuda")
    fb = tops.create_mel_filter(128, 22050, 0.0, None, 1025, device="cuda")
    before = tfused.FFT_KERNEL_LAUNCHES
    with torch.inference_mode():
        got = time_sharded_melspectrogram(
            x, _one_rank_mesh(), num_mels=128, sample_rate=22050,
            fft_length=2048, hop_length=512, use_fused=True)
    assert tfused.FFT_KERNEL_LAUNCHES == before + 1
    with torch.inference_mode():
        want = tfused.fused_melspectrogram(x, fb, 2048, 512)
    assert got.shape == want.shape and _rel(got, want) <= PARITY


@pytest.mark.cuda
def test_corpus_on_a_mesh_on_card(cuda_device):
    from torchaudio_contrib_tpu_torch.parallel import CorpusPreprocessor
    clips = np.random.default_rng(0).standard_normal((8, 1, 16000)) \
        .astype(np.float32)
    rows = {}
    before = tfused.KERNEL_LAUNCHES
    stats = CorpusPreprocessor(
        lambda i: clips[i], 16000, 4, mesh=_one_rank_mesh(), use_fused=True,
        sink=lambda i, r: rows.__setitem__(i, r), fft_length=512,
        hop_length=128, num_mels=64, sample_rate=16000).run(range(8))
    assert stats.files_done == 8 and len(rows) == 8
    assert tfused.KERNEL_LAUNCHES == before + 2


@pytest.mark.cuda
def test_sequence_parallel_wav2vec2_on_card(cuda_device):
    from torchaudio_contrib_tpu_torch.models import Wav2Vec2
    from torchaudio_contrib_tpu_torch.parallel import sp_wav2vec2_apply
    model = Wav2Vec2(extractor_conv_layers=((32, 10, 5), (32, 4, 2)),
                     d_model=64, num_layers=2, num_heads=4, ff_dim=128,
                     pos_conv_kernel=16, pos_conv_groups=4,
                     extractor_mode="group_norm", layer_norm_first=False,
                     device="cuda").eval()
    x = torch.randn(2, 4000, device="cuda")
    with torch.inference_mode():
        got, _ = sp_wav2vec2_apply(model, x, mesh=_one_rank_mesh())
        want, _ = model(x)
    assert _rel(got.full_tensor()[:, :want.shape[1]], want) <= 1e-5


@pytest.mark.cuda
def test_ring_attention_accumulates_bf16_in_float32_on_card(cuda_device):
    from torchaudio_contrib_tpu_torch.parallel import ring_attention
    mesh = _one_rank_mesh()
    q, k, v = (3 * torch.randn(2, 256, 4, 32, device="cuda")
               for _ in range(3))
    got = ring_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                         mesh.get_group("data"))
    qf, kf, vf = (t.bfloat16().float() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / 32 ** 0.5
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vf)
    assert got.dtype == torch.bfloat16
    assert (got.float() - want).abs().max() <= \
        2.0 ** -8 * want.abs().max()


@pytest.mark.cuda
def test_pipeline_and_tp_fsdp_step_on_card(cuda_device, tmp_path):
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    from torchaudio_contrib_tpu_torch.models import Wav2Vec2
    from torchaudio_contrib_tpu_torch import parallel as par
    from torchaudio_contrib_tpu_torch.utils import (load_checkpoint,
                                                    save_checkpoint)
    mesh = _one_rank_mesh()
    model = Wav2Vec2(extractor_conv_layers=((32, 10, 5), (32, 4, 2)),
                     d_model=64, num_layers=4, num_heads=4, ff_dim=128,
                     pos_conv_kernel=16, pos_conv_groups=4, device="cuda")
    pipe = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("pipe",))
    acts = torch.randn(4, 50, 64, device="cuda")
    stacked = par.stack_pipeline(list(model.encoder.layers), 1)
    out = par.pipeline_apply(model.encoder_layer, stacked, acts, mesh=pipe,
                             n_microbatches=4)
    ref = acts
    for layer in model.encoder.layers:
        ref = model.encoder_layer(layer, ref)
    assert _rel(out, ref) <= 1e-5
    sharded = copy.deepcopy(model)
    tp = par.tensor_parallel_specs(sharded, mesh)
    par.shard_params(sharded, mesh)
    par.fsdp_shard(sharded, mesh, base_specs=tp)
    x = torch.randn(2, 4000, device="cuda")
    (model(x)[0] ** 2).mean().backward()
    (sharded(x)[0] ** 2).mean().backward()
    for (n, p), (_, q) in zip(sorted(model.named_parameters()),
                              sorted(sharded.named_parameters())):
        g = q.grad.full_tensor() if isinstance(q.grad, DTensor) else q.grad
        assert _rel(g, p.grad) <= GRAD_PARITY, n
    save_checkpoint(str(tmp_path / "ck"), sharded)
    back = copy.deepcopy(model)
    load_checkpoint(str(tmp_path / "ck"), back)
    for (n, p), (_, q) in zip(sorted(back.named_parameters()),
                              sorted(sharded.named_parameters())):
        assert torch.equal(p.detach(), q.full_tensor().detach()), n


# ---- the classifier's training step replayed from a CUDA graph ------------

# BASELINE config 3, as the benchmark's c3_train cell runs it
C3 = dict(num_classes=10, num_mels=64, sample_rate=16000, fft_length=512,
          hop_length=128, channels=(32, 64, 128), fused=True,
          trainable_frontend=True)
STEP_GRAPH = ("STEP_GRAPH_CAPTURES", "STEP_GRAPH_REPLAYS",
              "STEP_GRAPH_REFUSED")


@pytest.fixture()
def deterministic_cudnn(cuda_device):
    """cuDNN's deterministic algorithms.  With its default ones two eager
    runs of config 3's steps differ by 9e-6 of the filterbank's norm after
    the second step and by 3e-2 after the fifth: its weight gradients sum
    in no fixed order, and from the second step on the filterbank's
    gradient turns last-bit differences into large ones.  With these, the
    eager steps repeat bit for bit, so a replay must match them."""
    kept = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield cuda_device
    torch.backends.cudnn.deterministic = kept


def _c3_pair():
    """Two config-3 classifiers on the card from one seed."""
    model = tat.MelFrontendClassifier(
        **C3, generator=torch.Generator().manual_seed(1)).cuda()
    return model, copy.deepcopy(model)


def _c3_batch(seed, clips=32, seconds=10):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = 0.1 * torch.randn((clips, 1, seconds * 16000), generator=gen,
                          device="cuda")
    return x, torch.randint(0, 10, (clips,), generator=gen, device="cuda")


def _eager_step(model, waveform, labels, lr):
    """``train_step``'s body before it was replayed from a graph: every
    call eager."""
    from torchaudio_contrib_tpu_torch.models._common import _fp32_cudnn

    @_fp32_cudnn
    def step(waveform, labels):
        params = [p for p in model.parameters() if p.requires_grad]
        loss = model.loss_fn(waveform, labels)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g)
        return loss.detach()
    return step(waveform, labels)


def _step_gaps(params, twin, loss, want):
    """The loss's relative gap and each of ``params``' to ``twin``'s, in
    l2."""
    gaps = {"loss": abs(float(loss) - float(want)) / abs(float(want))}
    for p, (name, q) in zip(params, twin.named_parameters()):
        gaps[name] = (torch.linalg.norm((p - q).double())
                      / torch.linalg.norm(q.double())).item()
    return gaps


def _graph_moves(before):
    from torchaudio_contrib_tpu_torch.utils import trace
    moved = trace.delta(before)
    return tuple(moved[k] for k in STEP_GRAPH)


@pytest.mark.cuda
def test_train_step_replays_as_the_eager_step(deterministic_cudnn):
    """Config 3: five ``train_step``s (eager, captured and replayed, three
    replays) against five eager steps of the old body from the same
    weights: every loss and parameter within 1e-6 relative after every
    step; the losses returned at steps 1-3 unchanged after step 5; one
    capture, four replays, nothing refused; the launch counters moved as
    the eager steps moved them."""
    from torchaudio_contrib_tpu_torch.ops import _launches
    from torchaudio_contrib_tpu_torch.utils import trace
    model, twin = _c3_pair()
    batches = [_c3_batch(seed) for seed in range(5)]
    before, launches = trace.counts(), _launches.counts()
    losses, kept, params = [], [], []
    for x, labels in batches:
        losses.append(model.train_step(x, labels, 1e-3))
        kept.append(losses[-1].clone())
        params.append([p.detach().clone() for p in model.parameters()])
    torch.cuda.synchronize()
    graph_launches = _launches.delta(launches)
    assert _graph_moves(before) == (1, 4, 0)
    launches = _launches.counts()
    for i, (x, labels) in enumerate(batches):
        want = _eager_step(twin, x, labels, 1e-3)
        gaps = _step_gaps(params[i], twin, losses[i], want)
        assert max(gaps.values()) <= 1e-6, (i, gaps)
    torch.cuda.synchronize()
    assert _launches.delta(launches) == graph_launches
    for got, first in zip(losses[:3], kept):
        assert torch.equal(got, first)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["lr", "batch shape", "assigned weights"])
def test_train_step_captures_again_on_a_new_signature(deterministic_cudnn,
                                                      change):
    """Two steps at one signature (eager, then captured), then three at
    another: eager, captured, replayed; every step within 1e-6 of the
    eager body's."""
    from torchaudio_contrib_tpu_torch.utils import trace
    model, twin = _c3_pair()
    x, labels = _c3_batch(0)
    lr = 1e-3
    before = trace.counts()
    for step in range(5):
        if step == 2:
            if change == "lr":
                lr = 2e-3
            elif change == "batch shape":
                x, labels = _c3_batch(1, clips=16)
            else:
                for m in (model, twin):
                    m.load_state_dict({k: v.clone() for k, v
                                       in m.state_dict().items()},
                                      assign=True)
        loss = model.train_step(x, labels, lr)
        gaps = _step_gaps(model.parameters(), twin, loss,
                          _eager_step(twin, x, labels, lr))
        assert max(gaps.values()) <= 1e-6, (step, gaps)
    assert _graph_moves(before) == (2, 3, 0)


@pytest.mark.cuda
def test_train_step_stays_eager_where_its_capture_fails(deterministic_cudnn):
    """A host sync in the head: the second call's capture fails, is counted
    and leaves the signature eager; every step is the eager body's and the
    card's generator still draws."""
    from torchaudio_contrib_tpu_torch.utils import trace
    model, twin = _c3_pair()
    head = model.head.forward

    def syncing(v):
        v.sum().item()
        return head(v)

    model.head.forward = syncing
    x, labels = _c3_batch(0, clips=4)
    before = trace.counts()
    for _ in range(3):
        loss = model.train_step(x, labels, 1e-3)
        gaps = _step_gaps(model.parameters(), twin, loss,
                          _eager_step(twin, x, labels, 1e-3))
        assert max(gaps.values()) <= 1e-6, gaps
    assert _graph_moves(before) == (0, 0, 1)
    torch.randn(4, device="cuda")


def _device_rows(fn):
    """Device rows (kernels, copies, fills) the profiler lists for
    ``fn()``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.device_type == cuda for e in prof.events())


@pytest.mark.cuda
def test_train_step_replay_issues_the_eager_launches_and_three(cuda_device):
    """Config 3 as ``c3_train`` runs it: a replayed step lists the eager
    step's device rows and three more (the two input copies and the
    loss's copy), as it did before the stream pool's steps shared its
    graph machinery (89 and 92 rows on the benchmark's trace)."""
    model, _ = _c3_pair()
    x, labels = _c3_batch(0)
    eager = _device_rows(lambda: model.train_step(x, labels, 1e-3))
    model.train_step(x, labels, 1e-3)             # captured, replayed
    replayed = _device_rows(lambda: model.train_step(x, labels, 1e-3))
    assert replayed == eager + 3, (eager, replayed)


# ---- the transducer's stream pool replayed from two CUDA graphs ----------

def _stream_calls(pool, audio, calls):
    """``calls`` steps of a pool of 16 slots over 1.2–6 s utterances of
    ``audio``, slots beginning at staggered calls and recycled."""
    rng = np.random.default_rng(3)
    lengths = rng.integers(19200, 96000, size=(16, 4))
    starts = rng.integers(0, audio.shape[0] - 96000, size=(16, 4))
    seg = np.zeros(16, dtype=np.int64) - np.arange(16) % 3
    k = np.zeros(16, dtype=np.int64)
    outs = []
    for _ in range(calls):
        n = lengths[np.arange(16), k]
        nseg = -(-pool.frames(torch.from_numpy(n)).numpy() // 16)
        cur = np.maximum(seg, 0)
        out = pool.step(audio, starts[np.arange(16), k], n, cur,
                        (seg == 0).astype(np.int64))
        outs.append(tuple(o.clone() for o in out))
        seg += 1
        done = seg >= nseg
        k[done] = (k[done] + 1) % 4
        seg[done] = 0
    return outs, pool.state


@pytest.mark.cuda
def test_stream_pool_replays_as_the_eager_step(cuda_device, monkeypatch):
    """``EMFORMER_RNNT_BASE_LIBRISPEECH`` at its published widths, 16
    slots, eight steps with staggered starts and recycled slots: the steps
    replayed from the two graphs (eager, captured, then replayed) give the
    grids, lengths, encodings and final state of eight eager steps bit for
    bit; one capture, seven replays, nothing refused."""
    from torchaudio_contrib_tpu_torch import pipelines
    from torchaudio_contrib_tpu_torch.models import _step_graph
    from torchaudio_contrib_tpu_torch.utils import trace
    bundle = pipelines.EMFORMER_RNNT_BASE_LIBRISPEECH
    model = bundle.get_model(torch.Generator().manual_seed(2)).eval()
    audio = 0.1 * torch.randn(400000, device="cuda",
                              generator=torch.Generator("cuda").manual_seed(4))
    before = trace.counts()
    replayed, state = _stream_calls(bundle.get_stream_pool(model, 16),
                                    audio, 8)
    moved = trace.delta(before)
    assert (moved["STEP_GRAPH_CAPTURES"], moved["STEP_GRAPH_REPLAYS"],
            moved["STEP_GRAPH_REFUSED"]) == (1, 7, 0)
    monkeypatch.setattr(_step_graph, "_stages_engage", lambda *a: False)
    eager, eager_state = _stream_calls(bundle.get_stream_pool(model, 16),
                                       audio, 8)
    for i, (got, want) in enumerate(zip(replayed, eager)):
        for g, w in zip(got, want):
            assert torch.equal(g, w), i
    from torchaudio_contrib_tpu_torch.models.rnnt import _leaves
    for g, w in zip(_leaves(state), _leaves(eager_state)):
        assert torch.equal(g, w)


# ---- utils.timing: the device loop as one CUDA graph replay ---------------

def _fold(s, k):
    """The loop's running float32 sum of ``k`` applications whose sum is
    ``s``."""
    acc = np.float32(0.0)
    for _ in range(k):
        acc = np.float32(acc + np.float32(s))
    return float(acc)


def _mel_grad_loop(shape, fft, hop, mels, k, seed):
    """A device loop over the gradient of the fused layer (B1 with its
    residual, then B2), with the last application's output kept; the
    input and the eager gradient."""
    from torchaudio_contrib_tpu_torch.utils import device_loop
    layer = tat.FusedMelspectrogram(num_mels=mels, sample_rate=16000,
                                    fft_length=fft, hop_length=hop).cuda()
    last = {}

    def f(v):
        v = v.detach().requires_grad_(True)
        last["g"] = torch.autograd.grad(layer(v).sum(), v)[0]
        return last["g"]

    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                         .astype(np.float32)).cuda()
    return device_loop(f, k), x, last, f


@pytest.mark.cuda
def test_device_loop_replays_b1_b2_bitwise_as_eager(cuda_device):
    looped, x, last, f = _mel_grad_loop((4, 1, 32000), 2048, 512, 128, 3, 1)
    value = float(looped(x))
    want = f(x)
    assert torch.equal(last["g"], want)
    assert value == _fold(float(want.sum(dtype=torch.float32)), 3)


@pytest.mark.cuda
def test_device_loop_captures_a_fresh_shape(cuda_device):
    """A size no call has seen (the constants on the card, the kernels'
    library looked up again): the warm-up fills every cache, the capture
    succeeds and replays the eager value."""
    tfused._fft_consts_on.cache_clear()
    tfused._basis_on.cache_clear()
    tfused._kernel_lib.cache_clear()
    looped, x, last, f = _mel_grad_loop((3, 1, 7777), 512, 160, 48, 2, 2)
    value = float(looped(x))
    assert len(looped.captures) == 1
    assert value == _fold(float(f(x).sum(dtype=torch.float32)), 2)


@pytest.mark.cuda
def test_device_loop_counters_count_replays(cuda_device):
    from torchaudio_contrib_tpu_torch.ops import _launches
    looped, x, _, _ = _mel_grad_loop((2, 1, 16000), 1024, 256, 64, 4, 3)
    before = _launches.counts()
    for _ in range(3):
        looped(x)
    torch.cuda.synchronize()
    moved = _launches.delta(before)
    n = 1 + 4 * 3           # the warm-up application, then 3 replays of 4
    for name in ("KERNEL_LAUNCHES", "FFT_KERNEL_LAUNCHES",
                 "BWD_KERNEL_LAUNCHES", "BWD_DFRAMES_LAUNCHES",
                 "BWD_FFT_LAUNCHES", *tfused.CARD_COUNTERS):
        assert moved["fused." + name] == n, (name, moved)
    assert moved["fused.MEL_BAND_LAUNCHES"] == 2 * n, moved
    assert not any(v for k, v in moved.items()
                   if k.startswith("fused_griffinlim."))


@pytest.mark.cuda
def test_device_loop_raises_on_a_host_sync(cuda_device):
    """``.item()`` cannot be captured: the call raises, names ``f`` and
    quotes CUDA, and runs nothing eagerly instead; the card's generator and
    a later capture still work."""
    from torchaudio_contrib_tpu_torch.utils import device_loop
    calls = []

    def syncs(v):
        calls.append(1)
        return v * v.sum().item()

    x = torch.ones(8, device="cuda")
    with pytest.raises(RuntimeError, match="syncs cannot be captured"):
        device_loop(syncs, 3)(x)
    assert len(calls) == 2          # the warm-up, then the capture's first
    torch.randn(4, device="cuda")
    assert float(device_loop(lambda v: v * 2, 3)(x)) == 48.0
