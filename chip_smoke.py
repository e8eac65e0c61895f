"""GPU smoke run of the PyTorch port's serving, training and inverse paths,
its corpus path, the IIR family, the ASR path, the streaming transducer
family, the wav2vec2 family and the TTS family.

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit's ``nvcc``; builds the port's kernels from ``csrc/`` itself.  It
imports no JAX.  Phases, each printing its lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: the kernels' ``nvcc`` build and its ptxas summary;
3. forward kernel vs plain PyTorch at small shapes (config 2, Whisper,
   stereo with a ragged frame count, ``to_db=False``, ``center=True``, a
   shorter window, the classifier's shape, fft 1024 with an odd frame
   count): relative error to peak <= 1e-5.  A power-of-two ``fft_length``
   from 256 to 2048 takes the shared-memory FFT kernel, any other
   (Whisper's 400) the DFT-product kernel; where the FFT kernel runs, the
   DFT-product kernel is run on the same input and held to the same bar;
4. gradients through the kernels (forward with its residual, backward)
   vs autograd of the plain chain at the same shapes, for the waveform and
   the filterbank, on the route the size takes and, where that is the FFT
   route, on the DFT route too: relative error to peak <= 1e-4, and two
   backward runs bitwise equal; then the filterbank-only case (the
   backward's frame passes not launched) and silence (gradients exactly
   0);
5. the serving path, once, between a reset and a read of the launch
   counters: BASELINE config 2 at full width (32 x 30 s at 22.05 kHz, fft
   2048, hop 512, 128 mels) through ``FusedMelspectrogram(precision=
   "split3")``, then ``MelFrontendClassifier(fused=True)`` answering 4
   requests of (8, 1, 16000) under ``torch.inference_mode()``; both must
   go through the FFT kernel (its own counter);
6. config 2 checked (shape, finiteness, parity) and timed, FFT route and
   DFT route, against the plain version (CUDA events);
7. the 4 requests' logits checked against the same module run on a CPU
   copy (the plain path);
8. the training path, each part between a reset and a read of the
   counters: config 2 forward + backward at full width through
   ``FusedMelspectrogram(trainable=True)`` with the waveform requiring
   grad, then BASELINE config 3 at full width: 4 ``train_step``s of
   ``MelFrontendClassifier(fused=True, trainable_frontend=True)`` on 32 x
   10 s at 16 kHz, each from the parameters the CPU copy had before its
   own step;
9. config 2's gradients checked against autograd of the plain chain; each
   kernel of both routes checked against its plain version at config 2,
   the FFT kernels also against the plain versions that repeat their
   arithmetic step by step; fwd+bwd, the forward with and without its
   residual and the backward timed on both routes against their plain
   versions;
10. config 3's losses and parameters checked against the CPU copy's
    (the plain path), and ms per step timed on both;
11. the fused Griffin-Lim kernels vs their plain version at small shapes
    (fft 1024 / hop 256, 2048 / 512, 1024 / 512, 1024 / 1024, fft 400 / hop
    160, stereo, ``center=False``, a Hamming window), in both state
    layouts, on the route the size takes (the shared-memory FFT kernels for
    a power of two from 256 to 2048, else the DFT-product kernels) and,
    where that is the FFT route, on the DFT route too: one iteration from
    the same state (the FFT kernels also against the plain version that
    repeats their arithmetic step by step), the 4-iteration waveform, the
    32-iteration spectral convergence; tile-major against row-major; two
    runs and the stage-bisect build's ``full`` variant bitwise against the
    solve;
12. the inverse path, each part between a reset and a read of the
    counters (every solve of it must take the FFT route): (a) ``griffin_lim(method="pallas")`` on the magnitudes of 8 x
    110 250 samples (fft 1024, hop 256, 431 frames, 32 iterations); (b) 4
    vocoder requests of 8 log-mels (8, 80, 431) through ``mel_to_audio`` at
    the Tacotron2 Griffin-Lim vocoder's settings (60 iterations) under
    ``torch.inference_mode()``; (c) the layout probe ``gl_probe.run`` at
    fft 1024 and 2048 and the stage bisect ``gl_bisect.run``;
13. (a) checked: shape, finiteness, spectral convergence against the
    ``matmul`` loop's on the same magnitudes;
14. BASELINE config 4: (4, 2, 32768) -> ``stft`` -> ``istft`` on the card
    (plain PyTorch, no kernel), max abs error <= 1e-4;
15. the solve at full width (fft 1024 and fft 2048) checked against its
    plain versions and timed on both routes against them, against the
    ``matmul`` and ``fft`` loops and against a loop of
    ``torch.stft``/``torch.istft``; the stage bisect on both routes;
16. the rules shared with the JAX package: ``power=1`` on a CUDA tensor
    computes the plain chain and launches nothing; 65 600 streams through
    the fused mel forward (fft 256, hop 64) and 65 600 clips through one
    fused Griffin-Lim call on each route equal the same inputs run as two
    slabs, bitwise; the build went into ``$TAC_TORCH_BUILD_DIR`` (phase 2
    sets it, inside the checkout, when the caller has not);
17. the corpus path, BASELINE config 5 at full width
    (``benchmarks/corpus_run.py``: 512 files from 8 synthetic 10 s clips
    at 16 kHz, batches of 256, 2 loader threads, 3 batches in flight, the
    int16 wire, ``use_fused=True``, fft 2048, hop 512, 128 mels), one
    warm-up batch first, the timed run between a reset and a read of the
    counters (the fused forward once a batch, on the FFT route), sink rows
    against the plain chain on the same dequantised clips; files/s,
    frames/s, wall seconds, bytes a batch to the card, the kernel's time a
    batch and the card's busy share; a run whose loader fails on every 7th
    file; the float32 and mulaw8 wires, and the chunked path
    (``use_fused=False``) against its CPU copy, on 64 files;
18. the ops and layers with no kernel of their own (masking, deltas,
    emphasis, spectral descriptors, effects, convolution, metrics, chroma,
    CQT, pitch detection, DSP synthesis, beamforming; the torchaudio-named
    transforms) on CUDA tensors against the same call on a CPU copy,
    ``deemphasis`` on a 10 s clip among them;
19. the IIR family and the ops beside it at full width, each part on
    CUDA tensors against the same call on a CPU copy (1e-5 of peak, 1e-4
    for scans and log-domain outputs, integers equal), timed by CUDA
    events with its peak memory: (a) config 3's batch (32 x 10 s at 16
    kHz) through ``Highpass(80)`` -> ``Equalizer(1000, +3 dB)`` ->
    ``Lowpass(7000)`` -> ``FusedMelspectrogram`` (fft 512, hop 128, 64
    mels) between a reset and a read of the counters (the fused forward
    once, on the FFT route), then ``Vad(mode="trim")`` and ``vad_onset``
    on the batch; (b) ``loudness`` and ``Loudness`` on 16 x 30 s stereo at
    48 kHz against a float64 BS.1770 chain (1e-3 LU); (c) a biquad through
    ``lfilter`` and ``filtfilt`` on config 2's batch, two rows and the
    gradient against float64 scipy, one backward's peak memory, and the
    same doubling in float32 for comparison; (d) ``overdrive``,
    ``contrast``, ``phaser`` at decay 0.4 and 0.9 and ``flanger`` at regen
    0 and 50 (linear and quadratic) on 8 x 10 s stereo at 44.1 kHz, one
    row of each feedback path against a float64 loop, the pointer-jumping
    rounds and the flanger's block count; (e) ``compute_kaldi_pitch`` on
    8 x 10 s at 16 kHz (pitch tracks equal on voiced clips; on speech-like
    clips at most 2 % of a clip's frames unequal); (f) ``compliance.kaldi``
    ``fbank`` and ``mfcc`` on config 3's clips; (g) ``simulate_rir_ism``
    (6 x 5 x 3 m, 8 mics, order 10; float32 delays of thousands of samples,
    so 1e-4, also against a float64 NumPy build; two card runs' spread
    printed), ``ray_tracing`` (10 000 rays) and one response applied
    through ``fftconvolve``;
20. the ASR path at full width, each part on CUDA tensors against a CPU
    copy with TF32 off: (a) 16 x 10 s at 16 kHz through ``mfcc(...,
    use_fused=True)`` (13 of 40 mels, fft 512, hop 160: the fused forward
    once a step, on the FFT route) into ``Wav2Letter`` at full width
    (~23 M parameters, 501 frames) trained by 4 SGD steps on ``ctc_loss``
    against 60-120 tokens a clip between a reset and a read of the
    counters; step 0's loss, emissions and gradients against the CPU copy;
    ms per step with TF32 off and with both TF32 flags on (the forward's
    convolutions stay FP32: only the backward's follow the flag); step 0's
    emissions also with PyTorch's default flags (cuDNN TF32 allowed),
    held to the same bar; (b) ``DeepSpeech`` (2048 hidden) on
    ``FusedMelspectrogram``'s 40-mel log-mel of the clips (the fused
    forward once), forward and backward through ``ctc_loss``, 2 clips
    against the CPU copy; (c) ``rnnt_loss`` on logits (8, 250, 101, 1024)
    and ``rnnt_loss_fused`` from the encodings and a (1024, 1024) joiner,
    equal to each other, two rows against the CPU copy, ms and peak MiB;
    (d) greedy, beam (16) and lexicon + bigram LM (1 000 words, beam 16)
    decoding of emissions planted from known transcripts (word error 0 by
    ``edit_distance_batched``), the device searches equal to the host
    searches on 2 clips, ``forced_align`` and ``merge_tokens`` recovering
    the planted alignment, and the decoders timed on (a)'s emissions;
21. the streaming transducer family at full width (no kernel: the launch
    counters stay at 0, the bundle's extractor being the plain chain), on
    CUDA tensors against a CPU copy with TF32 off: (a) 4 requests of 10 s
    of speech-like audio at 16 kHz served by
    ``pipelines.EMFORMER_RNNT_BASE_LIBRISPEECH.get_model(generator=...)``
    (20 x 512 Emformer, 4097 symbols) under ``torch.inference_mode()``:
    the bundle's extractor (checked against its CPU copy and a float64
    build, 1e-4 of peak: a log-domain output), then segment by
    segment (16 + 4 input frames) through ``stream_greedy_step``, and
    through ``stream_transcribe`` + ``RNNTBeamSearch.infer_batched`` (beam
    8), the tokens read back each segment; the streamed greedy grid equal
    to one-shot ``greedy_decode``'s, the streamed beam equal to
    ``decode_batched``'s, the host beam ``__call__`` equal to the batched
    beam on one request, the one-shot encodings within 1e-4 of peak of the
    CPU copy's (also with PyTorch's default flags); ms per segment (median
    and max) beside the 160 ms of audio
    a segment holds, one-shot ``transcribe`` ms, peak MiB; (b)
    ``conformer_rnnt_base()`` trained by SGD on ``RNNT.loss`` (fused) over
    8 x 10 s of the extractor's features with 60-100 target tokens: the
    loss (1e-5 relative) and gradients (1e-4 of the whole gradient's peak)
    of 2 clips against the CPU copy, ms per step and the shares of the
    model's forward + backward and of the fused loss's;
22. the wav2vec2 family at full width (no kernel: the launch counters are
    read before and after the phase and must not move), weights from the
    seeded generator, on CUDA tensors against a CPU copy with TF32 off
    (1e-4 of peak; losses 1e-5 relative, gradients 1e-4 of the whole
    gradient's peak), times with TF32 off and with both TF32 flags on (the
    models pin their forwards' cuDNN calls to FP32: the flag reaches the
    cuBLAS products, and a step's backward): (a)
    ``pipelines.WAV2VEC2_ASR_BASE_960H`` serving 8 requests of 4-16 s at 16
    kHz in one padded batch with ``lengths`` under
    ``torch.inference_mode()``: emissions, ``ctc_greedy_decode`` (frame
    labels equal to the CPU's wherever its top-2 margin exceeds twice the
    measured error) and ``bundle.decode``, ``get_decoder`` over a
    synthetic 40-word lexicon on one request; ms per batch and per
    request, the emissions with PyTorch's default flags (the same bar) and
    with both TF32 flags on (printed, no bar); (b) a CTC fine-tuning step
    of the same model (``ctc_loss``,
    SGD) on 8 x 10 s, 4 steps whose loss must fall, checked on 2 x 4 s; (c)
    ``hubert_pretrain_base(num_classes=100)`` on 8 x 10 s with a
    ``span_mask`` drawn from the generator and random labels, checked on 2
    clips with the same mask rows; (d) ``MMS_FA`` (the LARGE-lv60k
    geometry) on 2 x 15 s: emissions with the star column, then
    ``forced_align`` + ``merge_tokens`` of 60 tokens a clip, spans equal to
    the CPU path's; (e) ``WAVLM_BASE`` on 4 x 10 s,
    ``conformer_wav2vec2_base`` and ``emformer_hubert_base`` on 4 clips of
    features, and ``emformer_hubert_base`` streamed through ``infer``
    against its one-shot output;
23. the TTS family at full width (no kernel of its own; B3 once), weights
    from the seeded generator, with the global precision flags at
    PyTorch's defaults (cuDNN TF32 allowed: the models pin it off), each
    part on CUDA tensors against a CPU copy (1e-4 of peak) with its ms
    (CUDA events) and peak MiB: (a) ``TACOTRON2_WAVERNN_CHAR_LJSPEECH``: 4
    texts of 66-140 characters through the processor and
    ``Tacotron2.infer(max_steps=200)`` (mel, postnet, stop logits and
    alignments over the whole horizon, and equal lengths; a failure prints
    the mel's drift by step), then ``WaveRNN.infer`` (``fc3`` times 1e4)
    on each clip's first 24 frames (4 x 5 500 samples), the card drawing
    its noise from the shared generator and the CPU copy from one in the
    same state: on the CPU's history, the card's and the CPU's picks
    (logits + noise) equal wherever the CPU's top-2 margin exceeds twice
    the card's logit error, and the samples equal to the CPU copy's up to
    each clip's first step without that margin; (b) ``Tacotron2.apply``
    on 8 x (120 tokens, 800 frames) (2 clips on the CPU) with the card's
    busy share from one profiler window, and ``WaveRNN.apply`` on 4 x
    22 000 samples; (c)
    ``HIFIGAN_VOCODER_V3_LJSPEECH``: ``get_mel_transform`` on 4 x 10 s at
    22.05 kHz and the vocoder (``frames x 256`` samples; one clip on the
    CPU), its FLOP counted from the convolutions it runs, beside its FP32
    bound, and ``hifigan_vocoder_v1`` (512 channels) on the same mel (its
    first 86 frames on the CPU); (d) ``TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH``
    on (a)'s texts: the bundle's vocoder (the ``matmul`` loop, 60
    iterations) on the card and the CPU copy (spectral convergence within
    ``TTS_GL_CONV_GAP``; the same vocoder at 3 iterations from a random
    phase drawn on the CPU per sample), and the
    same mel through ``mel_to_audio(..., method="pallas")``: one B3 launch
    on the FFT route, counted from 0 just before it, its convergence
    within ``GL_CONV_SLACK`` of the bundle's; (e)
    ``TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH`` over a 50-word
    ``cmudict-0.7b`` written to a temporary directory: ids equal to a
    hand count, Tacotron2 (100 steps) and the vocoder on the card.  Every
    counter is set to 0 before the phase; the mel counters must stay there,
    B3's move only by (d)'s launch and the calls that time it.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before those lines; so does a machine without a CUDA card.
"""
from __future__ import annotations

import contextlib
import copy
from functools import partial
import json
import logging
import math
import os
from pathlib import Path
import re
import time

import numpy as np
import torch

F32_PARITY = 1e-5      # kernel vs plain, max|diff| / max|plain|
GRAD_PARITY = 1e-4     # the same for gradients (BASELINE's bar)
LOGIT_ATOL = 1e-4      # classifier logits, kernel path vs plain path
LOSS_RTOL = 1e-5       # config 3, one step's loss, card vs CPU copy
# Config 3, parameters after one step from the same parameters, against
# the same step in float64 on the CPU: max|card - f64| / max|f64 update|.
# The update is lr * gradient, so this is the gradient's error relative to
# its peak, as GRAD_PARITY.  The filterbank's gradient is ill-conditioned
# once the first step has made some of its entries negative: mel bins then
# cancel towards 0, and d(dB)/d(mel) = 4.34 / mel amplifies the forward's
# f32 rounding (on this script's data the CPU's f32 chain lands 3-6 % of
# an update away from the float64 step there, the card up to 41 %; which
# mel entries land near 0 decides it).  So it is held to STEP_PARITY_FB at
# the first step and, after that, in l2 to FB_DRIFT_L2 of the update: a
# filterbank gradient that is missing or has the wrong sign lands 1 or 2
# away.
STEP_PARITY = 1e-4
STEP_PARITY_FB = 1e-3
FB_DRIFT_L2 = 0.5
# Fused Griffin-Lim, kernel vs plain (both f32 chains), relative to peak.
# One iteration from the same state: the two products (read off ``prev``,
# the unnormalised rebuilt spectrum) to GL_PRODUCT_PARITY; the projected
# state to GL_STATE_PARITY, since mag * upd / |upd| amplifies the products'
# rounding where |upd| is near zero.
GL_PRODUCT_PARITY = 1e-5
GL_STATE_PARITY = 1e-4
GL_WAVE_PARITY = 1e-4      # the 4-iteration waveform
GL_LAYOUT_PARITY = 1e-6    # tile-major vs row-major waveform
GL_CONV_PARITY = 1e-3      # |convergence(kernel) - convergence(plain)|, 32 it.
GL_CONV_SLACK = 0.05       # fused convergence <= the matmul loop's + this
ISTFT_ATOL = 1e-4          # config 4 round trip, max abs error
# Phase 18, the card against the CPU copy, relative to peak: plain f32 ops;
# scans, torch.linalg and log-domain layers; the phase vocoder's float32
# phases summed along time in another order.
SCAN_PARITY = 1e-4
VOCODER_PARITY = 1e-2
# Phase 19, the IIR family at full width, (batch, channels, samples, rate):
# (a) config 3's batch through three biquads into the fused forward, and
# the VAD on it; (b) 30 s stereo at 48 kHz through the BS.1770 meter; (c)
# config 2's batch through a biquad and filtfilt; (d) 10 s stereo at 44.1
# kHz through the effects; (e) Kaldi pitch, (batch, samples, rate); (f)
# the Kaldi fbank and MFCC on config 3's clips; (g) a 6 x 5 x 3 m room.
IIR = dict(pre=(32, 1, 160000, 16000), loud=(16, 2, 1440000, 48000),
           filt=(32, 1, 661500, 22050), fx=(8, 2, 441000, 44100),
           pitch=(8, 160000, 16000), kaldi=(32, 160000, 16000),
           room=dict(room=(6.0, 5.0, 3.0), mics=8, max_order=10,
                     rays=10000))
LU_ATOL = 1e-3          # loudness, card vs float64 chain and CPU copy, LU
# Kaldi pitch on speech-like clips, card vs CPU copy: the most of one
# clip's frames whose Viterbi state may differ (1e-6 of noise moved up to
# 0.8 % of a clip's frames on the CPU alone)
PITCH_FLIP_SHARE = 0.02
# Phase 20, the ASR path at full width: (a) 16 x 10 s at 16 kHz through
# the fused MFCC (13 of 40 mels, fft 512, hop 160: 1001 frames) into
# Wav2Letter (29 classes, 501 frames out) trained on CTC against 60-120
# tokens a clip; (b) DeepSpeech (2048 hidden) on the fused 40-mel log-mel
# of the same clips, checked on a sub-batch of ``ds_check`` clips on the
# CPU; (c) RNN-T at conformer-RNN-T-base widths (models/factories.py:
# 1024 symbols, encoding width 1024, 10 s at time reduction 4 -> 250
# frames), 100 target tokens, batch 8; (d) decoding with beam 16 and a
# lexicon of ``words`` words, the device searches against the host
# searches on ``decode_check`` clips.
ASR = dict(clips=16, samples=160000, sr=16000, classes=29,
           mfcc=dict(sample_rate=16000, n_mfcc=13, num_mels=40,
                     fft_length=512, hop_length=160),
           targets=(60, 120), steps=4, lr=1e-3,
           ds_mels=40, ds_hidden=2048, ds_check=2,
           rnnt=(8, 250, 100, 1024, 1024),
           words=1000, beam=16, decode_check=2)
# device search scores vs the host's float64 search: |diff| / max(1, |host|)
DECODE_REL = 1e-5
# Phase 21, the streaming transducer family at full width: (a) 4 requests
# of 10 s at 16 kHz served by EMFORMER_RNNT_BASE_LIBRISPEECH (20 x 512
# Emformer, 4097 symbols, ~77 M parameters) a segment (16 + 4 input frames)
# at a time, greedy and beam 8, max 4 symbols a frame; (b)
# conformer_rnnt_base (16 x 256 Conformer, 1024-wide encodings, 1024
# symbols) trained on 8 x 10 s of the bundle's features (250 reduced
# frames) against 60-100 tokens, ``check`` clips against the CPU copy.
# The random model's 4097-way posteriors are near flat, which no trained
# model's are: its beam would be a field of near-ties that float32 orders
# by rounding.  So the joiner is made as confident as a trained one: its
# weights times ``joiner_scale``, and blank's bias raised until greedy
# decoding of the requests emits ``tokens_per_frame`` (a sentencepiece
# model's pace: a piece every 160 ms) (``_confident_joiner``).
RNNT_SERVE = dict(requests=4, samples=160000, sr=16000, beam=8,
                  max_symbols=4, joiner_scale=8.0, tokens_per_frame=0.25)
RNNT_TRAIN = dict(clips=8, samples=160000, targets=(60, 100), symbols=1024,
                  lr=1e-5, check=2)
# beams against each other: |diff| / max(1, |score|) (float32 running sums
# against the host beam's float64 ones over ~1000 tokens)
BEAM_REL = 1e-4
# Phase 22, the wav2vec2 family at full width (weights from the seeded
# generator): (a) WAV2VEC2_ASR_BASE_960H (94.4 M parameters + the 29-way
# head) serving 8 requests of 4-16 s at 16 kHz in one padded batch; (b) a
# CTC fine-tuning step of it on 8 x 10 s (60-120 tokens), checked on 2 x 4 s
# (20-40 tokens); (c) hubert_pretrain_base(num_classes=100) on 8 x 10 s
# with a span mask from the generator, checked on 2 of the clips with their
# mask rows; (d) MMS_FA (LARGE-lv60k, ~315 M) on 2 x 15 s, 60 tokens a
# clip; (e) WAVLM_BASE on 4 x 10 s, conformer_wav2vec2_base on 4 x 1000
# frames of 64 features, emformer_hubert_base on 4 x 996 frames of 80
# (62 segments of 4 + 1 lookahead, reduced frames), streamed and one-shot.
W2V2 = dict(sr=16000, requests=(4.0, 5.7, 7.4, 9.1, 10.9, 12.6, 14.3, 16.0),
            train=(8, 160000), check=(2, 64000), targets=(60, 120),
            check_targets=(20, 40), lr=1e-5, steps=4, classes=100,
            fa=(2, 240000), fa_tokens=60, ssl=(4, 160000), conf_frames=1000,
            emf_segments=62)
# card vs CPU copy (TF32 off), max |diff| / max |CPU|: twelve to 24 layers
# of float32 products summed in other orders (the phase 21 bar)
W2V2_REL = 1e-4
# What the "TF32 on" timings of phases 20 and 22 (both global flags on)
# reach: the models pin their forwards' cuDNN convolutions and RNNs to FP32,
# so only the cuBLAS products, and in a training step the backward's cuDNN
# calls (run under the flags in force then), go to TF32.
TF32_FWD = "both TF32 flags on: cuBLAS only, cuDNN pinned to FP32"
TF32_STEP = "both TF32 flags on: cuBLAS and the backward's cuDNN"
# Phase 23, the TTS family at full width (the global precision flags at
# PyTorch's defaults): (a) 4 texts of 60-150 characters through
# Tacotron2 infer (``steps``), WaveRNN infer on each clip's first
# ``wavernn_frames`` frames (fc3 times ``confident``);
# (b) Tacotron2 apply on ``tf`` = (clips, tokens, frames), ``tf_check``
# clips on the CPU, WaveRNN apply on ``wavernn_apply`` = (clips, mel
# frames); (c) HiFi-GAN on ``hifi`` = (clips, samples at 22.05 kHz), v1 on
# the CPU for ``v1_check_frames``; (e) the phone bundle, ``phone_steps``.
TTS = dict(steps=200, wavernn_frames=24, confident=1e4,
           tf=(8, 120, 800), tf_check=2, wavernn_apply=(4, 84),
           hifi=(4, 220500), v1_check_frames=86, gl_short_iter=3,
           phone_steps=100)
# card vs CPU copy, max |diff| / max |CPU|
TTS_REL = 1e-4
# the Griffin-Lim bundle's 60-iteration spectral convergence, card vs CPU
# copy (measured on an H100 gaps of 0 to 3e-4)
TTS_GL_CONV_GAP = 2e-3
TTS_TEXTS = [
    "The quick brown fox jumps over the lazy dog, then naps in the sun.",
    "Printing, in the only sense with which we are at present concerned, "
    "differs from most if not from all the arts and crafts.",
    "She sells sea shells by the sea shore; the shells she sells are surely "
    "sea shells, so if she sells shells on the shore, they are sea shells!",
    "How much wood would a woodchuck chuck if a woodchuck could chuck wood? "
    "As much as it could.",
]
TTS_CMUDICT = {
    "THE": "DH AH0", "CAT": "K AE1 T", "SAT": "S AE1 T", "ON": "AA1 N",
    "MAT": "M AE1 T", "A": "AH0", "DOG": "D AO1 G", "RAN": "R AE1 N",
    "TO": "T UW1", "HOUSE": "HH AW1 S", "AND": "AH0 N D", "BIG": "B IH1 G",
    "RED": "R EH1 D", "SUN": "S AH1 N", "WAS": "W AA1 Z", "HOT": "HH AA1 T",
    "IN": "IH0 N", "SKY": "S K AY1", "BLUE": "B L UW1", "WATER": "W AO1 T ER0",
    "FISH": "F IH1 SH", "SWIM": "S W IH1 M", "FAST": "F AE1 S T",
    "SLOW": "S L OW1", "GREEN": "G R IY1 N", "TREE": "T R IY1",
    "BIRD": "B ER1 D", "SING": "S IH1 NG", "SONG": "S AO1 NG",
    "NIGHT": "N AY1 T", "DAY": "D EY1", "MOON": "M UW1 N",
    "STAR": "S T AA1 R", "LIGHT": "L AY1 T", "DARK": "D AA1 R K",
    "ROAD": "R OW1 D", "CAR": "K AA1 R", "BOOK": "B UH1 K",
    "READ": "R IY1 D", "WRITE": "R AY1 T", "PEN": "P EH1 N",
    "CHAIR": "CH EH1 R", "TABLE": "T EY1 B AH0 L", "JUMP": "JH AH1 M P",
    "THINK": "TH IH1 NG K", "VOICE": "V OY1 S", "YES": "Y EH1 S",
    "ZOO": "Z UW1", "MEASURE": "M EH1 ZH ER0", "OF": "AH1 V",
}
TTS_PHONE_TEXT = "the cat sat on the mat."
# TTS_PHONE_TEXT in the 96-symbol table (12 specials "_-!'(),.:;? ", then
# the sorted phones): DH AH0 ' ' K AE1 T ' ' S AE1 T ' ' AA1 N ' ' DH AH0
# ' ' M AE1 T '.'
TTS_PHONE_IDS = [39, 21, 11, 64, 18, 81, 11, 79, 18, 81, 11, 14, 67, 11, 39,
                 21, 11, 66, 18, 81, 7]
# Published peaks of one H100 SXM (data sheet, 700 W): FP32 outside the
# tensor cores, and HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# BASELINE.json config 2, the headline workload, at full width
CFG2 = dict(batch=32, seconds=30, sr=22050, fft=2048, hop=512, mels=128)
# BASELINE.json config 3 (trainable front end into the CNN), full width
CFG3 = dict(batch=32, samples=160000, sr=16000, fft=512, hop=128, mels=64,
            classes=10, steps=4, lr=1e-3)
# The Griffin-Lim benchmark's shape (8 x 5 s at 22.05 kHz, 32 iterations)
# at the vocoder's transform and at the stage bisect's.
GL_FULL = dict(clips=8, samples=110250, n_iter=32, momentum=0.99)
GL_SHAPES = ((1024, 256), (2048, 512))
# The Tacotron2 Griffin-Lim vocoder's settings.
VOCODER = dict(num_mels=80, sample_rate=22050, f_max=8000.0, fft_length=1024,
               hop_length=256, n_iter=60, power=1.0)
# With hop = fft a Hann window has no overlap, so a projection changes only
# the samples the clamped envelope zeroes.  From the zero-phase start the
# spectrum then stays almost real, and wherever a bin's real part passes
# through zero |upd| is near 0, where mag * upd / |upd| turns the products'
# rounding into a sign; nothing pulls a flipped bin back.  Which bins flip
# is the luck of rounding (seen on an H100: one bin in 1.4 million, 5e-4 of
# peak after one iteration, at products equal to 1e-6).  So at that shape
# the state and the waveform are compared in l2 (GL_NO_OVERLAP_L2) and
# the convergence to GL_NO_OVERLAP_CONV; the products keep their bar.
GL_NO_OVERLAP_L2 = 5e-3
GL_NO_OVERLAP_CONV = 2e-2
# name, shape, fft, hop, window, center
GL_CASES = [
    ("fft 1024 hop 256", (2, 11025), 1024, 256, "hann", True),
    ("fft 2048 hop 512", (2, 22050), 2048, 512, "hann", True),
    ("fft 1024 hop 512", (2, 11025), 1024, 512, "hann", True),
    ("fft 1024 hop 1024 (no overlap)", (2, 11025), 1024, 1024, "hann", True),
    ("fft 400 hop 160 (no multiple of 128, fft % hop != 0)", (2, 16000),
     400, 160, "hann", True),
    ("stereo (2, 2, T)", (2, 2, 6000), 512, 128, "hann", True),
    ("center=False", (2, 11025), 1024, 256, "hann", False),
    ("hamming window", (2, 6000), 512, 128, "hamming", True),
]
# name, shape, fft, hop, mels, sr, win_length, to_db, center
PARITY_CASES = [
    ("config 2, 2 x 4 s", (2, 4 * 22050), 2048, 512, 128, 22050,
     None, True, False),
    ("Whisper fft 400 hop 160", (2, 3 * 16000), 400, 160, 80, 16000,
     None, True, False),
    ("stereo (2, 2, T), ragged frames", (2, 2, 7000), 256, 64, 40,
     16000, None, True, False),
    ("to_db=False", (2, 20000), 512, 128, 64, 16000, None, False, False),
    ("center=True", (3, 9000), 512, 200, 64, 16000, None, True, True),
    ("win_length 300 < fft 512", (2, 9000), 512, 128, 64, 16000, 300,
     True, False),
    ("classifier shape (8, 1, 16000)", (8, 1, 16000), 512, 128, 64,
     16000, None, True, False),
    ("fft 1024 hop 256, 21 frames (odd)", (2, 1024 + 20 * 256), 1024, 256,
     80, 22050, None, True, False),
]


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def _counts() -> tuple:
    from torchaudio_contrib_tpu_torch.ops import fused
    return (fused.KERNEL_LAUNCHES, fused.BWD_KERNEL_LAUNCHES,
            fused.BWD_DFRAMES_LAUNCHES)


def _fft_counts() -> tuple:
    """Launches that took the FFT route: forward, backward frame passes."""
    from torchaudio_contrib_tpu_torch.ops import fused
    return (fused.FFT_KERNEL_LAUNCHES, fused.BWD_FFT_LAUNCHES)


def _reset_counts() -> None:
    from torchaudio_contrib_tpu_torch.ops import fused
    fused.KERNEL_LAUNCHES = 0
    fused.BWD_KERNEL_LAUNCHES = 0
    fused.BWD_DFRAMES_LAUNCHES = 0
    fused.FFT_KERNEL_LAUNCHES = 0
    fused.BWD_FFT_LAUNCHES = 0


def _dft_route(xs, fb, n_fft, hop, wl, to_db):
    """The fused op on ``xs (..., T)`` through the DFT-product kernels,
    whatever the size: the op's own path (``_fused_apply``) with the route
    named."""
    from torchaudio_contrib_tpu_torch.ops import fused
    return fused._fused_apply(
        xs, fb, n_fft, hop, "hann", wl, to_db, 1.0, 1e-7,
        partial(fused._fused_mel_fwd_cuda, _route="dft"),
        partial(fused._fused_mel_bwd_cuda, _route="dft"))


def _gl_counts() -> tuple:
    from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as fg
    return (fg.GL_KERNEL_LAUNCHES, fg.GL_TILE_MAJOR_LAUNCHES)


def _gl_fft_count() -> int:
    """Solves that took the FFT route."""
    from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as fg
    return fg.GL_FFT_LAUNCHES


def _reset_gl_counts() -> None:
    from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as fg
    fg.GL_KERNEL_LAUNCHES = 0
    fg.GL_TILE_MAJOR_LAUNCHES = 0
    fg.GL_FFT_LAUNCHES = 0


def _gl_operands(mag, n_fft: int, hop: int, window, tile_major: bool) -> dict:
    """``{route: operands}`` of the fused Griffin-Lim solve from the state
    two plain iterations reach (a generic complex state): the DFT route's
    (also the plain version's) and, where the size takes it, the FFT
    route's, first."""
    from torchaudio_contrib_tpu_torch.ops import fused, fused_griffinlim as fg
    dft = fg._gl_prepare(mag, n_fft, hop, window, None, tile_major)[:5]
    start, _ = fg._gl_solve_plain(*dft, n_fft, hop, 2, GL_FULL["momentum"],
                                  tile_major)
    ops = {}
    if fused._fft_kernel_supported(n_fft):
        ops["fft"] = (start,) + fg._gl_prepare(
            mag, n_fft, hop, window, None, tile_major, "fft")[1:5]
    ops["dft"] = (start,) + dft[1:]
    return ops


def _fft_flops(n_fft: int) -> float:
    """Operations of one real (or Hermitian) length-``n_fft`` transform as
    an FFT does it: half the ``5 n log2 n`` of a complex one."""
    return 2.5 * n_fft * math.log2(n_fft)


def _bound(flops: float, nbytes: float, design_flops: float) -> dict:
    """The least time the card could take for the function: the larger of
    the operations it needs (its transforms counted as FFTs, its other
    products over the bins there are) over the FP32 peak and the bytes over
    the memory rate.  ``design_flop_ms`` is beside it what these kernels'
    own operation count takes at that peak: every transform a dense matrix
    product over their padded 64-bin frequency tiles.  No single PyTorch
    call computes any of these kernels' functions, so ``library_ms`` is
    null; the named comparisons (the ``torch.stft`` chain, the ``fft``
    loop) are printed with the timings."""
    ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "design_flop_ms": design_flops / PEAK_FP32 * 1e3,
            "library_ms": None}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _grads(fn, x, fb, g, need=(True, True)):
    """``(dx, dfb)`` of ``sum(fn(x, fb) * g)``; None where not needed."""
    x = x.detach().clone().requires_grad_(need[0])
    fb = fb.detach().clone().requires_grad_(need[1])
    (fn(x, fb) * g).sum().backward()
    return x.grad, fb.grad


def _time_ms(fn, warmup: int = 3, iters: int = 15) -> float:
    """Median over ``iters`` runs of one call, by CUDA events."""
    from torchaudio_contrib_tpu_torch.benchmarks import time_cuda_ms
    return time_cuda_ms(fn, warmup, iters)


def _turns(plain, kern, warmup: int = 2, iters: int = 10) -> tuple:
    """(kernel ms, plain ms): in turns plain, kernel, kernel, plain; the
    better median of each."""
    a, b, c, d = (_time_ms(plain, warmup, iters), _time_ms(kern, warmup, iters),
                  _time_ms(kern, warmup, iters), _time_ms(plain, warmup, iters))
    return min(b, c), min(a, d)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    from torchaudio_contrib_tpu_torch.benchmarks import card as card_name
    card = card_name()
    print(card, flush=True)          # name, power limit
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s)", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    from torchaudio_contrib_tpu_torch.ops import _cuda, fused
    # build where $TAC_TORCH_BUILD_DIR says: inside the checkout (a
    # gitignored directory) unless the caller names another
    os.environ.setdefault(_cuda.BUILD_DIR_ENV,
                          str(Path(__file__).resolve().parent / "_local"
                              / "kernels"))
    t0 = time.perf_counter()
    fused._kernel_lib()
    info = _cuda.build_info()
    _check(Path(info["path"]).parent == _cuda.build_dir(),
           f"the library {info['path']} is not in $TAC_TORCH_BUILD_DIR "
           f"{_cuda.build_dir()}")
    print(f"build: {'nvcc built' if info['built'] else 'loaded'} "
          f"{info['path']} in {info['seconds']:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s); ptxas, per kernel: "
          + "; ".join(_ptxas_summary(info["log"])), flush=True)


def _ptxas_summary(log: str) -> list:
    """``name<template ints>: registers, spill bytes`` for each kernel in
    an ``nvcc -Xptxas -v`` log."""
    out, name, spilled = [], None, 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            kernel = re.search(r"\d+([a-z_]+kernel)", entry.group(1))
            ints = re.findall(r"L[ib](\d+)E", entry.group(1))
            name = (kernel.group(1) if kernel else entry.group(1)) \
                + (f"<{','.join(ints)}>" if ints else "")
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            spilled = int(spill.group(1)) + int(spill.group(2))
        used = re.search(r"Used (\d+) registers", line)
        if used and name:
            out.append(f"{name} {used.group(1)} regs, {spilled} spill bytes")
            name = None
    return out


def phase_parity(gen: torch.Generator) -> None:
    from torchaudio_contrib_tpu_torch.ops import create_mel_filter, fused
    from torchaudio_contrib_tpu_torch.ops.stft import _pad_center
    for name, shape, n_fft, hop, mels, sr, wl, to_db, center in \
            PARITY_CASES:
        x = torch.randn(shape, generator=gen).cuda()
        fb = create_mel_filter(mels, sr, 0.0, None, n_fft // 2 + 1,
                               device="cuda")
        takes_fft = fused._fft_kernel_supported(n_fft)
        with torch.inference_mode():
            before = _counts()[0], _fft_counts()[0]
            got = fused.fused_melspectrogram(x, fb, n_fft, hop, to_db=to_db,
                                             win_length=wl, center=center)
            moved = _counts()[0] - before[0], _fft_counts()[0] - before[1]
            xs = _pad_center(x, n_fft // 2, "reflect") if center else x
            want = fused._reference(xs, fb, n_fft, hop, "hann", 2.0, to_db,
                                    1.0, 1e-7, wl)
            errs = {"fft" if takes_fft else "dft": _rel(got, want)}
            if takes_fft:
                errs["dft"] = _rel(_dft_route(xs, fb, n_fft, hop, wl, to_db),
                                   want)
        torch.cuda.synchronize()
        unit = "dB" if to_db else "linear"
        print(f"parity {name}: out {tuple(got.shape)}, "
              f"max|kernel-plain|/max|plain| ({unit}): "
              + ", ".join(f"{k} route {v:.3e}" for k, v in errs.items()),
              flush=True)
        _check(moved == (1, int(takes_fft)),
               f"{name}: launches (all, FFT route) {moved}")
        _check(got.shape == want.shape, f"{name}: shape {got.shape} != "
               f"{want.shape}")
        _check(bool(torch.isfinite(got).all()), f"{name}: non-finite")
        _check(max(errs.values()) <= F32_PARITY,
               f"{name}: {errs} > {F32_PARITY}")


def phase_main_path(gen: torch.Generator):
    """Drive the serving path once, between one reset and one read of the
    launch counter: config 2 at full width, then the 4 classifier
    requests.  Checking and timing come after, outside the count."""
    import torchaudio_contrib_tpu_torch as tac
    layer = tac.FusedMelspectrogram(num_mels=CFG2["mels"],
                                    sample_rate=CFG2["sr"],
                                    fft_length=CFG2["fft"],
                                    hop_length=CFG2["hop"],
                                    precision="split3").cuda()
    x = torch.randn((CFG2["batch"], 1, CFG2["seconds"] * CFG2["sr"]),
                    generator=gen).cuda()
    model_cpu = tac.MelFrontendClassifier(
        num_classes=10, num_mels=64, sample_rate=16000, fft_length=512,
        hop_length=128, fused=True,
        generator=torch.Generator().manual_seed(0)).eval()
    model = copy.deepcopy(model_cpu).cuda()
    requests = [torch.randn((8, 1, 16000), generator=gen)
                for _ in range(4)]
    with torch.inference_mode():
        _reset_counts()
        y = layer(x)
        torch.cuda.synchronize()
        cfg2_launches, cfg2_fft = _counts()[0], _fft_counts()[0]
        logits = [model(r.cuda()) for r in requests]
        torch.cuda.synchronize()
        launches, fft_launches = _counts()[0], _fft_counts()[0]
    print(f"main path: kernel launches {launches} (config 2: "
          f"{cfg2_launches}, serving: {launches - cfg2_launches}), of them "
          f"the FFT kernel {fft_launches} (config 2: {cfg2_fft}, serving: "
          f"{fft_launches - cfg2_fft})", flush=True)
    _check(cfg2_launches >= 1, "config 2 did not launch the kernel")
    _check(launches - cfg2_launches >= 4,
           f"4 requests launched the kernel {launches - cfg2_launches} "
           f"times")
    _check(cfg2_fft >= cfg2_launches
           and fft_launches - cfg2_fft >= launches - cfg2_launches,
           "the serving path did not go through the FFT kernel")
    return launches, (layer, x, y), (model_cpu, requests, logits)


def phase_config2(layer, x, y, card: str) -> dict:
    from torchaudio_contrib_tpu_torch.ops import fused
    n_fft, hop = CFG2["fft"], CFG2["hop"]
    frames = 1 + (x.shape[-1] - n_fft) // hop
    plain = lambda: fused._reference(x, layer.filterbank, n_fft, hop,  # noqa: E731
                                     "hann", 2.0, True, 1.0, 1e-7)
    kern = lambda: layer(x)  # noqa: E731
    dft = lambda: _dft_route(x, layer.filterbank, n_fft, hop, None,  # noqa: E731
                             True)
    with torch.inference_mode():
        ref = plain()
        _check(y.shape == (CFG2["batch"], 1, CFG2["mels"], frames),
               f"shape {tuple(y.shape)}")
        _check(bool(torch.isfinite(y).all()), "non-finite output")
        err, dft_err = _rel(y, ref), _rel(dft(), ref)
        max_abs = (y - ref).abs().max().item()
        _check(max(err, dft_err) <= F32_PARITY,
               f"config 2 parity {err}, DFT route {dft_err} > {F32_PARITY}")
        # in turns (plain, kernel, kernel, plain); the better median of each
        plain_a, ms_a, ms_b, plain_b = (_time_ms(plain), _time_ms(kern),
                                        _time_ms(kern), _time_ms(plain))
        ms, plain_ms = min(ms_a, ms_b), min(plain_a, plain_b)
        dft_ms = _time_ms(dft, 2, 7)
    n = CFG2["batch"] * frames
    print(f"config 2 ({CFG2['batch']} x {CFG2['seconds']} s, fft {n_fft}, "
          f"hop {hop}, {CFG2['mels']} mels): out {tuple(y.shape)}, "
          f"max|kernel-plain| = {max_abs:.3e} dB, rel {err:.3e} (DFT route "
          f"rel {dft_err:.3e})", flush=True)
    print(f"timing [{card}]: forward kernel, FFT route {ms:.3f} ms "
          f"({n / ms * 1e3:,.0f} frames/s), DFT route {dft_ms:.3f} ms "
          f"({n / dft_ms * 1e3:,.0f} frames/s), plain torch.stft chain "
          f"{plain_ms:.3f} ms ({n / plain_ms * 1e3:,.0f} frames/s)",
          flush=True)
    return {"design": "smem_fft", "max_abs_err": max_abs, "ms": ms,
            "dft_ms": dft_ms, "plain_ms": plain_ms}


def phase_serving(model_cpu, requests, logits) -> None:
    worst = 0.0
    with torch.inference_mode():
        for r, got in zip(requests, logits):
            _check(got.shape == (8, 10), f"logits {tuple(got.shape)}")
            _check(bool(torch.isfinite(got).all()), "non-finite logits")
            want = model_cpu(r)
            worst = max(worst, (got.cpu() - want).abs().max().item())
    print(f"serving: 4 requests of (8, 1, 16000) -> logits (8, 10), "
          f"max|logits - plain-path logits| = {worst:.3e}", flush=True)
    _check(worst <= LOGIT_ATOL, f"logits differ by {worst} > {LOGIT_ATOL}")


def phase_grad_parity(gen: torch.Generator) -> None:
    """Gradients through the kernels vs autograd of the plain chain at the
    shapes of ``phase_parity``, then the filterbank-only and silent
    cases."""
    from torchaudio_contrib_tpu_torch.ops import create_mel_filter, fused
    from torchaudio_contrib_tpu_torch.ops.stft import _pad_center
    for name, shape, n_fft, hop, mels, sr, wl, to_db, center in \
            PARITY_CASES:
        x = torch.randn(shape, generator=gen).cuda()
        fb = create_mel_filter(mels, sr, 0.0, None, n_fft // 2 + 1,
                               device="cuda")

        def kern(xv, fbv):
            return fused.fused_melspectrogram(xv, fbv, n_fft, hop,
                                              to_db=to_db, win_length=wl,
                                              center=center)

        def plain(xv, fbv):
            xs = _pad_center(xv, n_fft // 2, "reflect") if center else xv
            return fused._reference(xs, fbv, n_fft, hop, "hann", 2.0, to_db,
                                    1.0, 1e-7, wl)

        with torch.no_grad():
            g = torch.randn(tuple(plain(x, fb).shape), generator=gen).cuda()
        def kern_dft(xv, fbv):
            xs = _pad_center(xv, n_fft // 2, "reflect") if center else xv
            return _dft_route(xs, fbv, n_fft, hop, wl, to_db)

        takes_fft = fused._fft_kernel_supported(n_fft)
        want = _grads(plain, x, fb, g)
        before, fft_before = _counts(), _fft_counts()
        got, again = _grads(kern, x, fb, g), _grads(kern, x, fb, g)
        torch.cuda.synchronize()
        launched = [a - b for a, b in zip(_counts(), before)]
        fft_launched = [a - b for a, b in zip(_fft_counts(), fft_before)]
        errs = [_rel(a, b) for a, b in zip(got, want)]
        bitwise = all(torch.equal(a, b) for a, b in zip(got, again))
        line = ""
        if takes_fft:
            dft, dft_again = (_grads(kern_dft, x, fb, g),
                              _grads(kern_dft, x, fb, g))
            dft_errs = [_rel(a, b) for a, b in zip(dft, want)]
            bitwise = bitwise and all(torch.equal(a, b)
                                      for a, b in zip(dft, dft_again))
            line = (f" (FFT route; DFT route dx {dft_errs[0]:.3e}, dfb "
                    f"{dft_errs[1]:.3e})")
            _check(max(dft_errs) <= GRAD_PARITY,
                   f"{name}: DFT route gradient error {dft_errs}")
        print(f"grad parity {name}: max|kernel-plain|/max|plain| dx "
              f"{errs[0]:.3e}, dfb {errs[1]:.3e}{line}; two runs bitwise "
              f"equal {bitwise}; launches fwd/bwd/frame passes {launched}, "
              f"of them on the FFT route fwd/frame passes {fft_launched}",
              flush=True)
        _check(launched == [2, 2, 2], f"{name}: launches {launched}")
        _check(fft_launched == [2 * int(takes_fft)] * 2,
               f"{name}: FFT route launches {fft_launched}")
        _check(all(bool(torch.isfinite(t).all()) for t in got),
               f"{name}: non-finite gradient")
        _check(max(errs) <= GRAD_PARITY,
               f"{name}: gradient error {errs} > {GRAD_PARITY}")
        _check(bitwise, f"{name}: two backward runs differ")

    # config 2 at 2 x 4 s: the filterbank alone, then silence
    _, shape, n_fft, hop, mels, sr = PARITY_CASES[0][:6]
    x = torch.randn(shape, generator=gen).cuda()
    fb = create_mel_filter(mels, sr, 0.0, None, n_fft // 2 + 1, device="cuda")

    def kern(xv, fbv):
        return fused.fused_melspectrogram(xv, fbv, n_fft, hop)

    def plain(xv, fbv):
        return fused._reference(xv, fbv, n_fft, hop, "hann", 2.0, True, 1.0,
                                1e-7)

    with torch.no_grad():
        g = torch.randn(tuple(plain(x, fb).shape), generator=gen).cuda()
    _, want = _grads(plain, x, fb, g, need=(False, True))
    before = _counts()
    dx, got = _grads(kern, x, fb, g, need=(False, True))
    torch.cuda.synchronize()
    launched = [a - b for a, b in zip(_counts(), before)]
    err = _rel(got, want)
    print(f"grad parity filterbank only: dfb {err:.3e}; launches "
          f"fwd/bwd/frame passes {launched}", flush=True)
    _check(dx is None and launched == [1, 1, 0],
           f"filterbank only: launches {launched} (frame passes must not run)")
    _check(err <= GRAD_PARITY, f"filterbank only: {err} > {GRAD_PARITY}")
    dx, dfb = _grads(kern, torch.zeros_like(x), fb, g)
    zero = not bool(dx.any()) and not bool(dfb.any())
    print(f"grad parity silence: gradients exactly 0: {zero}", flush=True)
    _check(zero, "silent input gave non-zero gradients")


def phase_train_path(gen: torch.Generator):
    """Drive the training path: config 2 forward + backward once, then
    config 3's train steps, each between a reset and a read of the
    counters.

    The CPU copy takes its steps first, outside the count, and each card
    step starts from the parameters the CPU copy had before its own step.
    Run free, the two drift apart for a reason that is not the kernels: at
    lr 1e-3 the loss of this model swings by 2x from one step to the next,
    and that amplifies rounding.  Compared one step at a time, each step's
    difference is that step's error alone."""
    import torchaudio_contrib_tpu_torch as tac
    layer = tac.FusedMelspectrogram(num_mels=CFG2["mels"],
                                    sample_rate=CFG2["sr"],
                                    fft_length=CFG2["fft"],
                                    hop_length=CFG2["hop"],
                                    precision="split3",
                                    trainable=True).cuda()
    n_samples = CFG2["seconds"] * CFG2["sr"]
    frames = 1 + (n_samples - CFG2["fft"]) // CFG2["hop"]
    x = torch.randn((CFG2["batch"], 1, n_samples),
                    generator=gen).cuda().requires_grad_()
    g = torch.randn((CFG2["batch"], 1, CFG2["mels"], frames),
                    generator=gen).cuda()

    model_cpu = tac.MelFrontendClassifier(
        num_classes=CFG3["classes"], num_mels=CFG3["mels"],
        sample_rate=CFG3["sr"], fft_length=CFG3["fft"],
        hop_length=CFG3["hop"], fused=True, trainable_frontend=True,
        precision="split3", generator=torch.Generator().manual_seed(1))
    model = copy.deepcopy(model_cpu).cuda()
    xb = torch.randn((CFG3["batch"], 1, CFG3["samples"]), generator=gen)
    labels = torch.randint(0, CFG3["classes"], (CFG3["batch"],),
                           generator=gen)
    snaps, cpu_losses = [], []
    t0 = time.perf_counter()
    for _ in range(CFG3["steps"]):
        snaps.append({k: v.clone() for k, v in model_cpu.state_dict().items()})
        cpu_losses.append(model_cpu.train_step(xb, labels, CFG3["lr"]).item())
    cpu_ms = (time.perf_counter() - t0) * 1e3 / CFG3["steps"]
    snaps.append(model_cpu.state_dict())
    xb_c, labels_c = xb.cuda(), labels.cuda()

    _reset_counts()
    y = layer(x)
    dx, dfb = torch.autograd.grad(y, (x, layer.filterbank), g)
    torch.cuda.synchronize()
    cfg2_counts, cfg2_fft = _counts(), _fft_counts()
    _reset_counts()
    losses, after = [], []
    for k in range(CFG3["steps"]):
        model.load_state_dict(snaps[k])
        losses.append(model.train_step(xb_c, labels_c, CFG3["lr"]))
        after.append({n: v.to("cpu", copy=True)
                      for n, v in model.state_dict().items()})
    torch.cuda.synchronize()
    cfg3_counts, cfg3_fft = _counts(), _fft_counts()
    print(f"training path: launches fwd/bwd/frame passes: config 2 fwd+bwd "
          f"{list(cfg2_counts)}, config 3 {CFG3['steps']} steps "
          f"{list(cfg3_counts)}; of them on the FFT route, fwd/frame "
          f"passes: config 2 {list(cfg2_fft)}, config 3 {list(cfg3_fft)}",
          flush=True)
    _check(cfg2_fft == (cfg2_counts[0], cfg2_counts[2])
           and cfg3_fft == (cfg3_counts[0], cfg3_counts[2]),
           "the training path did not go through the FFT kernels")
    _check(min(cfg2_counts) >= 1,
           f"config 2 fwd+bwd launches {cfg2_counts}: a kernel did not run")
    _check(cfg3_counts[0] >= CFG3["steps"] and cfg3_counts[1] >= CFG3["steps"],
           f"config 3 launches {cfg3_counts} < {CFG3['steps']} steps")
    _check(cfg3_counts[2] == 0, "config 3's waveform needs no gradient, but "
           "the backward ran its frame passes")
    counts = [a + b for a, b in zip(cfg2_counts, cfg3_counts)]
    return (counts, (layer, x, g, y, dx, dfb),
            (model, xb_c, labels_c, snaps, cpu_losses, cpu_ms, losses, after))


def phase_config2_train(layer, x, g, y, dx, dfb, card: str) -> tuple:
    """Config 2's gradients vs autograd of the plain chain; each kernel vs
    its plain version at config 2; timings.  Returns the forward with its
    residual's and the backward's stats."""
    from torchaudio_contrib_tpu_torch.ops import fused
    n_fft, hop, batch = CFG2["fft"], CFG2["hop"], CFG2["batch"]
    fb = layer.filterbank
    frames = y.shape[-1]
    args = (n_fft, hop, "hann", None, True, 1.0, 1e-7)
    _check(y.shape == (batch, 1, CFG2["mels"], frames)
           and dx.shape == x.shape and dfb.shape == fb.shape,
           f"shapes {tuple(y.shape)} {tuple(dx.shape)} {tuple(dfb.shape)}")
    _check(all(bool(torch.isfinite(t).all()) for t in (y, dx, dfb)),
           "config 2 fwd+bwd: non-finite")
    want = torch.autograd.grad(fused._reference(x, fb, *args[:3], 2.0,
                                                *args[4:]), (x, fb), g)
    errs = [_rel(dx, want[0]), _rel(dfb, want[1])]
    print(f"config 2 fwd+bwd ({batch} x {CFG2['seconds']} s): "
          f"max|kernel-plain|/max|plain| dx {errs[0]:.3e}, dfb "
          f"{errs[1]:.3e}", flush=True)
    _check(max(errs) <= GRAD_PARITY, f"config 2 gradients {errs}")

    with torch.no_grad():
        x2, fbd = x.detach().reshape(batch, -1), fb.detach()
        out_p, reim_p = fused._fwd_res_plain(x2, fbd, *args, save_spec=True)
        out_s, reim_s = fused._fwd_fft_plain(x2, fbd, *args, save_spec=True)
        dmel = fused._dmel_from(g.reshape(out_p.shape), out_p, *args[4:])
        reim2 = reim_p.reshape(dmel.shape[0], -1)
        bargs = (fbd, n_fft, "hann", None)
        dframes_p, dfb_p = fused._bwd_plain(dmel, reim2, *bargs, True, True)
        dframes_s, _ = fused._bwd_fft_plain(dmel, reim2, *bargs, True, False)
        del out_s
        stats = {}
        for route in ("fft", "dft"):
            out, reim = fused._fused_mel_fwd_cuda(x2, fbd, *args,
                                                  save_spec=True, _route=route)
            out_serve, _ = fused._fused_mel_fwd_cuda(x2, fbd, *args,
                                                     _route=route)
            runs = [fused._fused_mel_bwd_cuda(dmel, reim2, *bargs, True, True,
                                              _route=route) for _ in range(2)]
            torch.cuda.synchronize()
            (dframes, dfb_k), (dframes_2, dfb_2) = runs
            fwd_err = [_rel(out, out_p), _rel(reim, reim_p)]
            bwd_err = [_rel(dframes, dframes_p), _rel(dfb_k, dfb_p)]
            same = torch.equal(out, out_serve)
            twice = torch.equal(dframes, dframes_2) and torch.equal(dfb_k,
                                                                    dfb_2)
            step = ""
            if route == "fft":
                step_err = [_rel(reim, reim_s), _rel(dframes, dframes_s)]
                step = (f"; against the step-by-step plain versions "
                        f"residual {step_err[0]:.3e}, dframes "
                        f"{step_err[1]:.3e}")
                _check(step_err[0] <= F32_PARITY
                       and step_err[1] <= GRAD_PARITY,
                       f"FFT kernels vs their step-by-step versions: "
                       f"{step_err}")
            stats[route] = (
                (out - out_p).abs().max().item(),
                max((dframes - dframes_p).abs().max().item(),
                    (dfb_k - dfb_p).abs().max().item()))
            print(f"kernels at config 2, {route.upper()} route, vs their "
                  f"plain versions: forward out {fwd_err[0]:.3e}, residual "
                  f"{fwd_err[1]:.3e}, output with the residual bitwise equal "
                  f"to without: {same}; backward dframes {bwd_err[0]:.3e}, "
                  f"dfb {bwd_err[1]:.3e} (max abs {stats[route][1]:.3e}), "
                  f"two runs bitwise equal: {twice}{step}", flush=True)
            _check(max(fwd_err) <= F32_PARITY and same,
                   f"{route} forward with residual: {fwd_err}, same output "
                   f"{same}")
            _check(max(bwd_err) <= GRAD_PARITY and twice,
                   f"{route} backward kernel: {bwd_err}, two runs equal "
                   f"{twice}")
        del out, reim, out_serve, runs, dframes, dframes_2, dframes_s, reim_s
        del dframes_p, out_p
    fwd_abs, bwd_abs = stats["fft"]

    xg = x.detach().requires_grad_()

    def kern_fb():
        return torch.autograd.grad(layer(xg), (xg, fb), g)

    def dft_fb():
        return torch.autograd.grad(_dft_route(xg, fb, n_fft, hop, None, True),
                                   (xg, fb), g)

    def plain_fb():
        ref = fused._reference(xg, fb, *args[:3], 2.0, *args[4:])
        return torch.autograd.grad(ref, (xg, fb), g)

    def fwd(route=None, save_spec=False):
        return fused._fused_mel_fwd_cuda(x2, fbd, *args, save_spec=save_spec,
                                         _route=route)

    def bwd(need_dx=True, route=None):
        return fused._fused_mel_bwd_cuda(dmel, reim2, *bargs, need_dx, True,
                                         _route=route)

    def bwd_plain():
        return fused._bwd_plain(dmel, reim2, *bargs, True, True)

    ms_fb, plain_fb_ms = _turns(plain_fb, kern_fb)
    dft_fb_ms = _time_ms(dft_fb, 2, 5)
    with torch.no_grad():
        ms_res, ms_fwd = _turns(fwd, lambda: fwd(save_spec=True))
        ms_bwd, plain_bwd = _turns(bwd_plain, bwd)
        ms_bwd_fb = _time_ms(lambda: bwd(False), 2, 10)
        dft_fwd, dft_res, dft_bwd = (
            _time_ms(lambda: fwd("dft"), 2, 5),
            _time_ms(lambda: fwd("dft", True), 2, 5),
            _time_ms(lambda: bwd(True, "dft"), 2, 5))
        plain_fwd_res = _time_ms(lambda: fused._fwd_res_plain(
            x2, fbd, *args, save_spec=True), 2, 10)
    n = batch * frames
    print(f"timing [{card}]: config 2 fwd+bwd kernels, FFT route "
          f"{ms_fb:.3f} ms ({n / ms_fb * 1e3:,.0f} frames/s), DFT route "
          f"{dft_fb_ms:.3f} ms ({n / dft_fb_ms * 1e3:,.0f} frames/s), plain "
          f"chain autograd {plain_fb_ms:.3f} ms "
          f"({n / plain_fb_ms * 1e3:,.0f} frames/s)", flush=True)
    print(f"timing [{card}]: forward kernel, FFT route {ms_fwd:.3f} ms, with "
          f"residual {ms_res:.3f} ms; DFT route {dft_fwd:.3f} ms, with "
          f"residual {dft_res:.3f} ms (plain version with residual "
          f"{plain_fwd_res:.3f} ms); backward kernel, FFT route "
          f"{ms_bwd:.3f} ms, DFT route {dft_bwd:.3f} ms, dFB only "
          f"{ms_bwd_fb:.3f} ms, plain version {plain_bwd:.3f} ms", flush=True)
    return ({"max_abs_err": fwd_abs, "ms": ms_res, "dft_ms": dft_res,
             "plain_ms": plain_fwd_res},
            {"design": "smem_fft", "max_abs_err": bwd_abs, "ms": ms_bwd,
             "dft_ms": dft_bwd, "plain_ms": plain_bwd})


def phase_config3(model, xb_c, labels_c, snaps, cpu_losses, cpu_ms, losses,
                  after, card: str) -> None:
    """Config 3's card steps vs the CPU copy's losses and vs the same steps
    in float64 on the CPU (from the same parameters), then ms per step."""
    import torchaudio_contrib_tpu_torch as tac
    losses = [v.item() for v in losses]
    _check(all(math.isfinite(v) for v in losses), f"losses {losses}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    print(f"config 3 ({CFG3['batch']} x 1 x {CFG3['samples']}, fft "
          f"{CFG3['fft']}, hop {CFG3['hop']}, {CFG3['mels']} mels): losses "
          f"card {[f'{v:.6f}' for v in losses]}, CPU "
          f"{[f'{v:.6f}' for v in cpu_losses]}, max rel diff {loss_err:.3e}",
          flush=True)
    _check(loss_err <= LOSS_RTOL, f"config 3 losses differ by {loss_err}")

    exact = tac.MelFrontendClassifier(
        num_classes=CFG3["classes"], num_mels=CFG3["mels"],
        sample_rate=CFG3["sr"], fft_length=CFG3["fft"],
        hop_length=CFG3["hop"], fused=True, trainable_frontend=True,
        precision="split3").double()
    xb64, labels = xb_c.cpu().double(), labels_c.cpu()
    fb_name = next(n for n in snaps[0] if n.endswith("filterbank"))
    cnn_worst = 0.0
    for k, got in enumerate(after):
        exact.load_state_dict(snaps[k])
        exact.train_step(xb64, labels, CFG3["lr"])
        want = exact.state_dict()
        line = []
        for name, value in got.items():
            update = want[name] - snaps[k][name].double()
            err = value.double() - want[name]
            cpu = snaps[k + 1][name].double() - want[name]
            if name != fb_name:
                ratio = err.abs().max().item() / update.abs().max().item()
                cnn_worst = max(cnn_worst, ratio)
                continue
            if k == 0:
                fb = err.abs().max().item() / update.abs().max().item()
                fb_cpu = cpu.abs().max().item() / update.abs().max().item()
                line.append(f"filterbank max {fb:.3e} (CPU f32 {fb_cpu:.3e})")
                _check(fb <= STEP_PARITY_FB, f"step 0 filterbank {fb}")
            else:
                fb = (err.norm() / update.norm()).item()
                fb_cpu = (cpu.norm() / update.norm()).item()
                negative = int((snaps[k][name] < 0).sum())
                line.append(f"filterbank l2 {fb:.3e} (CPU f32 {fb_cpu:.3e}; "
                            f"{negative} entries < 0)")
                _check(fb <= FB_DRIFT_L2, f"step {k} filterbank l2 {fb}")
        print(f"config 3 step {k} vs float64: " + ", ".join(line), flush=True)
        _check(all(bool(torch.isfinite(v).all()) for v in got.values()),
               f"step {k}: non-finite parameters")
    print(f"config 3 every other parameter, every step: max|card-f64|/max|"
          f"update| {cnn_worst:.3e}", flush=True)
    _check(cnn_worst <= STEP_PARITY,
           f"config 3 CNN parameters differ: {cnn_worst}")

    # lr 0 runs every kernel of a step and leaves the parameters as they are
    ms = _time_ms(lambda: model.train_step(xb_c, labels_c, 0.0), 2, 8)
    plain = tac.MelFrontendClassifier(
        num_classes=CFG3["classes"], num_mels=CFG3["mels"],
        sample_rate=CFG3["sr"], fft_length=CFG3["fft"],
        hop_length=CFG3["hop"], fused=False, trainable_frontend=True,
        generator=torch.Generator().manual_seed(1)).cuda()
    plain_ms = _time_ms(lambda: plain.train_step(xb_c, labels_c, 0.0), 2, 8)
    print(f"timing [{card}]: config 3 train step, fused kernels "
          f"{ms:.3f} ms; plain STFT pipeline (fused=False) on the card "
          f"{plain_ms:.3f} ms; plain path on the CPU {cpu_ms:.1f} ms "
          f"(host clock)", flush=True)


def _convergence(y, mag, n_fft: int, hop: int, window="hann",
                 center: bool = True) -> float:
    """Spectral convergence ``|| |STFT(y)| - mag || / || mag ||``."""
    from torchaudio_contrib_tpu_torch.ops import stft
    got = stft(y, n_fft, hop, window=window, center=center).abs()
    return (torch.linalg.norm(got - mag) / torch.linalg.norm(mag)).item()


def phase_gl_parity(gen: torch.Generator) -> None:
    """The fused Griffin-Lim kernels vs their plain versions on the card,
    row-major (the JAX package's first kernel) and tile-major (its layout
    probe), and the stage-bisect build's ``full`` variant: on the route the
    size takes and, where that is the FFT route, on the DFT route too."""
    from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as fg
    from torchaudio_contrib_tpu_torch.ops import stft, stft_output_length
    m = GL_FULL["momentum"]
    with torch.inference_mode():
        for name, shape, n_fft, hop, window, center in GL_CASES:
            x = torch.randn(shape, generator=gen).cuda()
            mag = stft(x, n_fft, hop, window=window, center=center).abs()
            length = stft_output_length(mag.shape[-1], n_fft, hop,
                                        center=center)
            waves = {}
            if hop == n_fft:
                err_of, what = _rel_l2, "l2"
                bars = (GL_NO_OVERLAP_L2, GL_NO_OVERLAP_L2,
                        GL_NO_OVERLAP_CONV)
            else:
                err_of, what = _rel, "max|kernel-plain|/max|plain|"
                bars = (GL_STATE_PARITY, GL_WAVE_PARITY, GL_CONV_PARITY)
            args = (mag, n_fft, hop, window)
            for tile_major in (False, True):
                lay = "tile-major" if tile_major else "row-major"
                # one iteration in every version, from the state two plain
                # iterations reach (a generic complex state)
                ops = _gl_operands(mag, n_fft, hop, window, tile_major)
                p_state, p_prev = fg._gl_solve_plain(*ops["dft"], n_fft, hop,
                                                     1, m, tile_major)
                y4_p = fg._gl_plain(*args, 4, m, length, center,
                                    tile_major=tile_major)
                y32_p = fg._gl_plain(*args, 32, m, length, center,
                                     tile_major=tile_major)
                conv_p = _convergence(y32_p, mag, n_fft, hop, window, center)
                before = _gl_counts() + (_gl_fft_count(),)
                for route, route_ops in ops.items():
                    k_state, k_prev = fg._gl_solve_cuda(
                        *route_ops, n_fft, hop, 1, m, tile_major,
                        _route=route)
                    solve = partial(fg._gl_solve_cuda, _route=route)
                    y4, y32 = (fg._gl_run(solve, route, *args, n, m, length,
                                          center, None, tile_major)
                               for n in (4, 32))
                    torch.cuda.synchronize()
                    errs = (_rel(k_prev, p_prev), err_of(k_state, p_state),
                            err_of(y4, y4_p))
                    conv = _convergence(y32, mag, n_fft, hop, window, center)
                    step = ""
                    if route == "fft":
                        s_state, s_prev = fg._gl_solve_fft_plain(
                            *route_ops, n_fft, hop, 1, m, tile_major)
                        s_errs = (_rel(k_prev, s_prev),
                                  err_of(k_state, s_state))
                        step = (f" (against the step-by-step plain version "
                                f"products {s_errs[0]:.3e}, state "
                                f"{s_errs[1]:.3e})")
                        _check(s_errs[0] <= GL_PRODUCT_PARITY
                               and s_errs[1] <= bars[0],
                               f"{name}, {lay}: FFT kernels vs their "
                               f"step-by-step version {s_errs}")
                    print(f"gl parity {name}, {lay}, {route.upper()} route: "
                          f"{tuple(mag.shape)} -> {tuple(y4.shape)}; one "
                          f"iteration max|kernel-plain|/max|plain| products "
                          f"{errs[0]:.3e}, {what} state {errs[1]:.3e}{step}; "
                          f"4-iteration waveform {errs[2]:.3e}; 32-iteration "
                          f"convergence kernel {conv:.6f}, plain "
                          f"{conv_p:.6f}", flush=True)
                    _check(y4.shape == shape[:-1] + (length,)
                           and all(bool(torch.isfinite(t).all())
                                   for t in (k_state, k_prev, y4, y32)),
                           f"{name}, {lay}, {route}: shape {tuple(y4.shape)} "
                           f"or non-finite")
                    _check(errs[0] <= GL_PRODUCT_PARITY and errs[1] <= bars[0]
                           and errs[2] <= bars[1],
                           f"{name}, {lay}, {route}: {errs} over "
                           f"({GL_PRODUCT_PARITY}, {bars[0]}, {bars[1]})")
                    _check(abs(conv - conv_p) <= bars[2],
                           f"{name}, {lay}, {route}: convergence {conv} vs "
                           f"{conv_p}")
                    waves[route, tile_major] = y4
                # the op itself takes the first of the routes
                y4 = fg._gl_fused(*args, 4, m, length, center,
                                  tile_major=tile_major)
                torch.cuda.synchronize()
                launched = [a - b for a, b in zip(
                    _gl_counts() + (_gl_fft_count(),), before)]
                n = 3 * len(ops) + 1
                takes_fft = "fft" in ops
                _check(launched == [n, n * int(tile_major),
                                    4 * int(takes_fft)],
                       f"{name}, {lay}: launches (all, tile-major, FFT "
                       f"route) {launched}")
                _check(torch.equal(y4, waves[next(iter(ops)), tile_major]),
                       f"{name}, {lay}: the op did not take the "
                       f"{next(iter(ops))} route")
            for route in ops:
                layouts = _rel(waves[route, True], waves[route, False])
                same = torch.equal(waves[route, True], waves[route, False])
                # two runs, and the bisect build's "full" variant, are the
                # solve itself
                prep = fg._gl_prepare(mag, n_fft, hop, window, None, False,
                                      route)[:5]
                solve = fg._gl_solve_cuda(*prep, n_fft, hop, 4, m,
                                          _route=route)
                again = fg._gl_solve_cuda(*prep, n_fft, hop, 4, m,
                                          _route=route)
                full = fg._gl_solve_cuda(*prep, n_fft, hop, 4, m, False,
                                         "full", _route=route)
                nonorm = fg._gl_solve_cuda(*prep, n_fft, hop, 4, m, False,
                                           "nonorm", _route=route)
                twice = all(torch.equal(a, b) for a, b in zip(solve, again))
                bitwise = all(torch.equal(a, b) for a, b in zip(solve, full))
                print(f"gl parity {name}, {route.upper()} route: tile-major "
                      f"vs row-major waveform {layouts:.3e} (bitwise equal: "
                      f"{same}); two runs bitwise equal: {twice}; bisect "
                      f"'full' bitwise equal to the solve: {bitwise}; "
                      f"'nonorm' differs: "
                      f"{not torch.equal(nonorm[0], solve[0])}", flush=True)
                _check(layouts <= GL_LAYOUT_PARITY
                       and (same or route == "dft"),
                       f"{name}, {route}: layouts differ by {layouts}")
                _check(twice, f"{name}, {route}: two runs of the solve differ")
                _check(bitwise,
                       f"{name}, {route}: bisect 'full' differs from the solve")
                _check(not torch.equal(nonorm[0], solve[0]),
                       f"{name}, {route}: the 'nonorm' switch changed nothing")


def phase_inverse_path(gen: torch.Generator):
    """Drive the inverse path, each part between a reset and a read of the
    fused Griffin-Lim counters: (a) ``griffin_lim``, (b) the vocoder's
    ``mel_to_audio`` requests, (c) the layout probe, (d) the stage bisect.
    Returns the launches of the row-major solve, the tile-major solve and
    the bisect build, those of them on the FFT route, and what the later
    phases check."""
    from torchaudio_contrib_tpu_torch import ops
    from torchaudio_contrib_tpu_torch.benchmarks import gl_bisect, gl_probe
    clips, samples = GL_FULL["clips"], GL_FULL["samples"]
    n_fft, hop = GL_SHAPES[0]
    x = torch.randn((clips, samples), generator=gen).cuda()
    noise = [torch.randn((8, samples), generator=gen).cuda()
             for _ in range(4)]
    mel_kw = {k: VOCODER[k] for k in ("num_mels", "sample_rate", "f_max",
                                      "fft_length", "hop_length", "power")}
    with torch.inference_mode():
        mag = ops.stft(x, n_fft, hop).abs()
        logmels = [torch.log(torch.clamp(ops.melspectrogram(n, **mel_kw),
                                         min=1e-5)) for n in noise]
        _reset_gl_counts()
        y = ops.griffin_lim(mag, n_fft, hop, n_iter=GL_FULL["n_iter"],
                            momentum=GL_FULL["momentum"], length=samples,
                            method="pallas")
        torch.cuda.synchronize()
        a_counts, fft_counts = _gl_counts(), [_gl_fft_count()]
        _reset_gl_counts()
        waves = [ops.mel_to_audio(torch.exp(mel), method="pallas", **VOCODER)
                 for mel in logmels]
        torch.cuda.synchronize()
        b_counts = _gl_counts()
        fft_counts.append(_gl_fft_count())
        _reset_gl_counts()
        probes = [gl_probe.run(f, h, 5.0) for f, h in GL_SHAPES]
        torch.cuda.synchronize()
        c_counts = _gl_counts()
        fft_counts.append(_gl_fft_count())
        _reset_gl_counts()
        bisect = gl_bisect.run()
        torch.cuda.synchronize()
        d_counts = _gl_counts()
        fft_counts.append(_gl_fft_count())
    print(f"inverse path: solves launched (all, tile-major): griffin_lim "
          f"{list(a_counts)}, 4 vocoder requests {list(b_counts)}, layout "
          f"probe {list(c_counts)}, stage bisect {list(d_counts)}; of them "
          f"on the FFT route {fft_counts}", flush=True)
    _check(fft_counts == [a_counts[0], b_counts[0], c_counts[0], d_counts[0]],
           "the inverse path did not go through the FFT-route kernels")
    _check(a_counts == (1, 0), f"griffin_lim launched {a_counts}")
    _check(b_counts == (4, 0), f"4 vocoder requests launched {b_counts}")
    _check(c_counts[1] >= 2 and c_counts[0] - c_counts[1] >= 2,
           f"the layout probe launched {c_counts}")
    _check(d_counts[0] >= len(bisect) == 5 and d_counts[1] == 0,
           f"the stage bisect launched {d_counts} for {sorted(bisect)}")
    frames = mag.shape[-1]
    for mel, wave in zip(logmels, waves):
        _check(mel.shape == (8, VOCODER["num_mels"], frames)
               and wave.shape == (8, (frames - 1) * hop)
               and bool(torch.isfinite(wave).all())
               and wave.abs().max().item() > 0,
               f"vocoder: mel {tuple(mel.shape)} -> {tuple(wave.shape)}")
    for probe in probes:
        _check(probe["rel_err"] <= GL_LAYOUT_PARITY,
               f"layout probe: waveforms differ by {probe['rel_err']}")
    print(f"vocoder: 4 requests of log-mel {tuple(logmels[0].shape)} -> "
          f"waveform {tuple(waves[0].shape)}, finite; layout probe rel_err "
          f"{[p['rel_err'] for p in probes]}", flush=True)
    launches = (a_counts[0] + b_counts[0] + c_counts[0] - c_counts[1],
                c_counts[1], d_counts[0])
    # every solve of these paths took the FFT route (checked above)
    return launches, launches, (mag, y), probes, bisect


def phase_gl_full(mag, y) -> None:
    """(a)'s waveform checked against the ``matmul`` loop's convergence on
    the same magnitudes."""
    from torchaudio_contrib_tpu_torch import ops
    n_fft, hop = GL_SHAPES[0]
    with torch.inference_mode():
        ref = ops.griffin_lim(mag, n_fft, hop, n_iter=GL_FULL["n_iter"],
                              momentum=GL_FULL["momentum"],
                              length=GL_FULL["samples"], method="matmul")
        conv, conv_ref = (_convergence(t, mag, n_fft, hop) for t in (y, ref))
    print(f"griffin_lim {tuple(mag.shape)} -> {tuple(y.shape)}, "
          f"{GL_FULL['n_iter']} iterations: spectral convergence fused "
          f"{conv:.4f}, matmul loop {conv_ref:.4f}", flush=True)
    _check(y.shape == (GL_FULL["clips"], GL_FULL["samples"])
           and bool(torch.isfinite(y).all()), f"shape {tuple(y.shape)}")
    _check(conv <= conv_ref + GL_CONV_SLACK,
           f"fused convergence {conv} > matmul loop's {conv_ref} + "
           f"{GL_CONV_SLACK}")


def phase_config4(gen: torch.Generator) -> None:
    """BASELINE config 4: the ISTFT round trip on the card (no kernel)."""
    from torchaudio_contrib_tpu_torch import ops
    x = torch.randn((4, 2, 32768), generator=gen).cuda()
    with torch.inference_mode():
        back = ops.istft(ops.stft(x, 1024, 256), 256, length=32768)
    err = (back - x).abs().max().item()
    print(f"config 4: (4, 2, 32768) -> stft(1024, 256) -> istft: "
          f"{tuple(back.shape)}, max abs error {err:.3e}", flush=True)
    _check(back.shape == x.shape and err <= ISTFT_ATOL,
           f"round trip {tuple(back.shape)}, error {err} > {ISTFT_ATOL}")


def _library_gl(mag, n_fft: int, hop: int, n_iter: int, momentum: float,
                length: int):
    """Momentum Griffin-Lim as a loop of ``torch.stft``/``torch.istft``
    (cuFFT): the library yardstick, used nowhere in the port."""
    w = torch.hann_window(n_fft, device=mag.device)
    spec = torch.complex(mag, torch.zeros_like(mag))
    prev = torch.zeros_like(spec)
    for _ in range(n_iter):
        wave = torch.istft(spec, n_fft, hop, window=w, length=length)
        rebuilt = torch.stft(wave, n_fft, hop, window=w, return_complex=True)
        update = rebuilt + momentum * (rebuilt - prev)
        spec = mag * update / torch.clamp(update.abs(), min=1e-16)
        prev = rebuilt
    return torch.istft(spec, n_fft, hop, window=w, length=length)


def _gl_work(clips: int, n_frames: int, n_fft: int, hop: int, n_iter: int,
             tensors) -> dict:
    """Operation and byte counts of one fused Griffin-Lim solve.  ``flops``:
    the function, an inverse and a forward real transform per frame and
    iteration as FFTs.  ``design``: the FFT kernels' own count: each
    transform a complex one of ``n_fft/2`` points with its Hermitian or
    real-bin step (12 operations a bin) and the window, the overlap-add
    gather, the epilogue (16 operations a padded bin).  ``dft_design``: the
    DFT-product kernels', both transforms as dense products over ``ft``
    padded 64-bin tiles of re and im.  ``traffic``: the bytes three
    launches an iteration move through device memory: ``state`` and
    ``prev`` read and written, ``mag`` read, the frames ``fr`` and the
    signal ``xv`` written and read, every iteration."""
    state, mag_t = tensors[0], tensors[1]
    rows, half, ft = clips * n_frames, n_fft // 2, n_fft // 128 + 1
    n_samples = (n_frames - 1) * hop + n_fft
    transform = 5.0 * half * math.log2(half) + 12.0 * (half + 1) + n_fft
    design = n_iter * (rows * (2 * transform + 16.0 * ft * 64)
                       + clips * n_samples * (-(-n_fft // hop) + 1.0))
    traffic = n_iter * 4.0 * (4 * state.numel() + mag_t.numel()
                              + 2 * rows * n_fft + 2 * clips * n_samples)
    return {"flops": n_iter * 2 * rows * _fft_flops(n_fft), "design": design,
            "dft_design": n_iter * 2 * 2.0 * rows * (ft * 128) * n_fft,
            "traffic": traffic}


def phase_gl_timings(gen: torch.Generator, card: str, probes, bisect) -> tuple:
    """The solve at full width, fft 1024 and fft 2048: one iteration
    checked against the plain versions in both layouts on both routes, then
    the solve timed on both routes against its plain versions and the whole
    op against the other loops.  Returns the kernels-line entries of the
    row-major solve and the tile-major solve (fft 1024) and of the bisect
    build (fft 2048)."""
    from torchaudio_contrib_tpu_torch import ops
    from torchaudio_contrib_tpu_torch.benchmarks import gl_bisect
    from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as fg
    clips, samples = GL_FULL["clips"], GL_FULL["samples"]
    n_iter, m = GL_FULL["n_iter"], GL_FULL["momentum"]
    entries = {}
    x = torch.randn((clips, samples), generator=gen).cuda()
    with torch.inference_mode():
        for (n_fft, hop), probe in zip(GL_SHAPES, probes):
            mag = ops.stft(x, n_fft, hop).abs()
            for tile_major in (False, True):
                lay = "tile-major" if tile_major else "row-major"
                prep = _gl_operands(mag, n_fft, hop, "hann", tile_major)
                want = fg._gl_solve_plain(*prep["dft"], n_fft, hop, 1, m,
                                          tile_major)
                step = fg._gl_solve_fft_plain(*prep["fft"], n_fft, hop, 1, m,
                                              tile_major)
                errs = {}
                for route, route_ops in prep.items():
                    got = fg._gl_solve_cuda(*route_ops, n_fft, hop, 1, m,
                                            tile_major, _route=route)
                    errs[route] = (_rel(got[1], want[1]),
                                   _rel(got[0], want[0]))
                    if route == "fft":
                        max_abs = (got[0] - want[0]).abs().max().item()
                        s_errs = (_rel(got[1], step[1]), _rel(got[0], step[0]))
                    _check(errs[route][0] <= GL_PRODUCT_PARITY
                           and errs[route][1] <= GL_STATE_PARITY,
                           f"fft {n_fft}, {lay}, {route} route: one "
                           f"iteration {errs[route]}")
                _check(s_errs[0] <= GL_PRODUCT_PARITY
                       and s_errs[1] <= GL_STATE_PARITY,
                       f"fft {n_fft}, {lay}: FFT kernels vs their "
                       f"step-by-step version {s_errs}")

                def solve(route):
                    return fg._gl_solve_cuda(*prep[route], n_fft, hop, n_iter,
                                             m, tile_major, _route=route)

                ms, plain_ms = _turns(
                    lambda: fg._gl_solve_plain(*prep["dft"], n_fft, hop,
                                               n_iter, m, tile_major),
                    lambda: solve("fft"), 2, 7)
                dft_ms = _time_ms(lambda: solve("dft"), 1, 3)
                fft_plain_ms = _time_ms(
                    lambda: fg._gl_solve_fft_plain(*prep["fft"], n_fft, hop,
                                                   n_iter, m, tile_major),
                    1, 3)
                n_frames = mag.shape[-1]
                work = _gl_work(clips, n_frames, n_fft, hop, n_iter,
                                prep["fft"])
                stats = {"design": "smem_fft", "max_abs_err": max_abs,
                         "ms": ms, "dft_ms": dft_ms, "plain_ms": plain_ms,
                         "fft_plain_ms": fft_plain_ms,
                         **_bound(work["flops"],
                                  _nbytes(*prep["fft"], got[0], got[1]),
                                  work["design"]),
                         "dft_design_flop_ms":
                             work["dft_design"] / PEAK_FP32 * 1e3,
                         "traffic_floor_ms":
                             work["traffic"] / PEAK_BYTES * 1e3}
                print(f"timing [{card}]: fused Griffin-Lim solve, fft "
                      f"{n_fft}, hop {hop}, {clips} x {n_frames} "
                      f"frames, {n_iter} iterations, {lay}: kernels, FFT "
                      f"route {ms:.3f} ms, DFT route {dft_ms:.3f} ms; plain "
                      f"version {plain_ms:.3f} ms, step-by-step plain "
                      f"version {fft_plain_ms:.3f} ms; bound "
                      f"{stats['bound_ms']:.4f} ms by {stats['bound_by']} "
                      f"({work['flops'] / 1e9:.2f} GFLOP as FFTs), traffic "
                      f"floor of three launches an iteration "
                      f"{stats['traffic_floor_ms']:.3f} ms "
                      f"({work['traffic'] / 1e9:.2f} GB); the FFT kernels' "
                      f"{work['design'] / 1e9:.2f} GFLOP at the FP32 peak "
                      f"{stats['design_flop_ms']:.3f} ms, the DFT products' "
                      f"{work['dft_design'] / 1e12:.3f} TFLOP "
                      f"{stats['dft_design_flop_ms']:.3f} ms; one iteration "
                      f"max|kernel-plain|/max|plain| products, state: FFT "
                      f"route {errs['fft'][0]:.3e}, {errs['fft'][1]:.3e} "
                      f"(step-by-step {s_errs[0]:.3e}, {s_errs[1]:.3e}), DFT "
                      f"route {errs['dft'][0]:.3e}, {errs['dft'][1]:.3e}",
                      flush=True)
                entries[(n_fft, tile_major)] = stats
                del prep, want, step, got

            def whole(method):
                return ops.griffin_lim(mag, n_fft, hop, n_iter=n_iter,
                                       momentum=m, length=samples,
                                       method=method)

            fused_ms, matmul_ms, fft_ms, lib_ms = (
                _time_ms(lambda: whole("pallas"), 2, 5),
                _time_ms(lambda: whole("matmul"), 1, 3),
                _time_ms(lambda: whole("fft"), 1, 3),
                _time_ms(lambda: _library_gl(mag, n_fft, hop, n_iter, m,
                                             samples), 1, 3))
            conv = [_convergence(t, mag, n_fft, hop) for t in (
                whole("pallas"), whole("fft"),
                _library_gl(mag, n_fft, hop, n_iter, m, samples))]
            print(f"timing [{card}]: griffin_lim fft {n_fft}, hop {hop}, "
                  f"{n_iter} iterations, whole op: fused kernels "
                  f"{fused_ms:.3f} ms, matmul loop {matmul_ms:.3f} ms, fft "
                  f"loop {fft_ms:.3f} ms, torch.stft/torch.istft loop "
                  f"{lib_ms:.3f} ms; spectral convergence fused "
                  f"{conv[0]:.4f}, fft loop {conv[1]:.4f}, torch loop "
                  f"{conv[2]:.4f}; layout probe: row-major "
                  f"{probe['baseline']:.3f} ms, tile-major "
                  f"{probe['tile_major']:.3f} ms", flush=True)
            for key in ((n_fft, False), (n_fft, True)):
                entries[key].update(whole_op_ms=fused_ms,
                                    matmul_loop_ms=matmul_ms,
                                    fft_loop_ms=fft_ms,
                                    torch_stft_loop_ms=lib_ms)
        bisect_dft = gl_bisect.run(route="dft", iters=3)
    print(f"timing [{card}]: stage bisect at fft 2048, hop 512, ms per "
          f"variant: FFT route "
          + ", ".join(f"{k} {v:.3f}" for k, v in bisect.items())
          + "; DFT route "
          + ", ".join(f"{k} {v:.3f}" for k, v in bisect_dft.items()),
          flush=True)
    # the bisect build's own entry: its "full" variant at fft 2048, full
    # width, bitwise the solve, and one iteration against the plain version
    n_fft, hop = GL_SHAPES[1]
    with torch.inference_mode():
        mag = ops.stft(x, n_fft, hop).abs()
        prep = _gl_operands(mag, n_fft, hop, "hann", False)
        want = fg._gl_solve_plain(*prep["dft"], n_fft, hop, 1, m)
        for route, route_ops in prep.items():
            full = fg._gl_solve_cuda(*route_ops, n_fft, hop, 1, m, False,
                                     "full", _route=route)
            solve = fg._gl_solve_cuda(*route_ops, n_fft, hop, 1, m,
                                      _route=route)
            bitwise = all(torch.equal(a, b) for a, b in zip(full, solve))
            err = _rel(full[0], want[0])
            if route == "fft":
                max_abs = (full[0] - want[0]).abs().max().item()
            print(f"stage bisect 'full' at fft {n_fft}, {clips} x "
                  f"{mag.shape[-1]} frames, {route.upper()} route: bitwise "
                  f"equal to the solve: {bitwise}; one iteration "
                  f"max|kernel-plain|/max|plain| state {err:.3e}", flush=True)
            _check(bitwise, f"bisect 'full' differs from the solve at full "
                   f"width on the {route} route")
            _check(err <= GL_STATE_PARITY,
                   f"bisect 'full', {route} route, one iteration: {err}")
    bisect_entry = {**entries[(n_fft, False)], "max_abs_err": max_abs,
                    "ms": bisect["full"], "dft_ms": bisect_dft["full"],
                    "variants_ms": bisect, "dft_variants_ms": bisect_dft}
    n_fft = GL_SHAPES[0][0]
    return entries[(n_fft, False)], entries[(n_fft, True)], bisect_entry


def phase_repairs(gen: torch.Generator) -> None:
    """``power=1`` on the card takes the plain chain and launches nothing;
    past 65 535 streams (clips) the wrappers launch slabs, bitwise the
    same as two calls."""
    from torchaudio_contrib_tpu_torch import ops
    from torchaudio_contrib_tpu_torch.ops import _cuda, fused
    from torchaudio_contrib_tpu_torch.ops import fused_griffinlim as fg
    x = torch.randn((4, 16000), generator=gen).cuda()
    fb = ops.create_mel_filter(64, 16000, 0.0, None, 257, device="cuda")
    with torch.inference_mode():
        before = _counts()[0], _fft_counts()[0]
        got = fused.fused_melspectrogram(x, fb, 512, 128, power=1.0)
        moved = (_counts()[0] - before[0], _fft_counts()[0] - before[1])
        want = fused._reference(x, fb, 512, 128, "hann", 1.0, True, 1.0,
                                1e-7)
        err = _rel(got, want)
        big = torch.randn((65600, 1024), generator=gen).cuda()
        fb256 = ops.create_mel_filter(16, 16000, 0.0, None, 129,
                                      device="cuda")
        before = _counts()[0]
        whole = fused.fused_melspectrogram(big, fb256, 256, 64)
        b1_calls = _counts()[0] - before
        b1_slabs = torch.equal(whole, torch.cat(
            [fused.fused_melspectrogram(big[a:b], fb256, 256, 64)
             for a, b in ((0, 65535), (65535, 65600))]))
        del big, whole
        mag = torch.rand((65600, 129, 4), generator=gen).cuda()
        gl_slabs = {}
        for route in ("fft", "dft"):
            prep = fg._gl_prepare(mag, 256, 64, "hann", route=route)[:5]
            before = fg.GL_KERNEL_LAUNCHES
            state, prev = fg._gl_solve_cuda(*prep, 256, 64, 2, 0.99,
                                            _route=route)
            calls = fg.GL_KERNEL_LAUNCHES - before
            same = True
            for a, b in ((0, 65535), (65535, 65600)):
                part = fg._gl_solve_cuda(prep[0][a:b].contiguous(),
                                         prep[1][a:b].contiguous(), *prep[2:],
                                         256, 64, 2, 0.99, _route=route)
                same = (same and torch.equal(part[0], state[a:b])
                        and torch.equal(part[1], prev[a:b]))
            gl_slabs[route] = (calls, same)
        del mag, prep, state, prev
    torch.cuda.synchronize()
    print(f"repairs: power=1 on the card: launches (all, FFT route) "
          f"{moved}, max|op-chain|/max|chain| {err:.3e}; 65600 streams "
          f"through the fused mel forward: 1 call counted {b1_calls}, "
          f"bitwise two slabs {b1_slabs}; 65600 clips through one fused "
          f"Griffin-Lim call (calls counted, bitwise two slabs): "
          + ", ".join(f"{k} route {v}" for k, v in gl_slabs.items())
          + f"; kernels built in $TAC_TORCH_BUILD_DIR {_cuda.build_dir()}",
          flush=True)
    _check(moved == (0, 0), f"power=1 launched a kernel: {moved}")
    _check(err <= F32_PARITY, f"power=1: {err} > {F32_PARITY}")
    _check(b1_calls == 1 and b1_slabs, "65600 streams: the slab loop")
    _check(all(v == (1, True) for v in gl_slabs.values()),
           f"65600 clips: the slab loop {gl_slabs}")


def _corpus_rows(pre, rows: dict) -> float:
    """max |sink row - plain chain| / max |plain chain| over ``rows`` (the
    plain chain on the same dequantised clips, on the card)."""
    from torchaudio_contrib_tpu_torch.benchmarks import corpus_run
    from torchaudio_contrib_tpu_torch.ops import fused
    mk = pre.mel_kwargs
    ids = sorted(rows)
    x, scale = corpus_run.staged_batch(pre, ids)
    with torch.inference_mode():
        want = fused._reference(pre._dequantize(x, scale), pre._fb,
                                mk["fft_length"], mk["hop_length"], "hann",
                                2.0, mk.get("to_db", True), 1.0, 1e-7)
    got = torch.from_numpy(np.stack([rows[i] for i in ids]))
    return _rel(got, want.cpu())


def phase_corpus(gen: torch.Generator, card: str) -> dict:
    """BASELINE config 5 at full width through ``CorpusPreprocessor``; see
    the module docstring (phase 17).  Returns its numbers."""
    from torchaudio_contrib_tpu_torch.benchmarks import corpus_run
    cfg = corpus_run.CONFIG5
    clips = corpus_run.synthetic_clips(gen)
    rows = {}

    def sink(i, row):
        if i % 37 == 0:                   # 14 rows of the 512
            rows[i] = row.copy()

    pre = corpus_run.preprocessor(clips)
    pre.sink = sink
    pre.run(range(pre.batch_size))            # warm-up batch, untimed
    rows.clear()
    stats = corpus_run.measure(pre, cfg["files"])   # counters reset inside
    row_err = _corpus_rows(pre, rows)
    print(f"config 5 [{card}]: {stats['files']} files ({stats['failed']} "
          f"failed) of {cfg['samples']} samples, batch {cfg['batch_size']}, "
          f"{cfg['wire_format']} wire, fused: {stats['files_per_sec']:.1f} "
          f"files/s, {stats['frames_per_sec']:,.0f} frames/s, wall "
          f"{stats['wall_s']:.3f} s ({stats['batches']} batches, "
          f"{stats['h2d_bytes_per_batch']:,} bytes a batch to the card); "
          f"fused forward {stats['b1_ms_per_batch']:.3f} ms a batch by "
          f"events ({stats['b1_trace_ms_per_batch']:.3f} traced; dequantise "
          f"+ forward {stats['features_ms_per_batch']:.3f}); device busy "
          f"{stats['busy_ms']:.2f} ms of the wall: busy share "
          f"{stats['busy_share']:.4f}; launches (all, FFT route) "
          f"{stats['launches']}, {stats['fft_launches']}; {len(rows)} sink "
          f"rows vs the plain chain max|diff|/max|plain| {row_err:.3e}",
          flush=True)
    _check(stats["files"] == cfg["files"] and stats["failed"] == 0,
           f"config 5: {stats['files']} done, {stats['failed']} failed")
    _check(stats["launches"] == stats["fft_launches"] == stats["batches"]
           == 2, f"config 5: launches {stats['launches']}, FFT route "
           f"{stats['fft_launches']}, batches {stats['batches']}")
    _check(len(rows) == 14 and row_err <= F32_PARITY,
           f"config 5 sink rows: {len(rows)}, error {row_err}")

    # a loader that fails on every 7th file: skipped, logged, counted
    def flaky(i):
        if i % 7 == 0:
            raise IOError(f"synthetic decode failure {i}")
        return clips[i % len(clips)]

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("torchaudio_contrib_tpu.corpus")
    log.addHandler(handler)
    log.propagate = False
    try:
        bad = corpus_run.preprocessor(clips, loader=flaky, retries=0)
        bad_stats = bad.run(range(cfg["batch_size"]))
    finally:
        log.removeHandler(handler)
        log.propagate = True
    want_failed = len(range(0, cfg["batch_size"], 7))
    skipped = sum(r.levelno == logging.ERROR for r in records)
    print(f"config 5, loader failing on every 7th file: "
          f"{bad_stats.files_done} done, {bad_stats.files_failed} failed, "
          f"{skipped} logged skipped, {bad_stats.frames} frames", flush=True)
    _check(bad_stats.files_failed == skipped == want_failed
           and bad_stats.files_done == cfg["batch_size"] - want_failed,
           f"failures: {bad_stats}")

    # the other wires and the chunked path, 64 files in batches of 32
    small = {}
    for name, kw in (("float32", dict(wire_format="float32")),
                     ("mulaw8", dict(wire_format="mulaw8")),
                     ("chunked", dict(use_fused=False))):
        got = {}
        run = corpus_run.preprocessor(
            clips, batch_size=32,
            sink=lambda i, row, got=got: got.__setitem__(i, row.copy()),
            **kw)
        _reset_counts()
        st = run.run(range(64))
        launched = _counts()[0]
        if name == "chunked":
            cpu_rows = {}
            mk = dict(run.mel_kwargs)
            cpu = corpus_run.CorpusPreprocessor(
                lambda i: clips[i % len(clips)], clips.shape[-1], 32,
                device="cpu", wire_format=run.wire_format,
                sink=lambda i, row: cpu_rows.__setitem__(i, row.copy()),
                **mk)
            cpu.run(range(64))
            err = max(_rel(torch.from_numpy(got[i]),
                           torch.from_numpy(cpu_rows[i])) for i in got)
        else:
            err = _corpus_rows(run, {i: got[i] for i in range(0, 64, 9)})
        small[name] = (st.files_done, launched, err)
        _check(st.files_done == 64 and len(got) == 64,
               f"{name}: {st.files_done} files, {len(got)} rows")
        _check(launched == (0 if name == "chunked" else 2),
               f"{name}: {launched} fused launches")
        _check(err <= F32_PARITY, f"{name}: rows differ by {err}")
    print("config 5, 64 files in batches of 32 (files, fused launches, "
          "max|diff|/max|ref|): " + ", ".join(
              f"{k} {v[0]}, {v[1]}, {v[2]:.3e}" for k, v in small.items())
          + " (the wires against the plain chain on the same dequantised "
          "clips, the chunked path against its CPU copy)", flush=True)
    return stats


def _ops_cases(gen: torch.Generator) -> list:
    """``(name, function, CPU inputs, bar)`` for phase 18: each function
    runs on the inputs and on their CUDA copies.  The bar is F32_PARITY for
    plain float32 ops; SCAN_PARITY for scans, ``torch.linalg`` and the
    log-domain layers (dB and cepstra of near-silent bins amplify the
    FFTs' rounding); VOCODER_PARITY for the phase vocoder's phases summed
    along time in another order (``tests/test_torch_vocoder_ops.py``)."""
    from torchaudio_contrib_tpu_torch import models, ops
    from torchaudio_contrib_tpu_torch.models import transforms as tr

    def rn(*shape):
        return torch.randn(shape, generator=gen)

    def pos(*shape):
        return rn(*shape).abs()

    wave, long_wave, spec_mag = rn(2, 8000), rn(2, 160000), pos(2, 129, 40)
    n = torch.arange(8000, dtype=torch.float32)
    tone = torch.stack([torch.sin(2 * math.pi * 220.0 * n / 8000),
                        torch.sin(2 * math.pi * 330.0 * n / 8000)])
    cspec = torch.complex(rn(2, 4, 65, 30), rn(2, 4, 65, 30))
    mask = torch.rand((2, 65, 30), generator=gen)
    cov = [torch.cov(rn(6, 40)) for _ in range(2)]
    freqs = torch.linspace(200.0, 300.0, 4000)[:, None].repeat(1, 3) \
        * torch.tensor([1.0, 2.0, 3.0])
    amps = torch.rand((4000, 3), generator=gen)
    cstft = torch.stft(wave, 256, 64, window=torch.hann_window(256),
                       return_complex=True)

    def g():
        return torch.Generator().manual_seed(11)

    def mvdr(sp, m, solution):
        return tr.MVDR(1, solution)(sp, mask_s=m, mask_n=1.0 - m)

    return [
        ("compute_deltas", ops.compute_deltas, (spec_mag,), F32_PARITY),
        ("preemphasis", ops.preemphasis, (wave,), F32_PARITY),
        ("deemphasis, 10 s at 16 kHz", ops.deemphasis, (long_wave,),
         SCAN_PARITY),
        ("time_mask", lambda s: ops.time_mask(g(), s, 10, 2), (spec_mag,),
         F32_PARITY),
        ("freq_mask", lambda s: ops.freq_mask(g(), s, 8, 2), (spec_mag,),
         F32_PARITY),
        ("spectral_centroid", lambda s: ops.spectral_centroid(s, 16000),
         (spec_mag,), F32_PARITY),
        ("spectral_bandwidth", lambda s: ops.spectral_bandwidth(s, 16000),
         (spec_mag,), SCAN_PARITY),
        ("spectral_rolloff", lambda s: ops.spectral_rolloff(s, 16000),
         (spec_mag,), F32_PARITY),
        ("spectral_flatness", ops.spectral_flatness, (spec_mag,),
         SCAN_PARITY),
        ("zero_crossing_rate", ops.zero_crossing_rate, (wave,), F32_PARITY),
        ("fade", lambda x: ops.fade(x, 500, 800, "half_sine"), (wave,),
         F32_PARITY),
        ("dcshift", lambda x: ops.dcshift(0.3 * x, 0.4, 0.05), (wave,),
         F32_PARITY),
        ("dither", lambda x: ops.dither(g(), x), (wave,), F32_PARITY),
        ("add_noise", lambda x, y: ops.add_noise(x, y, 10.0), (wave, rn(2, 8000)),
         F32_PARITY),
        ("speed", lambda x: ops.speed(x, 8000, 1.1), (wave,), F32_PARITY),
        ("sliding_window_cmn", lambda s: ops.sliding_window_cmn(
            s, 20, 5, False, True), (spec_mag,), SCAN_PARITY),
        ("apply_codec ALAW", lambda x: ops.apply_codec(0.3 * x, 8000, "wav",
                                                       "ALAW"),
         (wave,), F32_PARITY),
        ("convolve", lambda x, k: ops.convolve(x, k, "same"),
         (wave, rn(2, 65)), F32_PARITY),
        ("fftconvolve", ops.fftconvolve, (wave, rn(2, 400)), F32_PARITY),
        ("si_snr", ops.si_snr, (wave, rn(2, 8000)), F32_PARITY),
        ("frechet_distance", ops.frechet_distance,
         (rn(6), cov[0], rn(6), cov[1]), SCAN_PARITY),
        ("chroma filterbank", lambda s: ops.apply_filterbank(
            s, ops.create_chroma_filter(12, 16000, 129, device=s.device)),
         (spec_mag,), F32_PARITY),
        ("cqt", lambda x: ops.cqt(x, 8000, 128, 24, 110.0), (wave,),
         F32_PARITY),
        ("detect_pitch_frequency", lambda x: ops.detect_pitch_frequency(
            x, 8000), (tone,), F32_PARITY),
        ("oscillator_bank", lambda f, a: ops.oscillator_bank(f, a, 8000),
         (freqs, amps), F32_PARITY),
        ("filter_waveform", ops.filter_waveform,
         (wave, 0.2 * rn(2, 8, 33)), F32_PARITY),
        ("psd", ops.psd, (cspec, mask), SCAN_PARITY),
        ("MVDR ref_channel", lambda s, m: mvdr(s, m, "ref_channel"),
         (cspec, mask), SCAN_PARITY),
        ("MVDR stv_evd", lambda s, m: mvdr(s, m, "stv_evd"), (cspec, mask),
         SCAN_PARITY),
        ("MVDR stv_power", lambda s, m: mvdr(s, m, "stv_power"),
         (cspec, mask), SCAN_PARITY),
        ("MFCC", tr.MFCC(16000, 13, 40, 512, 128), (wave,), SCAN_PARITY),
        ("LFCC", tr.LFCC(16000, 13, 40, 512, 128), (wave,), SCAN_PARITY),
        ("MelSpectrogram", tr.MelSpectrogram(16000, 400, n_mels=64, pad=4),
         (wave,), F32_PARITY),
        ("InverseMelScale", tr.InverseMelScale(129, 32, 16000),
         (pos(2, 32, 40),), SCAN_PARITY),
        ("AmplitudeToDB", tr.AmplitudeToDB("power", 80.0), (spec_mag,),
         SCAN_PARITY),
        ("BarkSpectrogram", tr.BarkSpectrogram(16000, 400, n_barks=32),
         (wave,), F32_PARITY),
        ("InverseBarkScale", tr.InverseBarkScale(129, 24, 16000),
         (pos(2, 24, 40),), SCAN_PARITY),
        ("ChromaSpectrogram", tr.ChromaSpectrogram(16000, 400), (wave,),
         F32_PARITY),
        ("Chromagram", models.Chromagram(12, 16000, fft_length=256,
                                         hop_length=64), (wave,),
         F32_PARITY),
        ("TimeStretch", tr.TimeStretch(64, 129, 1.3), (cstft,),
         VOCODER_PARITY),
        ("PitchShift", tr.PitchShift(8000, 2.0, fft_length=256,
                                     hop_length=64), (wave,),
         VOCODER_PARITY),
        ("SpecAugment", lambda s: tr.SpecAugment(2, 10, 2, 8)(
            s, generator=g()), (spec_mag,), F32_PARITY),
    ]


def phase_ops_on_card(gen: torch.Generator) -> None:
    """Phase 18: each op or layer with no kernel of its own on CUDA tensors
    against the same call on the CPU copies."""
    worst, lines = {}, []
    for name, fn, args, bar in _ops_cases(gen):
        cuda_args = tuple(a.cuda() for a in args)
        if isinstance(fn, torch.nn.Module):
            cpu_fn, cuda_fn = fn, copy.deepcopy(fn).cuda()
        else:
            cpu_fn = cuda_fn = fn
        want = cpu_fn(*args)
        got = cuda_fn(*cuda_args)
        _check(got.is_cuda and got.shape == want.shape,
               f"{name}: {tuple(got.shape)} on {got.device}")
        err = _rel(got.cpu(), want)
        worst[name] = err
        lines.append(f"{name} {err:.1e}")
        _check(err <= bar, f"{name} on the card vs CPU: {err} > {bar}")
    torch.cuda.synchronize()
    print(f"ops and layers on the card vs their CPU copies ({len(worst)}; "
          "max|cuda-cpu|/max|cpu|): " + ", ".join(lines), flush=True)


def _on_card(fn, reps: int = 3) -> tuple:
    """``(output, ms, peak MiB)``: the output of one call of ``fn`` on the
    card, the memory it took above what was allocated before it, and the
    median of ``reps`` more calls by CUDA events (with ``reps=0``, that
    first call's own time)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    ms = _time_ms(fn, 0, reps) if reps else start.elapsed_time(stop)
    return out, ms, peak


def _speech_batch(gen: torch.Generator, n: int, samples: int,
                  sr: int) -> torch.Tensor:
    """``(n, samples)`` clips: a noise floor, and from an onset that moves
    by 0.5 s from clip to clip (none in every 8th) a voiced 120 Hz
    harmonic tone with a 3 Hz syllable envelope."""
    t = torch.arange(samples, dtype=torch.float64) / sr
    voice = sum(torch.sin(2 * math.pi * 120.0 * k * t) / k
                for k in range(1, 9))
    voice = voice * 0.5 * (1 + torch.sin(2 * math.pi * 3.0 * t
                                         - math.pi / 2))
    x = 0.01 * torch.randn((n, samples), generator=gen, dtype=torch.float64)
    for i in range(n):
        if i % 8 != 7:
            on = int((0.5 + 0.5 * (i % 8)) * sr)
            x[i, on:] += 0.3 * voice[:samples - on]
    return x.float()


def _voiced_batch(gen: torch.Generator, n: int, samples: int,
                  sr: int) -> tuple:
    """``(n, samples)`` voiced clips and their ``f0``: equal harmonics up
    to 900 Hz of an f0 on Kaldi pitch's lag grid, from 90 Hz up, and a
    little noise.  Pure tones make near-ties: the NCCF peak of one
    sinusoid is flat enough that 1e-6 of noise moves some frames' states
    on the CPU alone (``tests/test_torch_kaldipitch.py``); the harmonics
    sharpen the peak, and the same noise moves none."""
    from torchaudio_contrib_tpu_torch.ops.kaldipitch import _lag_grid
    hz = 4000.0 / _lag_grid(10, 80, 0.005)
    f0 = torch.tensor([hz[np.abs(hz - (90.0 + 25.0 * i)).argmin()]
                       for i in range(n)], dtype=torch.float64)
    t = torch.arange(samples, dtype=torch.float64) / sr
    x = torch.zeros((n, samples), dtype=torch.float64)
    for i, f in enumerate(f0.tolist()):
        for k in range(1, int(900 // f) + 1):
            x[i] += torch.sin(2 * math.pi * k * f * t + 0.7 * k)
    x = 0.3 * x / x.abs().amax(dim=1, keepdim=True)
    return (x + 1e-3 * torch.randn((n, samples), generator=gen,
                                   dtype=torch.float64)).float(), f0


def _bs1770_f64(x: np.ndarray, sr: float) -> np.ndarray:
    """BS.1770-4 integrated loudness of ``x (..., ch, t)`` in float64:
    SciPy's ``lfilter`` for the K-weighting, NumPy for the gates (the
    chain of ``tests/test_torch_loudness_vad.py``)."""
    import scipy.signal as sps
    from torchaudio_contrib_tpu_torch.ops.loudness import _k_weighting_coeffs
    (b1, a1), (b2, a2) = _k_weighting_coeffs(sr)
    y = sps.lfilter(b2, a2, sps.lfilter(b1, a1, np.asarray(x, np.float64)))
    block = int(round(0.4 * sr))
    hop = block // 4
    z = np.stack([np.mean(y[..., i * hop:i * hop + block] ** 2, -1)
                  for i in range(1 + (y.shape[-1] - block) // hop)], -1)
    g = np.ones(z.shape[-2])
    g[3:] = 1.41
    zw = np.einsum("c,...cn->...n", g, z)
    lb = -0.691 + 10 * np.log10(np.maximum(zw, 1e-30))
    gated = lb > -70.0
    mean = (zw * gated).sum(-1) / np.maximum(gated.sum(-1), 1)
    rel = -0.691 + 10 * np.log10(np.maximum(mean, 1e-30)) - 10.0
    gated = gated & (lb > rel[..., None])
    mean = (zw * gated).sum(-1) / np.maximum(gated.sum(-1), 1)
    return -0.691 + 10 * np.log10(np.maximum(mean, 1e-30))


def _rir_f64(room, source, mics, max_order: int, absorption: float,
             sr: float = 16000.0, c: float = 343.0,
             taps: int = 81) -> np.ndarray:
    """Image-source responses ``(n_mics, length)`` in float64 with NumPy:
    every image of order <= ``max_order`` of a shoebox room with one
    absorption on all walls, its Hann-windowed fractional-delay sinc added
    at each mic by ``np.add.at``; the length is the port's default."""
    room, source = np.asarray(room, np.float64), np.asarray(source)
    mics = np.asarray(mics, np.float64)
    r = np.arange(-max_order, max_order + 1)
    n = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 1, 3)
    p = np.stack(np.meshgrid([0, 1], [0, 1], [0, 1], indexing="ij"),
                 -1).reshape(1, -1, 3)
    n, p = (a.reshape(-1, 3) for a in np.broadcast_arrays(n, p))
    hits = np.abs(n - p) + np.abs(n)
    keep = hits.sum(-1) <= max_order
    att = np.sqrt(1.0 - absorption) ** hits[keep].sum(-1)
    img = (1 - 2 * p[keep]) * source + 2 * n[keep] * room
    dist = np.maximum(np.linalg.norm(img[:, None] - mics[None], axis=-1),
                      1e-3)
    delay = dist * sr / c
    half = taps // 2
    length = int(math.ceil(np.linalg.norm(room * (2 * max_order + 2))
                           * sr / c) + taps)
    base = np.floor(delay)
    k = np.arange(-half, half + 1)
    arg = k - (delay - base)[..., None]
    win = np.where(np.abs(arg) <= half + 1,
                   0.5 * (1 + np.cos(np.pi * arg / (half + 1))), 0.0)
    val = np.sinc(arg) * win * (att[:, None] / (4 * np.pi * dist))[..., None]
    idx = base.astype(np.int64)[..., None] + k
    out = np.zeros((mics.shape[0], length))
    for m in range(mics.shape[0]):
        ok = (idx[:, m] >= 0) & (idx[:, m] < length)
        np.add.at(out[m], idx[:, m][ok], val[:, m][ok])
    return out


def _phaser_row_f64(x: list, sr: float, decay: float) -> list:
    """The phaser on one channel, sample by sample in float64 (the ring
    buffer of ``tests/test_modfx.py::_phaser_oracle``, default
    parameters, with Python floats)."""
    from torchaudio_contrib_tpu_torch.ops.modfx import _wave_table
    d = int(3.0 * 0.001 * sr + 0.5)
    m = int(sr / 0.5 + 0.5)
    mod = _wave_table("sine", m, 1.0, float(d), math.pi / 2.0,
                      as_int=True).tolist()
    buf, out = [0.0] * d, []
    delay_pos = mod_pos = 0
    for xi in x:
        idx = int((delay_pos + mod[mod_pos]) % d)
        mod_pos = (mod_pos + 1) % m
        delay_pos = (delay_pos + 1) % d
        temp = xi * 0.4 + buf[idx] * decay
        buf[delay_pos] = temp
        out.append(temp * 0.74)
    return out


def _flanger_row_f64(x: list, sr: float, c: int, n_ch: int, regen: float,
                     interpolation: str) -> list:
    """The flanger on channel ``c`` of ``n_ch``, sample by sample in
    float64 (the ring buffer of ``tests/test_modfx.py::_flanger_oracle``,
    default delay, depth, width, speed and phase, with Python floats)."""
    from torchaudio_contrib_tpu_torch.ops.modfx import _wave_table
    delay_gain = 0.71
    in_gain = 1.0 / (1.0 + delay_gain)
    delay_gain = delay_gain / (1.0 + delay_gain)
    fb = regen / 100.0
    delay_gain *= 1.0 - abs(fb)
    size = int(2.0 * 0.001 * sr + 0.5) + 2
    lfo_len = max(int(sr / 0.5 + 0.5), 1)
    lfo = _wave_table("sine", lfo_len, 0.0, size - 2.0, 3.0 * math.pi / 2.0,
                      as_int=False).tolist()
    off = int(np.round(25.0 / 100.0 * lfo_len * c / n_ch))
    buf, out, pos = [0.0] * size, [], 0
    for i, xi in enumerate(x):
        pos = (pos + size - 1) % size
        dly = lfo[(i + off) % lfo_len]
        int_d = int(math.floor(dly))
        frac = dly - int_d
        a = buf[(pos + int_d) % size]
        b = buf[(pos + int_d + 1) % size]
        if interpolation == "linear":
            delayed = a + (b - a) * frac
        else:
            cc = buf[(pos + int_d + 2) % size]
            delayed = (a * (frac - 1) * (frac - 2) / 2
                       - b * frac * (frac - 2) + cc * frac * (frac - 1) / 2)
        buf[pos] = xi + delayed * fb
        out.append(xi * in_gain + delayed * delay_gain)
    return out


def _iir_pipeline(gen: torch.Generator, card: str) -> int:
    """Phase 19 (a): config 3's batch through ``Highpass(80)`` →
    ``Equalizer(1000, +3 dB)`` → ``Lowpass(7000)`` → the fused forward
    (fft 512, hop 128, 64 mels), between a reset and a read of the
    counters; then ``Vad(mode="trim")`` and ``vad_onset`` on the batch.
    Returns the fused forward's launches."""
    from torchaudio_contrib_tpu_torch import models, ops
    from torchaudio_contrib_tpu_torch.models import transforms as tr
    from torchaudio_contrib_tpu_torch.ops import iir
    b, c, t, sr = IIR["pre"]
    x = _speech_batch(gen, b, t, sr)[:, None, :]
    pipe = models.Pipeline(
        tr.Highpass(sr, 80.0), tr.Equalizer(sr, 1000.0, 3.0),
        tr.Lowpass(sr, 7000.0),
        models.FusedMelspectrogram(num_mels=64, sample_rate=sr,
                                   fft_length=512, hop_length=128))
    pipe_c, xc = copy.deepcopy(pipe).cuda(), x.cuda()
    with torch.inference_mode():
        _reset_counts()
        out, _, peak = _on_card(lambda: pipe_c(xc), reps=0)
        launches, fft_launches = _counts()[0], _fft_counts()[0]
        ms = _time_ms(lambda: pipe_c(xc), 1, 5)
        filt_ms = _time_ms(lambda: pipe_c[:3](xc), 1, 5)
        want = pipe(x)
        err = _rel(out.cpu(), want)
        onset, vad_ms, vad_peak = _on_card(lambda: ops.vad_onset(xc, sr))
        (trim, valid), trim_ms, trim_peak = _on_card(
            lambda: tr.Vad(sr, mode="trim")(xc))
        onset_cpu = ops.vad_onset(x, sr)
        trim_cpu, valid_cpu = tr.Vad(sr, mode="trim")(x)
    n_meas = 1 + (t - 2 * sr // 20) // (sr // 20)
    print(f"IIR pipeline [{card}]: {tuple(x.shape)} at {sr} Hz, Highpass(80)"
          f" -> Equalizer(1000, +3 dB) -> Lowpass(7000) -> fused log-mel "
          f"(fft 512, hop 128, 64 mels) {tuple(out.shape)}: {ms:.3f} ms "
          f"(the three biquads {filt_ms:.3f}, {iir._doubling_steps(t)} "
          f"doubling steps each), peak {peak:.0f} MiB; fused launches (all,"
          f" FFT route) {launches}, {fft_launches}; vs the CPU copy "
          f"max|diff|/max|cpu| {err:.2e}", flush=True)
    print(f"IIR pipeline VAD: vad_onset {vad_ms:.3f} ms (peak "
          f"{vad_peak:.0f} MiB), Vad(mode='trim') {trim_ms:.3f} ms (peak "
          f"{trim_peak:.0f} MiB), "
          f"{n_meas} noise-floor steps (one per measure frame); onsets "
          f"{onset.flatten().tolist()}", flush=True)
    _check(launches == fft_launches == 1,
           f"IIR pipeline: fused launches {launches}, FFT route "
           f"{fft_launches}")
    _check(bool(torch.isfinite(out).all()) and err <= SCAN_PARITY,
           f"IIR pipeline vs CPU: {err}")
    _check(torch.equal(onset.cpu(), onset_cpu)
           and torch.equal(valid.cpu(), valid_cpu)
           and torch.equal(trim.cpu(), trim_cpu),
           f"VAD on the card: {onset.flatten().tolist()} vs CPU "
           f"{onset_cpu.flatten().tolist()}")
    no_voice = onset_cpu.flatten()[7::8]
    voiced = torch.cat([onset_cpu.flatten()[k::8] for k in range(7)])
    _check(bool((no_voice == t).all()) and bool((voiced < t).all()),
           f"VAD onsets: {onset_cpu.flatten().tolist()}")
    return launches


def _iir_loudness(gen: torch.Generator, card: str) -> None:
    """Phase 19 (b): ``loudness`` and ``Loudness`` on 30 s stereo at
    48 kHz against the float64 chain and the CPU copy."""
    from torchaudio_contrib_tpu_torch import ops
    from torchaudio_contrib_tpu_torch.models import transforms as tr
    b, c, t, sr = IIR["loud"]
    level = 0.1 * 10.0 ** (-3.0 * (torch.arange(b) % 8) / 20.0)
    x = torch.randn((b, c, t), generator=gen) * level[:, None, None]
    x[::2, :, 2 * t // 3:] *= 1e-4            # a gated quiet third
    xc = x.cuda()
    lk, ms, peak = _on_card(lambda: ops.loudness(xc, sr))
    layer = tr.Loudness(sr)(xc)
    ref = _bs1770_f64(x.numpy(), sr)
    cpu = ops.loudness(x, sr)
    err_ref = float(np.abs(lk.cpu().double().numpy() - ref).max())
    err_cpu = (lk.cpu() - cpu).abs().max().item()
    print(f"loudness [{card}]: {tuple(x.shape)} at {sr} Hz: {ms:.3f} ms, "
          f"peak {peak:.0f} MiB; |card - float64 chain| {err_ref:.2e} LU, "
          f"|card - CPU| {err_cpu:.2e} LU; LKFS {lk.cpu().tolist()[:4]}...",
          flush=True)
    _check(err_ref <= LU_ATOL and err_cpu <= LU_ATOL
           and torch.equal(layer, lk),
           f"loudness: {err_ref} LU from float64, {err_cpu} from CPU")


def _iir_filters(gen: torch.Generator, card: str) -> None:
    """Phase 19 (c): a biquad (RBJ high-pass at 40 Hz: poles near the unit
    circle) through ``lfilter`` and ``filtfilt`` on config 2's batch; two
    rows against float64 scipy, the rest against the CPU copy; one
    backward through the doubling; the same scan in float32 for
    comparison."""
    import scipy.signal as sps
    from torchaudio_contrib_tpu_torch import ops
    from torchaudio_contrib_tpu_torch.ops import iir
    b, c, t, sr = IIR["filt"]
    bq, aq = iir._rbj("highpass", sr, 40.0, 0.707)
    x = torch.randn((b, c, t), generator=gen)
    xc = x.cuda()
    y, ms, peak = _on_card(lambda: ops.lfilter(xc, aq, bq))
    ff, ff_ms, ff_peak = _on_card(lambda: ops.filtfilt(xc, aq, bq))
    err_cpu = _rel(y.cpu(), ops.lfilter(x, aq, bq))
    ff_cpu = _rel(ff.cpu(), ops.filtfilt(x, aq, bq))
    rows = (0, b // 2 + 1)
    x64 = x[list(rows), 0].double().numpy()
    ref = sps.lfilter(bq, aq, x64, axis=-1)
    ff_ref = sps.lfilter(bq, aq, sps.lfilter(bq, aq, x64)[:, ::-1])[:, ::-1]
    err_ref = _rel(y[list(rows), 0].cpu().double(), torch.from_numpy(ref))
    ff_err_ref = _rel(ff[list(rows), 0].cpu().double(),
                      torch.from_numpy(ff_ref.copy()))
    g = torch.randn((b, c, t), generator=gen).cuda()

    def fwd_bwd():
        xg = xc.detach().requires_grad_()
        (ops.lfilter(xg, aq, bq) * g).sum().backward()
        return xg.grad

    dx, bwd_ms, bwd_peak = _on_card(fwd_bwd)
    g64 = g[list(rows), 0].cpu().double().numpy()
    dref = sps.lfilter(bq, aq, g64[:, ::-1], axis=-1)[:, ::-1]
    err_grad = _rel(dx[list(rows), 0].cpu().double(),
                    torch.from_numpy(dref.copy()))
    b_n, a_n = np.asarray(bq) / aq[0], np.asarray(aq) / aq[0]
    y32, ms32, _ = _on_card(lambda: iir._recursive_part(
        iir._fir_part(xc, b_n), a_n[1:]))
    err32 = _rel(y32[list(rows), 0].cpu().double(), torch.from_numpy(ref))
    print(f"lfilter [{card}]: RBJ high-pass 40 Hz on {tuple(x.shape)} at "
          f"{sr} Hz, {iir._doubling_steps(t)} doubling steps: {ms:.3f} ms, "
          f"peak {peak:.0f} MiB; filtfilt {ff_ms:.3f} ms, peak "
          f"{ff_peak:.0f} MiB; forward + backward {bwd_ms:.3f} ms, peak "
          f"{bwd_peak:.0f} MiB; two rows vs float64 scipy (max|diff|/max|ref|)"
          f": lfilter {err_ref:.2e}, filtfilt {ff_err_ref:.2e}, gradient "
          f"{err_grad:.2e}; vs the CPU copy: lfilter {err_cpu:.2e}, "
          f"filtfilt {ff_cpu:.2e}; the same doubling in float32: "
          f"{ms32:.3f} ms, {err32:.2e} from scipy", flush=True)
    _check(err_ref <= F32_PARITY and ff_err_ref <= F32_PARITY
           and err_grad <= F32_PARITY,
           f"lfilter vs scipy: {err_ref}, {ff_err_ref}, grad {err_grad}")
    _check(err_cpu <= SCAN_PARITY and ff_cpu <= SCAN_PARITY,
           f"lfilter vs CPU: {err_cpu}, filtfilt {ff_cpu}")


def _iir_effects(gen: torch.Generator, card: str) -> None:
    """Phase 19 (d): the effects on 10 s stereo at 44.1 kHz against the
    CPU copy; one row of each feedback path against a float64 loop."""
    from torchaudio_contrib_tpu_torch import ops
    from torchaudio_contrib_tpu_torch.ops import modfx
    b, c, t, sr = IIR["fx"]
    x = 0.3 * torch.randn((b, c, t), generator=gen)
    xc = x.cuda()
    cases = [
        ("overdrive", lambda v: ops.overdrive(v), SCAN_PARITY, 3),
        ("contrast", lambda v: ops.contrast(v), F32_PARITY, 3),
        ("phaser decay 0.4 (unrolled)",
         lambda v: ops.phaser(v, sr, decay=0.4), SCAN_PARITY, 3),
        ("phaser decay 0.9 (pointer jumping)",
         lambda v: ops.phaser(v, sr, decay=0.9), SCAN_PARITY, 3),
        ("flanger regen 0", lambda v: ops.flanger(v, sr), F32_PARITY, 3),
        ("flanger regen 50 linear",
         lambda v: ops.flanger(v, sr, regen=50.0), SCAN_PARITY, 0),
        ("flanger regen 50 quadratic",
         lambda v: ops.flanger(v, sr, regen=50.0,
                               interpolation="quadratic"), SCAN_PARITY, 0),
    ]
    outs, lines = {}, []
    for name, fn, bar, reps in cases:
        out, ms, peak = _on_card(lambda: fn(xc), reps)
        err = _rel(out.cpu(), fn(x))
        outs[name] = out
        lines.append(f"{name} {ms:.3f} ms, peak {peak:.0f} MiB, {err:.1e}")
        _check(err <= bar, f"{name} vs CPU: {err} > {bar}")
    rounds = len(modfx._pointer_jumps(
        modfx._phaser_lags(t, sr, 3.0, 0.5, True), 0.9))
    blocks = {k: len(modfx._flanger_blocks(*modfx._flanger_taps(
        c, t, sr, 0.0, 2.0, 71.0, 0.5, 25.0, "sinusoidal", k)[::2])) - 1
        for k in ("linear", "quadratic")}
    row = x[0, 1].double().tolist()
    oracle = {
        "phaser decay 0.9 (pointer jumping)": _phaser_row_f64(row, sr, 0.9),
        "flanger regen 50 linear": _flanger_row_f64(row, sr, 1, c, 50.0,
                                                    "linear"),
        "flanger regen 50 quadratic": _flanger_row_f64(row, sr, 1, c, 50.0,
                                                       "quadratic"),
    }
    oracle_err = {k: _rel(outs[k][0, 1].cpu().double(),
                          torch.tensor(v, dtype=torch.float64))
                  for k, v in oracle.items()}
    print(f"effects [{card}]: {tuple(x.shape)} at {sr} Hz (card; "
          f"max|cuda-cpu|/max|cpu|): " + "; ".join(lines), flush=True)
    print(f"effects: phaser decay 0.9, {rounds} pointer-jumping rounds; "
          f"flanger feedback, {blocks['linear']} blocks (linear), "
          f"{blocks['quadratic']} (quadratic) of {t} samples; one row vs "
          f"the float64 loop: " + ", ".join(
              f"{k} {v:.1e}" for k, v in oracle_err.items()), flush=True)
    _check(all(v <= F32_PARITY for v in oracle_err.values()),
           f"effects vs the float64 loop: {oracle_err}")


def _iir_features(gen: torch.Generator, card: str) -> None:
    """Phase 19 (e), (f): Kaldi pitch on 8 x 10 s of voiced clips and of
    speech-like clips, and the Kaldi fbank and MFCC on config 3's batch,
    against the CPU copy."""
    from torchaudio_contrib_tpu_torch import compliance, ops
    b, t, sr = IIR["pitch"]
    x, f0 = _voiced_batch(gen, b, t, sr)
    out, ms, peak = _on_card(lambda: ops.compute_kaldi_pitch(x.cuda(), sr))
    want = ops.compute_kaldi_pitch(x, sr)
    err = _rel(out[..., 0].cpu(), want[..., 0])
    track = want[:, 10:-10, 1].median(dim=1).values.double()
    print(f"kaldi pitch [{card}]: {tuple(x.shape)} at {sr} Hz -> "
          f"{tuple(out.shape)} ({out.shape[1]} Viterbi steps): {ms:.3f} ms, "
          f"peak {peak:.0f} MiB; NCCF vs CPU {err:.1e}, pitch tracks equal: "
          f"{torch.equal(out[..., 1].cpu(), want[..., 1])}; median pitch "
          f"{[round(v, 1) for v in track.tolist()]} Hz", flush=True)
    _check(torch.equal(out[..., 1].cpu(), want[..., 1])
           and err <= SCAN_PARITY, f"kaldi pitch vs CPU: {err}")
    _check(bool(((track - f0).abs() / f0 < 0.02).all()),
           f"kaldi pitch tracks {track.tolist()}")
    # speech-like clips (onsets, a noise floor, a 120 Hz voice): near-ties
    # of the NCCF move a few frames' states under rounding alone
    # (tests/test_torch_kaldipitch.py), so the share of unequal frames of
    # each clip is bounded rather than 0
    speech = _speech_batch(gen, b, t, sr)
    out = ops.compute_kaldi_pitch(speech.cuda(), sr).cpu()
    want = ops.compute_kaldi_pitch(speech, sr)
    share = (out[..., 1] != want[..., 1]).double().mean(dim=1)
    err = _rel(out[..., 0], want[..., 0])
    print(f"kaldi pitch [{card}] on speech-like clips: unequal frames per "
          f"clip {[round(v, 4) for v in share.tolist()]} (bar "
          f"{PITCH_FLIP_SHARE}), NCCF vs CPU {err:.1e}", flush=True)
    _check(float(share.max()) <= PITCH_FLIP_SHARE,
           f"kaldi pitch on speech: unequal frames {share.tolist()}")

    b, t, sr = IIR["kaldi"]
    x = _speech_batch(gen, b, t, sr)
    lines = []
    for name in ("fbank", "mfcc"):
        fn = getattr(compliance.kaldi, name)
        out, ms, peak = _on_card(lambda: fn(x.cuda()))
        err = _rel(out.cpu(), fn(x))
        lines.append(f"{name} {tuple(out.shape)} {ms:.3f} ms, peak "
                     f"{peak:.0f} MiB, vs CPU {err:.1e}")
        _check(err <= SCAN_PARITY, f"kaldi {name} vs CPU: {err}")
    print(f"compliance.kaldi [{card}]: {tuple(x.shape)} at {sr} Hz: "
          + "; ".join(lines), flush=True)


def _iir_room(gen: torch.Generator, card: str) -> None:
    """Phase 19 (g): image-source responses and ray tracing of a 6 x 5 x 3
    m room with 8 mics against the CPU copy; one response applied to a
    clip through ``fftconvolve``."""
    from torchaudio_contrib_tpu_torch import ops
    cfg = IIR["room"]
    room = np.asarray(cfg["room"])
    src = np.array([1.5, 2.0, 1.2])
    mics = np.stack([np.linspace(3.0, 5.0, cfg["mics"]),
                     np.full(cfg["mics"], 3.5),
                     np.full(cfg["mics"], 1.5)], axis=1)
    kw = dict(max_order=cfg["max_order"], absorption=0.2)
    mics_cpu = torch.as_tensor(mics)
    rir, ms, peak = _on_card(lambda: ops.simulate_rir_ism(
        room, src, mics_cpu.cuda(), **kw))
    rir = rir.cpu()
    again = ops.simulate_rir_ism(room, src, mics_cpu.cuda(), **kw).cpu()
    cpu = ops.simulate_rir_ism(room, src, mics_cpu, **kw)
    ref = torch.from_numpy(_rir_f64(room, src, mics, **kw))
    spread, err = _rel(again, rir), _rel(rir, cpu)
    card64, cpu64 = _rel(rir.double(), ref), _rel(cpu.double(), ref)
    rkw = dict(absorption=0.3, scattering=0.1)
    hist, rt_ms, rt_peak = _on_card(lambda: ops.ray_tracing(
        room, src, mics_cpu.cuda(), cfg["rays"], **rkw), reps=1)
    rt_err = _rel(hist.cpu(), ops.ray_tracing(room, src, mics_cpu,
                                              cfg["rays"], **rkw))
    clip = _speech_batch(gen, 1, 160000, 16000)
    wet, conv_ms, conv_peak = _on_card(lambda: ops.fftconvolve(
        clip.cuda(), rir[:1].cuda()))
    conv_err = _rel(wet.cpu(), ops.fftconvolve(clip, rir[:1]))
    print(f"room [{card}]: simulate_rir_ism {cfg['room']} m, "
          f"{cfg['mics']} mics, max_order {cfg['max_order']} -> "
          f"{tuple(rir.shape)}: {ms:.3f} ms, peak {peak:.0f} MiB, vs CPU "
          f"{err:.1e}, card vs card {spread:.1e}, vs a float64 build: card "
          f"{card64:.1e}, CPU {cpu64:.1e}; ray_tracing {cfg['rays']} rays -> "
          f"{tuple(hist.shape)}: {rt_ms:.3f} ms, peak {rt_peak:.0f} MiB, vs "
          f"CPU {rt_err:.1e}; fftconvolve of a 10 s clip with one response "
          f"{conv_ms:.3f} ms, peak {conv_peak:.0f} MiB, vs CPU "
          f"{conv_err:.1e}", flush=True)
    # the order-10 delays run to ~8 700 samples, where a float32 delay is
    # rounded to ~5e-4 of a sample and each tap with it: both float32
    # builds sit ~3e-5 of peak from the float64 one, so they are held to
    # it, and to each other, as the scans are
    _check(max(err, card64, cpu64) <= SCAN_PARITY and rt_err <= F32_PARITY
           and conv_err <= F32_PARITY and float(hist.sum()) > 0,
           f"room: rir vs CPU {err}, vs float64 card {card64} CPU {cpu64}; "
           f"rays {rt_err}, reverb {conv_err}")


def phase_iir(gen: torch.Generator, card: str) -> int:
    """Phase 19: the IIR family and the ops beside it at full width (the
    module docstring).  Returns the fused forward's launches in (a)."""
    launches = _iir_pipeline(gen, card)
    torch.cuda.empty_cache()
    _iir_loudness(gen, card)
    torch.cuda.empty_cache()
    _iir_filters(gen, card)
    torch.cuda.empty_cache()
    _iir_effects(gen, card)
    _iir_features(gen, card)
    _iir_room(gen, card)
    torch.cuda.empty_cache()
    return launches


def _asr_targets(gen: torch.Generator, n: int, lo: int, hi: int,
                 classes: int) -> tuple:
    """``(targets (n, hi), lengths (n,))``: token ids 1..classes-1 (0 is
    the blank), ragged lengths in ``[lo, hi]``."""
    tl = torch.randint(lo, hi + 1, (n,), generator=gen)
    tg = torch.randint(1, classes, (n, hi), generator=gen)
    return tg, tl


def _param_grads(model) -> dict:
    return {k: p.grad.detach().cpu() for k, p in model.named_parameters()}


def _grad_err(got: dict, want: dict) -> float:
    """A model's gradient against another's, relative to its peak:
    max|got - want| / max|want| over all parameters.  Not per tensor: a
    ReLU whose input rounds to the other side of 0 on one device moves
    that frame's whole contribution, and the float32 CPU step itself lands
    up to 1e-4 of a small tensor's own peak from a float64 step (Wav2Letter
    at phase 20's width: `benchmarks/asr_profile.py`)."""
    diff = max((got[k] - want[k]).abs().max().item() for k in want)
    return diff / max(want[k].abs().max().item() for k in want)


def _tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def _asr_train(gen: torch.Generator, card: str, x: torch.Tensor) -> tuple:
    """Phase 20 (a): Wav2Letter (full width, MFCC input) trained on CTC
    from the fused MFCC of the clips ``x``, between a reset and a read of
    the counters; step 0 against the CPU copy (TF32 off); ms per step with
    TF32 off and on.  Returns (B1 launches, the last emissions, numbers)."""
    from torchaudio_contrib_tpu_torch import ops
    from torchaudio_contrib_tpu_torch.models import Wav2Letter
    a = ASR
    tg, tl = _asr_targets(gen, a["clips"], *a["targets"], a["classes"])
    model = Wav2Letter(num_classes=a["classes"], input_type="mfcc",
                       num_features=a["mfcc"]["n_mfcc"], device="cpu",
                       generator=gen)
    card_model = copy.deepcopy(model).cuda()
    opt = torch.optim.SGD(card_model.parameters(), lr=a["lr"])
    xc, tgc, tlc = x.cuda(), tg.cuda(), tl.cuda()

    def features():
        with torch.no_grad():
            return ops.mfcc(xc, **a["mfcc"], use_fused=True)

    def step():
        feats = features()
        lp = torch.log_softmax(card_model(feats), -1)
        loss = ops.ctc_loss(lp, tgc, None, tlc)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return feats, lp, loss

    # C1: the first forward once more with PyTorch's default flags (cuDNN
    # TF32 allowed), before the counted run
    with _default_flags(), torch.no_grad():
        lp_default = torch.log_softmax(card_model(features()), -1).cpu()
    _reset_counts()
    losses = []
    for i in range(a["steps"]):
        feats, lp, loss = step()
        losses.append(loss.item())
        if i == 0:
            first = (feats, lp.detach(), loss.detach(),
                     _param_grads(card_model))
    launches, fft_launches = _counts()[0], _fft_counts()[0]
    feats, lp0, loss0, grads0 = first
    n_params = sum(p.numel() for p in model.parameters())
    feats_cpu = feats.cpu()
    lp_cpu = torch.log_softmax(model(feats_cpu), -1)
    loss_cpu = ops.ctc_loss(lp_cpu, tg, None, tl)
    loss_cpu.backward()
    loss_err = abs(loss0.item() - loss_cpu.item()) / abs(loss_cpu.item())
    lp_err = _rel(lp0.cpu(), lp_cpu.detach())
    default_err = _rel(lp_default, lp_cpu.detach())
    grad_err = _grad_err(grads0, _param_grads(model))
    feat_err = _rel(feats_cpu[:2], ops.mfcc(x[:2], **a["mfcc"]))

    ms = {"off": _time_ms(step, 1, 3)}
    with torch.no_grad():
        feats = features()
        emissions = torch.log_softmax(card_model(feats), -1)
    _tf32(True)
    try:
        with torch.no_grad():
            lp_tf32 = torch.log_softmax(card_model(feats), -1)
        ms["on"] = _time_ms(step, 1, 3)
    finally:
        _tf32(False)
    tf32_err = _rel(lp_tf32, emissions)
    feat_ms = _time_ms(features, 1, 5)
    lp_g = emissions.clone().requires_grad_()
    ctc_ms = _time_ms(lambda: ops.ctc_loss(lp_g, tgc, None, tlc), 1, 3)
    ctc_bwd_ms = _time_ms(
        lambda: ops.ctc_loss(lp_g, tgc, None, tlc).backward(), 1, 3)
    nums = {"w2l_params": n_params, "w2l_frames": tuple(emissions.shape),
            "w2l_step_ms_tf32_off": ms["off"], "w2l_step_ms_tf32_on":
            ms["on"], "mfcc_ms": feat_ms, "ctc_fwd_ms": ctc_ms,
            "ctc_fwd_bwd_ms": ctc_bwd_ms, "w2l_losses": losses,
            "w2l_loss_rel": loss_err, "w2l_emissions_err": lp_err,
            "w2l_grad_err": grad_err, "w2l_tf32_emissions_err": tf32_err,
            "w2l_default_flags_emissions_err": default_err}
    print(f"ASR (a) [{card}]: Wav2Letter ({n_params} parameters) on the "
          f"fused MFCC {tuple(feats.shape)} of {tuple(x.shape)} at "
          f"{a['sr']} Hz -> emissions {tuple(emissions.shape)}, CTC on "
          f"{int(tl.min())}-{int(tl.max())} tokens, {a['steps']} SGD steps: "
          f"losses {[round(v, 4) for v in losses]}; fused launches (all, FFT "
          f"route) {launches}, {fft_launches}; step 0 vs the CPU copy (TF32 "
          f"off): loss rel {loss_err:.2e}, emissions {lp_err:.2e} (with "
          f"PyTorch's default flags {default_err:.2e}), gradients "
          f"{grad_err:.2e} of peak; MFCC vs the plain chain {feat_err:.2e}; "
          f"ms per step: TF32 off {ms['off']:.2f}, {TF32_STEP} "
          f"{ms['on']:.2f} (emissions {tf32_err:.2e} from TF32 off); MFCC "
          f"{feat_ms:.3f}, "
          f"ctc_loss forward {ctc_ms:.2f}, forward + backward "
          f"{ctc_bwd_ms:.2f} ({emissions.shape[1]} frames, "
          f"{2 * int(tl.max()) + 1} states)", flush=True)
    _check(launches == fft_launches and launches >= a["steps"],
           f"ASR (a): fused launches {launches}, FFT route {fft_launches}")
    _check(all(math.isfinite(v) for v in losses), f"ASR (a): {losses}")
    _check(loss_err <= LOSS_RTOL and lp_err <= F32_PARITY
           and default_err <= F32_PARITY
           and grad_err <= GRAD_PARITY and feat_err <= SCAN_PARITY,
           f"ASR (a) vs CPU: loss {loss_err}, emissions {lp_err} (default "
           f"flags {default_err}), "
           f"gradients {grad_err}, MFCC {feat_err}")
    return launches, emissions, nums


def _asr_deepspeech(gen: torch.Generator, card: str,
                    x: torch.Tensor) -> tuple:
    """Phase 20 (b): DeepSpeech (2048 hidden) on 40-mel log-mels from
    ``FusedMelspectrogram`` of the clips, one forward and backward through
    ``ctc_loss``; a sub-batch against the CPU copy.  Returns (B1
    launches, numbers)."""
    from torchaudio_contrib_tpu_torch import models, ops
    a = ASR
    n = a["ds_check"]
    tg, tl = _asr_targets(gen, a["clips"], *a["targets"], a["classes"])
    mel = models.FusedMelspectrogram(
        num_mels=a["ds_mels"], sample_rate=a["sr"],
        fft_length=a["mfcc"]["fft_length"],
        hop_length=a["mfcc"]["hop_length"], center=True).cuda()
    ds = models.DeepSpeech(a["ds_mels"], a["ds_hidden"], a["classes"],
                           device="cpu", generator=gen)
    card_ds = copy.deepcopy(ds).cuda()
    xc, tgc, tlc = x.cuda(), tg.cuda(), tl.cuda()

    def run(feats, k):
        card_ds.zero_grad()
        lp = card_ds(feats[:k], log_probs=True)
        loss = ops.ctc_loss(lp, tgc[:k], None, tlc[:k])
        loss.backward()
        return loss

    _reset_counts()
    with torch.no_grad():
        feats = mel(xc).transpose(1, 2).contiguous()
    loss = run(feats, a["clips"])
    launches, fft_launches = _counts()[0], _fft_counts()[0]
    sub = run(feats, n).item()
    sub_grads = _param_grads(card_ds)
    lp_cpu = ds(feats[:n].cpu(), log_probs=True)
    loss_cpu = ops.ctc_loss(lp_cpu, tg[:n], None, tl[:n])
    loss_cpu.backward()
    loss_err = abs(sub - loss_cpu.item()) / abs(loss_cpu.item())
    grad_err = _grad_err(sub_grads, _param_grads(ds))
    ms = _time_ms(lambda: run(feats, a["clips"]), 1, 3)
    mel_ms = _time_ms(lambda: mel(xc), 1, 5)
    print(f"ASR (b) [{card}]: DeepSpeech ({a['ds_hidden']} hidden) on "
          f"FusedMelspectrogram {tuple(feats.shape)}: loss "
          f"{loss.item():.4f}; fused launches (all, FFT route) {launches}, "
          f"{fft_launches}; forward + backward through ctc_loss "
          f"{ms:.2f} ms, log-mel {mel_ms:.3f} ms; {n} clips vs the CPU copy "
          f"(TF32 off): loss rel {loss_err:.2e}, gradients {grad_err:.2e} "
          "of peak", flush=True)
    _check(launches == fft_launches == 1,
           f"ASR (b): fused launches {launches}, FFT route {fft_launches}")
    _check(math.isfinite(loss.item()) and loss_err <= LOSS_RTOL
           and grad_err <= GRAD_PARITY,
           f"ASR (b) vs CPU: loss {loss_err}, gradients {grad_err}")
    return launches, {"ds_fwd_bwd_ms": ms, "ds_mel_ms": mel_ms,
                      "ds_loss_rel": loss_err, "ds_grad_err": grad_err}


def _asr_rnnt(gen: torch.Generator, card: str) -> dict:
    """Phase 20 (c): ``rnnt_loss`` on a materialised joint and
    ``rnnt_loss_fused`` from the encodings, at conformer-RNN-T-base
    widths; equal to each other, two rows against the CPU copy; ms and
    peak MiB above the inputs."""
    from torchaudio_contrib_tpu_torch import ops
    b, t, u, j, v = ASR["rnnt"]
    enc = torch.randn((b, t, j), generator=gen)
    pred = torch.randn((b, u + 1, j), generator=gen)
    w = torch.randn((j, v), generator=gen) / math.sqrt(j)
    bias = 0.1 * torch.randn((v,), generator=gen)
    tg = torch.randint(0, v - 1, (b, u), generator=gen)
    ll = t - torch.randint(0, t // 5, (b,), generator=gen)
    tl = torch.randint(u * 3 // 5, u + 1, (b,), generator=gen)
    ll[0], tl[0] = t, u
    enc_c, pred_c, w_c, b_c = (a.cuda() for a in (enc, pred, w, bias))
    tg_c, ll_c, tl_c = tg.cuda(), ll.cuda(), tl.cuda()
    joiner = {"w": w_c, "b": b_c}

    def join(e, p):
        return torch.relu(e[:, :, None] + p[:, None]) @ w_c + b_c

    with torch.no_grad():
        logits = join(enc_c, pred_c)
    logits.requires_grad_(True)

    def lattice():
        loss = ops.rnnt_loss(logits, tg_c, ll_c, tl_c)
        loss.backward()
        logits.grad = None
        return loss

    e = enc_c.detach().requires_grad_(True)

    def fused():
        loss = ops.rnnt_loss_fused(e, pred_c, joiner, tg_c, logit_lengths=ll_c,
                                   target_lengths=tl_c)
        loss.backward()
        return loss

    _, lat_ms, lat_peak = _on_card(lattice)
    _, fused_ms, fused_peak = _on_card(fused)
    fwd_ms = _time_ms(lambda: ops.rnnt_loss(logits.detach(), tg_c, ll_c,
                                            tl_c), 1, 3)
    e.grad = None
    fused_loss = fused()
    g_fused = e.grad.clone()
    e.grad = None
    plain_loss = ops.rnnt_loss(join(e, pred_c), tg_c, ll_c, tl_c)
    plain_loss.backward()
    val_err = abs(fused_loss.item() - plain_loss.item()) \
        / abs(plain_loss.item())
    grad_err = _rel(g_fused.cpu(), e.grad.cpu())
    with torch.no_grad():
        rows_card = ops.rnnt_loss(logits[:2], tg_c[:2], ll_c[:2], tl_c[:2],
                                  reduction="none").cpu()
        rows_fused = ops.rnnt_loss_fused(
            enc_c[:2], pred_c[:2], joiner, tg_c[:2], logit_lengths=ll_c[:2],
            target_lengths=tl_c[:2], reduction="none").cpu()
        lg_cpu = torch.relu(enc[:2, :, None] + pred[:2, None]) @ w + bias
        rows_cpu = ops.rnnt_loss(lg_cpu, tg[:2], ll[:2], tl[:2],
                                 reduction="none")
    rows_err = max(_rel(rows_card, rows_cpu), _rel(rows_fused, rows_cpu))
    mib = logits.numel() * 4 / 2 ** 20
    print(f"ASR (c) [{card}]: rnnt_loss on logits {tuple(logits.shape)} "
          f"({mib:.0f} MiB) forward {fwd_ms:.2f} ms, forward + backward "
          f"{lat_ms:.2f} ms, peak {lat_peak:.0f} MiB above the inputs "
          f"({t + u} anti-diagonals); rnnt_loss_fused from enc "
          f"{tuple(e.shape)}, pred {tuple(pred.shape)}, joiner "
          f"{tuple(w.shape)} (time_chunk {max(4, 512 // b)}) forward + "
          f"backward {fused_ms:.2f} ms, peak "
          f"{fused_peak:.0f} MiB; fused vs rnnt_loss(join(...)): value rel "
          f"{val_err:.2e}, enc gradient {grad_err:.2e} of peak; two rows vs "
          f"the CPU copy {rows_err:.2e}", flush=True)
    _check(val_err <= LOSS_RTOL and grad_err <= GRAD_PARITY
           and rows_err <= LOSS_RTOL,
           f"ASR (c): fused vs lattice {val_err}, gradient {grad_err}, "
           f"rows vs CPU {rows_err}")
    _check(fused_peak < lat_peak,
           f"ASR (c): fused peak {fused_peak} MiB >= lattice {lat_peak}")
    return {"rnnt_fwd_ms": fwd_ms, "rnnt_fwd_bwd_ms": lat_ms,
            "rnnt_peak_mib": lat_peak, "rnnt_fused_fwd_bwd_ms": fused_ms,
            "rnnt_fused_peak_mib": fused_peak, "rnnt_fused_rel": val_err,
            "rnnt_fused_grad_err": grad_err, "rnnt_rows_rel": rows_err}


def _asr_lexicon(gen: torch.Generator, letters: list) -> tuple:
    """``(words, arpa lines)``: ``ASR["words"]`` distinct words of 2-7
    letters and a bigram ARPA LM over them (every word a unigram; each
    word's bigrams with four others)."""
    words, seen = [], set()
    while len(words) < ASR["words"]:
        n = int(torch.randint(2, 8, (1,), generator=gen))
        w = "".join(letters[i] for i in torch.randint(
            0, len(letters), (n,), generator=gen).tolist())
        if w not in seen:
            seen.add(w)
            words.append(w)
    uni = torch.rand((len(words),), generator=gen).double() + 0.1
    uni = torch.log10(uni / uni.sum()).tolist()
    pairs = torch.randint(0, len(words), (len(words), 4), generator=gen)
    bigrams = {}
    for i, row in enumerate(pairs.tolist()):
        for k, p in enumerate(row):
            bigrams.setdefault((i, p), f"{-0.3 - 0.5 * k:.3f}\t{words[i]} "
                               f"{words[p]}")
    bigrams = list(bigrams.values())
    lines = ["\\data\\", f"ngram 1={len(words) + 2}",
             f"ngram 2={len(bigrams)}", "", "\\1-grams:",
             "-1.000\t<s>\t-0.300", "-1.500\t</s>"]
    lines += [f"{p:.4f}\t{w}\t-0.300" for w, p in zip(words, uni)]
    lines += ["", "\\2-grams:"] + bigrams + ["", "\\end\\"]
    return words, lines


def _peaky(gen: torch.Generator, words: list, tokens: list, n: int,
           frames: int) -> tuple:
    """Emissions (n, frames, len(tokens)) planted from transcripts: each
    clip's words, "|" after each, every token held for 2-3 frames and
    followed by a blank frame; N(0, 1) logits with +8 on the planted
    token, log-softmaxed.  Returns (emissions, transcripts (word lists),
    token sequences, spans [(token, start, end)])."""
    v = len(tokens)
    logits = torch.randn((n, frames, v), generator=gen)
    plant = torch.zeros((n, frames), dtype=torch.long)
    scripts, seqs, spans = [], [], []
    for i in range(n):
        pos, script, seq, sp = 2, [], [], []
        while True:
            w = words[int(torch.randint(0, len(words), (1,), generator=gen))]
            toks = [tokens.index(c) for c in w] + [tokens.index("|")]
            hold = torch.randint(2, 4, (len(toks),), generator=gen).tolist()
            if pos + sum(hold) + len(hold) > frames - 4:
                break
            for tok, h in zip(toks, hold):
                plant[i, pos:pos + h] = tok
                sp.append((tok, pos, pos + h))
                pos += h + 1
            script.append(w)
            seq += toks
        scripts.append(script)
        seqs.append(seq)
        spans.append(sp)
    logits.scatter_add_(2, plant[..., None], torch.full((n, frames, 1), 8.0))
    return torch.log_softmax(logits, -1), scripts, seqs, spans


def _pad_ids(rows: list) -> tuple:
    """``(ids (n, longest), lengths (n,))``, padded with -1."""
    longest = max(1, max(len(r) for r in rows))
    ids = torch.full((len(rows), longest), -1, dtype=torch.long)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = torch.tensor(r, dtype=torch.long)
    return ids, torch.tensor([len(r) for r in rows])


def _words_of(tokens_row: list, tokens: list, sil: int) -> list:
    out, cur = [], ""
    for tok in tokens_row:
        if tok == sil:
            out.append(cur)
            cur = ""
        else:
            cur += tokens[tok]
    return out + ([cur] if cur else [])


def _asr_decode(gen: torch.Generator, card: str, trained) -> dict:
    """Phase 20 (d): greedy, beam and lexicon + bigram LM decoding of
    peaky emissions planted from known transcripts (WER 0 by
    ``edit_distance_batched``), the device searches against the host
    searches on ``ASR["decode_check"]`` clips, ``forced_align`` and
    ``merge_tokens`` against the planted alignment; then the same decoders
    on (a)'s trained emissions, for timing."""
    from torchaudio_contrib_tpu_torch import models, ops
    a = ASR
    letters = [chr(ord("a") + i) for i in range(26)]
    tokens = ["-", "|"] + letters + ["'"]
    sil = tokens.index("|")
    words, arpa = _asr_lexicon(gen, letters)
    word_id = {w: i for i, w in enumerate(words)}
    lp, scripts, seqs, spans = _peaky(gen, words, tokens, a["clips"],
                                      trained.shape[1])
    lpc = lp.cuda()
    host = models.ctc_decoder([f"{w} {' '.join(w)}" for w in words], tokens,
                              lm=models.ARPALM(arpa), nbest=a["beam"],
                              beam_size=a["beam"], beam_threshold=math.inf)
    t0 = time.perf_counter()
    device = ops.device_ctc_decoder(host)
    compile_s = time.perf_counter() - t0

    def wer(hyp_words: list) -> int:
        ref, rl = _pad_ids([[word_id[w] for w in s] for s in scripts])
        hyp, hl = _pad_ids([[word_id.get(w, -2) for w in h]
                            for h in hyp_words])
        d = ops.edit_distance_batched(ref.cuda(), hyp.cuda(), rl.cuda(),
                                      hl.cuda())
        return int(d.sum())

    def greedy():
        return ops.ctc_greedy_decode(lpc)

    def beam():
        return ops.ctc_beam_decode(lpc, beam_width=a["beam"])

    (gt, gl, _), greedy_ms, _ = _on_card(greedy, reps=3)
    (bt, bl, bs), beam_ms, beam_peak = _on_card(beam, reps=1)
    t0 = time.perf_counter()
    lex = device(lpc)
    lex_s = time.perf_counter() - t0
    greedy_rows = [gt[i, :gl[i]].tolist() for i in range(a["clips"])]
    beam_rows = [bt[i, 0, :bl[i, 0]].tolist() for i in range(a["clips"])]
    wers = {"greedy": wer([_words_of(r, tokens, sil) for r in greedy_rows]),
            "beam": wer([_words_of(r, tokens, sil) for r in beam_rows]),
            "lexicon": wer([h[0].words for h in lex])}
    _check(greedy_rows == seqs and beam_rows == seqs
           and all(w == 0 for w in wers.values()),
           f"ASR (d): decoded transcripts differ, word errors {wers}")

    n = a["decode_check"]
    t0 = time.perf_counter()
    host_beam = [ops.ctc_prefix_beam_search(lp[i], beam_width=a["beam"],
                                            nbest=a["beam"])
                 for i in range(n)]
    host_lex = host(lp[:n])
    host_s = time.perf_counter() - t0
    beam_err = 0.0
    for i, hyps in enumerate(host_beam):
        got = [bt[i, k, :bl[i, k]].tolist() for k in range(len(hyps))]
        _check(got == [h.tokens for h in hyps],
               f"ASR (d): device beam != host prefix search, clip {i}")
        beam_err = max(beam_err, max(abs(float(bs[i, k]) - h.score)
                                     / max(1.0, abs(h.score))
                                     for k, h in enumerate(hyps)))
    lex_err = 0.0
    for i in range(n):
        got, want = lex[i], host_lex[i]
        _check([(h.words, h.tokens, h.timesteps) for h in got]
               == [(h.words, h.tokens, h.timesteps) for h in want],
               f"ASR (d): device lexicon search != host search, clip {i}")
        lex_err = max(lex_err, max(abs(g.score - h.score)
                                   / max(1.0, abs(h.score))
                                   for g, h in zip(got, want)))
    _check(beam_err <= DECODE_REL and lex_err <= DECODE_REL,
           f"ASR (d): scores vs host: beam {beam_err}, lexicon {lex_err}")

    tgt, tgt_len = _pad_ids(seqs)
    tgt = tgt.clamp(min=0).cuda()
    (ali, ali_scores), align_ms, _ = _on_card(
        lambda: ops.forced_align(lpc, tgt, None, tgt_len.cuda()), reps=1)
    recovered = all(
        [(s.token, s.start, s.end) for s in ops.merge_tokens(
            ali[i], ali_scores[i])] == spans[i] for i in range(a["clips"]))
    _check(recovered, "ASR (d): merge_tokens spans != the planted alignment")

    tc = trained.cuda()
    trained_ms = {
        "greedy": _time_ms(lambda: ops.ctc_greedy_decode(tc), 1, 3),
        "beam": _time_ms(lambda: ops.ctc_beam_decode(
            tc, beam_width=a["beam"]), 0, 1),
        "lexicon": _time_ms(lambda: device(tc), 0, 1)}
    dist_ms = _time_ms(lambda: ops.edit_distance_batched(gt, gt, gl, gl), 1, 3)
    n_tok = [len(s) for s in seqs]
    print(f"ASR (d) [{card}]: peaky emissions {tuple(lp.shape)} of "
          f"{sum(len(s) for s in scripts)} planted words "
          f"({min(n_tok)}-{max(n_tok)} tokens a clip), lexicon of "
          f"{len(words)} words ({device.tables.child.shape[0]} trie nodes), "
          f"bigram ARPA LM ({device.tables.lm_score.shape[0]} states, tables "
          f"compiled in {compile_s:.2f} s); word errors {wers}; ms a batch: "
          f"greedy {greedy_ms:.3f}, beam (16) {beam_ms:.1f} (peak "
          f"{beam_peak:.0f} MiB), lexicon + LM (16) {lex_s * 1e3:.1f} "
          f"(host clock, n-best read back), forced_align {align_ms:.1f}, "
          f"edit distance {dist_ms:.3f}; device vs host searches on {n} "
          f"clips: equal, scores rel beam {beam_err:.2e}, lexicon "
          f"{lex_err:.2e} (host {host_s:.1f} s); merge_tokens spans = the "
          f"planted alignment; on (a)'s trained emissions: greedy "
          f"{trained_ms['greedy']:.3f}, beam {trained_ms['beam']:.1f}, "
          f"lexicon {trained_ms['lexicon']:.1f} ms", flush=True)
    return {"greedy_ms": greedy_ms, "beam_ms": beam_ms,
            "lexicon_ms": lex_s * 1e3, "align_ms": align_ms,
            "edit_distance_ms": dist_ms, "lexicon_compile_s": compile_s,
            "beam_rel": beam_err, "lexicon_rel": lex_err, "wer": wers,
            "trained_ms": trained_ms}


def phase_asr(gen: torch.Generator, card: str) -> int:
    """Phase 20: the ASR path at full width (the module docstring).
    Returns the fused forward's launches in (a) and (b)."""
    a = ASR
    x = _speech_batch(gen, a["clips"], a["samples"], a["sr"])
    w2l_launches, emissions, nums = _asr_train(gen, card, x)
    torch.cuda.empty_cache()
    ds_launches, ds_nums = _asr_deepspeech(gen, card, x)
    torch.cuda.empty_cache()
    rnnt_nums = _asr_rnnt(gen, card)
    torch.cuda.empty_cache()
    decode_nums = _asr_decode(gen, card, emissions.cpu())
    launches = w2l_launches + ds_launches
    print("ASR path [" + card + "]: " + json.dumps(
        {**nums, **ds_nums, **rnnt_nums, **decode_nums,
         "fused_launches": launches}), flush=True)
    return launches


def _segments(feats: torch.Tensor, T: int, S: int, R: int):
    """``(chunk (B, S + R, D), utt_lengths, rc_lengths)`` a segment of
    full-length streams ``feats (B, T + R, D)``: ``S`` utterance slots
    (zero-padded past ``T``: the last segment may be short) and the ``R``
    lookahead frames after the segment's valid ones."""
    B = feats.shape[0]
    nseg = -(-T // S)
    ext = torch.nn.functional.pad(feats, (0, 0, 0, nseg * S - T))
    for i in range(nseg):
        base, rc = i * S, min(i * S + S, T)
        yield (torch.cat([ext[:, base:base + S], ext[:, rc:rc + R]], 1),
               torch.full((B,), min(S, T - base)),
               torch.full((B,), min(R, T + R - rc)))


def _confident_joiner(model, enc) -> float:
    """Scale the joiner by ``RNNT_SERVE["joiner_scale"]`` and raise blank's
    bias, by bisection, until greedy decoding of ``enc`` emits about
    ``RNNT_SERVE["tokens_per_frame"]``.  Returns the raise."""
    a = RNNT_SERVE
    lin, blank = model.joiner.linear, model.blank
    lengths = torch.full((enc.shape[0],), enc.shape[1])

    def rate(r: float) -> float:
        with torch.no_grad():
            lin.bias[blank] = r
        grid, _ = model._greedy_on_enc(enc, lengths, a["max_symbols"],
                                       model.greedy_init_state(len(enc)))
        return (grid != blank).sum().item() / enc.shape[:2].numel()

    with torch.no_grad():
        lin.weight.mul_(a["joiner_scale"])
    lo, hi = 0.0, 1.0
    while rate(hi) > a["tokens_per_frame"]:
        lo, hi = hi, 2 * hi
    for _ in range(8):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if rate(mid) > a["tokens_per_frame"] \
            else (lo, mid)
    rate(hi)
    return hi


def _same_nbest(got: list, want: list) -> float:
    """Fails unless the n-best lists hold the same sequences in the same
    order; returns the largest |score diff| / max(1, |score|)."""
    err = 0.0
    _check(len(got) == len(want), "beams: batch sizes differ")
    for g, w in zip(got, want):
        _check([t for t, _ in g] == [t for t, _ in w],
               f"beams: n-best sequences differ ({len(g)} vs {len(w)} "
               "hypotheses)")
        err = max([err] + [abs(a - b) / max(1.0, abs(b))
                           for (_, a), (_, b) in zip(g, w)])
    return err


def _rnnt_serve(gen: torch.Generator, card: str) -> dict:
    """Phase 21 (a): the Emformer-RNNT bundle serving 4 requests, streamed
    and one-shot, greedy and beam (the module docstring)."""
    from torchaudio_contrib_tpu_torch.pipelines import \
        EMFORMER_RNNT_BASE_LIBRISPEECH as bundle
    a = RNNT_SERVE
    B, ms_ = a["requests"], a["max_symbols"]
    S, R = bundle.segment_length, bundle.right_context_length
    stride = bundle.time_reduction_stride
    x = _speech_batch(gen, B, a["samples"], a["sr"])
    model_cpu = bundle.get_model(gen, device="cpu").eval()
    n_params = sum(p.numel() for p in model_cpu.parameters())
    with torch.inference_mode():
        extract_cpu = bundle.get_feature_extractor(device="cpu")
        feats_cpu = extract_cpu(x)
        # the log of a float32 FFT's power: a quiet bin's rounding, which
        # is relative to its frame's loudest, becomes an absolute error
        feats64 = extract_cpu.double()(x.double())
    # the utterance: the extractor's frames less the lookahead, trimmed to
    # a stride multiple (the JAX bundle's docstring asks the same)
    T = (feats_cpu.shape[1] - R) // stride * stride
    t_red = T // stride
    feats_cpu, feats64 = feats_cpu[:, :T + R], feats64[:, :T + R]
    lengths = torch.full((B,), T)
    with torch.inference_mode():
        enc_cpu, _ = model_cpu.transcribe(feats_cpu, lengths)
    blank_raise = _confident_joiner(model_cpu, enc_cpu)
    model = copy.deepcopy(model_cpu).cuda()
    search = bundle.get_decoder(model, beam_width=a["beam"])
    max_tokens = t_red * ms_

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    _reset_gl_counts()
    with torch.inference_mode():
        extract = bundle.get_feature_extractor()
        feats = extract(x.cuda())[:, :T + R]
        feat_err = _rel(feats.cpu(), feats_cpu)
        feat64_err = (_rel(feats.cpu().double(), feats64),
                      _rel(feats_cpu.double(), feats64))
        lc = lengths.cuda()

        def timed(fn):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            stop.record()
            stop.synchronize()
            return out, start.elapsed_time(stop)

        # one segment of each decoder first, untimed: a server is warm
        first = next(_segments(feats, T, S, R))
        model.stream_greedy_step(first[0], model.init_stream_state(B),
                                 max_symbols=ms_, utt_lengths=first[1],
                                 rc_lengths=first[2])[0].cpu()
        f, ol, _ = model.stream_transcribe(
            first[0], model.transcriber.init_state(B),
            utt_lengths=first[1], rc_lengths=first[2])
        search.infer_batched(f, ol, search.init_batched_state(B, max_tokens))

        # streamed greedy: a server reads each segment's tokens back
        state = model.init_stream_state(B)
        grids, greedy_ms = [], []
        for chunk, ul, rl in _segments(feats, T, S, R):
            def seg():
                g, _, st = model.stream_greedy_step(
                    chunk, state, max_symbols=ms_, utt_lengths=ul,
                    rc_lengths=rl)
                return g.cpu(), st
            (g, state), ms = timed(seg)
            grids.append(g)
            greedy_ms.append(ms)
        grid_stream = torch.cat(grids, 1)[:, :t_red]

        # streamed batched beam: encodings a segment, the beam's carry
        carry = search.init_batched_state(B, max_tokens)
        enc_state = model.transcriber.init_state(B)
        enc_stream, beam_ms = [], []
        for chunk, ul, rl in _segments(feats, T, S, R):
            def seg():
                f, ol, st = model.stream_transcribe(
                    chunk, enc_state, utt_lengths=ul, rc_lengths=rl)
                nbest, c = search.infer_batched(f, ol, carry)
                return f, st, nbest, c
            (f, enc_state, beam_stream, carry), ms = timed(seg)
            enc_stream.append(f)
            beam_ms.append(ms)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20

        (enc, _), transcribe_ms = timed(lambda: model.transcribe(feats, lc))
        transcribe_ms = min(transcribe_ms, _time_ms(
            lambda: model.transcribe(feats, lc), 1, 3))
        grid, greedy_full_ms = timed(lambda: model.greedy_decode(
            feats, lc, max_symbols=ms_, compact=False).cpu())
        beam, beam_full_ms = timed(lambda: search.decode_batched(
            feats, lc, max_tokens=max_tokens))
        one, one_ms = timed(lambda: search.decode_batched(
            feats[:1], lc[:1], max_tokens=max_tokens))
        host, host_ms = timed(lambda: search(feats[:1], lc[:1]))
        with _default_flags():
            enc_default, _ = model.transcribe(feats, lc)
    launches = sum(_counts()) + sum(_gl_counts())

    enc_err = _rel(enc.cpu(), enc_cpu)
    default_err = _rel(enc_default.cpu(), enc_cpu)
    stream_err = _rel(torch.cat(enc_stream, 1)[:, :t_red], enc)
    greedy_equal = torch.equal(grid_stream, grid)
    emitted = int((grid != model.blank).sum())
    print(f"Transducer (a) [{card}]: EMFORMER_RNNT_BASE_LIBRISPEECH "
          f"({n_params} parameters, joiner x{a['joiner_scale']}, blank "
          f"+{blank_raise:.3f}) serving {B} requests of "
          f"{a['samples'] / a['sr']:.0f} s: features {tuple(feats.shape)} "
          f"(vs CPU {feat_err:.2e}; card and CPU vs float64 "
          f"{feat64_err[0]:.2e}, {feat64_err[1]:.2e}), {len(greedy_ms)} "
          f"segments of {S} + "
          f"{R} frames ({S * bundle.hop_length * 1000 // a['sr']} ms of "
          f"audio each), encodings {tuple(enc.shape)}; ms per segment "
          f"after one untimed segment: "
          f"greedy median {np.median(greedy_ms):.2f}, max "
          f"{max(greedy_ms):.2f}; beam {a['beam']} median "
          f"{np.median(beam_ms):.2f}, max {max(beam_ms):.2f}; one-shot "
          f"transcribe {transcribe_ms:.2f}, greedy_decode "
          f"{greedy_full_ms:.1f}, decode_batched {beam_full_ms:.1f}; one "
          f"request: batched beam {one_ms:.1f}, host beam {host_ms:.1f}; "
          f"peak {peak:.0f} MiB above the inputs; {emitted} tokens emitted "
          f"in {t_red} frames x {B}; encodings vs the CPU copy (TF32 off) "
          f"{enc_err:.2e} (with PyTorch's default flags {default_err:.2e}), "
          f"streamed vs one-shot {stream_err:.2e} of peak; "
          f"kernel launches {launches}", flush=True)
    _check(launches == 0, f"Transducer (a): {launches} kernel launches")
    _check(max(feat_err, *feat64_err) <= SCAN_PARITY
           and max(enc_err, default_err) <= GRAD_PARITY
           and stream_err <= GRAD_PARITY,
           f"Transducer (a): features {feat_err} (vs float64 {feat64_err}), "
           f"encodings vs CPU {enc_err} (default flags {default_err}), "
           f"streamed vs one-shot {stream_err}")
    _check(greedy_equal, "Transducer (a): the streamed greedy grid differs "
           "from greedy_decode's")
    stream_beam_err = _same_nbest(beam_stream, beam)
    host_err = _same_nbest(host, one)
    _check(stream_beam_err <= BEAM_REL and host_err <= BEAM_REL,
           f"Transducer (a): beam scores: streamed {stream_beam_err}, host "
           f"{host_err}")
    print(f"Transducer (a) [{card}]: streamed greedy grid = greedy_decode's; "
          f"streamed beam = decode_batched (scores {stream_beam_err:.2e}); "
          f"host beam = batched beam on one request ({len(host[0])} "
          f"hypotheses, scores {host_err:.2e}); best score "
          f"{beam[0][0][1]:.3f} over {len(beam[0][0][0])} tokens",
          flush=True)
    return {"serve_params": n_params, "segments": len(greedy_ms),
            "greedy_ms_median": float(np.median(greedy_ms)),
            "greedy_ms_max": max(greedy_ms),
            "beam_ms_median": float(np.median(beam_ms)),
            "beam_ms_max": max(beam_ms), "transcribe_ms": transcribe_ms,
            "greedy_decode_ms": greedy_full_ms,
            "decode_batched_ms": beam_full_ms, "one_request_batched_ms":
            one_ms, "one_request_host_ms": host_ms, "serve_peak_mib": peak,
            "features_err": feat_err, "features_f64_err": feat64_err,
            "enc_err": enc_err, "enc_default_flags_err": default_err,
            "stream_err": stream_err,
            "beam_stream_rel": stream_beam_err, "beam_host_rel": host_err,
            "tokens_emitted": emitted}


def _rnnt_train(gen: torch.Generator, card: str) -> dict:
    """Phase 21 (b): ``conformer_rnnt_base`` trained on ``RNNT.loss``
    (the module docstring)."""
    from torchaudio_contrib_tpu_torch import models, ops
    from torchaudio_contrib_tpu_torch.pipelines import \
        EMFORMER_RNNT_BASE_LIBRISPEECH as bundle
    b = RNNT_TRAIN
    n = b["check"]
    x = _speech_batch(gen, b["clips"], b["samples"], 16000)
    with torch.no_grad():
        feats = bundle.get_feature_extractor()(x.cuda())
    tg, tl = _asr_targets(gen, b["clips"], *b["targets"], b["symbols"])
    model = models.conformer_rnnt_base(b["symbols"], device="cpu",
                                       generator=gen)
    n_params = sum(p.numel() for p in model.parameters())
    card_model = copy.deepcopy(model).cuda()
    opt = torch.optim.SGD(card_model.parameters(), lr=b["lr"])
    tgc, tlc = tg.cuda(), tl.cuda()

    # step 0 on ``check`` clips against the CPU copy
    _reset_counts()
    _reset_gl_counts()
    loss = card_model.loss(feats[:n], tgc[:n], None, tlc[:n])
    loss.backward()
    grads = _param_grads(card_model)
    cpu_loss = model.loss(feats[:n].cpu(), tg[:n], None, tl[:n])
    cpu_loss.backward()
    loss_err = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    grad_err = _grad_err(grads, _param_grads(model))

    def step():
        out = card_model.loss(feats, tgc, None, tlc)
        opt.zero_grad()
        out.backward()
        opt.step()
        return out

    losses, step_ms, step_peak = [], [], 0.0
    for _ in range(3):
        out, ms, pk = _on_card(step, reps=0)
        losses.append(out.item())
        step_ms.append(ms)
        step_peak = max(step_peak, pk)
    launches = sum(_counts()) + sum(_gl_counts())

    enc, _ = card_model.transcribe(feats)
    pred = card_model.predictor(tgc)
    g_enc, g_pred = torch.randn_like(enc), torch.randn_like(pred)

    def model_part():
        e, _ = card_model.transcribe(feats)
        p = card_model.predictor(tgc)
        opt.zero_grad()
        torch.autograd.backward([e, p], [g_enc, g_pred])

    enc_d = enc.detach().requires_grad_()
    pred_d = pred.detach().requires_grad_()
    lin = card_model.joiner.linear

    def loss_part():
        out = ops.rnnt_loss_fused(enc_d, pred_d,
                                  {"w": lin.weight.t(), "b": lin.bias},
                                  tgc, act=card_model.act,
                                  target_lengths=tlc, blank=0)
        out.backward()

    model_ms = _time_ms(model_part, 1, 3)
    loss_ms = _time_ms(loss_part, 1, 3)
    step_med = float(np.median(step_ms))
    print(f"Transducer (b) [{card}]: conformer_rnnt_base ({n_params} "
          f"parameters) on features {tuple(feats.shape)} -> encodings "
          f"{tuple(enc.shape)}, {int(tl.min())}-{int(tl.max())} target "
          f"tokens, 3 SGD steps on RNNT.loss (fused, time_chunk "
          f"{max(4, 512 // b['clips'])}): losses "
          f"{[round(v, 4) for v in losses]}; ms per step {step_ms[0]:.1f} "
          f"(first), median {step_med:.1f}, peak {step_peak:.0f} MiB; the "
          f"model's forward + backward {model_ms:.1f} ms "
          f"({model_ms / step_med:.0%} of a step), the fused loss's "
          f"(joint + lattice) {loss_ms:.1f} ms ({loss_ms / step_med:.0%}); "
          f"{n} clips vs the CPU copy (TF32 off): loss rel "
          f"{loss_err:.2e}, gradients {grad_err:.2e} of peak; kernel "
          f"launches {launches}", flush=True)
    _check(launches == 0, f"Transducer (b): {launches} kernel launches")
    _check(all(math.isfinite(v) for v in losses), f"Transducer (b): {losses}")
    _check(loss_err <= LOSS_RTOL and grad_err <= GRAD_PARITY,
           f"Transducer (b) vs CPU: loss {loss_err}, gradients {grad_err}")
    return {"train_params": n_params, "train_step_ms": step_ms,
            "train_peak_mib": step_peak, "train_model_ms": model_ms,
            "train_loss_ms": loss_ms, "train_losses": losses,
            "train_loss_rel": loss_err, "train_grad_err": grad_err}


def phase_transducer(gen: torch.Generator, card: str) -> None:
    """Phase 21: the streaming transducer family at full width (the
    module docstring)."""
    _tf32(False)
    serve = _rnnt_serve(gen, card)
    torch.cuda.empty_cache()
    train = _rnnt_train(gen, card)
    torch.cuda.empty_cache()
    print("Transducer path [" + card + "]: " + json.dumps(
        {**serve, **train}), flush=True)


def _kernel_count() -> int:
    return sum(_counts()) + sum(_fft_counts()) + sum(_gl_counts()) \
        + _gl_fft_count()


def _w2v2_serve(gen: torch.Generator, card: str) -> tuple:
    """Phase 22 (a): ``WAV2VEC2_ASR_BASE_960H`` serving 8 requests in one
    padded batch (the module docstring).  Returns (numbers, the CPU
    model)."""
    from torchaudio_contrib_tpu_torch import ops
    from torchaudio_contrib_tpu_torch.pipelines import \
        WAV2VEC2_ASR_BASE_960H as bundle
    w = W2V2
    lengths = torch.tensor([int(s * w["sr"]) for s in w["requests"]])
    x = _speech_batch(gen, len(lengths), int(lengths.max()), w["sr"])
    x = x * (torch.arange(x.shape[1])[None] < lengths[:, None])
    model_cpu = bundle.get_model(gen, device="cpu").eval()
    n_params = sum(p.numel() for p in model_cpu.parameters())
    model = copy.deepcopy(model_cpu).cuda()
    xc, lc = x.cuda(), lengths.cuda()
    with torch.inference_mode():
        (emis, out_len), ms, peak = _on_card(lambda: model(xc, lc))
        _tf32(True)
        ms_tf32 = _time_ms(lambda: model(xc, lc), 1, 3)
        emis_tf32 = model(xc, lc)[0]
        _tf32(False)
        with _default_flags():
            emis_default = model(xc, lc)[0]
        t0 = time.perf_counter()
        emis_cpu, out_len_cpu = model_cpu(x, lengths)
        cpu_s = time.perf_counter() - t0
        lp = torch.log_softmax(emis, -1)
        lp_cpu = torch.log_softmax(emis_cpu, -1)
        ids, n_ids, _ = ops.ctc_greedy_decode(lp, out_len)
        ids_cpu, n_cpu, _ = ops.ctc_greedy_decode(lp_cpu, out_len_cpu)
    err = _rel(emis.cpu(), emis_cpu)
    err_tf32 = _rel(emis_tf32.cpu(), emis_cpu)
    err_default = _rel(emis_default.cpu(), emis_cpu)
    abs_err = (lp.cpu() - lp_cpu).abs().max().item()
    # frame labels equal wherever the CPU's top-2 margin exceeds twice the
    # log-probs' measured error
    top2 = lp_cpu.topk(2, -1).values
    valid = torch.arange(lp_cpu.shape[1])[None] < out_len_cpu[:, None]
    sure = valid & (top2[..., 0] - top2[..., 1] > 2 * abs_err)
    differ = (lp.argmax(-1).cpu() != lp_cpu.argmax(-1)) & sure
    texts = [bundle.decode(ids[i, :n_ids[i]].tolist())
             for i in range(len(lengths))]
    texts_cpu = [bundle.decode(ids_cpu[i, :n_cpu[i]].tolist())
                 for i in range(len(lengths))]
    labels = bundle.get_labels()
    words = {"".join(labels[j] for j in torch.randint(
        2, 29, (int(torch.randint(2, 7, (1,), generator=gen)),),
        generator=gen).tolist()) for _ in range(40)}
    decoder = bundle.get_decoder({wd: list(wd) + ["|"] for wd in words},
                                 beam_size=16)
    t0 = time.perf_counter()
    hyp = decoder(lp[:1].float().cpu(), out_len[:1].cpu())[0][0]
    lex_ms = (time.perf_counter() - t0) * 1e3
    print(f"wav2vec2 (a) [{card}]: WAV2VEC2_ASR_BASE_960H ({n_params} "
          f"parameters) on 8 requests of {w['requests'][0]}-"
          f"{w['requests'][-1]} s, padded to {tuple(x.shape)} -> emissions "
          f"{tuple(emis.shape)}, frames {out_len.tolist()}; ms per batch "
          f"{ms:.1f} (TF32 off), {ms_tf32:.1f} ({TF32_FWD}), per request "
          f"{ms / len(lengths):.2f} / {ms_tf32 / len(lengths):.2f}; peak "
          f"{peak:.0f} MiB; the CPU copy {cpu_s:.1f} s; emissions vs CPU "
          f"{err:.2e} of peak (with PyTorch's default flags {err_default:.2e};"
          f" {TF32_FWD} {err_tf32:.2e}, no bar), log-probs "
          f"{abs_err:.2e} abs; greedy frames "
          f"unequal where sure {int(differ.sum())} of {int(sure.sum())} "
          f"(of {int(valid.sum())}); texts equal to the CPU's "
          f"{sum(a == b for a, b in zip(texts, texts_cpu))} of 8; request "
          f"0 greedy {texts[0][:40]!r}; lexicon + beam 16 over "
          f"{len(words)} words: {hyp.words[:6]} in {lex_ms:.0f} ms",
          flush=True)
    _check(emis.shape == (8, int(out_len.max()), 29)
           and bool(torch.isfinite(emis).all()), "wav2vec2 (a): emissions")
    _check(out_len.tolist() == out_len_cpu.tolist()
           == model_cpu.output_length(lengths).tolist(),
           f"wav2vec2 (a): lengths {out_len.tolist()}")
    _check(max(err, err_default) <= W2V2_REL,
           f"wav2vec2 (a) vs CPU: {err} (default flags {err_default})")
    _check(not differ.any(), f"wav2vec2 (a): {int(differ.sum())} frames")
    _check(all(wd in words for wd in hyp.words)
           and math.isfinite(hyp.score), f"wav2vec2 (a): lexicon {hyp}")
    return {"serve_params": n_params, "serve_ms": ms,
            "serve_ms_tf32": ms_tf32, "serve_ms_per_request": ms / 8,
            "serve_peak_mib": peak, "serve_rel": err,
            "serve_rel_tf32": err_tf32, "serve_rel_default_flags":
            err_default,
            "serve_cpu_s": cpu_s, "lexicon_ms": lex_ms}, model_cpu


def _w2v2_ctc(gen: torch.Generator, card: str, model_cpu) -> dict:
    """Phase 22 (b): SGD on ``ctc_loss`` of the bundle's model (the module
    docstring)."""
    from torchaudio_contrib_tpu_torch import ops
    w = W2V2
    model_cpu.train()
    card_model = copy.deepcopy(model_cpu).cuda()

    def loss_of(m, x, tg, tl):
        logits, out_len = m(x)
        return ops.ctc_loss(torch.log_softmax(logits, -1), tg, out_len, tl)

    n, samples = w["check"]
    xs = _speech_batch(gen, n, samples, w["sr"])
    tg, tl = _asr_targets(gen, n, *w["check_targets"], 29)
    loss = loss_of(card_model, xs.cuda(), tg.cuda(), tl.cuda())
    loss.backward()
    grads = _param_grads(card_model)
    cpu_loss = loss_of(model_cpu, xs, tg, tl)
    cpu_loss.backward()
    loss_err = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    grad_err = _grad_err(grads, _param_grads(model_cpu))

    n, samples = w["train"]
    xb = _speech_batch(gen, n, samples, w["sr"]).cuda()
    tgb, tlb = (t.cuda() for t in _asr_targets(gen, n, *w["targets"], 29))
    opt = torch.optim.SGD(card_model.parameters(), lr=w["lr"])

    def step():
        out = loss_of(card_model, xb, tgb, tlb)
        opt.zero_grad()
        out.backward()
        opt.step()
        return out

    losses, step_ms, step_peak = [], [], 0.0
    for _ in range(w["steps"]):
        out, ms, pk = _on_card(step, reps=0)
        losses.append(out.item())
        step_ms.append(ms)
        step_peak = max(step_peak, pk)
    _tf32(True)
    ms_tf32 = _time_ms(step, 1, 2)
    _tf32(False)
    med = float(np.median(step_ms[1:]))
    print(f"wav2vec2 (b) [{card}]: CTC fine-tuning of the same model, SGD lr "
          f"{w['lr']} on {tuple(xb.shape)}, {int(tlb.min())}-{int(tlb.max())} "
          f"tokens: losses {[round(v, 4) for v in losses]}; ms per step "
          f"{step_ms[0]:.1f} (first), median {med:.1f} (TF32 off), "
          f"{ms_tf32:.1f} ({TF32_STEP}); peak {step_peak:.0f} MiB; "
          f"{w['check'][0]} x {w['check'][1] / w['sr']:.0f} s vs the CPU copy: "
          f"loss rel {loss_err:.2e}, gradients {grad_err:.2e} of peak",
          flush=True)
    _check(all(math.isfinite(v) for v in losses), f"wav2vec2 (b): {losses}")
    _check(losses[-1] < losses[0], f"wav2vec2 (b): loss did not fall {losses}")
    _check(loss_err <= LOSS_RTOL and grad_err <= GRAD_PARITY,
           f"wav2vec2 (b) vs CPU: loss {loss_err}, gradients {grad_err}")
    return {"ctc_step_ms": step_ms, "ctc_step_ms_tf32": ms_tf32,
            "ctc_peak_mib": step_peak, "ctc_losses": losses,
            "ctc_loss_rel": loss_err, "ctc_grad_err": grad_err}


def _w2v2_hubert(gen: torch.Generator, card: str) -> dict:
    """Phase 22 (c): a HuBERT pretraining step (the module docstring)."""
    from torchaudio_contrib_tpu_torch import models
    w = W2V2
    model_cpu = models.hubert_pretrain_base(w["classes"], device="cpu",
                                            generator=gen)
    card_model = copy.deepcopy(model_cpu).cuda()
    n, samples = w["train"]
    x = _speech_batch(gen, n, samples, w["sr"])
    t_out = int(model_cpu.encoder.output_length(samples))
    mask = models.span_mask(gen, n, t_out, None, device="cuda")
    labels = torch.randint(0, w["classes"], (n, t_out), generator=gen)
    k = w["check"][0]
    loss = card_model.loss(x[:k].cuda(), labels[:k].cuda(), None, mask[:k])
    loss.backward()
    grads = _param_grads(card_model)
    cpu_loss = model_cpu.loss(x[:k], labels[:k], None, mask[:k].cpu())
    cpu_loss.backward()
    loss_err = abs(loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    grad_err = _grad_err(grads, _param_grads(model_cpu))

    xc, lc = x.cuda(), labels.cuda()
    opt = torch.optim.SGD(card_model.parameters(), lr=w["lr"])

    def step():
        out = card_model.loss(xc, lc, None, mask)
        opt.zero_grad()
        out.backward()
        opt.step()
        return out

    losses, step_ms, step_peak = [], [], 0.0
    for _ in range(3):
        out, ms, pk = _on_card(step, reps=0)
        losses.append(out.item())
        step_ms.append(ms)
        step_peak = max(step_peak, pk)
    _tf32(True)
    ms_tf32 = _time_ms(step, 1, 2)
    _tf32(False)
    print(f"wav2vec2 (c) [{card}]: hubert_pretrain_base({w['classes']}) on "
          f"{tuple(xc.shape)}, span mask covering "
          f"{mask.float().mean().item():.1%} of {t_out} frames: losses "
          f"{[round(v, 4) for v in losses]}; ms per step {step_ms[0]:.1f} "
          f"(first), median {float(np.median(step_ms[1:])):.1f} (TF32 off), "
          f"{ms_tf32:.1f} ({TF32_STEP}); peak {step_peak:.0f} MiB; {k} "
          f"clips vs the CPU copy with the same mask: loss rel "
          f"{loss_err:.2e}, gradients {grad_err:.2e} of peak", flush=True)
    _check(all(math.isfinite(v) for v in losses), f"wav2vec2 (c): {losses}")
    _check(0.3 < mask.float().mean().item() < 0.7,
           "wav2vec2 (c): span-mask coverage")
    _check(loss_err <= LOSS_RTOL and grad_err <= GRAD_PARITY,
           f"wav2vec2 (c) vs CPU: loss {loss_err}, gradients {grad_err}")
    return {"hubert_step_ms": step_ms, "hubert_step_ms_tf32": ms_tf32,
            "hubert_peak_mib": step_peak, "hubert_losses": losses,
            "hubert_loss_rel": loss_err, "hubert_grad_err": grad_err}


def _w2v2_fa(gen: torch.Generator, card: str) -> dict:
    """Phase 22 (d): ``MMS_FA`` emissions and forced alignment (the module
    docstring)."""
    from torchaudio_contrib_tpu_torch.pipelines import MMS_FA as bundle
    w = W2V2
    fa_cpu = bundle.get_model(generator=gen, device="cpu").eval()
    n_params = sum(p.numel() for p in fa_cpu.parameters())
    fa = copy.deepcopy(fa_cpu).cuda()
    n, samples = w["fa"]
    x = _speech_batch(gen, n, samples, w["sr"])
    xc = x.cuda()
    with torch.inference_mode():
        (em, out_len), ms, peak = _on_card(lambda: fa(xc), reps=2)
        _tf32(True)
        ms_tf32 = _time_ms(lambda: fa(xc), 1, 2)
        _tf32(False)
        em_cpu, _ = fa_cpu(x)
    err = _rel(em.cpu(), em_cpu)
    tokens = torch.randint(1, 28, (n, w["fa_tokens"]), generator=gen)
    aligner = bundle.get_aligner()
    t0 = time.perf_counter()
    spans = [aligner(em[i], tokens[i]) for i in range(n)]
    align_ms = (time.perf_counter() - t0) * 1e3
    spans_cpu = [aligner(em_cpu[i], tokens[i]) for i in range(n)]
    spans_same = [aligner(em_cpu[i].cuda(), tokens[i]) for i in range(n)]

    def key(rows):
        return [[(s.token, s.start, s.end) for s in r] for r in rows]

    print(f"wav2vec2 (d) [{card}]: MMS_FA ({n_params} parameters) on "
          f"{tuple(x.shape)} -> emissions {tuple(em.shape)} (star column "
          f"included); ms {ms:.1f} (TF32 off), {ms_tf32:.1f} ({TF32_FWD}), "
          f"peak {peak:.0f} MiB; vs CPU {err:.2e} of peak; "
          f"{w['fa_tokens']} tokens a clip aligned in {align_ms:.0f} ms; "
          f"spans equal to the CPU "
          f"path's: {key(spans) == key(spans_cpu)}; first spans "
          f"{spans[0][:3]}", flush=True)
    _check(bool(torch.isfinite(em).all()) and not em[..., -1].any(),
           "wav2vec2 (d): emissions or star column")
    _check(err <= W2V2_REL, f"wav2vec2 (d) vs CPU: {err}")
    _check(key(spans_same) == key(spans_cpu),
           "wav2vec2 (d): the card's Viterbi on the CPU's emissions")
    _check(key(spans) == key(spans_cpu), "wav2vec2 (d): spans vs the CPU's")
    _check(all([s.token for s in r] == t.tolist()
               for r, t in zip(spans, tokens)), "wav2vec2 (d): tokens")
    return {"fa_params": n_params, "fa_ms": ms, "fa_ms_tf32": ms_tf32,
            "fa_rel": err, "fa_align_ms": align_ms}


def _w2v2_ssl(gen: torch.Generator, card: str) -> dict:
    """Phase 22 (e): WavLM, the Conformer and the streaming Emformer
    variants against CPU copies (the module docstring)."""
    from torchaudio_contrib_tpu_torch import models
    from torchaudio_contrib_tpu_torch.pipelines import WAVLM_BASE
    w = W2V2
    n, samples = w["ssl"]
    x = _speech_batch(gen, n, samples, w["sr"])
    nums = {}

    def pair(name, model_cpu, inp):
        model = copy.deepcopy(model_cpu).cuda()
        xc = inp.cuda()
        with torch.inference_mode():
            (out, _), ms, _ = _on_card(lambda: model(xc), reps=2)
            _tf32(True)
            ms_tf32 = _time_ms(lambda: model(xc), 1, 2)
            _tf32(False)
            want, _ = model_cpu(inp)
        err = _rel(out.cpu(), want)
        nums[name + "_ms"], nums[name + "_ms_tf32"] = ms, ms_tf32
        nums[name + "_rel"] = err
        print(f"wav2vec2 (e) [{card}]: {name} on {tuple(inp.shape)} -> "
              f"{tuple(out.shape)} in {ms:.1f} ms ({ms_tf32:.1f}, "
              f"{TF32_FWD}); vs CPU {err:.2e} of peak", flush=True)
        _check(bool(torch.isfinite(out).all()) and err <= W2V2_REL,
               f"wav2vec2 (e) {name} vs CPU: {err}")
        return model, out

    pair("wavlm_base", WAVLM_BASE.get_model(gen, device="cpu").eval(), x)
    feats = torch.randn((n, w["conf_frames"], 64), generator=gen)
    pair("conformer_wav2vec2_base", models.conformer_wav2vec2_base(
        device="cpu", generator=gen).eval(), feats)
    emf_cpu = models.emformer_hubert_base(device="cpu", generator=gen).eval()
    S, R = emf_cpu.encoder.S, emf_cpu.encoder.R
    st, nseg = emf_cpu.stride, w["emf_segments"]
    feats = torch.randn((n, (nseg * S + R) * st, 80), generator=gen)
    emf, full = pair("emformer_hubert_base", emf_cpu, feats)
    fc = feats.cuda()

    def stream():
        state, outs = emf.init_state(n), []
        for i in range(nseg):
            o, _, state = emf.infer(fc[:, i * S * st:(i * S + S + R) * st],
                                    state)
            outs.append(o)
        return torch.cat(outs, 1)

    with torch.inference_mode():
        streamed, ms, _ = _on_card(stream, reps=0)
        _tf32(True)
        _, ms_tf32, _ = _on_card(stream, reps=0)
        _tf32(False)
    err = _rel(streamed, full)
    nums["emformer_stream_ms"], nums["emformer_stream_rel"] = ms, err
    nums["emformer_stream_ms_tf32"] = ms_tf32
    print(f"wav2vec2 (e) [{card}]: emformer_hubert_base streamed, {nseg} "
          f"segments of {S} + {R} reduced frames: {ms:.1f} ms "
          f"({ms / nseg:.2f} a segment; {ms_tf32:.1f}, {TF32_FWD}); vs "
          f"one-shot {err:.2e} of peak", flush=True)
    _check(err <= W2V2_REL, f"wav2vec2 (e): streamed vs one-shot {err}")
    return nums


def phase_wav2vec2(gen: torch.Generator, card: str) -> None:
    """Phase 22: the wav2vec2 family at full width (the module docstring);
    no kernel, so the launch counters must not move."""
    _tf32(False)
    before = _kernel_count()
    serve, model_cpu = _w2v2_serve(gen, card)
    torch.cuda.empty_cache()
    ctc = _w2v2_ctc(gen, card, model_cpu)
    del model_cpu
    torch.cuda.empty_cache()
    hubert = _w2v2_hubert(gen, card)
    torch.cuda.empty_cache()
    fa = _w2v2_fa(gen, card)
    torch.cuda.empty_cache()
    ssl = _w2v2_ssl(gen, card)
    torch.cuda.empty_cache()
    moved = _kernel_count() - before
    print("wav2vec2 family [" + card + "]: " + json.dumps(
        {**serve, **ctc, **hubert, **fa, **ssl, "kernel_launches": moved}),
        flush=True)
    _check(moved == 0, f"phase 22 moved the kernel counters by {moved}")


@contextlib.contextmanager
def _default_flags():
    """PyTorch's default precision flags for the block (cuDNN TF32 on,
    cuBLAS TF32 off); both off again after it."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        _tf32(False)


def _wavernn_block() -> int:
    """Steps of Gumbel noise ``WaveRNN.infer`` draws at a time."""
    from torchaudio_contrib_tpu_torch.models import wavernn
    return wavernn._NOISE_BLOCK


def _taco_check(taco, taco_cpu, ids, lengths, steps: int, part: str,
                card: str) -> tuple:
    """Tacotron2 ``infer`` on the card against its CPU copy: mel, postnet,
    stop logits and alignments over the whole horizon at TTS_REL, and
    equal lengths; a failure prints the mel's drift by step.  Returns (the
    card's outputs, the CPU's, numbers)."""
    idc, lc = ids.cuda(), lengths.cuda()
    with torch.inference_mode():
        out, ms, peak = _on_card(lambda: taco.infer(idc, lc, steps), reps=2)
        t0 = time.perf_counter()
        out_cpu = taco_cpu.infer(ids, lengths, steps)
        cpu_s = time.perf_counter() - t0
    errs = [_rel(g.cpu().float(), w.float()) for g, w in
            zip(out[:4], out_cpu[:4])]
    same_len = out[4].tolist() == out_cpu[4].tolist()
    nums = {f"{part}_ms": ms, f"{part}_ms_per_step": ms / steps,
            f"{part}_peak_mib": peak, f"{part}_cpu_s": cpu_s,
            f"{part}_errs": errs, f"{part}_lengths": out[4].tolist()}
    print(f"TTS {part} [{card}]: Tacotron2 infer({steps}) of "
          f"{tuple(ids.shape)} ids ({lengths.tolist()} long) -> mel "
          f"{tuple(out[0].shape)}; {ms:.1f} ms ({ms / steps:.3f} a step), "
          f"peak {peak:.0f} MiB; the CPU copy {cpu_s:.1f} s; vs CPU (mel, "
          f"postnet, stop, alignments) "
          f"{', '.join(f'{e:.2e}' for e in errs)} of peak; lengths "
          f"{out[4].tolist()} (CPU {out_cpu[4].tolist()})", flush=True)
    _check(bool(torch.isfinite(out[1]).all()), f"TTS {part}: not finite")
    if not (max(errs) <= TTS_REL and same_len):
        # the mel's error at each step, relative to the CPU mel's peak
        drift = ((out[0].cpu() - out_cpu[0]).abs().amax((0, 1))
                 / out_cpu[0].abs().max())
        _check(False, f"TTS {part}: vs CPU {errs} of peak (bar "
               f"{TTS_REL}), lengths {out[4].tolist()} vs "
               f"{out_cpu[4].tolist()}; the mel's drift by step "
               f"{[f'{d:.1e}' for d in drift.tolist()]}")
    return out, out_cpu, nums


def _tts_char(gen: torch.Generator, card: str) -> tuple:
    """Phase 23 (a): TACOTRON2_WAVERNN_CHAR_LJSPEECH: the texts through
    the processor and Tacotron2 ``infer``, then WaveRNN ``infer`` (``fc3``
    made confident) on each clip's first frames, card vs CPU copy.
    Returns (numbers, the bundle's models on the card and the CPU)."""
    from torchaudio_contrib_tpu_torch.pipelines import \
        TACOTRON2_WAVERNN_CHAR_LJSPEECH as bundle
    ids, lengths = (torch.from_numpy(a) for a in
                    bundle.get_text_processor()(TTS_TEXTS))
    taco_cpu = bundle.get_tacotron2(gen, device="cpu")
    taco = copy.deepcopy(taco_cpu).cuda()
    n_taco = sum(p.numel() for p in taco.parameters())
    out, out_cpu, nums = _taco_check(taco, taco_cpu, ids, lengths,
                                     TTS["steps"], "(a)", card)

    voc_cpu = bundle.get_vocoder(gen, device="cpu")
    n_voc = sum(p.numel() for p in voc_cpu.parameters())
    with torch.no_grad():
        voc_cpu.fc3.weight.mul_(TTS["confident"])
    voc = copy.deepcopy(voc_cpu).cuda()
    spec = out_cpu[1][..., :TTS["wavernn_frames"]].contiguous()
    state = gen.get_state()

    def stream() -> torch.Generator:
        g = torch.Generator()
        g.set_state(state)
        return g

    with torch.inference_mode():
        # the Gumbel noise is drawn on the generator's device (the CPU)
        # and moved: the card draws from the shared generator, the CPU
        # copy from a generator in the same state, so both add the same
        # noise
        wav, ms, peak = _on_card(lambda: voc.infer(spec.cuda(), gen),
                                 reps=0)
        t0 = time.perf_counter()
        wav_cpu = voc_cpu.infer(spec, stream())
        cpu_s = time.perf_counter() - t0
        B, T = wav.shape
        g = stream()
        noise = torch.cat([voc_cpu._gumbel(g, min(_wavernn_block(), T - t),
                                           B, "cpu")
                           for t in range(0, T, _wavernn_block())])
        noise = noise.transpose(0, 1)                       # (B, T, classes)
        history = torch.cat([torch.zeros(B, 1), wav_cpu[:, :-1]], 1)
        logits_cpu = voc_cpu(history, spec)
        logits = voc(history.cuda(), spec.cuda()).cpu()
    # each step's scores (logits + noise) on the CPU's history: where the
    # CPU's top-2 margin exceeds twice the card's measured logit error the
    # two must pick the same class, and up to each clip's first step
    # without such a margin (a near-tie) the card's samples must equal the
    # CPU copy's
    logit_err = (logits - logits_cpu).abs().max().item()
    scores_cpu = logits_cpu + noise
    top2 = scores_cpu.topk(2, -1).values
    margin = top2[..., 0] - top2[..., 1]
    clear = margin > 2 * logit_err
    picks_differ = int(((logits + noise).argmax(-1)
                        != scores_cpu.argmax(-1))[clear].sum())
    first_tie = [int((~c).nonzero()[0]) if (~c).any() else T for c in clear]
    unequal = sum(int((wav[b, :n].cpu() != wav_cpu[b, :n]).sum())
                  for b, n in enumerate(first_tie))
    near_ties = int((~clear).sum())
    nums.update({"tacotron2_params": n_taco, "wavernn_params": n_voc,
                 "wavernn_infer_ms": ms,
                 "wavernn_samples_per_s": B * T / ms * 1e3,
                 "wavernn_infer_peak_mib": peak,
                 "wavernn_infer_cpu_s": cpu_s,
                 "wavernn_unequal_samples": unequal,
                 "wavernn_samples_held": sum(first_tie),
                 "wavernn_near_ties": near_ties,
                 "wavernn_picks_differ": picks_differ,
                 "wavernn_min_margin": float(margin.min()),
                 "wavernn_logit_abs_err": logit_err})
    print(f"TTS (a) [{card}]: TACOTRON2_WAVERNN_CHAR_LJSPEECH, Tacotron2 "
          f"{n_taco} parameters, WaveRNN {n_voc} (n_rnn 512, hop 275, fc3 "
          f"x{TTS['confident']:g}); WaveRNN infer on {tuple(spec.shape)} -> "
          f"{tuple(wav.shape)} in {ms:.0f} ms ({B * T / ms * 1e3:.0f} "
          f"samples/s, {ms / T:.3f} ms a step), peak {peak:.0f} MiB; the CPU "
          f"copy {cpu_s:.1f} s; on the CPU's history: card vs CPU logits "
          f"{logit_err:.2e} abs, least top-2 score margin "
          f"{float(margin.min()):.3f}, {near_ties} near-ties (margin <= "
          f"2x the error; first per clip {first_tie}), {picks_differ} other "
          f"picks differ; samples up to the first near-tie "
          f"({sum(first_tie)} of {B * T}): {unequal} unequal to the CPU's",
          flush=True)
    _check(unequal == 0 and picks_differ == 0,
           f"TTS (a): WaveRNN: {unequal} samples differ before a near-tie, "
           f"{picks_differ} clear picks differ (logit error {logit_err})")
    return nums, (taco, taco_cpu, voc, voc_cpu)


def _tts_teacher_forced(gen: torch.Generator, card: str, models) -> dict:
    """Phase 23 (b): Tacotron2 ``apply`` on 8 × (120 tokens, 800 frames)
    and WaveRNN ``apply`` on 4 × 1 s, card vs CPU copy, with one profiler
    window over the Tacotron2 loop."""
    from torchaudio_contrib_tpu_torch.benchmarks import trace_kernels
    taco, taco_cpu, voc, voc_cpu = models
    B, S, T = TTS["tf"]
    k = TTS["tf_check"]
    ids = torch.randint(1, taco.n_symbols, (B, S), generator=gen)
    lengths = torch.full((B,), S)
    mels = torch.randn((B, taco.n_mels, T), generator=gen)
    idc, lc, mc = ids.cuda(), lengths.cuda(), mels.cuda()
    with torch.inference_mode():
        out, ms, peak = _on_card(lambda: taco.apply(idc, lc, mc), reps=2)
        out_cpu = taco_cpu.apply(ids[:k], lengths[:k], mels[:k])
        trace = trace_kernels(lambda: taco.apply(idc, lc, mc), calls=1,
                              warmup=0, top=5, part="tacotron2 apply")
    errs = [_rel(g[:k].cpu(), w) for g, w in zip(out, out_cpu)]
    Bw, Tm = TTS["wavernn_apply"]
    samples = 275 * (Tm - 4)
    spec = torch.randn((Bw, 80, Tm), generator=gen)
    wav = torch.rand((Bw, samples), generator=gen) * 2 - 1
    with torch.inference_mode():
        logits, wms, wpeak = _on_card(lambda: voc.apply(wav.cuda(),
                                                        spec.cuda()), reps=2)
        logits_cpu = voc_cpu.apply(wav, spec)
    werr = _rel(logits.cpu(), logits_cpu)
    nums = {"tf_ms": ms, "tf_ms_per_frame": ms / T, "tf_peak_mib": peak,
            "tf_errs": errs, "tf_busy_ms": trace["busy_ms"],
            "tf_window_ms": trace["window_ms"],
            "tf_idle_share": trace["idle_share"], "wavernn_apply_ms": wms,
            "wavernn_apply_peak_mib": wpeak, "wavernn_apply_err": werr}
    print(f"TTS (b) [{card}]: Tacotron2 apply on {B} x ({S} tokens, {T} "
          f"frames): {ms:.0f} ms ({ms / T:.3f} a frame), peak {peak:.0f} "
          f"MiB, busy {trace['busy_ms']:.1f} ms of a {trace['window_ms']:.0f}"
          f" ms window (idle {trace['idle_share']:.1%}); {k} clips vs CPU "
          f"{', '.join(f'{e:.2e}' for e in errs)} of peak; WaveRNN apply on "
          f"{Bw} x {samples} samples: {wms:.1f} ms, peak {wpeak:.0f} MiB, "
          f"logits vs CPU {werr:.2e} of peak", flush=True)
    _check(max(errs) <= TTS_REL and werr <= TTS_REL,
           f"TTS (b) vs CPU: Tacotron2 {errs}, WaveRNN {werr}")
    return nums


def _conv_flops(model, x) -> float:
    """Multiply-adds × 2 of every ``Conv1d``/``ConvTranspose1d`` in one
    forward of ``model`` on ``x``, from the shapes each one sees."""
    total = [0.0]

    def hook(mod, args, out):
        cin, k = mod.in_channels, mod.kernel_size[0]
        cout = mod.out_channels // mod.groups
        steps = args[0].shape[-1] if isinstance(
            mod, torch.nn.ConvTranspose1d) else out.shape[-1]
        total[0] += 2.0 * out.shape[0] * cin * cout * k * steps

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv1d, torch.nn.ConvTranspose1d))]
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def _tts_hifigan(gen: torch.Generator, card: str) -> dict:
    """Phase 23 (c): HIFIGAN_VOCODER_V3_LJSPEECH's log-mel of 4 × 10 s and
    its vocoder, and ``hifigan_vocoder_v1`` on the same mel, card vs CPU
    copy (on one clip; v1 on its first second)."""
    from torchaudio_contrib_tpu_torch import models as M
    from torchaudio_contrib_tpu_torch.pipelines import \
        HIFIGAN_VOCODER_V3_LJSPEECH as bundle
    B, n = TTS["hifi"]
    x = _speech_batch(gen, B, n, bundle.sample_rate)
    tf_cpu = bundle.get_mel_transform(device="cpu")
    tf = bundle.get_mel_transform()
    voc_cpu = bundle.get_vocoder(gen, device="cpu")
    voc = copy.deepcopy(voc_cpu).cuda()
    v1_cpu = M.hifigan_vocoder_v1(device="cpu", generator=gen).eval()
    v1 = copy.deepcopy(v1_cpu).cuda()
    xc = x.cuda()
    with torch.inference_mode():
        mel, mel_ms, _ = _on_card(lambda: tf(xc))
        mel_err = _rel(mel.cpu(), tf_cpu(x))
        wav, ms, peak = _on_card(lambda: voc(mel))
        wav_cpu = voc_cpu(mel[:1].cpu())
        v1_wav, v1_ms, v1_peak = _on_card(lambda: v1(mel), reps=2)
        f1 = TTS["v1_check_frames"]
        v1_err = _rel(v1(mel[:1, :, :f1]).cpu(), v1_cpu(mel[:1, :, :f1].cpu()))
    err = _rel(wav[:1].cpu(), wav_cpu)
    frames = mel.shape[-1]
    flops, v1_flops = _conv_flops(voc, mel), _conv_flops(v1, mel)
    weights = sum(p.numel() * 4 for p in voc.parameters())
    bound = max(flops / PEAK_FP32, (mel.numel() * 4 + wav.numel() * 4
                                    + weights) / PEAK_BYTES) * 1e3
    v1_bound = v1_flops / PEAK_FP32 * 1e3
    nums = {"hifi_mel_ms": mel_ms, "hifi_mel_err": mel_err,
            "hifi_v3_ms": ms, "hifi_v3_peak_mib": peak, "hifi_v3_err": err,
            "hifi_v3_gflop": flops / 1e9, "hifi_v3_fp32_bound_ms": bound,
            "hifi_v1_ms": v1_ms, "hifi_v1_peak_mib": v1_peak,
            "hifi_v1_err": v1_err, "hifi_v1_gflop": v1_flops / 1e9,
            "hifi_v1_fp32_bound_ms": v1_bound}
    print(f"TTS (c) [{card}]: HIFIGAN_VOCODER_V3_LJSPEECH: log-mel of "
          f"{tuple(x.shape)} at {bundle.sample_rate} Hz -> {tuple(mel.shape)}"
          f" in {mel_ms:.2f} ms (vs CPU {mel_err:.2e} of peak); v3 "
          f"({sum(p.numel() for p in voc.parameters())} parameters) -> "
          f"{tuple(wav.shape)} in {ms:.2f} ms, {flops / 1e9:.1f} GFLOP "
          f"({flops / ms / 1e9:.1f} TFLOP/s; FP32 bound {bound:.2f} ms), "
          f"peak {peak:.0f} MiB, clip 0 vs CPU {err:.2e} of peak; v1 (512 "
          f"channels, {sum(p.numel() for p in v1.parameters())} parameters)"
          f" {v1_ms:.1f} ms, {v1_flops / 1e9:.0f} GFLOP "
          f"({v1_flops / v1_ms / 1e9:.1f} TFLOP/s; FP32 bound "
          f"{v1_bound:.1f} ms), peak {v1_peak:.0f} MiB, "
          f"{f1} frames vs CPU {v1_err:.2e}", flush=True)
    _check(wav.shape == (B, 1, frames * 256) and frames == n // 256
           and v1_wav.shape == wav.shape
           and bool(torch.isfinite(wav).all()), "TTS (c): shapes")
    _check(max(mel_err, err, v1_err) <= TTS_REL,
           f"TTS (c) vs CPU: mel {mel_err}, v3 {err}, v1 {v1_err}")
    _check(bound <= ms and v1_bound <= v1_ms, "TTS (c): a bound over a time")
    return nums


def _tts_griffinlim(gen: torch.Generator, card: str) -> tuple:
    """Phase 23 (d): TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH on (a)'s texts: the
    bundle's vocoder (``mel_to_audio``'s ``matmul`` loop) on the card and
    the CPU copy, and the same mel through ``method="pallas"`` (B3).
    Returns (numbers, B3's launches on the path, B3's launches timing
    it)."""
    from torchaudio_contrib_tpu_torch import ops, pipelines
    from torchaudio_contrib_tpu_torch.pipelines import \
        TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH as bundle
    ids, lengths = (torch.from_numpy(a) for a in
                    bundle.get_text_processor()(TTS_TEXTS))
    taco_cpu = bundle.get_tacotron2(gen, device="cpu")
    taco = copy.deepcopy(taco_cpu).cuda()
    out, out_cpu, nums = _taco_check(taco, taco_cpu, ids, lengths,
                                     TTS["steps"], "(d)", card)
    vocoder = bundle.get_vocoder()
    post = out[1]
    warm, iters = 1, 3
    with torch.inference_mode():
        (wave, wl), ms, peak = _on_card(lambda: vocoder(post, out[4]),
                                        reps=0)
        t0 = time.perf_counter()
        wave_cpu, _ = vocoder(post.cpu(), out[4].cpu())
        cpu_s = time.perf_counter() - t0
        # the vocoder's settings at a few iterations, card vs CPU copy per
        # sample, from a random phase drawn on the CPU (the card from the
        # shared generator, the CPU copy from one in the same state): from
        # the vocoder's zero phase a near-stationary mel, as a random
        # Tacotron2 makes, keeps the spectrum almost real, and which bins
        # flip sign is the luck of rounding (printed: card vs CPU, and the
        # CPU copy against itself with the mel nudged by 1e-7)
        short = pipelines._GriffinLimVocoder(n_iter=TTS["gl_short_iter"])
        state = gen.get_state()
        phase_cpu = torch.Generator()
        phase_cpu.set_state(state)
        short_err = _rel(short(post, generator=gen)[0].cpu(),
                         short(post.cpu(), generator=phase_cpu)[0])
        zero_cpu = short(post.cpu())[0]
        zero_err = _rel(short(post)[0].cpu(), zero_cpu)
        nudged = post.cpu() * (1 + 1e-7 * torch.randn(post.shape,
                                                      generator=gen))
        zero_nudged = _rel(short(nudged)[0], zero_cpu)
        inv = ops.create_inverse_mel_filter(
            VOCODER["num_mels"], VOCODER["sample_rate"], 0.0,
            VOCODER["f_max"], VOCODER["fft_length"] // 2 + 1, 1e-8,
            device="cuda")
        mag = ops.mel_to_linear(torch.exp(post), inv)
        _check(_gl_counts() == (0, 0) and _gl_fft_count() == 0,
               f"TTS (d): B3/B4 launched before method='pallas': "
               f"{_gl_counts()}, FFT route {_gl_fft_count()}")
        _reset_gl_counts()
        fused, fused_ms, fused_peak = _on_card(lambda: ops.mel_to_audio(
            torch.exp(post), **VOCODER, method="pallas"), reps=0)
        launches, tile_major = _gl_counts()
        on_fft = _gl_fft_count()
        # warm times (the first calls above build the inverse filterbank's
        # pseudo-inverse and the solver's constants on the card)
        ms = _time_ms(lambda: vocoder(post, out[4]), warm, iters)
        fused_ms = _time_ms(lambda: ops.mel_to_audio(
            torch.exp(post), **VOCODER, method="pallas"), warm, iters)
    n_fft, hop = VOCODER["fft_length"], VOCODER["hop_length"]
    conv = _convergence(wave, mag, n_fft, hop)
    conv_cpu = _convergence(wave_cpu.cuda(), mag, n_fft, hop)
    conv_fused = _convergence(fused, mag, n_fft, hop)
    wave_err = _rel(wave.cpu(), wave_cpu)
    nums.update({"gl_matmul_ms": ms, "gl_matmul_peak_mib": peak,
                 "gl_matmul_cpu_s": cpu_s, "gl_pallas_ms": fused_ms,
                 "gl_pallas_peak_mib": fused_peak,
                 "gl_convergence": conv, "gl_convergence_cpu": conv_cpu,
                 "gl_convergence_pallas": conv_fused,
                 "gl_wave_err_vs_cpu": wave_err,
                 "gl_short_wave_err_vs_cpu": short_err,
                 "gl_short_zero_phase_err_vs_cpu": zero_err,
                 "gl_short_zero_phase_nudged_cpu": zero_nudged,
                 "gl_pallas_launches": launches,
                 "gl_pallas_fft_launches": on_fft})
    print(f"TTS (d) [{card}]: TACOTRON2_GRIFFINLIM_CHAR_LJSPEECH: "
          f"{tuple(post.shape)} mel -> {tuple(wave.shape)}, lengths "
          f"{wl.tolist()}; the bundle's vocoder (matmul, "
          f"{VOCODER['n_iter']} iterations) {ms:.1f} ms, peak {peak:.0f} "
          f"MiB, the CPU copy {cpu_s:.1f} s; method='pallas' (B3) "
          f"{fused_ms:.2f} ms, peak {fused_peak:.0f} MiB, {launches} launch "
          f"({on_fft} on the FFT route, {tile_major} tile-major); spectral "
          f"convergence: card {conv:.4f}, CPU copy {conv_cpu:.4f}, B3 "
          f"{conv_fused:.4f}; waveform vs the CPU copy: "
          f"{TTS['gl_short_iter']} iterations from a random phase "
          f"{short_err:.2e} of peak; from zero phase "
          f"{TTS['gl_short_iter']} iterations {zero_err:.2e} (the CPU copy "
          f"with the mel nudged by 1e-7: {zero_nudged:.2e}), "
          f"{VOCODER['n_iter']} iterations {wave_err:.2e} (held by "
          f"convergence)", flush=True)
    _check(launches == 1 and on_fft == 1 and tile_major == 0,
           f"TTS (d): B3 launches {launches}, FFT route {on_fft}, B4 "
           f"{tile_major}")
    _check(bool(torch.isfinite(wave).all() and torch.isfinite(fused).all()),
           "TTS (d): not finite")
    _check(short_err <= TTS_REL,
           f"TTS (d): {TTS['gl_short_iter']} iterations vs the CPU copy "
           f"{short_err} of peak")
    _check(abs(conv - conv_cpu) <= TTS_GL_CONV_GAP
           and conv_fused <= conv + GL_CONV_SLACK,
           f"TTS (d): convergence card {conv}, CPU {conv_cpu}, B3 "
           f"{conv_fused}")
    return nums, launches, warm + iters


def _tts_phone(gen: torch.Generator, card: str) -> dict:
    """Phase 23 (e): TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH over a CMU
    dictionary of TTS_CMUDICT's words written to a temporary directory:
    the ids against TTS_PHONE_IDS (counted by hand), Tacotron2 and the
    vocoder on the card, Tacotron2 against its CPU copy."""
    import tempfile
    from torchaudio_contrib_tpu_torch.pipelines import \
        TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH as bundle
    with tempfile.TemporaryDirectory() as root:
        Path(root, "cmudict-0.7b").write_text(
            ";;; words for the smoke\n" + "".join(
                f"{w}  {p}\n" for w, p in TTS_CMUDICT.items()),
            encoding="latin-1")
        proc = bundle.get_text_processor(root=root)
    texts = [TTS_PHONE_TEXT] + [" ".join(list(TTS_CMUDICT)[i::3]).lower()
                                for i in range(3)]
    ids, lengths = (torch.from_numpy(a) for a in proc(texts))
    # the other texts, word by word from the same table
    index = {s: i for i, s in enumerate(proc.symbols)}
    for r, text in enumerate(texts[1:], 1):
        want = []
        for w in text.upper().split():
            want += ([index[" "]] if want else []) + [
                index[p] for p in TTS_CMUDICT[w].split()]
        _check(ids[r, :lengths[r]].tolist() == want,
               f"TTS (e): ids of text {r}")
    _check(ids[0, :lengths[0]].tolist() == TTS_PHONE_IDS,
           f"TTS (e): ids {ids[0, :lengths[0]].tolist()}")
    taco_cpu = bundle.get_tacotron2(gen, device="cpu")
    taco = copy.deepcopy(taco_cpu).cuda()
    out, _, nums = _taco_check(taco, taco_cpu, ids, lengths,
                               TTS["phone_steps"], "(e)", card)
    with torch.inference_mode():
        (wave, wl), ms, _ = _on_card(lambda: bundle.get_vocoder()(
            out[1], out[4]), reps=0)
    nums.update({"phone_symbols": len(proc.symbols),
                 "phone_ids": lengths.tolist(), "phone_vocoder_ms": ms})
    print(f"TTS (e) [{card}]: TACOTRON2_GRIFFINLIM_PHONE_LJSPEECH over a "
          f"{len(TTS_CMUDICT)}-word cmudict-0.7b: {len(texts)} texts -> ids "
          f"{tuple(ids.shape)} ({lengths.tolist()} long, text 0 equal to the "
          f"hand count), {len(proc.symbols)} symbols; the vocoder "
          f"{tuple(wave.shape)} in {ms:.1f} ms", flush=True)
    _check(bool(torch.isfinite(wave).all()), "TTS (e): not finite")
    return nums


def phase_tts(gen: torch.Generator, card: str) -> int:
    """Phase 23: the TTS family at full width with the global precision
    flags at PyTorch's defaults (the module docstring), every counter set
    to 0 before it.  Returns B3's launches in (d); no other kernel may be
    launched, and B3 only by (d)'s launch and the calls that time it."""
    _reset_counts()
    _reset_gl_counts()
    with _default_flags():
        char, models = _tts_char(gen, card)
        tf = _tts_teacher_forced(gen, card, models)
        del models
        torch.cuda.empty_cache()
        hifi = _tts_hifigan(gen, card)
        torch.cuda.empty_cache()
        # (d) resets B3's counters just before its one launch and reads
        # them just after
        gl, b3, b3_timing = _tts_griffinlim(gen, card)
        torch.cuda.empty_cache()
        phone = _tts_phone(gen, card)
        torch.cuda.empty_cache()
    mel = (_counts(), _fft_counts())
    gl_after = (_gl_counts(), _gl_fft_count())
    print("TTS family [" + card + "]: " + json.dumps(
        {**char, **tf, **hifi, **gl, **phone, "b3_launches": b3}),
        flush=True)
    _check(mel == ((0, 0, 0), (0, 0)),
           f"phase 23 launched the mel kernels: {mel}")
    _check(gl_after == ((b3 + b3_timing, 0), b3 + b3_timing),
           f"phase 23: B3/B4 counters {gl_after} since (d)'s reset, not "
           f"its {b3} launch and the {b3_timing} that time it")
    return b3


def _mel_bounds(x, mels: int, n_fft: int, hop: int) -> tuple:
    """The bounds of the fused mel forward and backward at ``x (B, 1, T)``.
    The function: one real transform per frame (an FFT's operations) plus
    the mel products over the ``n_fft//2 + 1`` bins there are, in FP32;
    each input read once and each output written once.  ``design_flop_ms``
    is for the FFT kernels' own count: one complex transform per two
    frames, splitting the pair (12 operations a bin), and the mel products
    over the bins padded to groups of 4 (forward) or to the 64-bin tiles
    (backward) and the mels padded to 64.  ``dft_design_flop_ms`` is for
    the DFT-product kernels: the transform as a matrix product over their
    padded 64-bin tiles."""
    rows = x.shape[0] * (1 + (x.shape[-1] - n_fft) // hop)
    n_freqs = n_fft // 2 + 1
    ft = -(-n_freqs // 64)
    m_pad = -(-mels // 64) * 64
    fft, mel = rows * _fft_flops(n_fft), 2.0 * rows * n_freqs * mels
    split = 12.0 * rows * n_freqs
    mel_quads = 2.0 * rows * 4 * -(-n_freqs // 4) * m_pad
    dft = 2.0 * rows * n_fft * ft * 128
    mel_pad = 2.0 * rows * ft * 64 * m_pad
    fb = n_freqs * mels
    fwd = _bound(fft + mel, 4 * (x.numel() + fb + rows * mels),
                 fft + split + mel_quads)
    bwd = _bound(fft + 2 * mel, 4 * (rows * mels + rows * 2 * n_freqs + fb
                                     + rows * n_fft + fb),
                 fft + split + 2 * mel_pad)
    fwd["dft_design_flop_ms"] = (dft + mel_pad) / PEAK_FP32 * 1e3
    bwd["dft_design_flop_ms"] = (dft + 2 * mel_pad) / PEAK_FP32 * 1e3
    return fwd, bwd


def main() -> None:
    card = phase_device()
    phase_build()
    gen = torch.Generator().manual_seed(0)
    phase_parity(gen)
    phase_grad_parity(gen)
    launches, cfg2_run, serving_run = phase_main_path(gen)
    stats = phase_config2(*cfg2_run, card)
    phase_serving(*serving_run)
    train_counts, cfg2_train, cfg3_train = phase_train_path(gen)
    _, bwd_stats = phase_config2_train(*cfg2_train, card)
    phase_config3(*cfg3_train, card)
    fwd_bound, bwd_bound = _mel_bounds(cfg2_run[1], CFG2["mels"], CFG2["fft"],
                                       CFG2["hop"])
    del cfg2_run, serving_run, cfg2_train, cfg3_train
    torch.cuda.empty_cache()
    phase_gl_parity(gen)
    gl_launches, gl_fft_launches, gl_run, probes, bisect = \
        phase_inverse_path(gen)
    phase_gl_full(*gl_run)
    phase_config4(gen)
    gl_stats = phase_gl_timings(gen, card, probes, bisect)
    torch.cuda.empty_cache()
    phase_repairs(gen)
    torch.cuda.empty_cache()
    corpus = phase_corpus(gen, card)
    phase_ops_on_card(gen)
    iir_launches = phase_iir(gen, card)
    torch.cuda.empty_cache()
    asr_launches = phase_asr(gen, card)
    torch.cuda.empty_cache()
    phase_transducer(gen, card)
    torch.cuda.empty_cache()
    phase_wav2vec2(gen, card)
    torch.cuda.empty_cache()
    tts_launches = phase_tts(gen, card)
    source = "torchaudio_contrib_tpu_torch/csrc/"
    gl_file = "torchaudio_contrib_tpu/ops/fused_griffinlim.py"
    kernels = [
        {"name": "fused_mel_fwd", "route": "cuda",
         "source": source + "fused_mel_fwd.cu",
         "headers": [source + "fft_smem.cuh"],
         "replaces": "torchaudio_contrib_tpu/ops/fused.py:440",
         "launches": launches + train_counts[0] + corpus["launches"]
         + iir_launches + asr_launches,
         "corpus_launches": corpus["launches"],
         "iir_pipeline_launches": iir_launches,
         "asr_launches": asr_launches,
         "corpus_ms_per_batch": corpus["b1_ms_per_batch"],
         **stats, **fwd_bound},
        {"name": "fused_mel_bwd", "route": "cuda",
         "source": source + "fused_mel_bwd.cu",
         "headers": [source + "fft_smem.cuh"],
         "replaces": "torchaudio_contrib_tpu/ops/fused.py:604",
         "launches": train_counts[1], **bwd_stats, **bwd_bound},
    ] + [
        {"name": name, "route": "cuda", "source": source + "fused_gl.cu",
         "headers": [source + "fft_smem.cuh"], "replaces": replaces,
         "launches": n, "fft_launches": on_fft, "dft_launches": n - on_fft,
         **entry}
        for name, replaces, n, on_fft, entry in zip(
            ("fused_gl", "fused_gl_tile_major", "fused_gl_bisect"),
            (gl_file + ":132", gl_file + ":261",
             "benchmarks/r3_gl_bisect.py:97"),
            (gl_launches[0] + tts_launches,) + tuple(gl_launches[1:]),
            (gl_fft_launches[0] + tts_launches,) + tuple(gl_fft_launches[1:]),
            gl_stats)
    ]
    kernels[2]["tts_launches"] = tts_launches
    for k in kernels:
        # a bound over a time measured for the same function is no bound
        _check(0 < k["bound_ms"] <= min(k["ms"], k["plain_ms"]),
               f"{k['name']}: bound {k['bound_ms']} ms over a measured time")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
