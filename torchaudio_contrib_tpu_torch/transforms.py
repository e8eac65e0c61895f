"""``torchaudio.transforms``-shaped namespace.

The port of the JAX package's ``transforms``: a migration alias so code
written as ``import torchaudio.transforms as T`` ports by changing only the
package name.  Every name is the same class as the flat package export
(:mod:`.models.transforms` and :mod:`.models.layers`), with the JAX
module's ``__all__``.
"""

from .models import (
    Spectrogram, InverseSpectrogram, GriffinLim,
    AmplitudeToDB, MelScale, InverseMelScale, MelSpectrogram,
    MFCC, LFCC,
    MuLawEncoding, MuLawDecoding,
    Resample, ComputeDeltas, TimeStretch, Fade, Vol, Loudness,
    FrequencyMasking, TimeMasking, SpecAugment,
    SlidingWindowCmn, SpectralCentroid, Vad, PitchShift,
    RNNTLoss, PSD, MVDR, RTFMVDR, SoudenMVDR,
    Convolve, FFTConvolve, Speed, SpeedPerturbation, AddNoise,
    Preemphasis, Deemphasis,
)

__all__ = [
    "Spectrogram", "InverseSpectrogram", "GriffinLim",
    "AmplitudeToDB", "MelScale", "InverseMelScale", "MelSpectrogram",
    "MFCC", "LFCC",
    "MuLawEncoding", "MuLawDecoding",
    "Resample", "ComputeDeltas", "TimeStretch", "Fade", "Vol",
    "Loudness", "FrequencyMasking", "TimeMasking", "SpecAugment",
    "SlidingWindowCmn", "SpectralCentroid", "Vad", "PitchShift",
    "RNNTLoss", "PSD", "MVDR", "RTFMVDR", "SoudenMVDR",
    "Convolve", "FFTConvolve", "Speed", "SpeedPerturbation",
    "AddNoise", "Preemphasis", "Deemphasis",
]
