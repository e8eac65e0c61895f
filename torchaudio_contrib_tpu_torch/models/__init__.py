"""Layer API and models of the PyTorch port (the mel front end's slice)."""
from .layers import (
    Transform, Pipeline,
    STFT, ComplexNorm,
    Filterbank, MelFilterbank, ApplyFilterbank,
    AmplitudeToDb, DbToAmplitude,
    Spectrogram, Melspectrogram, FusedMelspectrogram,
)
from .frontend import MelFrontendClassifier

__all__ = [
    "Transform", "Pipeline",
    "STFT", "ComplexNorm",
    "Filterbank", "MelFilterbank", "ApplyFilterbank",
    "AmplitudeToDb", "DbToAmplitude",
    "Spectrogram", "Melspectrogram", "FusedMelspectrogram",
    "MelFrontendClassifier",
]
