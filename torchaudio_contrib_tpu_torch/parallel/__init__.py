"""Corpus-scale preprocessing on one device (port of
``torchaudio_contrib_tpu.parallel``'s corpus preprocessor; the multi-device
layer is not ported yet)."""
from .corpus import (
    StreamingSTFT, chunked_melspectrogram, CorpusPreprocessor, CorpusStats,
)

__all__ = [
    "StreamingSTFT", "chunked_melspectrogram", "CorpusPreprocessor",
    "CorpusStats",
]
