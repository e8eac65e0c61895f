"""Compatibility feature extractors (the ``compliance.kaldi`` surface).

Port of ``torchaudio_contrib_tpu/compliance``."""
from . import kaldi

__all__ = ["kaldi"]
