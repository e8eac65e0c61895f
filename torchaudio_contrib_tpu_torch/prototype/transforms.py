"""``torchaudio.prototype.transforms`` namespace alias (the JAX
package's name list, the port's objects)."""

from ..models import (
    BarkScale, BarkSpectrogram, ChromaScale, ChromaSpectrogram,
    InverseBarkScale,
)

__all__ = [
    "BarkScale", "BarkSpectrogram", "ChromaScale", "ChromaSpectrogram",
    "InverseBarkScale",
]
