"""``torchaudio.prototype.pipelines`` namespace alias (the JAX
package's name list, the port's objects)."""

from ..pipelines import (
    EMFORMER_RNNT_BASE_MUSTC, EMFORMER_RNNT_BASE_TEDLIUM3,
    HIFIGAN_VOCODER_V3_LJSPEECH, VGGISH, VGGishBundle,
)

__all__ = [
    "EMFORMER_RNNT_BASE_MUSTC", "EMFORMER_RNNT_BASE_TEDLIUM3",
    "HIFIGAN_VOCODER_V3_LJSPEECH", "VGGISH", "VGGishBundle",
]
