"""``torchaudio.prototype.models`` namespace alias (the JAX package's
name list, the port's objects)."""

from ..models import (
    ConformerWav2Vec2, ConformerWav2Vec2PretrainModel, ConvEmformer,
    EmformerHuBERT, HiFiGANVocoder,
    conformer_rnnt_base, conformer_rnnt_model,
    conformer_wav2vec2_base, conformer_wav2vec2_model,
    conformer_wav2vec2_pretrain_base, conformer_wav2vec2_pretrain_large,
    conformer_wav2vec2_pretrain_model,
    emformer_hubert_base, emformer_hubert_model,
    hifigan_vocoder, hifigan_vocoder_v1, hifigan_vocoder_v2,
    hifigan_vocoder_v3,
)

__all__ = [
    "ConformerWav2Vec2", "ConformerWav2Vec2PretrainModel",
    "ConvEmformer", "EmformerHuBERT", "HiFiGANVocoder",
    "conformer_rnnt_base", "conformer_rnnt_model",
    "conformer_wav2vec2_base", "conformer_wav2vec2_model",
    "conformer_wav2vec2_pretrain_base",
    "conformer_wav2vec2_pretrain_large",
    "conformer_wav2vec2_pretrain_model",
    "emformer_hubert_base", "emformer_hubert_model",
    "hifigan_vocoder", "hifigan_vocoder_v1", "hifigan_vocoder_v2",
    "hifigan_vocoder_v3",
]
