"""Utilities of the PyTorch port."""
from .convert import (from_jax_params, wav2letter_from_jax_params,
                      deepspeech_from_jax_params, emformer_from_jax_params,
                      conformer_from_jax_params,
                      emformer_rnnt_from_jax_params,
                      conformer_rnnt_from_jax_params,
                      wav2vec2_from_jax_params,
                      hubert_pretrain_from_jax_params,
                      conformer_wav2vec2_from_jax_params,
                      emformer_hubert_from_jax_params,
                      wav2vec2_from_torch_state_dict)
from .checkpoint import save_params, load_params

__all__ = ["from_jax_params", "wav2letter_from_jax_params",
           "deepspeech_from_jax_params", "emformer_from_jax_params",
           "conformer_from_jax_params", "emformer_rnnt_from_jax_params",
           "conformer_rnnt_from_jax_params", "wav2vec2_from_jax_params",
           "hubert_pretrain_from_jax_params",
           "conformer_wav2vec2_from_jax_params",
           "emformer_hubert_from_jax_params",
           "wav2vec2_from_torch_state_dict", "save_params", "load_params"]
