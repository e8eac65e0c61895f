"""Utilities of the PyTorch port."""
from .convert import (from_jax_params, wav2letter_from_jax_params,
                      deepspeech_from_jax_params, emformer_from_jax_params,
                      conformer_from_jax_params,
                      emformer_rnnt_from_jax_params,
                      conformer_rnnt_from_jax_params)

__all__ = ["from_jax_params", "wav2letter_from_jax_params",
           "deepspeech_from_jax_params", "emformer_from_jax_params",
           "conformer_from_jax_params", "emformer_rnnt_from_jax_params",
           "conformer_rnnt_from_jax_params"]
