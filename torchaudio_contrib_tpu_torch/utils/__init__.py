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
                      wav2vec2_from_torch_state_dict,
                      tacotron2_from_jax_params, wavernn_from_jax_params,
                      hifigan_from_jax_params,
                      hifigan_from_torch_state_dict,
                      conv_tasnet_from_jax_params, hdemucs_from_jax_params,
                      hdemucs_ta_from_jax_params,
                      squim_objective_from_jax_params,
                      squim_objective_ta_from_jax_params,
                      squim_subjective_from_jax_params,
                      vggish_from_jax_params,
                      conv_tasnet_from_torch_state_dict,
                      hdemucs_from_torch_state_dict,
                      squim_objective_from_torch_state_dict,
                      vggish_from_torch_state_dict)
from .checkpoint import (save_params, load_params, save_checkpoint,
                         load_checkpoint)
from .precision import cast_floats, mixed_precision
from .timing import device_loop, time_device_loop, time_device_loop_p
from .compat import view_as_real, view_as_complex
from . import convert

__all__ = ["cast_floats", "mixed_precision", "save_params", "load_params",
           "save_checkpoint", "load_checkpoint", "view_as_real",
           "view_as_complex", "device_loop", "time_device_loop"] \
    + convert.__all__
