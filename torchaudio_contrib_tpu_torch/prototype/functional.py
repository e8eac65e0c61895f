"""``torchaudio.prototype.functional`` namespace alias (the JAX
package's name list, the port's objects)."""

from ..ops import (
    adsr_envelope, barkscale_fbanks, chroma_filterbank, exp_sigmoid,
    extend_pitch, filter_waveform, frequency_impulse_response,
    oscillator_bank, ray_tracing, simulate_rir_ism,
    sinc_impulse_response,
)

__all__ = [
    "adsr_envelope", "barkscale_fbanks", "chroma_filterbank",
    "exp_sigmoid", "extend_pitch", "filter_waveform",
    "frequency_impulse_response", "oscillator_bank", "ray_tracing",
    "simulate_rir_ism", "sinc_impulse_response",
]
