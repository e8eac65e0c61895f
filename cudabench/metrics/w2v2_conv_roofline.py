"""wav2vec2's convolutions (the extractor's seven and the positional one,
cuDNN in FP32): percent of their roofline for the work the requests need
(``systems/wav2vec2_asr.work``'s ``conv``) over the summed device time of
the convolution kernels' rows (``_library.CONV``).

A lower bound, not the layer's share: cuDNN runs the positional
convolution's groups as concurrent launches, whose rows overlap, so the
summed time exceeds the time the convolutions held the card (the trace's
rows keep no intervals to take their union).  A change that serialises
or merges those launches raises it with little gain in wall time: read a
move in it beside the convolutions' wall time (CUDA events)."""
from ._library import CONV, share


def read(m):
    return share(m, CONV, "conv")
