"""B1, the fused log-mel forward (``csrc/fused_mel_fwd.cu``): percent of
its roofline for the forward the cell needs (``work.logmel_fwd``)."""
from ._roofline import share

KERNELS = ("fused_mel_fft_fwd_kernel", "fused_mel_fwd_kernel")


def read(m):
    return share(m, KERNELS, "b1")
