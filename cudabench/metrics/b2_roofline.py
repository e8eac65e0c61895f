"""B2, the fused log-mel backward (``csrc/fused_mel_bwd.cu``): percent of
its roofline for the gradients the cell needs (``work.logmel_bwd``)."""
from ._roofline import share

KERNELS = ("dframes_fft_kernel", "dframes_kernel", "dfb_kernel",
           "dfb_reduce_kernel", "dreim_kernel")


def read(m):
    return share(m, KERNELS, "b2")
