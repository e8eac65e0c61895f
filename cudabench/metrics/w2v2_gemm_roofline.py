"""wav2vec2's matrix products (projection, q/k/v/out, FFN, head and the
attention products, cuBLAS in FP32): percent of their roofline for the
work the requests need (``systems/wav2vec2_asr.work``'s ``gemm``) over
the device time of the product kernels (``_library.GEMM``)."""
from ._library import GEMM, share


def read(m):
    return share(m, GEMM, "gemm")
