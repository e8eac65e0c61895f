"""The Emformer-RNNT's matrix products (input and output linears, the
projections, FFNs and attention products of every layer, the joiner and
the predictor's cells, cuBLAS in FP32): percent of their roofline for the
work the streams need (``systems/emformer_rnnt.work``'s ``gemm``: each
row's projections once, keys and values of a left-context row counted at
the step it was new) over the device time of the product kernels
(``_library.GEMM``)."""
from ._library import GEMM, share


def read(m):
    return share(m, GEMM, "gemm")
