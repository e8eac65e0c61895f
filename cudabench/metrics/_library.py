"""A family of library kernels' share of its roofline over the traced
stretch: the least time the counted work of the calls could take
(``work.bound_s``) over the summed device time of the profiler rows of
that family.  cuDNN's and cuBLAS's kernel names are single identifiers
(``sm80_xmma_fprop_implicit_gemm_..._cudnn``,
``sm80_xmma_gemm_..._cublas``, ``implicit_convolve_sgemm<...>``), which
``_roofline.share``'s whole-word match does not find and in which "gemm"
names a convolution too, so each family is a pattern of its own, and no
name of the cell's trace matches both (``tests/test_cudabench_w2v2.py``):

* ``CONV``: cuDNN's convolutions (``conv``, ``fprop``, ``dgrad``,
  ``wgrad``, a ``_cudnn`` suffix);
* ``GEMM``: cuBLAS's products (a ``_cublas`` suffix, the classic
  ``<arch>_sgemm`` and CUTLASS ``simt_sgemm`` names, ``gemv``,
  ``gemmSN``, ``gemmk1``, split-K reductions).

Where rows of a family overlap (cuDNN runs the groups of a grouped
convolution side by side), their summed time exceeds the time they took,
and the share reads low."""
import re

from ..work import bound_s

CONV = re.compile(r"conv|fprop|dgrad|wgrad|_cudnn\b", re.IGNORECASE)
GEMM = re.compile(r"_cublas\b|(?:ampere|volta|turing|sm\d+|simt)_[sd]gemm"
                  r"|gemv|gemmSN|gemmk1|splitKreduce", re.IGNORECASE)


def share(m, pattern, work_key):
    t = m["trace"]
    if not t:
        return None
    spent = sum(s for k, (s, _) in t["device_ops"].items()
                if pattern.search(k))
    flops, nbytes = t["work"].get(work_key, (0.0, 0.0))
    if spent <= 0 or flops <= 0:
        return None
    return 100.0 * bound_s(flops, nbytes) / spent
