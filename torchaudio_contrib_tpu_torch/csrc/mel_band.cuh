// What the fused mel kernels (fused_mel_fwd.cu, fused_mel_bwd.cu) share
// about the filterbank's nonzero bands, which mel_band_kernel
// (fused_mel_fwd.cu) writes on every call: a band is a range [lo, hi) of
// indices held as an int2, and an empty one is (BAND_EMPTY, 0), so that
// bands join by a minimum of their lows and a maximum of their highs.

#pragma once

#include <cuda_runtime.h>

namespace tacband {

constexpr int EMPTY = 0x3fffffff;

__device__ __forceinline__ int2 join(int2 a, int2 b) {
    return make_int2(min(a.x, b.x), max(a.y, b.y));
}

// Adds one to a counter in mapped host memory, from one thread of a launch
// that took a banded product.  A plain read and write (no host atomics):
// launches on one stream run one after the other.
__device__ __forceinline__ void count_launch(int* counter) {
    volatile int* c = counter;
    *c = *c + 1;
    __threadfence_system();
}

}  // namespace tacband
