// Shared-memory FFT for a thread block (Hopper, sm_90a), the device code
// that the fused mel forward (fused_mel_fwd.cu) and the frame-gradient
// pass of its backward (fused_mel_bwd.cu) share.
//
// A block of FFT_THREADS = 256 threads transforms ROUND_POINTS = 2048
// complex points per round: 2048 / M transforms of M points side by side,
// M a power of two in [FFT_MIN, FFT_MAX].  A group of M / 8 threads owns
// one transform; every thread holds 8 points in registers in every pass.
//
// The complex transform is a Stockham autosort FFT (decimation in time,
// no bit reversal) in radix-8 passes plus one last radix-2 or radix-4
// pass where the size leaves one:
//
//   128 = 8 * 8 * 2     512 = 8 * 8 * 8
//   256 = 8 * 8 * 4    1024 = 8 * 8 * 8 * 2
//
// A pass of radix R after passes whose radices multiply to NS takes, for
// butterfly b in [0, M / R), the points in[b + r * M / R], multiplies
// point r by w^(r * k), k = b mod NS, w = exp(-+2 pi i / (NS * R)), takes
// their R-point DFT and writes output r to out[(b - k) * R + k + r * NS].
// Thread j of a group works on the 8 / R butterflies b = j + q * M / 8,
// so in every pass it reads the points j + m * M / 8, m = 0..7:
// neighbouring threads read neighbouring addresses, and after the last
// pass thread j holds the transform's outputs j + m * M / 8 in natural
// order, which the caller can store straight to device memory.
//
// Between passes the points go through a shared-memory buffer of the
// round's 2048 points.  Index i lives at i + i / 16: the first pass
// writes with a stride of 8 points, which without the padding would put
// the 16 lanes of a half warp onto two 8-byte banks.
//
// A real frame of N = 2 M samples is one complex transform of M points:
// z[m] = x[2m] + i x[2m+1], Z = FFT_M(z), and with E_k = (Z_k + conj
// Z_{M-k}) / 2, O_k = (Z_k - conj Z_{M-k}) / (2i) (the transforms of the
// even and of the odd samples), X_k = E_k + W_N^k O_k for k < M and X_M =
// E_0 - O_0 (real_bin below).  The inverse of a Hermitian spectrum Y runs
// the same steps backwards (hermitian_point below).  Each frame is
// transformed alone: packing two frames into one complex transform costs
// the same, but lets the rounding of a loud frame leak into a quiet
// neighbour (3e-4 dB at 60 dB between them, against 1e-5 dB here).
//
// Twiddles come from one table of N float2 that the host builds in
// float64 and rounds to float32; the block copies it to shared memory
// once.  It is laid out in the order the threads read it, so that
// neighbouring threads read neighbouring entries (read from one table
// W_N^j with the index r * k * N / (NS * R), the lanes of a warp fall
// 4 to 16 deep onto one bank):
//
//   [0, M)                     W_N^k = (cos, -sin)(2 pi k / N), the
//                              real-input step
//   then for each pass after   w^(r k) at (r - 1) * NS + k, r = 1..R-1,
//   the first, in order        k = 0..NS-1, w = exp(-2 pi i / (NS * R))
//
// (M + 56 + 7 * 64 + 512 = 2040 entries at M = 1024), zeros after that.
// The inverse transform conjugates what it reads.  The fast intrinsics
// (__sincosf) are not accurate enough for an f32-grade result, and
// sincospif per butterfly costs more than the butterfly.

#pragma once

#include <cuda_runtime.h>

namespace tacfft {

constexpr int FFT_THREADS = 256;
constexpr int POINTS = 8;                              // per thread and pass
constexpr int ROUND_POINTS = FFT_THREADS * POINTS;     // 2048
constexpr int FFT_MIN = 128;                           // complex points
constexpr int FFT_MAX = 1024;

__host__ __device__ constexpr int padded(int i) { return i + (i >> 4); }

constexpr int WORK_POINTS = padded(ROUND_POINTS);      // float2 per block

__host__ __device__ constexpr bool fft_size_ok(int n) {
    return n >= FFT_MIN && n <= FFT_MAX && (n & (n - 1)) == 0;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * (-i) for the forward transform, a * (+i) for the inverse
template <bool INV>
__device__ __forceinline__ float2 rot4(float2 a) {
    return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
}

// a * exp(-+ i pi / 4) and a * exp(-+ 3 i pi / 4)
template <bool INV>
__device__ __forceinline__ float2 rot8_1(float2 a) {
    const float h = 0.70710678118654752440f;
    return INV ? make_float2((a.x - a.y) * h, (a.x + a.y) * h)
               : make_float2((a.x + a.y) * h, (a.y - a.x) * h);
}

template <bool INV>
__device__ __forceinline__ float2 rot8_3(float2 a) {
    const float h = 0.70710678118654752440f;
    return INV ? make_float2((-a.x - a.y) * h, (a.x - a.y) * h)
               : make_float2((a.y - a.x) * h, (-a.x - a.y) * h);
}

// R-point DFTs in place, outputs in natural order.
__device__ __forceinline__ void dft2(float2& a, float2& b) {
    const float2 t = a;
    a = cadd(t, b);
    b = csub(t, b);
}

template <bool INV>
__device__ __forceinline__ void dft4(float2& x0, float2& x1, float2& x2,
                                     float2& x3) {
    const float2 e0 = cadd(x0, x2), e1 = csub(x0, x2);
    const float2 o0 = cadd(x1, x3), o1 = rot4<INV>(csub(x1, x3));
    x0 = cadd(e0, o0);
    x1 = cadd(e1, o1);
    x2 = csub(e0, o0);
    x3 = csub(e1, o1);
}

template <bool INV>
__device__ __forceinline__ void dft8(float2& x0, float2& x1, float2& x2,
                                     float2& x3, float2& x4, float2& x5,
                                     float2& x6, float2& x7) {
    dft4<INV>(x0, x2, x4, x6);          // evens: E0..E3 in x0, x2, x4, x6
    dft4<INV>(x1, x3, x5, x7);          // odds:  O0..O3 in x1, x3, x5, x7
    const float2 e0 = x0, e1 = x2, e2 = x4, e3 = x6;
    const float2 o0 = x1, o1 = rot8_1<INV>(x3), o2 = rot4<INV>(x5),
                 o3 = rot8_3<INV>(x7);
    x0 = cadd(e0, o0);
    x1 = cadd(e1, o1);
    x2 = cadd(e2, o2);
    x3 = cadd(e3, o3);
    x4 = csub(e0, o0);
    x5 = csub(e1, o1);
    x6 = csub(e2, o2);
    x7 = csub(e3, o3);
}

// The butterflies of one pass on a thread's 8 points.  On entry v[m] is
// the pass's input point j + m * N / 8; on return v[q + r * (8 / R)] is
// output r of butterfly j + q * N / 8.  `tw` is this pass's table: w^(r k)
// at (r - 1) * NS + k.
template <int N, int R, int NS, bool INV>
__device__ __forceinline__ void butterflies(float2 (&v)[POINTS], int j,
                                            const float2* __restrict__ tw) {
    constexpr int Q = POINTS / R;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        if constexpr (NS > 1) {
            const int k = (j + q * (N / POINTS)) & (NS - 1);
#pragma unroll
            for (int r = 1; r < R; ++r) {
                float2 w = tw[(r - 1) * NS + k];
                if (INV) w.y = -w.y;
                v[q + r * Q] = cmul(v[q + r * Q], w);
            }
        }
        if constexpr (R == 8)
            dft8<INV>(v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]);
        else if constexpr (R == 4)
            dft4<INV>(v[q], v[q + Q], v[q + 2 * Q], v[q + 3 * Q]);
        else
            dft2(v[q], v[q + Q]);
    }
}

// Waits for the N / 8 threads that work on one transform: the warp where
// they fit one, else a named barrier of their own (transform g of the
// round uses barrier g + 1; 0 is __syncthreads').  Transforms of one round
// do not wait for each other.
template <int N>
__device__ __forceinline__ void group_sync(int g) {
    constexpr int TPF = N / POINTS;
    if constexpr (TPF <= 32)
        __syncwarp();
    else
        asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "n"(TPF) : "memory");
}

// Stores a pass's outputs into the round buffer (transform `g` of the
// round starts at point g * N), waits for the transform's threads, reads
// the next pass's inputs and waits again, so the buffer may be written
// anew.  The addresses are padded(first) + constant: a thread's 8 inputs
// are N / 8 apart, a multiple of 16, and a butterfly's R outputs lie NS
// apart, within one group of 16 (NS = 1), in two (NS = 8: the even and
// the odd r), or a multiple of 16 apart.
template <int N, int R, int NS>
__device__ __forceinline__ void exchange(float2 (&v)[POINTS], float2* work,
                                         int g, int j) {
    constexpr int Q = POINTS / R;
    static_assert(NS == 1 || NS == 8 || NS % 16 == 0, "see above");
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int b = j + q * (N / POINTS);
        const int k = b & (NS - 1);
        const int base = g * N + (b - k) * R + k;
        if constexpr (NS == 1) {
            float2* dst = work + padded(base);
#pragma unroll
            for (int r = 0; r < R; ++r) dst[r] = v[q + r * Q];
        } else if constexpr (NS == 8) {
            float2* even = work + padded(base);
            float2* odd = work + padded(base + 8);
#pragma unroll
            for (int r = 0; r < R; ++r)
                (r % 2 ? odd : even)[(r / 2) * padded(16)] = v[q + r * Q];
        } else {
            float2* dst = work + padded(base);
#pragma unroll
            for (int r = 0; r < R; ++r) dst[r * padded(NS)] = v[q + r * Q];
        }
    }
    group_sync<N>(g);
    const float2* src = work + padded(g * N + j);
#pragma unroll
    for (int m = 0; m < POINTS; ++m)
        v[m] = src[m * padded(N / POINTS)];
    group_sync<N>(g);
}

// The transform of N complex points by the group of N / 8 threads that
// thread (g, j) belongs to: g = threadIdx.x / (N / 8), j = threadIdx.x %
// (N / 8).  On entry v[m] is input point j + m * N / 8, on return v[m] is
// output point j + m * N / 8 (unnormalised in both directions).  Every
// thread of the group must call it: it synchronises the group, not the
// block.  `work` holds WORK_POINTS float2; the transform's N points of it
// must not be in use on entry and are free again on return.  `tw` points
// at the passes' tables (entry N of the table of a frame of 2 N samples).
template <int N, bool INV>
__device__ __forceinline__ void fft_block(float2 (&v)[POINTS], float2* work,
                                          const float2* __restrict__ tw,
                                          int g, int j) {
    static_assert(fft_size_ok(N), "N must be a power of two in [128, 1024]");
    butterflies<N, 8, 1, INV>(v, j, tw);
    exchange<N, 8, 1>(v, work, g, j);
    butterflies<N, 8, 8, INV>(v, j, tw);
    exchange<N, 8, 8>(v, work, g, j);
    constexpr int REST = N / 64;        // 2, 4, 8 or 16
    constexpr int PASS3 = 7 * 8;        // where the third pass's table starts
    if constexpr (REST < 8) {
        butterflies<N, REST, 64, INV>(v, j, tw + PASS3);
    } else {
        butterflies<N, 8, 64, INV>(v, j, tw + PASS3);
        if constexpr (REST == 16) {
            exchange<N, 8, 64>(v, work, g, j);
            butterflies<N, 2, 512, INV>(v, j, tw + PASS3 + 7 * 64);
        }
    }
}

// Bin k (0..M) of the transform of the 2 M real samples packed as z[m] =
// x[2m] + i x[2m+1], from Z = FFT_M(z): zk = Z[k mod M], zn = Z[(M - k)
// mod M], w = W_N^k for k < M and -1 for k = M.
__device__ __forceinline__ float2 real_bin(float2 zk, float2 zn, float2 w) {
    const float2 e = make_float2(0.5f * (zk.x + zn.x), 0.5f * (zk.y - zn.y));
    const float2 o = make_float2(0.5f * (zk.y + zn.y), 0.5f * (zn.x - zk.x));
    return cadd(e, cmul(w, o));
}

// Point k (0..M-1) of the M-point spectrum whose unnormalised inverse
// transform is z[m] = y[2m] + i y[2m+1], y the unnormalised inverse of the
// Hermitian spectrum Y of 2 M points: yk = Y[k], yn = Y[M - k], w = W_N^k.
__device__ __forceinline__ float2 hermitian_point(float2 yk, float2 yn,
                                                  float2 w) {
    const float2 e = make_float2(yk.x + yn.x, yk.y - yn.y);
    const float2 d = make_float2(yk.x - yn.x, yk.y + yn.y);
    const float2 o = cmul(d, make_float2(w.x, -w.y));
    return make_float2(e.x - o.y, e.y + o.x);       // e + i o
}

// Copies a table of N twiddles to shared memory (no synchronisation).
template <int N>
__device__ __forceinline__ void load_twiddles(float2* tw_s,
                                              const float2* __restrict__ tw) {
    for (int i = threadIdx.x; i < N; i += FFT_THREADS) tw_s[i] = tw[i];
}

}  // namespace tacfft
