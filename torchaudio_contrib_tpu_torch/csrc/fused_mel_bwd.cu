// Fused (log-)mel spectrogram backward for Hopper (sm_90a).
//
// Replaces torchaudio_contrib_tpu/ops/fused.py::_build_bwd_call (kernel B2
// of the JAX package).  Given the output cotangent after the dB gate,
// dmel (rows, m_pad), and the forward's re/im residual reim (rows,
// FT*2*FBT), tile t columns [re_t | im_t] as fused_mel_fwd.cu writes them,
// it computes
//
//   dFB[k, m]       = sum_rows p[row, k] * dmel[row, m],   p = re^2 + im^2
//   dp[row, k]      = sum_m dmel[row, m] * fb[k, m]
//   dreim[row, .]   = [2 re dp | 2 im dp]                   (per tile)
//   dframes[row, n] = sum_c dreim[row, c] * basis[n, c]
//
// with the windowed onesided DFT basis of the forward.  Rows are (stream,
// frame) pairs, frame fastest; the host overlap-adds dframes onto the
// waveform, or, on the FFT route at hops from fft_length / (FR + 1) to
// fft_length, the kernel does: see dframes_fft_kernel.
//
// The frame gradient is the transpose of the forward's windowed real
// transform.  With G_k = dre_k + i dim_k,
//
//   dframes[row, n] = w[n] * Re sum_{k=0}^{N/2} G_k exp(+2 pi i k n / N)
//
// which is the unnormalised inverse DFT of the Hermitian spectrum Y_0 =
// Re G_0, Y_{N/2} = Re G_{N/2}, Y_k = G_k / 2, Y_{N-k} = conj(G_k) / 2
// (not irfft(G): DC and Nyquist weigh double), times the window.  Two
// routes for the frame passes, chosen by fft_length alone:
//   * dframes_fft_kernel<N>, for N = fft_length a power of two in [256,
//     2048]: one kernel.  A block forms dp for 16 rows in shared memory
//     (the mel product, FP32 FMAs), scales the residual by it in
//     registers, so dreim is never written, and runs the inverse FFT in
//     shared memory (fft_smem.cuh), a row as one complex transform of N / 2
//     points whose output is z[m] = y[2m] + i y[2m+1].  What bounds it: the
//     FFT's shared-memory traffic, wherever the filterbank is banded (as
//     every mel or linear filterbank is): each lane sums dp over its bins'
//     nonzero mels only (mel_band_kernel's tables, about 2 to 5 of 128 at
//     config 2), which leaves out only exact zero weights, so dp is the
//     dense sum with its zero terms skipped.  The dense dp product (2 *
//     bins * mels FLOPs a row, 10.8 GFLOP at 32 x 30 s, fft 2048, 128
//     mels) only where the bands cover more than DP_BAND_SHARE of it (a
//     learned filterbank); every block decides from the tables alone.  Its
//     bytes (the residual read and dframes written once, 0.70 GB) are
//     below both.
//     The last pass leaves each thread with sample pairs, which go
//     straight to device memory, coalesced, or (the waveform-gradient
//     epilogue) are overlap-added in shared memory into dx, so that the
//     frame gradient never reaches device memory.
//   * dreim_kernel (pass A) and dframes_kernel (pass B), for every other
//     size.  The TPU kernel recomputed dp for every tile of the dframes
//     output; a Hopper block cannot hold a (64 frames, fft) dframes tile
//     of a dense product, so that would rerun the dp product fft / 128
//     times.  Pass A (one block per (64 rows, frequency tile)) forms dp
//     once and writes dreim to a scratch buffer; pass B is the dense
//     product with the windowed basis that the forward's general-size
//     kernel reads, here read transposed.  What bounds it: 2 * rows * fft *
//     FT*2*FBT FLOPs as FP32 FMAs on CUDA cores (0.37 TFLOP at that
//     shape), ~160 x the FFT's count; no f32-grade tensor-core tier of
//     that product beats the plain chain (see fused_mel_fwd.cu).
//
// On both routes:
//   * dFB is a pass of its own (dfb_kernel, 2 * rows * n_freqs * m_pad
//     FLOPs, FP32 FMAs on CUDA cores), a product whose reduction runs over
//     the rows.  What bounds it: at config 2 (41 216 rows, 1 025 bins, 128
//     mels) the FLOPs, 10.8 GFLOP or 0.161 ms at 67 TFLOP/s, against 0.113
//     ms for its bytes (the residual's 359 MB once, dmel's 21 MB); at
//     config 3 (39 904 rows, 257 bins, 64 mels) the bytes, 102 MB or 0.030
//     ms, against 1.31 GFLOP.  So a block owns 128 bins (two residual tiles)
//     and every mel column up to 128 (m_pad 64 or 128: the residual is read
//     from device memory once a pass; wider filterbanks take a grid of
//     128- or 64-column tiles) for one contiguous split of the rows.  Each
//     of its 256 threads sums 8 bins x 8 mels (8 x 4 at 64): per row 64
//     FMAs for four 16-byte shared-memory loads.  The rows come in chunks
//     of KC through a ring of DFB_STAGES stages filled by cp.async, two
//     chunks in flight while a third is summed and the next has
//     p = re^2 + im^2 formed in place, once per element, as it lands; one
//     barrier a chunk.  Two blocks an SM, and the rows are split so that
//     the grid is about two blocks on every SM in one wave (_dfb_splits).
//   * Work past n_freqs is skipped: a tile's warps whose bins (32 a warp
//     at 128 mels, 16 at 64) all lie past n_freqs neither sum nor store,
//     and only the residual tiles that hold bins below n_freqs are loaded.  A lone last bin (the Nyquist bin
//     of every FFT size from 256 on: 1 025 = 8 * 128 + 1) gets no tile of
//     its own: the blocks of tile 0 also sum it, one chunk row a thread,
//     and add their 16 row partial sums in a fixed order at the end.  dFB
//     is written for bins below n_freqs only.
//   * Bitwise repeatable: each block sums its rows in order, the splits
//     (a function of the shapes alone) are added by dfb_reduce_kernel in
//     split order, and there are no float atomics anywhere, so the same
//     inputs give bitwise-equal gradients on every run.  dFB needs only p
//     and dmel, so a caller that wants the filterbank gradient alone (a
//     trainable front end on a waveform that needs no gradient) runs this
//     pass only, a few percent of the work.
//   * Ragged edges: rows past `rows` load zeros and are not stored; bins
//     past fft//2+1 have zero residual, so their p and dreim are zero; mels
//     past num_mels have zero dmel and zero fb; in dframes_kernel basis
//     rows past k_pad load zeros and dframes columns past fft_length are
//     not stored.

#include <cuda_runtime.h>

#include "fft_smem.cuh"
#include "mel_band.cuh"

namespace {

constexpr int TB = 64;          // rows per block (the forward's frame block)
constexpr int FBT = 64;         // bins per frequency tile (the forward's)
constexpr int KC = 16;          // depth of one K step
constexpr int MC = 64;          // mel columns the filterbank pads to
constexpr int NB = 128;         // dframes columns per block
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int LD = TB + 4;      // padded leading dims of the k-major tiles
constexpr int NB_LD = NB + 4;   // (rows stay 16-byte aligned)
constexpr int REDUCE_THREADS = 256;
constexpr int DFB_BM = 2 * FBT;         // bins per dFB block: two residual tiles
constexpr int DFB_BN = 128;             // most mel columns per dFB block
constexpr int DFB_LDA = 2 * DFB_BM;     // a chunk row's residual: re|im|re|im
constexpr int DFB_STAGES = 4;           // row chunks in the ring

static_assert(TB == 16 * 4 && FBT == 16 * 4 && MC == 16 * 4 && NB == 16 * 8,
              "the 16 x 16 thread grid owns 4 x 4 (4 x 8 in pass B) tiles");
static_assert(TB * KC == 4 * THREADS, "64-row operand chunk: one float4 per thread");
static_assert(KC * 16 == THREADS && KC * DFB_LDA % (4 * THREADS) == 0,
              "dFB: the folded bin takes one chunk row per 16 threads; a "
              "chunk's residual is whole float4s a thread");

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

// Four consecutive K values of column `col`, stored k-major.
__device__ __forceinline__ void st_kmajor(float* tile, int ld, int k0, int col,
                                          float4 v) {
    tile[(k0 + 0) * ld + col] = v.x;
    tile[(k0 + 1) * ld + col] = v.y;
    tile[(k0 + 2) * ld + col] = v.z;
    tile[(k0 + 3) * ld + col] = v.w;
}

// `bytes` (16 or 4) from device to shared memory, asynchronously; zeros
// where `ok` is false (nothing is read then).
template <int BYTES>
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool ok) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     ::"r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                     ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void copy_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void copy_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// A dFB stage: the residual of KC rows (KC, DFB_LDA), p formed in place over
// the re columns; dmel (KC, BN); the folded bin's (re, im) of each row.
template <int BN>
constexpr int DFB_STAGE = KC * (DFB_LDA + BN) + 2 * KC;

// grid (bin tiles, m_pad / BN, n_splits): the (DFB_BM bins, BN mels) tile
// of the filterbank gradient summed over rows [split * rows_per_split, +
// that).  part (n_splits, n_freqs, m_pad).  `nyq`: the lone last bin that
// tile 0's blocks sum besides their own, or -1.  A thread sums 8 bins x 4 MH
// mels.  A warp covers WB bins x 64 mels: LM lanes along the mels, 4 mels a
// lane and, with BN = 128, 4 more LM * 4 further on, so that a warp's
// shared-memory loads touch distinct banks (BN = 128: 4 x 2 warps of 32 bins
// x 64 mels; BN = 64: 8 x 1 of 16 x 64).
template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
dfb_kernel(const float* __restrict__ dmel, const float* __restrict__ reim,
           float* __restrict__ part, int rows, int rows_per_split, int ldr,
           int m_pad, int n_freqs, int nyq) {
    constexpr int MH = BN / 64;                  // runs of 4 mels a thread
    constexpr int LM = 16 / MH;                  // lanes along the mels
    constexpr int WM = LM * 4 * MH;              // a warp's mels: 64
    constexpr int WB = 8 * (32 / LM);            // a warp's bins: 32 or 16
    constexpr int STAGE = DFB_STAGE<BN>;
    constexpr int R4 = DFB_LDA / 4;              // residual float4s a chunk row
    constexpr int D4 = BN / 4;                   // dmel float4s a chunk row
    static_assert(WB * (THREADS / 32) / (BN / WM) == DFB_BM, "warps tile the block");
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int b0 = blockIdx.x * DFB_BM;
    const int mc = blockIdx.y * BN;
    const int split = blockIdx.z;
    const int nb = min(DFB_BM, n_freqs - b0);    // the tile's bins below n_freqs
    const bool two = nb > FBT;                   // both residual tiles hold some
    const bool fold = nyq >= 0 && blockIdx.x == 0;
    const int r_begin = split * rows_per_split;
    const int n_rows = min(rows, r_begin + rows_per_split) - r_begin;
    const int chunks = (n_rows + KC - 1) / KC;

    // loaders, a float4 a copy: the residual's row tid / R4 + i THREADS / R4,
    // column tid % R4 (its second tile zero where no bin of it is below
    // n_freqs); dmel's row tid / D4 + i THREADS / D4; the folded bin's re
    // (even tid) and im (odd) of row tid / 2.  Rows past the split are
    // zeros, copied from nothing (the address is the split's first row).
    const int lc = tid % R4;
    const bool col_ok = two || lc < R4 / 2;
    const float* rsrc = reim + (long long)r_begin * ldr + blockIdx.x * DFB_LDA
                        + lc * 4;
    const float* dsrc = dmel + (long long)r_begin * m_pad + mc + (tid % D4) * 4;
    const int nq = max(nyq, 0);
    const float* nsrc = reim + (long long)r_begin * ldr
                        + (nq / FBT) * 2 * FBT + nq % FBT + (tid & 1) * FBT;
    auto load = [&](int c) {
        if (c < chunks) {
            float* st = smem + (c % DFB_STAGES) * STAGE;
            const int r0 = c * KC;
#pragma unroll
            for (int i = 0; i < KC * R4 / THREADS; ++i) {
                const int k = tid / R4 + i * (THREADS / R4);
                const bool ok = col_ok && r0 + k < n_rows;
                copy_async<16>(st + k * DFB_LDA + lc * 4,
                               rsrc + (ok ? (long long)(r0 + k) * ldr : 0), ok);
            }
#pragma unroll
            for (int i = 0; i < KC * D4 / THREADS; ++i) {
                const int k = tid / D4 + i * (THREADS / D4);
                const bool ok = r0 + k < n_rows;
                copy_async<16>(st + KC * DFB_LDA + k * BN + (tid % D4) * 4,
                               dsrc + (ok ? (long long)(r0 + k) * m_pad : 0), ok);
            }
            if (fold && tid < 2 * KC) {
                const bool ok = r0 + tid / 2 < n_rows;
                copy_async<4>(st + KC * (DFB_LDA + BN) + tid,
                              nsrc + (ok ? (long long)(r0 + tid / 2) * ldr : 0),
                              ok);
            }
        }
        copy_commit();
    };
    // p = re^2 + im^2 over the re columns of a landed chunk
    auto convert = [&](int c) {
        if (c >= chunks) return;
        float* st = smem + (c % DFB_STAGES) * STAGE;
#pragma unroll
        for (int i = 0; i < KC * (R4 / 2) / THREADS; ++i) {
            const int q = tid + i * THREADS;    // row q / 32, p float4 q % 32
            float* a = st + (q / 32) * DFB_LDA + (q % 32) / 16 * 2 * FBT
                       + (q % 16) * 4;
            const float4 re = ld4(a);
            const float4 im = ld4(a + FBT);
            st4(a, make_float4(fmaf(re.x, re.x, im.x * im.x),
                               fmaf(re.y, re.y, im.y * im.y),
                               fmaf(re.z, re.z, im.z * im.z),
                               fmaf(re.w, re.w, im.w * im.w)));
        }
        if (fold && tid < KC) {
            float* t = st + KC * (DFB_LDA + BN) + 2 * tid;
            t[0] = fmaf(t[0], t[0], t[1] * t[1]);
        }
    };

    const int wb = (warp / (BN / WM)) * WB;     // the warp's first bin
    const bool active = wb < nb;                 // warp-uniform
    const int bin = wb + (lane / LM) * 8;
    const int apos = (bin / FBT) * 2 * FBT + bin % FBT;
    const int mel = (warp % (BN / WM)) * WM + (lane % LM) * 4;
    const int tk = tid >> 4;                     // the folded bin: chunk row tk,
    const int tm = (tid & 15) * 4;               // mels tm.. + 3 (and 64 more)
    float acc[8][4 * MH];
    float nacc[4 * MH];
#pragma unroll
    for (int c = 0; c < 4 * MH; ++c) {
        nacc[c] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][c] = 0.f;
    }

    for (int c = 0; c < DFB_STAGES - 1; ++c) load(c);
    copy_wait<DFB_STAGES - 2>();
    __syncthreads();
    convert(0);
    for (int c = 0; c < chunks; ++c) {
        // chunk c + 1 has landed, chunk c is converted, chunk c - 1's stage
        // is free for chunk c + 3
        copy_wait<DFB_STAGES - 3>();
        __syncthreads();
        load(c + DFB_STAGES - 1);
        convert(c + 1);
        const float* st = smem + (c % DFB_STAGES) * STAGE;
        if (active) {
            const float* a = st + apos;
            const float* d = st + KC * DFB_LDA + mel;
#pragma unroll
            for (int k = 0; k < KC; ++k) {
                const float4 a0 = ld4(a + k * DFB_LDA);
                const float4 a1 = ld4(a + k * DFB_LDA + 4);
                const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
                float bv[4 * MH];
#pragma unroll
                for (int h = 0; h < MH; ++h) {
                    const float4 b = ld4(d + k * BN + h * LM * 4);
                    bv[4 * h + 0] = b.x;
                    bv[4 * h + 1] = b.y;
                    bv[4 * h + 2] = b.z;
                    bv[4 * h + 3] = b.w;
                }
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 4 * MH; ++j)
                        acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
        }
        if (fold) {
            const float pn = st[KC * (DFB_LDA + BN) + 2 * tk];
            const float* d = st + KC * DFB_LDA + tk * BN + tm;
#pragma unroll
            for (int h = 0; h < MH; ++h) {
                const float4 b = ld4(d + h * 64);
                nacc[4 * h + 0] = fmaf(pn, b.x, nacc[4 * h + 0]);
                nacc[4 * h + 1] = fmaf(pn, b.y, nacc[4 * h + 1]);
                nacc[4 * h + 2] = fmaf(pn, b.z, nacc[4 * h + 2]);
                nacc[4 * h + 3] = fmaf(pn, b.w, nacc[4 * h + 3]);
            }
        }
    }

    float* out = part + (long long)split * n_freqs * m_pad + mc;
    if (active) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int k = b0 + bin + i;
            if (k >= n_freqs) break;
#pragma unroll
            for (int h = 0; h < MH; ++h)
                st4(out + (long long)k * m_pad + mel + h * LM * 4,
                    make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                acc[i][4 * h + 2], acc[i][4 * h + 3]));
        }
    }
    if (fold) {
        // the folded bin: the 16 chunk rows' partial sums, in row order
        copy_wait<0>();
        __syncthreads();
        float* red = smem;                       // (KC, BN)
#pragma unroll
        for (int h = 0; h < MH; ++h)
            st4(red + tk * BN + tm + h * 64,
                make_float4(nacc[4 * h], nacc[4 * h + 1], nacc[4 * h + 2],
                            nacc[4 * h + 3]));
        __syncthreads();
        if (tid < BN) {
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < KC; ++k) s += red[k * BN + tid];
            out[(long long)nyq * m_pad + tid] = s;
        }
    }
}

template <int BN>
cudaError_t launch_dfb(const float* dmel, const float* reim, float* out,
                       int tiles, int rows, int n_splits, int rows_per_split,
                       int ldr, int m_pad, int n_freqs, int nyq,
                       cudaStream_t st) {
    const int smem = (int)sizeof(float) * DFB_STAGES * DFB_STAGE<BN>;
    cudaError_t err = cudaFuncSetAttribute(
        dfb_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dfb_kernel<BN>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    dfb_kernel<BN><<<dim3(tiles, m_pad / BN, n_splits), THREADS, smem, st>>>(
        dmel, reim, out, rows, rows_per_split, ldr, m_pad, n_freqs, nyq);
    return cudaGetLastError();
}

// dfb[i] = sum over splits, in split order, of part[split, i]
__global__ void __launch_bounds__(REDUCE_THREADS)
dfb_reduce_kernel(const float* __restrict__ part, float* __restrict__ dfb,
                  int n_splits, int n) {
    const int i = blockIdx.x * REDUCE_THREADS + threadIdx.x;
    if (i >= n) return;
    float s = 0.f;
    for (int k = 0; k < n_splits; ++k) s += part[(long long)k * n + i];
    dfb[i] = s;
}

// Pass A.  grid (ceil(rows / TB), ft_count): dp = dmel . fb_t^T for 64 rows
// and one frequency tile, then dreim = [2 re dp | 2 im dp] for that tile.
__global__ void __launch_bounds__(THREADS)
dreim_kernel(const float* __restrict__ dmel, const float* __restrict__ fb,
             const float* __restrict__ reim, float* __restrict__ dreim,
             int rows, int ldr, int m_pad) {
    __shared__ __align__(16) float a_s[KC * LD];   // dmel chunk [k][row]
    __shared__ __align__(16) float b_s[KC * LD];   // fb chunk   [k][bin]
    const int r0 = blockIdx.x * TB;
    const int t = blockIdx.y;
    const int tid = threadIdx.x;
    const int ty = tid / 16;
    const int tx = tid % 16;
    const int lr = tid / 4;           // loader: row / bin lr, K values lk..lk+3
    const int lk = (tid % 4) * 4;
    const bool row_ok = r0 + lr < rows;
    const float* dm = dmel + (long long)(r0 + lr) * m_pad + lk;
    const float* fp = fb + (long long)(t * FBT + lr) * m_pad + lk;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int m0 = 0; m0 < m_pad; m0 += KC) {
        st_kmajor(a_s, LD, lk, lr,
                  row_ok ? ld4(dm + m0) : make_float4(0.f, 0.f, 0.f, 0.f));
        st_kmajor(b_s, LD, lk, lr, ld4(fp + m0));
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
            const float4 a = ld4(&a_s[kk * LD + ty * 4]);
            const float4 b = ld4(&b_s[kk * LD + tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty * 4 + i;
        if (row >= rows) continue;
        const long long off = (long long)row * ldr + t * 2 * FBT + tx * 4;
        const float4 re = ld4(reim + off);
        const float4 im = ld4(reim + off + FBT);
        st4(dreim + off, make_float4(2.f * re.x * acc[i][0], 2.f * re.y * acc[i][1],
                                     2.f * re.z * acc[i][2], 2.f * re.w * acc[i][3]));
        st4(dreim + off + FBT,
            make_float4(2.f * im.x * acc[i][0], 2.f * im.y * acc[i][1],
                        2.f * im.z * acc[i][2], 2.f * im.w * acc[i][3]));
    }
}

// Pass B.  grid (ceil(rows / TB), ceil(fft / NB)):
// dframes[row, n] = sum_c dreim[row, c] * basis[n, c], c over ldr columns.
__global__ void __launch_bounds__(THREADS)
dframes_kernel(const float* __restrict__ dreim, const float* __restrict__ basis,
               float* __restrict__ dframes, int rows, int fft_length,
               int k_pad, int ldr) {
    __shared__ __align__(16) float a_s[KC * LD];      // dreim chunk [k][row]
    __shared__ __align__(16) float b_s[KC * NB_LD];   // basis chunk [k][n]
    const int r0 = blockIdx.x * TB;
    const int n0 = blockIdx.y * NB;
    const int tid = threadIdx.x;
    const int ty = tid / 16;
    const int tx = tid % 16;
    const int lr = tid / 4;           // loader: row lr and basis rows n0+lr,
    const int lk = (tid % 4) * 4;     // n0+64+lr; K values lk..lk+3
    const bool row_ok = r0 + lr < rows;
    const bool n_ok0 = n0 + lr < k_pad;
    const bool n_ok1 = n0 + NB / 2 + lr < k_pad;
    const float* ap = dreim + (long long)(r0 + lr) * ldr + lk;
    const float* bp0 = basis + (long long)(n0 + lr) * ldr + lk;
    const float* bp1 = bp0 + (long long)(NB / 2) * ldr;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < ldr; c0 += KC) {
        st_kmajor(a_s, LD, lk, lr, row_ok ? ld4(ap + c0) : zero);
        st_kmajor(b_s, NB_LD, lk, lr, n_ok0 ? ld4(bp0 + c0) : zero);
        st_kmajor(b_s, NB_LD, lk, NB / 2 + lr, n_ok1 ? ld4(bp1 + c0) : zero);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
            const float4 a = ld4(&a_s[kk * LD + ty * 4]);
            const float4 b0 = ld4(&b_s[kk * NB_LD + tx * 4]);
            const float4 b1 = ld4(&b_s[kk * NB_LD + NB / 2 + tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty * 4 + i;
        if (row >= rows) continue;
        float* dst = dframes + (long long)row * fft_length;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx * 4 + j;
            if (n < fft_length) dst[n] = acc[i][j];
            const int n1 = n + NB / 2;
            if (n1 < fft_length) dst[n1] = acc[i][4 + j];
        }
    }
}


// The frame passes of the FFT route in one kernel: dp as pass A forms it,
// dreim in registers, the inverse FFT of pass B.  One block per tile of FR
// consecutive frames of one stream (`frames` a stream, `tiles` a stream;
// the stream's last tile may be partial).
//   * dp[f, k] = sum_m dmel[f, m] * fbt[m, k] for the tile's rows stays in
//     shared memory, (FR, bins padded).  Each warp owns 32 * BPL of the N / 2
//     bins below Nyquist and a lane BPL of them for all FR rows in registers;
//     it reads the transposed filterbank as one row per mel and dmel, staged
//     mel-major in shared memory, as 16-byte loads.  Banded (bin_band's
//     bands cover at most DP_BAND_SHARE / 1024 of the dense product), a lane
//     sums the mels of its bins' bands joined, in the dense order, and one
//     thread a row sums the Nyquist bin's band; dense, every lane sums all
//     the mels (the filterbank rows coalesced, dmel broadcast) and the
//     Nyquist bin is summed by all threads, 1 / 16 of the mels each, and
//     added up in a fixed order.
//   * Then, FR rows in rounds of G = 4096 / N: Y_k = (re_k, im_k) * dp_k from
//     the residual (G_k / 2 with G = [2 re dp, 2 im dp]; Re G_k at k = 0 and
//     N / 2), the inverse transform and the window.  Rounds past the tile's
//     last frame are skipped.
//   * The epilogue, OLA false: the windowed frames go to dframes (rows, N),
//     the caller passes the rows as one stream.
//   * OLA true: the frames are overlap-added onto out = dx (streams,
//     n_samples), tile-local sample s = f * hop + n.  A round's G frames are
//     staged in their own parts of `work`; then each thread sums, for its
//     samples of the round's span (G - 1) * hop + N, what the round before
//     left of them and the round's frames, in a fixed order (ola_round).
//     A sample that no later frame of the tile reaches (below the next
//     round's first frame, or all of them in the tile's last round) goes to
//     dx; the rest stays in `ring`, a circular buffer of one span (sample s
//     at s mod span), for the next round.  With hop >= N / (FR + 1) the first and the last N -
//     hop samples of a tile are each shared with one neighbouring tile of
//     the stream and with no other: those go to dx by a float atomic add
//     onto the zeros that the launch set first, two partial sums each, so
//     the result is the same whichever lands first; every other sample is
//     stored once.  Samples past the last frame are not written.
// dmel (rows, m_pad); reim (rows, ldr) with ldr = 2 * (N / 2 + FBT); fbt
// (m_pad, N / 2 + FBT) the filterbank transposed, zero padded; bin_band
// (N / 2 + FBT) each bin's mel band (mel_band.cuh); window (N); twiddle: the
// N pairs of fft_smem.cuh's twiddle table; banded: 1 or 0 forces the
// banded or the dense dp product, -1 lets the bands decide; counter
// (mapped host memory, or null) gains one if the launch took the banded one.
constexpr int FR = 16;          // frames per block of the fused frame passes
constexpr int DM = 128;         // mels staged per step
// dp is summed over the bands where the lanes' joined bands are at most
// DP_BAND_SHARE / 1024 of the dense product's mels.  The frame pass is
// bound by its transform, so the banded dp stays the faster up to wide
// bands.  On an H100 (chip_smoke.py's band sweep, the band pass included)
// at config 2's shape 0.850 ms against the dense 0.878 at a 72 % share,
// 0.902 against 0.869 at 95 %; at config 3's (one bin a lane) 0.217
// against 0.223 at 49 %, 0.219 against 0.215 at 72 %.  The crossover lies
// near 80 % and 60 %; 50 % keeps to the banded side of both.
constexpr int DP_BAND_SHARE = 512;

// Loads W consecutive floats (W = 2: 8-byte aligned).
template <int W>
__device__ __forceinline__ void ld_w(float (&v)[W], const float* p) {
    if constexpr (W == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        v[0] = t.x;
        v[1] = t.y;
    } else {
        v[0] = *p;
    }
}

// One round of dframes_fft_kernel's overlap-add epilogue, in samples of
// the round's span from its first, `base` samples into the tile.
struct OlaRound {
    int ring0;      // where the span starts in the ring
    int span;       // (G - 1) * hop + N, the ring's length
    int carried;    // samples below this add what the ring holds of them
    int settled;    // samples from this go back to the ring, the rest to dx
    int end;        // samples from this are past the tile's last frame
    int count;      // the round's frames
    int base;
    int hop;
};

// After the round's frames are staged (frame q's sample n at float 2
// padded(q M + n / 2) + n % 2 of `staged`), the thread sums samples k ..
// k + W - 1 of the span for k = W tid, W (tid + FFT_THREADS), ...: W = 2
// with an even hop, where a pair lies whole in every frame, in the carried
// part, in a seam and in the settled part.  `dxt` is the tile's first
// sample of dx; `lead` / `trail`: the tile shares its first / last N - hop
// samples with a neighbour.
template <int N, int W>
__device__ __forceinline__ void ola_round(const float* __restrict__ staged,
                                          float* ring, float* dxt,
                                          const OlaRound& r, bool lead,
                                          bool trail) {
    constexpr int M = N / 2;
    const float inv_hop = 1.f / (float)r.hop;
    for (int k = W * threadIdx.x; k < r.end; k += W * tacfft::FFT_THREADS) {
        int slot = r.ring0 + k;
        if (slot >= r.span) slot -= r.span;
        float sum[W] = {};
        if (k < r.carried) ld_w<W>(sum, ring + slot);
        // frames q <= k / hop reach k while k - q * hop < N; the last first
        int q = min(r.count - 1, (int)(((float)k + 0.5f) * inv_hop));
        for (int n = k - q * r.hop; q >= 0 && n < N; --q, n += r.hop) {
            float t[W];
            ld_w<W>(t, staged + 2 * tacfft::padded(q * M + (n >> 1)) + (n & 1));
#pragma unroll
            for (int w = 0; w < W; ++w) sum[w] += t[w];
        }
        if (k >= r.settled) {
#pragma unroll
            for (int w = 0; w < W; ++w) ring[slot + w] = sum[w];
            continue;
        }
        const int s = r.base + k;
        if ((lead && s < N - r.hop) || (trail && s >= FR * r.hop)) {
#pragma unroll
            for (int w = 0; w < W; ++w) atomicAdd(dxt + s + w, sum[w]);
        } else {
#pragma unroll
            for (int w = 0; w < W; ++w) dxt[s + w] = sum[w];
        }
    }
}

template <int N, bool OLA>
__global__ void __launch_bounds__(tacfft::FFT_THREADS, 2)
dframes_fft_kernel(const float* __restrict__ dmel,
                   const float* __restrict__ reim,
                   const float* __restrict__ fbt,
                   const int2* __restrict__ bin_band,
                   const float* __restrict__ window,
                   const float2* __restrict__ twiddle,
                   float* __restrict__ out, int frames, int tiles, int m_pad,
                   int hop, int n_samples, int banded, int* counter) {
    using namespace tacfft;
    constexpr int M = N / 2;
    constexpr int TPF = M / POINTS;
    constexpr int G = ROUND_POINTS / M;
    constexpr int KP = M + FBT;
    constexpr int LDR = 2 * KP;
    constexpr int WARPS = FFT_THREADS / 32;
    constexpr int BPL = M / (32 * WARPS) > 0 ? M / (32 * WARPS) : 1;
    constexpr int TASKS = M / (32 * BPL);        // warps with bins to sum
    static_assert(G <= FR && FR % G == 0
                  && FR * DM + FFT_THREADS <= 2 * WORK_POINTS,
                  "a round's rows fit the block; dmel is staged in `work`");
    extern __shared__ __align__(16) float smem[];
    float2* work = reinterpret_cast<float2*>(smem);      // (WORK_POINTS)
    float2* tw_s = work + WORK_POINTS;                   // (N)
    float* dp_s = reinterpret_cast<float*>(tw_s + N);    // (FR, KP)
    float* ring = dp_s + FR * KP;        // (span) OLA: the sums carried on
    float* dm_s = smem;                  // (DM, FR) dmel, mel-major; in `work`
    float* ny_s = dm_s + FR * DM;        // (16, FR) partial sums of bin M

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int tile = blockIdx.x % tiles;
    const long long stream = blockIdx.x / tiles;
    const int nf = min(FR, frames - tile * FR);          // the tile's frames
    const long long r0 = stream * frames + (long long)tile * FR;

    load_twiddles<N>(tw_s, twiddle);

    // the mels of the lane's bins' bands, of the Nyquist bin's, and the
    // lanes' joined bands summed over the block
    const int k0 = (warp * 32 + lane) * BPL;
    int2 band = make_int2(tacband::EMPTY, 0);
    if (warp < TASKS)
#pragma unroll
        for (int c = 0; c < BPL; ++c) band = tacband::join(band, bin_band[k0 + c]);
    const int2 nband = bin_band[M];
    int mels = max(band.y - band.x, 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mels += __shfl_xor_sync(0xffffffffu, mels, o);
    __shared__ int work_s[WARPS];
    if (lane == 0) work_s[warp] = mels;
    __syncthreads();
    if (banded < 0) {
        long long total = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) total += work_s[w];
        banded = total * 1024 <= (long long)DP_BAND_SHARE * TASKS * 32 * m_pad;
    }
    if (!banded) band = make_int2(0, m_pad);

    // dp for the tile's rows
    float acc[FR][BPL];
#pragma unroll
    for (int f = 0; f < FR; ++f)
#pragma unroll
        for (int c = 0; c < BPL; ++c) acc[f][c] = 0.f;
    float nyq = 0.f;
    for (int mc = 0; mc < m_pad; mc += DM) {
        const int width = min(DM, m_pad - mc);
        __syncthreads();                 // the staged chunk before is consumed
        for (int idx = tid; idx < FR * width; idx += FFT_THREADS) {
            const int f = idx / width;
            const int m = idx % width;
            dm_s[m * FR + f] = f < nf ? dmel[(r0 + f) * m_pad + mc + m] : 0.f;
        }
        __syncthreads();
        if (warp < TASKS) {
            const int m_end = min(band.y - mc, width);
#pragma unroll 2
            for (int m = max(band.x - mc, 0); m < m_end; ++m) {
                const float* row = fbt + (long long)(mc + m) * KP + k0;
                float w[BPL];
                if constexpr (BPL == 4) {
                    const float4 t = *reinterpret_cast<const float4*>(row);
                    w[0] = t.x;
                    w[1] = t.y;
                    w[2] = t.z;
                    w[3] = t.w;
                } else if constexpr (BPL == 2) {
                    const float2 t = *reinterpret_cast<const float2*>(row);
                    w[0] = t.x;
                    w[1] = t.y;
                } else {
                    w[0] = *row;
                }
#pragma unroll
                for (int f4 = 0; f4 < FR; f4 += 4) {
                    const float4 d = *reinterpret_cast<const float4*>(&dm_s[m * FR + f4]);
#pragma unroll
                    for (int c = 0; c < BPL; ++c) {
                        acc[f4 + 0][c] = fmaf(d.x, w[c], acc[f4 + 0][c]);
                        acc[f4 + 1][c] = fmaf(d.y, w[c], acc[f4 + 1][c]);
                        acc[f4 + 2][c] = fmaf(d.z, w[c], acc[f4 + 2][c]);
                        acc[f4 + 3][c] = fmaf(d.w, w[c], acc[f4 + 3][c]);
                    }
                }
            }
        }
        if (banded) {
            // bin M: thread f sums row f over the bin's band
            if (tid < FR) {
                const int m_end = min(nband.y - mc, width);
                for (int m = max(nband.x - mc, 0); m < m_end; ++m)
                    nyq = fmaf(dm_s[m * FR + tid],
                               fbt[(long long)(mc + m) * KP + M], nyq);
            }
        } else {
            // bin M: thread (part, f) sums mels part, part + 16, ...
            for (int m = tid / FR; m < width; m += FFT_THREADS / FR)
                nyq = fmaf(dm_s[m * FR + tid % FR],
                           fbt[(long long)(mc + m) * KP + M], nyq);
        }
    }
    ny_s[tid] = nyq;
    if (warp < TASKS) {
#pragma unroll
        for (int f = 0; f < FR; ++f)
#pragma unroll
            for (int c = 0; c < BPL; ++c) dp_s[f * KP + k0 + c] = acc[f][c];
    }
    __syncthreads();
    if (tid < FR) {
        float sum = nyq;
        if (!banded) {
            sum = 0.f;
            for (int part = 0; part < FFT_THREADS / FR; ++part)
                sum += ny_s[part * FR + tid];
        }
        dp_s[tid * KP + M] = sum;
    }
    __syncthreads();                     // dp_s complete; `work` is free

    const int g = tid / TPF;
    const int j = tid % TPF;
    // OLA: the samples a round's frames cover, and where the ring starts
    const int span = (G - 1) * hop + N;
    int ring0 = 0;
    float* dxt = out + stream * n_samples + (long long)tile * FR * hop;
    for (int round = 0; round * G < nf; ++round) {
        const int f = round * G + g;
        const bool ok = f < nf;
        const float* re = reim + (r0 + f) * LDR;
        const float* dp = dp_s + f * KP;
        float2 v[POINTS];
#pragma unroll
        for (int m = 0; m < POINTS; ++m) {
            const int k = j + m * TPF;              // 0..M-1
            const int kn = M - k;                   // 1..M
            const int ck = (k / FBT) * 2 * FBT + k % FBT;
            const int cn = (kn / FBT) * 2 * FBT + kn % FBT;
            float2 yk = make_float2(0.f, 0.f), yn = yk;
            if (ok) {
                const float dk = dp[k], dn = dp[kn];
                yk = k == 0 ? make_float2(2.f * re[ck] * dk, 0.f)
                            : make_float2(re[ck] * dk, re[ck + FBT] * dk);
                yn = k == 0 ? make_float2(2.f * re[cn] * dn, 0.f)
                            : make_float2(re[cn] * dn, re[cn + FBT] * dn);
            }
            v[m] = hermitian_point(yk, yn, tw_s[k]);
        }
        // OLA: the round before has read its staged frames; waiting here
        // lets this round's residual loads overlap that
        if (OLA && round > 0) __syncthreads();
        fft_block<M, true>(v, work, tw_s + M, g, j);
        if constexpr (!OLA) {
            if (!ok) continue;
            float* dst = out + (r0 + f) * N;
#pragma unroll
            for (int m = 0; m < POINTS; ++m) {
                const int n = 2 * (j + m * TPF);
                const float2 w = *reinterpret_cast<const float2*>(window + n);
                *reinterpret_cast<float2*>(dst + n) =
                    make_float2(w.x * v[m].x, w.y * v[m].y);
            }
        } else {
            // the transform's own part of `work` is free again: stage the
            // windowed frame there, sample n at float 2 padded(g M + n / 2)
            // + n % 2
#pragma unroll
            for (int m = 0; m < POINTS; ++m) {
                const int n = 2 * (j + m * TPF);
                const float2 w = *reinterpret_cast<const float2*>(window + n);
                work[padded(g * M + n / 2)] =
                    make_float2(w.x * v[m].x, w.y * v[m].y);
            }
            __syncthreads();                 // the round's frames are staged
            const int base = round * G * hop;            // tile-local
            const bool last = (round + 1) * G >= nf;
            const OlaRound r = {ring0, span, round > 0 ? N - hop : 0,
                                last ? span : G * hop,
                                min(span, (nf - 1) * hop + N - base),
                                min(G, nf - round * G), base, hop};
            const float* staged = reinterpret_cast<const float*>(work);
            if (hop % 2 == 0)
                ola_round<N, 2>(staged, ring, dxt, r, tile > 0, tile + 1 < tiles);
            else
                ola_round<N, 1>(staged, ring, dxt, r, tile > 0, tile + 1 < tiles);
            ring0 += G * hop;
            if (ring0 >= span) ring0 -= span;
        }
    }
    // last, so that no thread of the block waits on the host's memory
    if (banded && counter && blockIdx.x == 0 && tid == 0)
        tacband::count_launch(counter);
}

template <int N, bool OLA>
cudaError_t launch_dframes_fft(const float* dmel, const float* reim,
                               const float* fbt, const int* bin_band,
                               const float* window, const float* twiddle,
                               float* out, int streams, int frames, int m_pad,
                               int hop, int n_samples, int banded,
                               int* counter, cudaStream_t st) {
    const int tiles = (frames + FR - 1) / FR;
    size_t smem = sizeof(float2) * (tacfft::WORK_POINTS + N)
                  + sizeof(float) * FR * (N / 2 + FBT);
    if (OLA) smem += sizeof(float) * ((tacfft::ROUND_POINTS / (N / 2) - 1) * hop + N);
    cudaError_t err = cudaFuncSetAttribute(
        dframes_fft_kernel<N, OLA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    dframes_fft_kernel<N, OLA><<<(unsigned)((long long)streams * tiles),
                                 tacfft::FFT_THREADS, smem, st>>>(
        dmel, reim, fbt, reinterpret_cast<const int2*>(bin_band), window,
        reinterpret_cast<const float2*>(twiddle), out, frames, tiles, m_pad,
        hop, n_samples, banded, counter);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the backward passes on `stream`; returns the first cudaError_t
// (0 on success).  Does not synchronise and allocates nothing.
//   dmel (rows, m_pad), reim (rows, ldr), fb (f_pad, m_pad) (the
//   DFT-route frame passes only), basis (k_pad, ldr) with ldr = ft_count *
//   2 * FBT, f_pad = ft_count * FBT.
//   dfb (n_freqs, m_pad) or null, n_freqs = fft_length / 2 + 1: the
//     filterbank gradient; n_splits contiguous splits of rows_per_split
//     rows (a multiple of KC), each but the last full; with n_splits > 1
//     dfb_part (n_splits, n_freqs, m_pad) holds the per-split sums.
//   dframes (rows, fft_length) or null: the frame gradient; dreim (rows,
//     ldr) is its scratch.
//   The frame passes run as one kernel around an inverse FFT when `twiddle`
//     is given: fft_length a power of two in [256, 2048], `window` its
//     fft_length samples, `twiddle` the fft_length pairs of fft_smem.cuh's
//     twiddle table, `fbt` (m_pad, f_pad) the transposed filterbank and
//     `bin_band` (f_pad, 2) its bins' mel bands, as tac_mel_bands writes
//     them; `banded` 1 or 0 forces the banded or the dense dp product, -1
//     lets the bands decide, and `counter` (mapped host memory, or null)
//     gains one if the launch took the banded one; `fb`, `basis` and `dreim`
//     are then not used.  Otherwise they are pass A and the product with
//     `basis`.
//   dx (streams, n_samples) or null, with dframes null and `twiddle` given:
//     the waveform gradient, the frame gradient overlap-added in that
//     kernel (dframes_fft_kernel<N, true>).  The rows are `streams` streams
//     of n_frames = 1 + (n_samples - fft_length) / hop_length frames each,
//     fft_length / (FR + 1) <= hop_length <= fft_length; dx is set to zero
//     first (a memset on `stream`), so samples past the last frame are 0.
int tac_fused_mel_bwd(const float* dmel, const float* reim, const float* fb,
                      const float* fbt, const int* bin_band,
                      const float* basis, const float* window,
                      const float* twiddle, float* dreim, float* dframes,
                      float* dx, float* dfb, float* dfb_part, int rows,
                      int fft_length, int k_pad, int ft_count, int m_pad,
                      int n_splits, int rows_per_split, int hop_length,
                      int n_samples, int banded, int* counter, void* stream) {
    if (rows <= 0) return 0;
    if (m_pad <= 0 || m_pad % MC != 0 || ft_count <= 0 || fft_length < 2
        || (dx && dframes) || banded < -1 || banded > 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int ldr = ft_count * 2 * FBT;
    cudaError_t err;
    if (dfb) {
        // 128-bin tiles; a lone last bin is folded into tile 0's blocks
        const int n_freqs = fft_length / 2 + 1;
        const int nyq = n_freqs % DFB_BM == 1 && n_freqs > DFB_BM ? n_freqs - 1 : -1;
        const int tiles = n_freqs / DFB_BM + (n_freqs % DFB_BM != 0 && nyq < 0);
        if (n_splits < 1 || n_splits > 65535 || rows_per_split % KC != 0
            || (long long)n_splits * rows_per_split < rows
            || (long long)(n_splits - 1) * rows_per_split >= rows
            || ft_count != (n_freqs + FBT - 1) / FBT
            || (n_splits > 1 && !dfb_part))
            return (int)cudaErrorInvalidValue;
        float* out = n_splits > 1 ? dfb_part : dfb;
        err = m_pad % DFB_BN == 0
                  ? launch_dfb<DFB_BN>(dmel, reim, out, tiles, rows, n_splits,
                                       rows_per_split, ldr, m_pad, n_freqs, nyq, st)
                  : launch_dfb<MC>(dmel, reim, out, tiles, rows, n_splits,
                                   rows_per_split, ldr, m_pad, n_freqs, nyq, st);
        if (err != cudaSuccess) return (int)err;
        if (n_splits > 1) {
            const int n = n_freqs * m_pad;
            dfb_reduce_kernel<<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS,
                                REDUCE_THREADS, 0, st>>>(dfb_part, dfb, n_splits, n);
            if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        }
    }
    if ((dframes || dx) && twiddle) {
        if (!(fbt && bin_band && window && fft_length % 2 == 0
              && tacfft::fft_size_ok(fft_length / 2)
              && ft_count == fft_length / (2 * FBT) + 1))
            return (int)cudaErrorInvalidValue;
        int streams = 1, frames = rows;
        if (dx) {
            if (!(hop_length <= fft_length
                  && (long long)(FR + 1) * hop_length >= fft_length
                  && n_samples >= fft_length))
                return (int)cudaErrorInvalidValue;
            frames = 1 + (n_samples - fft_length) / hop_length;
            streams = rows / frames;
            if (rows % frames != 0) return (int)cudaErrorInvalidValue;
            err = cudaMemsetAsync(dx, 0, sizeof(float) * streams * (size_t)n_samples, st);
            if (err != cudaSuccess) return (int)err;
        }
#define TAC_FFT_CASE(n)                                                       \
    case n:                                                                   \
        err = dx ? launch_dframes_fft<n, true>(                               \
                       dmel, reim, fbt, bin_band, window, twiddle, dx,        \
                       streams, frames, m_pad, hop_length, n_samples, banded, \
                       counter, st)                                           \
                 : launch_dframes_fft<n, false>(                              \
                       dmel, reim, fbt, bin_band, window, twiddle, dframes,   \
                       1, rows, m_pad, 0, 0, banded, counter, st);            \
        break
        switch (fft_length) {
            TAC_FFT_CASE(256);
            TAC_FFT_CASE(512);
            TAC_FFT_CASE(1024);
            TAC_FFT_CASE(2048);
            default: err = cudaErrorInvalidValue;
        }
#undef TAC_FFT_CASE
        if (err != cudaSuccess) return (int)err;
    } else if (dframes) {
        if (!(fb && dreim && basis && k_pad >= fft_length))
            return (int)cudaErrorInvalidValue;
        const int row_blocks = (rows + TB - 1) / TB;
        dreim_kernel<<<dim3(row_blocks, ft_count), THREADS, 0, st>>>(
            dmel, fb, reim, dreim, rows, ldr, m_pad);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        dframes_kernel<<<dim3(row_blocks, (fft_length + NB - 1) / NB), THREADS, 0, st>>>(
            dreim, basis, dframes, rows, fft_length, k_pad, ldr);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    } else if (dx) {
        return (int)cudaErrorInvalidValue;
    }
    return 0;
}

// Tile constants the host wrapper lays its operands out for.
int tac_fused_mel_bwd_tile(int which) {
    switch (which) {
        case 0: return TB;
        case 1: return FBT;
        case 2: return KC;
        case 3: return MC;
        case 4: return FR;
        case 5: return DFB_BM;
        case 6: return DFB_BN;
        case 7: return DP_BAND_SHARE;
        default: return -1;
    }
}

}  // extern "C"
