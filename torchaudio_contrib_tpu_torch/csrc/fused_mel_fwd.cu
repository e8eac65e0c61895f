// Fused (log-)mel spectrogram forward for Hopper (sm_90a).
//
// Replaces torchaudio_contrib_tpu/ops/fused.py::_build_fwd_call (kernel B1
// of the JAX package): waveform -> windowed onesided DFT -> |.|^2 -> mel
// filterbank -> optional dB, in one kernel, for any fft_length >= 2 and
// any hop_length > 0.
//
//   out[s, m, f] = dB( sum_k fb[k, m] * (re[s, f, k]^2 + im[s, f, k]^2) )
//   re + i*im    = sum_n x[s, f*hop + n] * w[n] * exp(-2 pi i k n / fft)
//
// Two kernels, chosen by fft_length alone:
//
// A. fused_mel_fft_fwd_kernel<N>, for N = fft_length a power of two in
//    [256, 2048]: the transform is an FFT in shared memory (fft_smem.cuh).
//    What bounds it: the FFT's shared-memory traffic (5 N log2 N FLOPs a
//    frame, 15.5 GFLOP at 32 x 30 s, fft 2048, but ~23 shared-memory
//    accesses per 8 points and pass) wherever the filterbank is banded, as
//    every mel or linear filterbank is; the dense mel product (2 * bins *
//    mels FLOPs a frame, 10.8 GFLOP there) only for a filterbank whose
//    entries are mostly nonzero, such as a learned one.  Device-memory
//    bytes are two orders below either.  What the design does about it:
//      * One block per (stream, FR = 16 frames).  A real frame is one
//        complex transform of N / 2 points (even samples real, odd
//        imaginary), windowed on the way in from the waveform at any hop,
//        and split into its N / 2 + 1 bins after it.  Frames past n_frames
//        load zeros and are not stored.
//      * The power of the block's frames stays in shared memory, (FR,
//        bins) with the bins padded to the 64-bin tiles of the residual;
//        the spectrum never reaches device memory unless asked for.
//      * The mel product runs over the filterbank's nonzero bands only
//        (mel_band_kernel's tables, written on every call: a filterbank
//        changed in place is always seen; a thread loads its mel's band
//        before the transform and the block decides after it).  A skipped
//        term is an exact zero weight times a power, so the banded sum is
//        the dense sum in another order.  A thread owns one mel and 8 (or
//        4) frames and sums 4 bins a step from the transposed filterbank:
//        32 FMAs per 9 16-byte loads, about 2 440 x 16 FMAs a block at
//        config 2 (1.9 % of the dense product); no sum across warps.
//      * Where the bands cover more than B1_BAND_SHARE of the dense product
//        (a learned filterbank), every block takes the dense product
//        instead: the bins split over the 8 warps; a lane owns 4 (or 2)
//        mels x all 16 frames in registers, reads the power as broadcast
//        16-byte loads and the filterbank from L2 as one coalesced row per
//        bin: 64 FMAs per 5 loads; the warps' partial sums are added
//        through shared memory in a fixed order.  Every block decides from
//        the tables alone, so all decide alike.
//      * The residual (SAVE_SPEC) is written in kernel B's layout, 128
//        bytes per warp and store.
// B. fused_mel_fwd_kernel, for every other size (Whisper's 400, odd and
//    very small sizes): the transform as a dense product with the windowed
//    DFT basis.  What bounds it: that product, 2 * fft * 2 * F FLOPs a
//    frame (F = onesided bins padded to the tile), ~160 x an FFT's count,
//    as FP32 FMAs on CUDA cores.  The tensor cores do not save it: the
//    same product through cuBLAS took 7.5 ms in FP32, 2.8 ms in TF32 (7.9e-4
//    of peak off, over the 1e-5 bar), 9.6 ms in 3xTF32 and 1.7 ms in BF16
//    (5e-3 off) at 32 x 30 s on an H100, every f32-grade tier slower than
//    the torch.stft chain's 1.45 ms; so the power-of-two sizes went to A.
//
// What kernel B's design does:
//   * One thread block per (stream, block of TB frames).  The block walks
//     the frequency tiles in a loop, so the (TB, mels) accumulator stays in
//     shared memory for the whole block: no cross-block reduction, and the
//     spectrum never reaches device memory.
//   * Frames are read straight from the waveform with strided loads at any
//     hop; the fft axis is a K-loop over KT-sample shared-memory tiles, so
//     the (TB, fft) frame matrix is never held whole.  Ragged edges are
//     masked in the kernel: frames past n_frames load zeros and are not
//     stored, samples past fft_length load zeros, bins past n_freqs have
//     zero basis columns and zero filterbank rows, mels past num_mels are
//     not stored.
//   * Each thread keeps a 4-frame x 4-bin register tile of both re and im,
//     so the power is formed in registers and only the (TB, FBT) power tile
//     goes through shared memory into the mel product.
//   * The windowed basis (fft rounded up to KT, FT*2*FBT) is built once per
//     config by the host and stays on the device (it fits in L2 at the
//     main configs); the filterbank is passed on every call because it may
//     be a trainable parameter.
//
// Both kernels: for training, an optional second output `reim` (the JAX
// kernel's save_spec residual) takes re/im before the power is formed:
// (n_streams, n_frames, FT*2*FBT), tile t columns [re_t | im_t], zeros in
// the bins past n_freqs.  Frames past n_frames are not stored.  It is a
// template flag, so the serving instantiation is the kernel without it.

#include <cuda_runtime.h>

#include "fft_smem.cuh"
#include "mel_band.cuh"

namespace {

constexpr int TB = 64;          // frames per block
constexpr int FBT = 64;         // onesided bins per frequency tile
constexpr int KT = 16;          // fft samples per K step
constexpr int MC = 64;          // mel columns per step of the mel product
constexpr int THREADS = 256;    // 16 x 16: thread (ty, tx) owns 4 frames x 4 bins
constexpr int A_LD = TB + 4;    // padded leading dims: 16-byte aligned rows,
constexpr int P_LD = FBT + 4;   // fewer shared-memory bank conflicts

static_assert(TB == 16 * 4 && FBT == 16 * 4 && MC == 16 * 4,
              "the 16 x 16 thread grid owns 4 x 4 tiles");
static_assert(KT * TB == 4 * THREADS, "frame tile: 4 loads per thread");
static_assert(KT * 2 * FBT == 8 * THREADS, "basis tile: 2 float4 per thread");
static_assert(FBT * MC == 16 * THREADS, "filterbank tile: 4 float4 per thread");

__host__ __device__ inline int mel_ld(int m_pad) { return m_pad + 4; }

size_t smem_bytes(int m_pad) {
    return sizeof(float) * (size_t)(KT * A_LD + KT * 2 * FBT + TB * P_LD
                                    + FBT * MC + TB * mel_ld(m_pad));
}

// x      (n_streams, n_samples)           waveform, row-major
// basis  (k_pad, ft_count * 2 * FBT)      tile t columns = [w*cos_t | -w*sin_t],
//                                          rows >= fft_length are zero
// fb     (ft_count * FBT, m_pad)          filterbank, zero padded
// out    (n_streams, num_mels, n_frames)
// reim   (n_streams, n_frames, ft_count * 2 * FBT)  written when SAVE_SPEC
template <bool SAVE_SPEC>
__global__ void __launch_bounds__(THREADS)
fused_mel_fwd_kernel(const float* __restrict__ x,
                     const float* __restrict__ basis,
                     const float* __restrict__ fb,
                     float* __restrict__ out,
                     float* __restrict__ reim,
                     int n_samples, int fft_length, int hop_length,
                     int n_frames, int ft_count, int num_mels, int m_pad,
                     int to_db, float amin, float db_offset) {
    extern __shared__ __align__(16) float smem[];
    float* a_s = smem;                        // (KT, A_LD)  frames, k-major
    float* b_s = a_s + KT * A_LD;             // (KT, 2*FBT) basis tile
    float* p_s = b_s + KT * 2 * FBT;          // (TB, P_LD)  power tile
    float* f_s = p_s + TB * P_LD;             // (FBT, MC)   filterbank tile
    float* mel_s = f_s + FBT * MC;            // (TB, m_ld)  mel accumulator
    const int m_ld = mel_ld(m_pad);

    const int tid = threadIdx.x;
    const int ty = tid / 16;
    const int tx = tid % 16;
    const int f0 = blockIdx.x * TB;
    const int s = blockIdx.y;
    const float* xs = x + (long long)s * n_samples;
    const int ldb = ft_count * 2 * FBT;
    const int k_steps = (fft_length + KT - 1) / KT;

    for (int mc = 0; mc < m_pad; mc += MC)
        for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(&mel_s[(ty * 4 + i) * m_ld + mc + tx * 4]) =
                make_float4(0.f, 0.f, 0.f, 0.f);

    for (int t = 0; t < ft_count; ++t) {
        float re[4][4], im[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

        for (int ks = 0; ks < k_steps; ++ks) {
            const int k0 = ks * KT;
            for (int l = 0; l < 4; ++l) {
                const int idx = tid + l * THREADS;
                const int k = idx % KT;
                const int r = idx / KT;
                const int frame = f0 + r;
                float v = 0.f;
                if (frame < n_frames && k0 + k < fft_length)
                    v = xs[(long long)frame * hop_length + k0 + k];
                a_s[k * A_LD + r] = v;
            }
            for (int l = 0; l < 2; ++l) {
                const int idx4 = tid + l * THREADS;
                const int row = idx4 / (2 * FBT / 4);
                const int c4 = idx4 % (2 * FBT / 4);
                *reinterpret_cast<float4*>(&b_s[row * 2 * FBT + c4 * 4]) =
                    *reinterpret_cast<const float4*>(
                        &basis[(long long)(k0 + row) * ldb + t * 2 * FBT + c4 * 4]);
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
                const float4 a = *reinterpret_cast<const float4*>(&a_s[kk * A_LD + ty * 4]);
                const float4 br = *reinterpret_cast<const float4*>(&b_s[kk * 2 * FBT + tx * 4]);
                const float4 bi = *reinterpret_cast<const float4*>(&b_s[kk * 2 * FBT + FBT + tx * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float rv[4] = {br.x, br.y, br.z, br.w};
                const float iv[4] = {bi.x, bi.y, bi.z, bi.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        re[i][j] = fmaf(av[i], rv[j], re[i][j]);
                        im[i][j] = fmaf(av[i], iv[j], im[i][j]);
                    }
            }
            __syncthreads();
        }

        if (SAVE_SPEC) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int frame = f0 + ty * 4 + i;
                if (frame >= n_frames) continue;
                float* dst = reim + ((long long)s * n_frames + frame) * ldb
                             + t * 2 * FBT + tx * 4;
                *reinterpret_cast<float4*>(dst) =
                    make_float4(re[i][0], re[i][1], re[i][2], re[i][3]);
                *reinterpret_cast<float4*>(dst + FBT) =
                    make_float4(im[i][0], im[i][1], im[i][2], im[i][3]);
            }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(&p_s[(ty * 4 + i) * P_LD + tx * 4]) = make_float4(
                re[i][0] * re[i][0] + im[i][0] * im[i][0],
                re[i][1] * re[i][1] + im[i][1] * im[i][1],
                re[i][2] * re[i][2] + im[i][2] * im[i][2],
                re[i][3] * re[i][3] + im[i][3] * im[i][3]);

        for (int mc = 0; mc < m_pad; mc += MC) {
            __syncthreads();   // p_s written / previous f_s chunk consumed
            for (int l = 0; l < 4; ++l) {
                const int idx4 = tid + l * THREADS;
                const int j = idx4 / (MC / 4);
                const int c4 = idx4 % (MC / 4);
                *reinterpret_cast<float4*>(&f_s[j * MC + c4 * 4]) =
                    *reinterpret_cast<const float4*>(
                        &fb[(long long)(t * FBT + j) * m_pad + mc + c4 * 4]);
            }
            __syncthreads();
            float acc[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
            for (int j = 0; j < FBT; ++j) {
                const float4 fv = *reinterpret_cast<const float4*>(&f_s[j * MC + tx * 4]);
                const float fw[4] = {fv.x, fv.y, fv.z, fv.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p = p_s[(ty * 4 + i) * P_LD + j];
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(p, fw[c], acc[i][c]);
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float4* dst = reinterpret_cast<float4*>(&mel_s[(ty * 4 + i) * m_ld + mc + tx * 4]);
                float4 v = *dst;
                v.x += acc[i][0];
                v.y += acc[i][1];
                v.z += acc[i][2];
                v.w += acc[i][3];
                *dst = v;
            }
        }
        __syncthreads();   // p_s and f_s free for the next tile
    }

    // epilogue: dB in place of the store, frames along the fastest index
    // of the (stream, mel, frame) output so neighbouring threads store to
    // neighbouring addresses
    const float db_scale = 4.342944819032518f;   // 10 / ln(10)
    for (int idx = tid; idx < TB * num_mels; idx += THREADS) {
        const int r = idx % TB;
        const int m = idx / TB;
        const int frame = f0 + r;
        if (frame >= n_frames) continue;
        float v = mel_s[r * m_ld + m];
        if (to_db) v = db_scale * logf(fmaxf(v, amin)) - db_offset;
        out[((long long)s * num_mels + m) * n_frames + frame] = v;
    }
}

template <bool SAVE_SPEC>
int launch(const float* x, const float* basis, const float* fb, float* out,
           float* reim, int n_streams, int n_samples, int fft_length,
           int hop_length, int n_frames, int ft_count, int num_mels,
           int m_pad, int to_db, float amin, float db_offset,
           cudaStream_t stream) {
    const size_t smem = smem_bytes(m_pad);
    cudaError_t err = cudaFuncSetAttribute(
        fused_mel_fwd_kernel<SAVE_SPEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_frames + TB - 1) / TB, n_streams);
    fused_mel_fwd_kernel<SAVE_SPEC><<<grid, THREADS, smem, stream>>>(
        x, basis, fb, out, reim, n_samples, fft_length, hop_length, n_frames,
        ft_count, num_mels, m_pad, to_db, amin, db_offset);
    return (int)cudaGetLastError();
}


// ---- the filterbank's bands --------------------------------------------------

constexpr int BAND_LD = FBT + 1;        // the band pass's tile row
constexpr int BAND_MELS = 8;            // mels a column block of the band pass

// grid (ft_count + m_pad / BAND_MELS), two kinds of block.  Reads fb
// (n_freqs, num_mels) at strides (s0, s1) and writes, where the pointer is
// given:
//   fbp      (ft_count * FBT, m_pad)  the filterbank zero padded
//   fbt      (m_pad, ft_count * FBT)  the same transposed
//   mel_band (m_pad) int2             mel m's bins from its first nonzero
//                                      to its last: [lo, hi) (mel_band.cuh)
//   bin_band (ft_count * FBT) int2    bin k's mels, likewise
// Blocks [0, ft_count) own FBT bin rows and all mels, in chunks of 64: a
// thread loads 16 entries of a 64 x 64 chunk (the next chunk's loads in
// flight while this one is copied and scanned), scans 16 mels of one bin,
// and the four quarters are joined.  Blocks from ft_count own BAND_MELS mel
// columns and all bins: 32 lanes of rows a mel, joined by shuffles and
// through shared memory.  "Nonzero" is != 0, so NaN, inf and denormal
// entries lie in a band.  The bands are minima and maxima of indices, the
// same in any order, so the pass is deterministic; it keeps nothing from
// one call to the next.
__global__ void __launch_bounds__(THREADS)
mel_band_kernel(const float* __restrict__ fb, long long s0, long long s1,
                int n_freqs, int num_mels, int m_pad, int ft_count,
                float* __restrict__ fbp, float* __restrict__ fbt,
                int2* __restrict__ mel_band, int2* __restrict__ bin_band) {
    constexpr int Q = THREADS / FBT;            // quarters of a row or column
    constexpr int RQ = FBT / Q;                 // rows (mels) a quarter
    constexpr int RL = THREADS / BAND_MELS;     // lanes of rows a mel
    static_assert(RL % 32 == 0 && 32 % BAND_MELS == 0, "row lanes");
    __shared__ float tile[FBT * BAND_LD];
    __shared__ int2 part[Q][FBT];               // quarters' bin bands
    const int tid = threadIdx.x;
    if (blockIdx.x >= ft_count) {
        // mel m over rows r, r + RL, ...; the lanes of a warp hold 32 /
        // BAND_MELS row lanes of each of its mels
        const int m = (blockIdx.x - ft_count) * BAND_MELS + tid % BAND_MELS;
        int2 band = make_int2(tacband::EMPTY, 0);
        if (m < num_mels)
#pragma unroll 4
            for (int k = tid / BAND_MELS; k < n_freqs; k += RL)
                if (fb[k * s0 + m * s1] != 0.f)
                    band = make_int2(min(band.x, k), k + 1);
#pragma unroll
        for (int o = BAND_MELS; o < 32; o <<= 1)
            band = tacband::join(
                band, make_int2(__shfl_xor_sync(0xffffffffu, band.x, o),
                                __shfl_xor_sync(0xffffffffu, band.y, o)));
        int2* red = &part[0][0];                // (warps, BAND_MELS)
        if ((tid & 31) < BAND_MELS) red[(tid >> 5) * BAND_MELS + (tid & 31)] = band;
        __syncthreads();
        if (tid < BAND_MELS) {
            for (int w = 1; w < THREADS / 32; ++w)
                band = tacband::join(band, red[w * BAND_MELS + tid]);
            mel_band[m] = band;
        }
        return;
    }
    const int col = tid % FBT;
    const int q = tid / FBT;
    const int b0 = blockIdx.x * FBT;
    const int ldt = ft_count * FBT;
    auto load = [&](int mc, float (&v)[RQ]) {
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const int k = b0 + q + Q * i;
            const int m = mc + col;
            v[i] = k < n_freqs && m < num_mels ? fb[k * s0 + m * s1] : 0.f;
        }
    };
    float v[RQ];
    load(0, v);
    int2 bin = make_int2(tacband::EMPTY, 0);    // bin b0 + col, with tid < FBT
    for (int mc = 0; mc < m_pad; mc += FBT) {
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const int r = q + Q * i;
            tile[r * BAND_LD + col] = v[i];
            if (fbp) fbp[(long long)(b0 + r) * m_pad + mc + col] = v[i];
        }
        __syncthreads();
        if (mc + FBT < m_pad) load(mc + FBT, v);
        if (fbt)
#pragma unroll
            for (int i = 0; i < RQ; ++i) {
                const int r = q + Q * i;        // the mel within the chunk
                fbt[(long long)(mc + r) * ldt + b0 + col] = tile[col * BAND_LD + r];
            }
        // bin b0 + col over the chunk's mels q RQ .. + RQ
        int2 row = make_int2(tacband::EMPTY, 0);
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
            const int r = q * RQ + i;
            if (tile[col * BAND_LD + r] != 0.f)
                row = make_int2(min(row.x, mc + r), mc + r + 1);
        }
        part[q][col] = row;
        __syncthreads();
        if (tid < FBT)
#pragma unroll
            for (int j = 0; j < Q; ++j) bin = tacband::join(bin, part[j][tid]);
        __syncthreads();                        // tile and part free again
    }
    if (tid < FBT) bin_band[b0 + tid] = bin;
}


// ---- kernel A: the transform as a shared-memory FFT --------------------------

using tacfft::FFT_THREADS;
using tacfft::POINTS;
using tacfft::ROUND_POINTS;
using tacfft::WORK_POINTS;
using tacfft::padded;

constexpr int FR = 16;          // frames per block
constexpr int WARPS = FFT_THREADS / 32;
// The banded mel product is taken where its bins, rounded out to whole
// groups of 4, are at most B1_BAND_SHARE / 1024 of the dense product's.
// A banded step costs more than a dense one (scattered power and
// filterbank loads against broadcast ones).  On an H100 (chip_smoke.py's
// band sweep, the band pass included) the banded kernel at config 2's
// shape took 0.518 ms at a 15 % share against the dense 0.575 and 0.598
// at 20 % against 0.578; at config 3's 0.130 at 20 % against 0.138 and
// 0.151 at 30 % against 0.137.  The crossover lies near 18 % and 25 %;
// 15.6 % keeps to the banded side of both.
constexpr int B1_BAND_SHARE = 160;

static_assert(ROUND_POINTS / tacfft::FFT_MIN <= FR,
              "a round's frames must fit the block's frame group");
static_assert(WARPS == 8, "the mel reduction pairs 8 warps in 4 steps");

// onesided bins padded to the residual's 64-bin tiles
__host__ __device__ constexpr int bins_padded(int n) { return n / 2 + FBT; }

template <int N>
size_t fft_smem_bytes(int m_pad) {
    return sizeof(float2) * (WORK_POINTS + N)
           + sizeof(float) * FR * bins_padded(N) + sizeof(int2) * m_pad;
}

// Stores a chunk of CH mels x FR frames from the reduction buffer (frames
// as rows of RL, mels as columns; the two halves added where TWO), frames
// along the fastest index of the (mel, frame) output, so that neighbouring
// threads store to neighbouring addresses.  dB in place of the store.
template <int CH, bool TWO>
__device__ __forceinline__ void store_chunk(const float* __restrict__ red,
                                            float* __restrict__ out_s, int mc,
                                            int f0, int n_frames,
                                            int num_mels, int to_db,
                                            float amin, float db_offset) {
    constexpr int RL = CH + 4;
    const float db_scale = 4.342944819032518f;   // 10 / ln(10)
    for (int idx = threadIdx.x; idx < FR * CH; idx += FFT_THREADS) {
        const int r = idx % FR;
        const int m = mc + idx / FR;
        const int frame = f0 + r;
        if (m >= num_mels || frame >= n_frames) continue;
        float v = red[r * RL + idx / FR];
        if (TWO) v += red[FR * RL + r * RL + idx / FR];
        if (to_db) v = db_scale * logf(fmaxf(v, amin)) - db_offset;
        out_s[(long long)m * n_frames + frame] = v;
    }
}

// The dense mel product and the epilogue of kernel A for MPL mels per
// lane: out[m, frame] = dB(sum_k p_s[frame, k] * fb[k, m]).
template <int N, int MPL>
__device__ __forceinline__ void mel_epilogue(
        const float* __restrict__ p_s, float* __restrict__ red,
        const float* __restrict__ fb, float* __restrict__ out_s, int f0,
        int n_frames, int num_mels, int m_pad, int to_db, float amin,
        float db_offset) {
    constexpr int KP = bins_padded(N);
    constexpr int NQ = (N / 2 + 1 + 3) / 4;      // groups of 4 bins
    constexpr int CH = 32 * MPL;                 // mels per chunk
    constexpr int RL = CH + 4;                   // row of the reduction buffer
    static_assert(2 * FR * RL <= 2 * WORK_POINTS, "reduction buffer");
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    for (int mc = 0; mc < m_pad; mc += CH) {
        float acc[FR][MPL];
#pragma unroll
        for (int f = 0; f < FR; ++f)
#pragma unroll
            for (int c = 0; c < MPL; ++c) acc[f][c] = 0.f;

        for (int q = warp; q < NQ; q += WARPS) {
            const int k = 4 * q;
            float w[4][MPL];
            const float* fp = fb + (long long)k * m_pad + mc + lane * MPL;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float* row = fp + (long long)i * m_pad;
                if constexpr (MPL == 4) {
                    const float4 t = *reinterpret_cast<const float4*>(row);
                    w[i][0] = t.x;
                    w[i][1] = t.y;
                    w[i][2] = t.z;
                    w[i][3] = t.w;
                } else {
                    const float2 t = *reinterpret_cast<const float2*>(row);
                    w[i][0] = t.x;
                    w[i][1] = t.y;
                }
            }
#pragma unroll
            for (int f = 0; f < FR; ++f) {
                const float4 p = *reinterpret_cast<const float4*>(&p_s[f * KP + k]);
#pragma unroll
                for (int c = 0; c < MPL; ++c) {
                    acc[f][c] = fmaf(p.x, w[0][c], acc[f][c]);
                    acc[f][c] = fmaf(p.y, w[1][c], acc[f][c]);
                    acc[f][c] = fmaf(p.z, w[2][c], acc[f][c]);
                    acc[f][c] = fmaf(p.w, w[3][c], acc[f][c]);
                }
            }
        }

        // warps 0 and 1 store, then 2 and 3 add, ...: a fixed order
        for (int step = 0; step < WARPS / 2; ++step) {
            if ((warp >> 1) == step) {
                float* r = red + (warp & 1) * FR * RL + lane * MPL;
#pragma unroll
                for (int f = 0; f < FR; ++f)
#pragma unroll
                    for (int c = 0; c < MPL; ++c) {
                        if (step == 0) r[f * RL + c] = acc[f][c];
                        else r[f * RL + c] += acc[f][c];
                    }
            }
            __syncthreads();
        }
        store_chunk<CH, true>(red, out_s, mc, f0, n_frames, num_mels, to_db,
                              amin, db_offset);
        __syncthreads();   // the reduction buffer is free for the next chunk
    }
}

// The banded mel product and the epilogue: out[m, frame] = dB(sum over k
// in mel m's band of p_s[frame, k] * fbt[m, k]).  Thread t owns mel mc + t
// % CH and FG frames of a chunk of CH mels; it walks the band 4 bins a
// step from lo rounded down to hi rounded up (the bins past the band have
// exact zero weights, and past n_freqs zero power), so the power and the
// transposed filterbank are read as aligned 16-byte loads.
template <int N, int MPL>
__device__ __forceinline__ void mel_epilogue_banded(
        const float* __restrict__ p_s, float* __restrict__ red,
        const float* __restrict__ fbt, const int2* __restrict__ band_s,
        float* __restrict__ out_s, int f0, int n_frames, int num_mels,
        int m_pad, int to_db, float amin, float db_offset) {
    constexpr int KP = bins_padded(N);
    constexpr int CH = 32 * MPL;
    constexpr int RL = CH + 4;
    constexpr int FG = FR * CH / FFT_THREADS;    // frames a thread: 8 or 4
    const int c = threadIdx.x % CH;
    const int fr0 = threadIdx.x / CH * FG;
    for (int mc = 0; mc < m_pad; mc += CH) {
        const int m = mc + c;
        float acc[FG];
#pragma unroll
        for (int f = 0; f < FG; ++f) acc[f] = 0.f;
        const int2 band = m < num_mels ? band_s[m] : make_int2(0, 0);
        const float* w = fbt + (long long)m * KP;
        for (int k = band.x & ~3; k < band.y; k += 4) {
            const float4 wv = *reinterpret_cast<const float4*>(w + k);
#pragma unroll
            for (int f = 0; f < FG; ++f) {
                const float4 p = *reinterpret_cast<const float4*>(
                    &p_s[(fr0 + f) * KP + k]);
                acc[f] = fmaf(p.x, wv.x, acc[f]);
                acc[f] = fmaf(p.y, wv.y, acc[f]);
                acc[f] = fmaf(p.z, wv.z, acc[f]);
                acc[f] = fmaf(p.w, wv.w, acc[f]);
            }
        }
#pragma unroll
        for (int f = 0; f < FG; ++f) red[(fr0 + f) * RL + c] = acc[f];
        __syncthreads();
        store_chunk<CH, false>(red, out_s, mc, f0, n_frames, num_mels, to_db,
                               amin, db_offset);
        __syncthreads();   // the reduction buffer is free for the next chunk
    }
}

// x        (n_streams, n_samples)      waveform
// window   (N)                         the window, zero padded to N
// twiddle  (N)                         the twiddle table of fft_smem.cuh
// fb       (KP, m_pad)                 filterbank, zero padded
// fbt      (m_pad, KP)                 the same transposed
// mel_band (m_pad)                    each mel's band, as mel_band_kernel
//                                      writes it
// out      (n_streams, num_mels, n_frames)
// reim     (n_streams, n_frames, KP * 2)  written when SAVE_SPEC
// banded   1 or 0 forces the banded or the dense mel product, -1 lets the
//          tables decide; `counter` (mapped host memory, or null) counts
//          the launches that took the banded product
template <int N, bool SAVE_SPEC>
__global__ void __launch_bounds__(FFT_THREADS, 2)
fused_mel_fft_fwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ window,
                         const float2* __restrict__ twiddle,
                         const float* __restrict__ fb,
                         const float* __restrict__ fbt,
                         const int2* __restrict__ mel_band,
                         float* __restrict__ out, float* __restrict__ reim,
                         int n_samples, int hop_length, int n_frames,
                         int num_mels, int m_pad, int to_db, float amin,
                         float db_offset, int banded, int* counter) {
    constexpr int M = N / 2;                     // complex points a frame
    constexpr int TPF = M / POINTS;              // threads per frame
    constexpr int G = ROUND_POINTS / M;          // frames per round
    constexpr int ROUNDS = FR / G;
    constexpr int KP = bins_padded(N);
    constexpr int LDR = 2 * KP;                  // residual row
    constexpr int NQ = (N / 2 + 1 + 3) / 4;
    extern __shared__ __align__(16) float smem[];
    float2* work = reinterpret_cast<float2*>(smem);      // (WORK_POINTS)
    float2* tw_s = work + WORK_POINTS;                   // (N)
    float* p_s = reinterpret_cast<float*>(tw_s + N);     // (FR, KP) power
    int2* band_s = reinterpret_cast<int2*>(p_s + FR * KP);   // (m_pad)
    __shared__ int work_s[WARPS];

    const int tid = threadIdx.x;
    const int g = tid / TPF;
    const int j = tid % TPF;
    const int f0 = blockIdx.x * FR;
    const int s = blockIdx.y;
    const float* xs = x + (long long)s * n_samples;

    tacfft::load_twiddles<N>(tw_s, twiddle);
    // mel tid's band: loaded now, used after the transform, so that its
    // latency hides behind it (mels past 256 are loaded then)
    const int2 first = tid < num_mels ? mel_band[tid]
                                      : make_int2(tacband::EMPTY, 0);
    __syncthreads();

    for (int round = 0; round < ROUNDS; ++round) {
        // the windowed frame, even samples real and odd imaginary
        const int frame = f0 + round * G + g;
        const bool ok = frame < n_frames;
        const float* xf = xs + (long long)frame * hop_length;
        float2 v[POINTS];
#pragma unroll
        for (int m = 0; m < POINTS; ++m) {
            const int n = 2 * (j + m * TPF);
            const float2 w = *reinterpret_cast<const float2*>(window + n);
            v[m] = ok ? make_float2(w.x * xf[n], w.y * xf[n + 1])
                      : make_float2(0.f, 0.f);
        }
        tacfft::fft_block<M, false>(v, work, tw_s + M, g, j);
#pragma unroll
        for (int m = 0; m < POINTS; ++m)
            work[padded(g * M + j + m * TPF)] = v[m];
        __syncthreads();

        // the frames' bins, their power, and the residual
#pragma unroll
        for (int gg = 0; gg < G; ++gg) {
            const int fr = round * G + gg;       // frame within the block
            const float2* z = work + padded(gg * M);
            float* dst = reim + ((long long)s * n_frames + f0 + fr) * LDR;
            const bool store = SAVE_SPEC && f0 + fr < n_frames;
            for (int k = tid; k < KP; k += FFT_THREADS) {
                float2 bin = make_float2(0.f, 0.f);
                if (k <= M) {
                    const int kk = k & (M - 1), kn = (M - k) & (M - 1);
                    bin = tacfft::real_bin(
                        z[kk + (kk >> 4)], z[kn + (kn >> 4)],
                        k < M ? tw_s[k] : make_float2(-1.f, 0.f));
                }
                p_s[fr * KP + k] = bin.x * bin.x + bin.y * bin.y;
                if (store) {
                    const int col = (k / FBT) * 2 * FBT + k % FBT;
                    dst[col] = bin.x;
                    dst[col + FBT] = bin.y;
                }
            }
        }
        __syncthreads();   // the round buffer is free for the next round
    }

    // the banded product's bins, rounded out to groups of 4, summed over
    // the mels, against the dense product's
    int bins = 0;
    for (int m = tid; m < num_mels; m += FFT_THREADS) {
        const int2 band = m == tid ? first : mel_band[m];
        band_s[m] = band;
        if (band.y > band.x) bins += ((band.y + 3) & ~3) - (band.x & ~3);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) bins += __shfl_xor_sync(0xffffffffu, bins, o);
    if ((tid & 31) == 0) work_s[tid >> 5] = bins;
    __syncthreads();
    if (banded < 0) {
        long long total = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) total += work_s[w];
        banded = total * 1024 <= (long long)B1_BAND_SHARE * 4 * NQ * m_pad;
    }

    float* out_s = out + (long long)s * num_mels * n_frames;
    float* red = reinterpret_cast<float*>(work);
    if (banded) {
        if (m_pad % 128 == 0)
            mel_epilogue_banded<N, 4>(p_s, red, fbt, band_s, out_s, f0,
                                      n_frames, num_mels, m_pad, to_db, amin,
                                      db_offset);
        else
            mel_epilogue_banded<N, 2>(p_s, red, fbt, band_s, out_s, f0,
                                      n_frames, num_mels, m_pad, to_db, amin,
                                      db_offset);
    } else if (m_pad % 128 == 0) {
        mel_epilogue<N, 4>(p_s, red, fb, out_s, f0, n_frames, num_mels, m_pad,
                           to_db, amin, db_offset);
    } else {
        mel_epilogue<N, 2>(p_s, red, fb, out_s, f0, n_frames, num_mels, m_pad,
                           to_db, amin, db_offset);
    }
    // last, so that no thread of the block waits on the host's memory
    if (banded && counter && blockIdx.x == 0 && blockIdx.y == 0 && tid == 0)
        tacband::count_launch(counter);
}

template <int N, bool SAVE_SPEC>
int launch_fft(const float* x, const float* window, const float* twiddle,
               const float* fb, const float* fbt, const int* mel_band,
               float* out, float* reim, int n_streams, int n_samples,
               int hop_length, int n_frames, int num_mels, int m_pad,
               int to_db, float amin, float db_offset, int banded,
               int* counter, cudaStream_t stream) {
    const size_t smem = fft_smem_bytes<N>(m_pad);
    cudaError_t err = cudaFuncSetAttribute(
        fused_mel_fft_fwd_kernel<N, SAVE_SPEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_frames + FR - 1) / FR, n_streams);
    fused_mel_fft_fwd_kernel<N, SAVE_SPEC><<<grid, FFT_THREADS, smem, stream>>>(
        x, window, reinterpret_cast<const float2*>(twiddle), fb, fbt,
        reinterpret_cast<const int2*>(mel_band), out, reim, n_samples,
        hop_length, n_frames, num_mels, m_pad, to_db, amin, db_offset, banded,
        counter);
    return (int)cudaGetLastError();
}

template <int N>
int launch_fft_n(const float* x, const float* window, const float* twiddle,
                 const float* fb, const float* fbt, const int* mel_band,
                 float* out, float* reim, int n_streams, int n_samples,
                 int hop_length, int n_frames, int num_mels, int m_pad,
                 int to_db, float amin, float db_offset, int banded,
                 int* counter, cudaStream_t stream) {
    return reim ? launch_fft<N, true>(x, window, twiddle, fb, fbt, mel_band,
                                      out, reim, n_streams, n_samples,
                                      hop_length, n_frames, num_mels, m_pad,
                                      to_db, amin, db_offset, banded, counter,
                                      stream)
                : launch_fft<N, false>(x, window, twiddle, fb, fbt, mel_band,
                                       out, nullptr, n_streams, n_samples,
                                       hop_length, n_frames, num_mels, m_pad,
                                       to_db, amin, db_offset, banded,
                                       counter, stream);
}

}  // namespace

extern "C" {

// Launches the forward on `stream`; returns the cudaError_t of the launch
// (0 on success).  Does not synchronise and allocates nothing.  `reim` may
// be null (serving); otherwise it receives the re/im residual.
int tac_fused_mel_fwd(const float* x, const float* basis, const float* fb,
                      float* out, float* reim, int n_streams, int n_samples,
                      int fft_length, int hop_length, int n_frames,
                      int ft_count, int num_mels, int m_pad, int to_db,
                      float amin, float db_offset, void* stream) {
    if (n_streams <= 0 || n_frames <= 0 || num_mels <= 0) return 0;
    if (m_pad % MC != 0 || m_pad < num_mels || fft_length < 2 || hop_length < 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    return reim ? launch<true>(x, basis, fb, out, reim, n_streams, n_samples,
                               fft_length, hop_length, n_frames, ft_count,
                               num_mels, m_pad, to_db, amin, db_offset, st)
                : launch<false>(x, basis, fb, out, nullptr, n_streams,
                                n_samples, fft_length, hop_length, n_frames,
                                ft_count, num_mels, m_pad, to_db, amin,
                                db_offset, st);
}

// The filterbank's bands for kernel A and for the backward's frame pass
// (mel_band_kernel): fb (n_freqs, num_mels) at element strides (s0, s1);
// fbp (ft_count * FBT, m_pad) and fbt (m_pad, ft_count * FBT) may be null;
// mel_band (m_pad, 2) and bin_band (ft_count * FBT, 2) ints.
int tac_mel_bands(const float* fb, long long s0, long long s1, int n_freqs,
                  int num_mels, int m_pad, int ft_count, float* fbp,
                  float* fbt, int* mel_band, int* bin_band, void* stream) {
    if (num_mels <= 0 || m_pad % MC != 0 || m_pad < num_mels
        || (n_freqs - 1) / FBT + 1 != ft_count || !mel_band || !bin_band)
        return (int)cudaErrorInvalidValue;
    mel_band_kernel<<<ft_count + m_pad / BAND_MELS, THREADS, 0,
                      (cudaStream_t)stream>>>(
        fb, s0, s1, n_freqs, num_mels, m_pad, ft_count, fbp, fbt,
        reinterpret_cast<int2*>(mel_band), reinterpret_cast<int2*>(bin_band));
    return (int)cudaGetLastError();
}

// Kernel A: the forward for fft_length a power of two in [256, 2048], the
// transform as a shared-memory FFT.  `window` is the fft_length window
// samples, `twiddle` the fft_length pairs of fft_smem.cuh's twiddle table;
// `fb` is (fft_length / 2 + FBT, m_pad), zero padded, `fbt` its transpose
// and `mel_band` the mel bands, as tac_mel_bands writes them.  `banded`:
// 1 or 0 forces the banded or the dense mel product, -1 lets the bands
// decide; `counter` (mapped host memory, or null) gains one if the
// launch took the banded product.  Otherwise as tac_fused_mel_fwd.
int tac_fused_mel_fft_fwd(const float* x, const float* window,
                          const float* twiddle, const float* fb,
                          const float* fbt, const int* mel_band, float* out,
                          float* reim, int n_streams, int n_samples,
                          int fft_length, int hop_length, int n_frames,
                          int num_mels, int m_pad, int to_db, float amin,
                          float db_offset, int banded, int* counter,
                          void* stream) {
    if (n_streams <= 0 || n_frames <= 0 || num_mels <= 0) return 0;
    if (m_pad % MC != 0 || m_pad < num_mels || hop_length < 1
        || fft_length % 2 != 0 || !tacfft::fft_size_ok(fft_length / 2)
        || banded < -1 || banded > 1 || !fbt || !mel_band)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
#define TAC_FFT_CASE(n)                                                       \
    case n:                                                                   \
        return launch_fft_n<n>(x, window, twiddle, fb, fbt, mel_band, out,    \
                               reim, n_streams, n_samples, hop_length,        \
                               n_frames, num_mels, m_pad, to_db, amin,        \
                               db_offset, banded, counter, st)
    switch (fft_length) {
        TAC_FFT_CASE(256);
        TAC_FFT_CASE(512);
        TAC_FFT_CASE(1024);
        TAC_FFT_CASE(2048);
        default: return (int)cudaErrorInvalidValue;
    }
#undef TAC_FFT_CASE
}

// What the host lays out for kernel A: the least and the largest
// fft_length it takes, the residual's bin tile, the filterbank's column pad,
// and the share (in 1 / 1024) of the dense product below which it takes
// the banded one.
int tac_fused_mel_fft_tile(int which) {
    switch (which) {
        case 0: return 2 * tacfft::FFT_MIN;
        case 1: return 2 * tacfft::FFT_MAX;
        case 2: return FBT;
        case 3: return MC;
        case 4: return B1_BAND_SHARE;
        default: return -1;
    }
}

const char* tac_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

// Tile constants the host wrapper lays its operands out for.
int tac_fused_mel_fwd_tile(int which) {
    switch (which) {
        case 0: return TB;
        case 1: return FBT;
        case 2: return KT;
        case 3: return MC;
        default: return -1;
    }
}

}  // extern "C"
