// Fused (log-)mel spectrogram forward for Hopper (sm_90a).
//
// Replaces torchaudio_contrib_tpu/ops/fused.py::_build_fwd_call (kernel B1
// of the JAX package): waveform -> windowed onesided DFT -> |.|^2 -> mel
// filterbank -> optional dB, in one kernel, for any fft_length >= 2 and
// any hop_length > 0.
//
//   out[s, m, f] = dB( sum_k fb[k, m] * (re[s, f, k]^2 + im[s, f, k]^2) )
//   re + i*im    = sum_n x[s, f*hop + n] * basis[n, (re|im) of bin k]
//
// What bounds it: the DFT product.  Per frame it costs 2 * fft * 2 * F
// FLOPs (F = onesided bins padded to the tile), against 4 * fft bytes of
// waveform read (less with overlapping frames), so it is compute bound by
// two orders of magnitude; the mel product adds ~6 % of that.  This first
// version runs the products as FP32 FMAs on CUDA cores.
//
// What the design does about it:
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
//   * For training, an optional second output `reim` (the JAX kernel's
//     save_spec residual) takes each thread's re/im register tile before
//     the power is formed: (n_streams, n_frames, FT*2*FBT), tile t columns
//     [re_t | im_t], laid out like the basis.  Frames past n_frames are not
//     stored.  It is a template flag, so the serving instantiation is the
//     kernel without it.
// Tensor-core tiers (TF32, 3xTF32, BF16 with wgmma) are later work.

#include <cuda_runtime.h>

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
