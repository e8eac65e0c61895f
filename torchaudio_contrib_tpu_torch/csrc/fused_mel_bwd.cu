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
// with the windowed basis (k_pad, FT*2*FBT) that the forward reads, here
// read transposed, so there is no second basis.  Rows are (stream, frame)
// pairs, frame fastest; the host overlap-adds dframes onto the waveform.
//
// What bounds it: the dframes product, 2 * rows * fft * FT*2*FBT FLOPs,
// the same count as the forward's DFT (0.37 TFLOP at 32 x 30 s, fft 2048);
// dp and dFB are 2 * rows * f_pad * m_pad each (3 % of it at 128 mels).
// Like the forward, this first version runs FP32 FMAs on CUDA cores.
//
// Design, and why it is not the TPU's merged kernel:
//   * Three passes instead of one merged grid.  The TPU kernel recomputed
//     dp for every tile of the dframes output; a Hopper block cannot hold a
//     (64 frames, fft) dframes tile, so on Hopper that would rerun the dp
//     product fft / 128 times.  Pass A (dreim_kernel, one block per (64
//     rows, frequency tile)) forms dp once and writes dreim to a scratch
//     buffer; pass B (dframes_kernel) is a plain tiled GEMM with K over the
//     FT*2*FBT residual columns and the forward's inner loop shape.
//   * dFB is a pass of its own (dfb_kernel): each block owns a (64 bins,
//     64 mels) tile and one contiguous split of the rows, and writes its
//     partial sum; dfb_reduce_kernel adds the splits in a fixed order.  No
//     float atomics: the same inputs give bitwise-equal gradients on every
//     run.  dFB needs only p and dmel, so a caller that wants the
//     filterbank gradient alone (a trainable front end on a waveform that
//     needs no gradient) runs this pass only, a few percent of the work.
//   * Ragged edges: rows past `rows` load zeros and are not stored; bins
//     past fft//2+1 have zero basis columns, so their residual, p and dreim
//     are zero; mels past num_mels have zero dmel and zero fb; basis rows
//     past k_pad load zeros and dframes columns past fft_length are not
//     stored.
// Tensor cores (wgmma) and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 64;          // rows per block (the forward's frame block)
constexpr int FBT = 64;         // bins per frequency tile (the forward's)
constexpr int KC = 16;          // depth of one K step
constexpr int MC = 64;          // mel columns per dFB block
constexpr int NB = 128;         // dframes columns per block
constexpr int THREADS = 256;    // 16 x 16 threads
constexpr int LD = TB + 4;      // padded leading dims of the k-major tiles
constexpr int NB_LD = NB + 4;   // (rows stay 16-byte aligned)
constexpr int REDUCE_THREADS = 256;

static_assert(TB == 16 * 4 && FBT == 16 * 4 && MC == 16 * 4 && NB == 16 * 8,
              "the 16 x 16 thread grid owns 4 x 4 (4 x 8 in pass B) tiles");
static_assert(TB * KC == 4 * THREADS, "64-row operand chunk: one float4 per thread");
static_assert(KC * FBT == 4 * THREADS && KC * MC == 4 * THREADS,
              "dFB chunks: one float4 per thread");

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

// grid (ft_count, m_pad / MC, n_splits): the (FBT bins, MC mels) tile of
// the filterbank gradient summed over rows [split * rows_per_split, + that).
// part (n_splits, f_pad, m_pad)
__global__ void __launch_bounds__(THREADS)
dfb_kernel(const float* __restrict__ dmel, const float* __restrict__ reim,
           float* __restrict__ part, int rows, int rows_per_split, int ldr,
           int m_pad, int f_pad) {
    __shared__ __align__(16) float p_s[KC * FBT];   // p chunk   [k][bin]
    __shared__ __align__(16) float d_s[KC * MC];    // dmel chunk [k][mel]
    const int t = blockIdx.x;
    const int mc = blockIdx.y * MC;
    const int split = blockIdx.z;
    const int tid = threadIdx.x;
    const int ty = tid / 16;
    const int tx = tid % 16;
    const int lk = tid / 16;          // loader: chunk row lk, columns lc..lc+3
    const int lc = (tid % 16) * 4;
    const int r_begin = split * rows_per_split;
    const int r_end = min(rows, r_begin + rows_per_split);

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

    for (int r0 = r_begin; r0 < r_end; r0 += KC) {
        const int row = r0 + lk;
        float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 d = p;
        if (row < r_end) {
            const float* rp = reim + (long long)row * ldr + t * 2 * FBT + lc;
            const float4 re = ld4(rp);
            const float4 im = ld4(rp + FBT);
            p = make_float4(re.x * re.x + im.x * im.x, re.y * re.y + im.y * im.y,
                            re.z * re.z + im.z * im.z, re.w * re.w + im.w * im.w);
            d = ld4(dmel + (long long)row * m_pad + mc + lc);
        }
        st4(&p_s[lk * FBT + lc], p);
        st4(&d_s[lk * MC + lc], d);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KC; ++kk) {
            const float4 a = ld4(&p_s[kk * FBT + ty * 4]);
            const float4 b = ld4(&d_s[kk * MC + tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
        }
        __syncthreads();
    }

    float* dst = part + ((long long)split * f_pad + t * FBT + ty * 4) * m_pad
                 + mc + tx * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        st4(dst + (long long)i * m_pad,
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
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

}  // namespace

extern "C" {

// Launches the backward passes on `stream`; returns the first cudaError_t
// (0 on success).  Does not synchronise and allocates nothing.
//   dmel (rows, m_pad), reim (rows, ldr), fb (f_pad, m_pad),
//   basis (k_pad, ldr) with ldr = ft_count * 2 * FBT, f_pad = ft_count * FBT.
//   dfb (f_pad, m_pad) or null: the filterbank gradient; with n_splits > 1
//     dfb_part (n_splits, f_pad, m_pad) holds the per-split sums.
//   dframes (rows, fft_length) or null: the frame gradient; dreim (rows,
//     ldr) is its scratch.
int tac_fused_mel_bwd(const float* dmel, const float* reim, const float* fb,
                      const float* basis, float* dreim, float* dframes,
                      float* dfb, float* dfb_part, int rows, int fft_length,
                      int k_pad, int ft_count, int m_pad, int n_splits,
                      int rows_per_split, void* stream) {
    if (rows <= 0) return 0;
    if (m_pad <= 0 || m_pad % MC != 0 || ft_count <= 0 || fft_length < 2
        || k_pad < fft_length)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int ldr = ft_count * 2 * FBT;
    const int f_pad = ft_count * FBT;
    cudaError_t err;
    if (dfb) {
        if (n_splits < 1 || n_splits > 65535 || rows_per_split % KC != 0
            || (long long)n_splits * rows_per_split < rows
            || (n_splits > 1 && !dfb_part))
            return (int)cudaErrorInvalidValue;
        float* out = n_splits > 1 ? dfb_part : dfb;
        dfb_kernel<<<dim3(ft_count, m_pad / MC, n_splits), THREADS, 0, st>>>(
            dmel, reim, out, rows, rows_per_split, ldr, m_pad, f_pad);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        if (n_splits > 1) {
            const int n = f_pad * m_pad;
            dfb_reduce_kernel<<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS,
                                REDUCE_THREADS, 0, st>>>(dfb_part, dfb, n_splits, n);
            if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        }
    }
    if (dframes) {
        if (!dreim) return (int)cudaErrorInvalidValue;
        const int row_blocks = (rows + TB - 1) / TB;
        dreim_kernel<<<dim3(row_blocks, ft_count), THREADS, 0, st>>>(
            dmel, fb, reim, dreim, rows, ldr, m_pad);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        dframes_kernel<<<dim3(row_blocks, (fft_length + NB - 1) / NB), THREADS, 0, st>>>(
            dreim, basis, dframes, rows, fft_length, k_pad, ldr);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
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
        default: return -1;
    }
}

}  // extern "C"
