// Fused Griffin-Lim solve for Hopper (sm_90a).
//
// Replaces three TPU kernels of the JAX package, which are one solve written
// three times:
//   * torchaudio_contrib_tpu/ops/fused_griffinlim.py::_build_gl_call
//     (all n_iter momentum projections of one clip),
//   * ::_build_gl_call_tile_major (the same with the state in tile-major
//     layout): here a stride argument of the same kernels,
//   * benchmarks/r3_gl_bisect.py::build (the same with one stage
//     neutralised per variant, for timing): here compile-time switches of
//     the same kernels.
//
// Per iteration, for every clip b (rows = n_frames, L = (rows-1)*hop + fft):
//   fr[b, j, n]  = sum_k state[b, j, k] * syn[k, n]        synthesis product
//   xv[b, s]     = inv_env[s] * sum_j fr[b, j, s - j*hop]  overlap-add, envelope
//   reim[b, j, c]= sum_n xv[b, j*hop + n] * ana[n, c]      analysis product
//   upd          = reim + momentum * (reim - prev);  prev = reim
//   state        = mag * upd / max(|upd|, 1e-16)           (|.| over re, im)
// prev starts at zero, so the first step projects (1 + momentum) * reim.
//
// What bounds it: the two products, 2 * 2 * rows * fft * (ft*2*FBT) FLOPs per
// clip and iteration, against a state of rows * ft*2*FBT floats: compute
// bound by two orders of magnitude, as a DFT written as a matrix product
// always is.  This first version runs them as FP32 FMAs on CUDA cores, with
// float32 state, prev and bases.
//
// What the design does about it, and where it leaves the TPU kernel's shape:
//   * The TPU kernel is one program per clip with the state resident in its
//     on-chip memory.  A clip's state is megabytes and there are only a few
//     clips, so here state, prev, fr and xv live in device memory (they sit
//     in or near L2) and every clip's rows and frequency tiles are spread
//     over many thread blocks.
//   * An iteration has two grid-wide dependencies (every fr row before the
//     overlap-add, the whole signal before the analysis), so it is three
//     launches; the host side of tac_fused_gl_solve loops them, so that one
//     call runs the whole solve on the caller's stream, in order, with no
//     synchronisation.  Launch overhead is a few microseconds against about
//     a millisecond of products per iteration.
//   * The overlap-add is a gather (one thread per output sample sums the
//     frames that cover it, in frame order), so it has no atomics and the
//     solve gives the same bits on every run.
//   * There is no re-framing pass: the analysis product reads its frames
//     from the enveloped signal with strided loads at any hop, like the fused
//     mel forward, and its basis is that kernel's basis.  So fft % hop == 0
//     and the multiples of 128 are not needed here.
//   * Each analysis thread keeps a 4-frame x 4-bin register tile of both re
//     and im, so the momentum step, the magnitude projection and the update
//     of prev are thread-local epilogue work on registers.
//   * Layout: element (frame j, tile t, column c) of a clip's state lives at
//     t*tile_stride + j*row_stride + c.  Row-major (rows, ft*2*FBT) has
//     tile_stride 2*FBT and row_stride ft*2*FBT; tile-major (ft, rows, 2*FBT)
//     has tile_stride rows*2*FBT and row_stride 2*FBT.  The magnitudes use
//     half of each.
// Tensor-core products (TF32/BF16 with wgmma) and an in-kernel FFT are later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 64;          // frames per block
constexpr int FBT = 64;         // onesided bins per frequency tile
constexpr int KT = 16;          // contraction elements per K step
constexpr int NT = 64;          // synthesis output samples per block
constexpr int THREADS = 256;    // 16 x 16: thread (ty, tx) owns a 4 x 4 tile
constexpr int A_LD = TB + 4;    // padded leading dim of the k-major A tile

static_assert(TB == 16 * 4 && FBT == 16 * 4 && NT == 16 * 4,
              "the 16 x 16 thread grid owns 4 x 4 tiles");
static_assert(KT * TB == 4 * THREADS, "A tile: 4 loads per thread");
static_assert(KT * NT == 4 * THREADS, "syn tile: 1 float4 per thread");
static_assert(KT * 2 * FBT == 8 * THREADS, "ana tile: 2 float4 per thread");
static_assert((2 * FBT) % KT == 0, "a K step stays inside one state tile");

// The stage switches (only FULL computes Griffin-Lim).
enum Variant { FULL = 0, NONORM = 1, NOOLA = 2, NOSYN = 3, NOANA = 4 };

struct Layout {
    long long clip;         // floats per clip of state / prev
    long long tile_stride;  // see the note above
    long long row_stride;
};

// fr[b, j, n0 + ...] = sum_k state[b, j, k] * syn[k, n0 + ...]
// grid (n_pad / NT, ceil(rows / TB), clips)
__global__ void __launch_bounds__(THREADS)
gl_syn_kernel(const float* __restrict__ state, const float* __restrict__ syn,
              float* __restrict__ fr, Layout lay, int rows, int ft, int n_pad) {
    __shared__ __align__(16) float a_s[KT * A_LD];   // (KT, A_LD) state, k-major
    __shared__ __align__(16) float b_s[KT * NT];     // (KT, NT)   basis tile

    const int tid = threadIdx.x;
    const int ty = tid / 16;
    const int tx = tid % 16;
    const int n0 = blockIdx.x * NT;
    const int f0 = blockIdx.y * TB;
    const int b = blockIdx.z;
    const float* st = state + (long long)b * lay.clip;
    const int k_steps = ft * 2 * FBT / KT;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int ks = 0; ks < k_steps; ++ks) {
        const int k0 = ks * KT;
        const int t = k0 / (2 * FBT);
        const int c0 = k0 % (2 * FBT);
        for (int l = 0; l < 4; ++l) {
            const int idx = tid + l * THREADS;
            const int k = idx % KT;
            const int r = idx / KT;
            const int frame = f0 + r;
            float v = 0.f;
            if (frame < rows)
                v = st[t * lay.tile_stride + frame * lay.row_stride + c0 + k];
            a_s[k * A_LD + r] = v;
        }
        {
            const int row = tid / (NT / 4);
            const int c4 = tid % (NT / 4);
            *reinterpret_cast<float4*>(&b_s[row * NT + c4 * 4]) =
                *reinterpret_cast<const float4*>(
                    &syn[(long long)(k0 + row) * n_pad + n0 + c4 * 4]);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&a_s[kk * A_LD + ty * 4]);
            const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk * NT + tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float wv[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int frame = f0 + ty * 4 + i;
        if (frame >= rows) continue;
        *reinterpret_cast<float4*>(
            &fr[((long long)b * rows + frame) * n_pad + n0 + tx * 4]) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
}

// xv[b, s] = inv_env[s] * sum over the frames j that cover s of
// fr[b, j, s - j*hop], in frame order.  grid (ceil(L / THREADS), clips)
__global__ void __launch_bounds__(THREADS)
gl_ola_kernel(const float* __restrict__ fr, const float* __restrict__ inv_env,
              float* __restrict__ xv, int rows, int fft_length, int hop_length,
              int n_pad, int n_samples) {
    const int s = blockIdx.x * THREADS + threadIdx.x;
    if (s >= n_samples) return;
    const int b = blockIdx.y;
    const int j_lo = s >= fft_length ? (s - fft_length) / hop_length + 1 : 0;
    const int j_hi = min(rows - 1, s / hop_length);
    const float* base = fr + (long long)b * rows * n_pad;
    float sum = 0.f;
    for (int j = j_lo; j <= j_hi; ++j)
        sum += base[(long long)j * n_pad + (s - j * hop_length)];
    xv[(long long)b * n_samples + s] = sum * inv_env[s];
}

// reim = frames(xv) * ana for one (frame block, frequency tile, clip), then
// the momentum step and the magnitude projection on the register tile.
// grid (ceil(rows / TB), ft, clips)
template <bool NO_NORM, bool NO_ANA>
__global__ void __launch_bounds__(THREADS)
gl_ana_kernel(const float* __restrict__ xv, const float* __restrict__ ana,
              const float* __restrict__ mag, float* __restrict__ state,
              float* __restrict__ prev, Layout lay, int rows, int fft_length,
              int hop_length, int ft, int n_samples, float momentum) {
    __shared__ __align__(16) float a_s[KT * A_LD];      // (KT, A_LD) frames, k-major
    __shared__ __align__(16) float b_s[KT * 2 * FBT];   // (KT, 2*FBT) basis tile

    const int tid = threadIdx.x;
    const int ty = tid / 16;
    const int tx = tid % 16;
    const int f0 = blockIdx.x * TB;
    const int t = blockIdx.y;
    const int b = blockIdx.z;
    const float* xs = xv + (long long)b * n_samples;
    const int ldb = ft * 2 * FBT;
    const int k_steps = NO_ANA ? 0 : (fft_length + KT - 1) / KT;

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
            if (frame < rows && k0 + k < fft_length)
                v = xs[(long long)frame * hop_length + k0 + k];
            a_s[k * A_LD + r] = v;
        }
        for (int l = 0; l < 2; ++l) {
            const int idx4 = tid + l * THREADS;
            const int row = idx4 / (2 * FBT / 4);
            const int c4 = idx4 % (2 * FBT / 4);
            *reinterpret_cast<float4*>(&b_s[row * 2 * FBT + c4 * 4]) =
                *reinterpret_cast<const float4*>(
                    &ana[(long long)(k0 + row) * ldb + t * 2 * FBT + c4 * 4]);
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

    float* st = state + (long long)b * lay.clip;
    float* pv = prev + (long long)b * lay.clip;
    const float* mg = mag + (long long)b * (lay.clip / 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int frame = f0 + ty * 4 + i;
        if (frame >= rows) continue;
        const long long off = t * lay.tile_stride + frame * lay.row_stride + tx * 4;
        float4* s_re = reinterpret_cast<float4*>(st + off);
        float4* s_im = reinterpret_cast<float4*>(st + off + FBT);
        if (NO_NORM) {
            *s_re = make_float4(re[i][0], re[i][1], re[i][2], re[i][3]);
            *s_im = make_float4(im[i][0], im[i][1], im[i][2], im[i][3]);
            continue;
        }
        float4* p_re = reinterpret_cast<float4*>(pv + off);
        float4* p_im = reinterpret_cast<float4*>(pv + off + FBT);
        const float4 pr4 = *p_re;
        const float4 pi4 = *p_im;
        const float4 m4 = *reinterpret_cast<const float4*>(
            mg + t * (lay.tile_stride / 2) + frame * (lay.row_stride / 2) + tx * 4);
        *p_re = make_float4(re[i][0], re[i][1], re[i][2], re[i][3]);
        *p_im = make_float4(im[i][0], im[i][1], im[i][2], im[i][3]);
        const float pr[4] = {pr4.x, pr4.y, pr4.z, pr4.w};
        const float pi[4] = {pi4.x, pi4.y, pi4.z, pi4.w};
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
        float o_re[4], o_im[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float ur = re[i][j] + momentum * (re[i][j] - pr[j]);
            const float ui = im[i][j] + momentum * (im[i][j] - pi[j]);
            const float sc = mv[j] / fmaxf(sqrtf(ur * ur + ui * ui), 1e-16f);
            o_re[j] = ur * sc;
            o_im[j] = ui * sc;
        }
        *s_re = make_float4(o_re[0], o_re[1], o_re[2], o_re[3]);
        *s_im = make_float4(o_im[0], o_im[1], o_im[2], o_im[3]);
    }
}

template <int V>
int solve(float* state, float* prev, const float* mag, const float* syn,
          const float* ana, const float* inv_env, float* fr, float* xv,
          int clips, int rows, int fft_length, int hop_length, int ft,
          int n_pad, Layout lay, int n_iter, float momentum, cudaStream_t st) {
    const int n_samples = (rows - 1) * hop_length + fft_length;
    const int row_blocks = (rows + TB - 1) / TB;
    const dim3 syn_grid(n_pad / NT, row_blocks, clips);
    const dim3 ola_grid((n_samples + THREADS - 1) / THREADS, clips);
    const dim3 ana_grid(row_blocks, ft, clips);
    for (int it = 0; it < n_iter; ++it) {
        if (V != NOSYN)
            gl_syn_kernel<<<syn_grid, THREADS, 0, st>>>(state, syn, fr, lay,
                                                        rows, ft, n_pad);
        if (V != NOOLA)
            gl_ola_kernel<<<ola_grid, THREADS, 0, st>>>(
                fr, inv_env, xv, rows, fft_length, hop_length, n_pad, n_samples);
        gl_ana_kernel<V == NONORM, V == NOANA><<<ana_grid, THREADS, 0, st>>>(
            xv, ana, mag, state, prev, lay, rows, fft_length, hop_length, ft,
            n_samples, momentum);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

}  // namespace

extern "C" {

// Runs n_iter Griffin-Lim projections in place on `state` (clips of rows
// frames; layout by `tile_major`, see the note at the top), launching
// 3 * n_iter kernels on `stream`; returns the cudaError_t of the first
// launch that failed (0 on success).  Does not synchronise and allocates
// nothing.  `prev` must start at zero; `fr` (clips, rows, n_pad) and `xv`
// (clips, (rows-1)*hop + fft) are scratch.  `variant` is a Variant.
int tac_fused_gl_solve(float* state, float* prev, const float* mag,
                       const float* syn, const float* ana,
                       const float* inv_env, float* fr, float* xv, int clips,
                       int rows, int fft_length, int hop_length, int ft,
                       int n_pad, int tile_major, int n_iter, float momentum,
                       int variant, void* stream) {
    if (clips <= 0 || rows <= 0 || n_iter <= 0) return 0;
    if (fft_length < 2 || hop_length < 1 || ft < 1 || n_pad % NT != 0 ||
        n_pad < fft_length || ft * FBT < fft_length / 2 + 1)
        return (int)cudaErrorInvalidValue;
    Layout lay;
    lay.clip = (long long)rows * ft * 2 * FBT;
    lay.tile_stride = tile_major ? (long long)rows * 2 * FBT : 2 * FBT;
    lay.row_stride = tile_major ? 2 * FBT : (long long)ft * 2 * FBT;
    const cudaStream_t st = (cudaStream_t)stream;
#define TAC_GL_SOLVE(V)                                                       \
    case V:                                                                   \
        return solve<V>(state, prev, mag, syn, ana, inv_env, fr, xv, clips,   \
                        rows, fft_length, hop_length, ft, n_pad, lay, n_iter, \
                        momentum, st);
    switch (variant) {
        TAC_GL_SOLVE(FULL)
        TAC_GL_SOLVE(NONORM)
        TAC_GL_SOLVE(NOOLA)
        TAC_GL_SOLVE(NOSYN)
        TAC_GL_SOLVE(NOANA)
        default: return (int)cudaErrorInvalidValue;
    }
#undef TAC_GL_SOLVE
}

// Tile constants the host wrapper lays its operands out for.
int tac_fused_gl_tile(int which) {
    switch (which) {
        case 0: return TB;
        case 1: return FBT;
        case 2: return KT;
        case 3: return NT;
        default: return -1;
    }
}

}  // extern "C"
