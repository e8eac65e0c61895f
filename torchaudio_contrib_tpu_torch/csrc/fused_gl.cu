// Fused Griffin-Lim solve for Hopper (sm_90a).
//
// Replaces three TPU kernels of the JAX package, which are one solve written
// three times:
//   * torchaudio_contrib_tpu/ops/fused_griffinlim.py::_build_gl_call
//     (all n_iter momentum projections of one clip),
//   * ::_build_gl_call_tile_major (the same with the state in tile-major
//     layout): here a stride argument of the same kernels,
//   * benchmarks/r3_gl_bisect.py::build (the same with one stage
//     neutralised per variant, for timing): here switches of the same
//     kernels.
//
// Per iteration, for every clip b (rows = n_frames, L = (rows-1)*hop + fft):
//   fr[b, j, n]  = window[n] * irfft(state[b, j, :])[n]     synthesis
//   xv[b, s]     = inv_env[s] * sum_j fr[b, j, s - j*hop]  overlap-add, envelope
//   reim[b, j, :]= rfft(window * xv[b, j*hop : j*hop + fft]) analysis
//   upd          = reim + momentum * (reim - prev);  prev = reim
//   state        = mag * upd / max(|upd|, 1e-16)           (|.| over re, im)
// prev starts at zero, so the first step projects (1 + momentum) * reim.
// (irfft ignores the imaginary parts of DC and Nyquist.)
//
// Two routes, chosen by the host from fft_length alone:
//   * FFT route (fft_length a power of two from 256 to 2048): both
//     transforms run through fft_smem.cuh, a frame of N samples as one
//     complex Stockham transform of N / 2 points in shared memory
//     (gl_syn_fft_kernel: hermitian_point, inverse transform, window;
//     gl_ana_fft_kernel: window, transform, real_bin, then the momentum step
//     and the projection in the same loop over bins).
//   * DFT route (any other even size): both transforms as dense FP32
//     products with the windowed DFT bases (gl_syn_kernel, gl_ana_kernel),
//     2 * 2 * rows * fft * (ft*2*FBT) FLOPs per clip and iteration.
//
// What bounds it.  The DFT route is bound by its products: two orders of
// magnitude more operations than the function needs.  On the FFT route the
// operations are the function's own, and what is left is traffic: an
// iteration has two grid-wide dependencies (every fr row before the
// overlap-add, the whole signal before the analysis), so state, prev, mag, fr
// and xv go through device memory (or L2) once or twice per iteration, about
// 100 MB at 8 x 431 frames of 1024, where the function as a whole would move
// each tensor once.
//
// What the design does about it, and where it leaves the TPU kernel's shape:
//   * The TPU kernel is one program per clip with the state resident in its
//     on-chip memory.  A clip's state is megabytes and there are only a few
//     clips, so here state, prev, fr and xv live in device memory (they sit
//     in or near L2) and every clip's rows are spread over many thread
//     blocks.
//   * An iteration is three launches; the host side of the solve loops them,
//     so that one call runs the whole solve on the caller's stream, in order,
//     with no synchronisation.
//   * Grid fill: a solve has a few thousand frames, so an FFT-route block
//     takes one round of fft_smem.cuh (2048 / (N / 2) frames: 2 at fft 2048,
//     16 at fft 256) and no more: that gives several blocks for every SM at
//     the benchmark shapes, four of them resident (64 registers a thread).
//   * The FFT route's kernels are bound by the latency of their loads, not
//     by their transforms: the epilogue reads and writes 16 bytes a thread,
//     and its inputs travel to shared memory (cp.async) while the transform
//     runs.
//   * Each frame is transformed alone (two real frames packed into one
//     complex transform would leak a loud frame's rounding into a quiet
//     neighbour), with twiddles from the host's float64-built table.
//   * The overlap-add is a gather (one thread per output sample sums the
//     frames that cover it, in frame order), so it has no atomics and the
//     solve gives the same bits on every run.
//   * There is no re-framing pass: the analysis reads its frames from the
//     enveloped signal with strided loads at any hop.  So fft % hop == 0 and
//     the multiples of 128 are not needed here.
//   * The momentum step, the magnitude projection and the update of prev are
//     epilogue work on the transform's output: on the DFT route on each
//     thread's 4-frame x 4-bin register tile, on the FFT route in the loop
//     that forms the bins from the parked transform.  The FFT route writes
//     exact zeros to the padded bins of state and prev, which the DFT route's
//     zero basis columns give.
//   * Layout: element (frame j, tile t, column c) of a clip's state lives at
//     t*tile_stride + j*row_stride + c.  Row-major (rows, ft*2*FBT) has
//     tile_stride 2*FBT and row_stride ft*2*FBT; tile-major (ft, rows, 2*FBT)
//     has tile_stride rows*2*FBT and row_stride 2*FBT.  The magnitudes use
//     half of each.  Every kernel of both routes addresses the state through
//     it.
//   * The stage switches are template parameters of the DFT route's analysis
//     kernel and a uniform runtime argument of the FFT route's (one instance
//     per size: the build's time goes with the number of instances).

#include <cuda_runtime.h>

#include "fft_smem.cuh"

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

// ---- the FFT route ---------------------------------------------------------

constexpr int GL_FFT_BLOCKS = 4;    // resident blocks an SM (64 registers a thread)

// Where bin k of a frame's row starts in a state of 64-bin [re | im] tiles.
__device__ __forceinline__ long long bin_col(const Layout& lay, int k) {
    return (long long)(k / FBT) * lay.tile_stride + k % FBT;
}

// fr[b, j, :] = window * (unnormalised inverse of the Hermitian spectrum
// Y = state[b, j, :] / N, the imaginary parts of DC and Nyquist ignored).
// A block takes one round of fft_smem.cuh, G = 2048 / (N / 2) frames, one
// frame per thread group.  grid (ceil(rows / G), clips)
template <int N>
__global__ void __launch_bounds__(tacfft::FFT_THREADS, GL_FFT_BLOCKS)
gl_syn_fft_kernel(const float* __restrict__ state,
                  const float* __restrict__ window,
                  const float2* __restrict__ twiddle, float* __restrict__ fr,
                  Layout lay, int rows) {
    using namespace tacfft;
    constexpr int M = N / 2;                     // complex points a frame
    constexpr int TPF = M / POINTS;              // threads per frame
    constexpr int G = ROUND_POINTS / M;          // frames per round
    __shared__ __align__(16) float2 work[WORK_POINTS];
    __shared__ __align__(16) float2 tw_s[N];

    const int tid = threadIdx.x;
    const int g = tid / TPF;
    const int j = tid % TPF;
    const int b = blockIdx.y;
    const float* st = state + (long long)b * lay.clip;
    const float inv_n = 1.f / N;

    load_twiddles<N>(tw_s, twiddle);
    __syncthreads();

    const int frame = blockIdx.x * G + g;
    const bool ok = frame < rows;
    const float* row = st + (long long)frame * lay.row_stride;
    float2 v[POINTS];
#pragma unroll
    for (int m = 0; m < POINTS; ++m) {
        const int k = j + m * TPF;              // 0..M-1
        float2 yk = make_float2(0.f, 0.f), yn = yk;
        if (ok) {
            const float* pk = row + bin_col(lay, k);
            const float* pn = row + bin_col(lay, M - k);
            yk = make_float2(pk[0] * inv_n, k == 0 ? 0.f : pk[FBT] * inv_n);
            yn = make_float2(pn[0] * inv_n, k == 0 ? 0.f : pn[FBT] * inv_n);
        }
        v[m] = hermitian_point(yk, yn, tw_s[k]);
    }
    fft_block<M, true>(v, work, tw_s + M, g, j);
    if (!ok) return;
    float* out = fr + ((long long)b * rows + frame) * N;
#pragma unroll
    for (int m = 0; m < POINTS; ++m) {
        const int n = 2 * (j + m * TPF);
        const float2 w = *reinterpret_cast<const float2*>(window + n);
        *reinterpret_cast<float2*>(out + n) =
            make_float2(w.x * v[m].x, w.y * v[m].y);
    }
}

// 16 bytes from device memory to shared memory, asynchronously.
__device__ __forceinline__ void copy_async16(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src));
}

// reim[b, j, :] = the N / 2 + 1 bins of window * xv[b, j*hop : j*hop + N],
// then, in the same loop over bins, the momentum step and the magnitude
// projection, 4 bins of one tile a thread.  The epilogue's inputs (prev and
// mag of the block's frames) are set off towards shared memory once the
// twiddles are in and before the frame is loaded, so that their latency
// passes behind the transform (set off before the twiddles they delay its
// start: 8-12 % slower); each thread reads back only what it copied itself.  Bins N / 2 + 1 .. ft*FBT - 1 of state and
// prev get zeros.  `variant` is uniform over the grid: NOANA skips the load
// and the transform (the epilogue runs on zero bins), NONORM stores the bins
// as the state.  A block takes G = 2048 / (N / 2) frames, as the synthesis.
// grid (ceil(rows / G), clips); dynamic shared memory: 3 * G * (N / 2 + FBT)
// floats
template <int N>
__global__ void __launch_bounds__(tacfft::FFT_THREADS, GL_FFT_BLOCKS)
gl_ana_fft_kernel(const float* __restrict__ xv,
                  const float* __restrict__ window,
                  const float2* __restrict__ twiddle,
                  const float* __restrict__ mag, float* __restrict__ state,
                  float* __restrict__ prev, Layout lay, int rows,
                  int hop_length, int n_samples, float momentum,
                  int variant) {
    using namespace tacfft;
    constexpr int M = N / 2;
    constexpr int TPF = M / POINTS;
    constexpr int G = ROUND_POINTS / M;
    constexpr int KP = M + FBT;                  // bins padded to the tiles
    constexpr int QUADS = G * (KP / 4);          // groups of 4 bins a block
    __shared__ __align__(16) float2 work[WORK_POINTS];
    __shared__ __align__(16) float2 tw_s[N];
    extern __shared__ __align__(16) float stage[];       // (3, G * KP)
    float* pre_s = stage;                        // prev re, prev im, mag
    float* pim_s = stage + G * KP;
    float* mag_s = stage + 2 * G * KP;

    const int tid = threadIdx.x;
    const int g = tid / TPF;
    const int j = tid % TPF;
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * G;
    const float* xs = xv + (long long)b * n_samples;
    float* st = state + (long long)b * lay.clip;
    float* pv = prev + (long long)b * lay.clip;
    const float* mg = mag + (long long)b * (lay.clip / 2);

    load_twiddles<N>(tw_s, twiddle);
    __syncthreads();
    if (variant != NONORM) {
        for (int q = tid; q < QUADS; q += FFT_THREADS) {
            const int frame = f0 + q / (KP / 4);
            const int k0 = (q % (KP / 4)) * 4;
            if (frame >= rows) break;
            if (k0 > M) continue;
            const long long off = (long long)frame * lay.row_stride
                                  + bin_col(lay, k0);
            copy_async16(pre_s + 4 * q, pv + off);
            copy_async16(pim_s + 4 * q, pv + off + FBT);
            copy_async16(mag_s + 4 * q,
                         mg + (long long)frame * (lay.row_stride / 2)
                         + (long long)(k0 / FBT) * (lay.tile_stride / 2)
                         + k0 % FBT);
        }
    }
    asm volatile("cp.async.commit_group;");

    float2 v[POINTS];
#pragma unroll
    for (int m = 0; m < POINTS; ++m) v[m] = make_float2(0.f, 0.f);
    if (variant != NOANA) {
        // the windowed frame, even samples real and odd imaginary
        const int frame = f0 + g;
        if (frame < rows) {
            const float* xf = xs + (long long)frame * hop_length;
#pragma unroll
            for (int m = 0; m < POINTS; ++m) {
                const int n = 2 * (j + m * TPF);
                const float2 w = *reinterpret_cast<const float2*>(window + n);
                v[m] = make_float2(w.x * xf[n], w.y * xf[n + 1]);
            }
        }
        fft_block<M, false>(v, work, tw_s + M, g, j);
    }
#pragma unroll
    for (int m = 0; m < POINTS; ++m)
        work[padded(g * M + j + m * TPF)] = v[m];
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();

    for (int q = tid; q < QUADS; q += FFT_THREADS) {
        const int gg = q / (KP / 4);
        const int k0 = (q % (KP / 4)) * 4;
        const int frame = f0 + gg;
        if (frame >= rows) break;
        const long long off = (long long)frame * lay.row_stride
                              + bin_col(lay, k0);
        const float2* z = work + padded(gg * M);
        float re[4], im[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int k = k0 + e;
            float2 bin = make_float2(0.f, 0.f);
            if (k <= M) {
                const int kk = k & (M - 1), kn = (M - k) & (M - 1);
                bin = real_bin(z[kk + (kk >> 4)], z[kn + (kn >> 4)],
                               k < M ? tw_s[k] : make_float2(-1.f, 0.f));
            }
            re[e] = bin.x;
            im[e] = bin.y;
        }
        float4* s_re = reinterpret_cast<float4*>(st + off);
        float4* s_im = reinterpret_cast<float4*>(st + off + FBT);
        if (variant == NONORM) {
            *s_re = make_float4(re[0], re[1], re[2], re[3]);
            *s_im = make_float4(im[0], im[1], im[2], im[3]);
            continue;
        }
        *reinterpret_cast<float4*>(pv + off) =
            make_float4(re[0], re[1], re[2], re[3]);
        *reinterpret_cast<float4*>(pv + off + FBT) =
            make_float4(im[0], im[1], im[2], im[3]);
        float4 p_re = make_float4(0.f, 0.f, 0.f, 0.f), p_im = p_re, m4 = p_re;
        if (k0 <= M) {
            p_re = *reinterpret_cast<const float4*>(pre_s + 4 * q);
            p_im = *reinterpret_cast<const float4*>(pim_s + 4 * q);
            m4 = *reinterpret_cast<const float4*>(mag_s + 4 * q);
        }
        const float pr[4] = {p_re.x, p_re.y, p_re.z, p_re.w};
        const float pi[4] = {p_im.x, p_im.y, p_im.z, p_im.w};
        const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
        float o_re[4], o_im[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            // a padded bin (k > M) has re = im = 0 and gives exact zeros
            const float ur = re[e] + momentum * (re[e] - pr[e]);
            const float ui = im[e] + momentum * (im[e] - pi[e]);
            const float sc = k0 + e > M
                ? 0.f : mv[e] / fmaxf(sqrtf(ur * ur + ui * ui), 1e-16f);
            o_re[e] = ur * sc;
            o_im[e] = ui * sc;
        }
        *s_re = make_float4(o_re[0], o_re[1], o_re[2], o_re[3]);
        *s_im = make_float4(o_im[0], o_im[1], o_im[2], o_im[3]);
    }
}

template <int N>
int solve_fft(float* state, float* prev, const float* mag, const float* window,
              const float* twiddle, const float* inv_env, float* fr, float* xv,
              int clips, int rows, int hop_length, Layout lay, int n_iter,
              float momentum, int variant, cudaStream_t st) {
    constexpr int G = tacfft::ROUND_POINTS / (N / 2);
    const int n_samples = (rows - 1) * hop_length + N;
    const float2* tw = reinterpret_cast<const float2*>(twiddle);
    const size_t stage_bytes = sizeof(float) * 3 * G * (N / 2 + FBT);
    // room for GL_FFT_BLOCKS blocks' shared memory on an SM
    cudaError_t err = cudaFuncSetAttribute(
        gl_syn_fft_kernel<N>, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            gl_ana_fft_kernel<N>,
            cudaFuncAttributePreferredSharedMemoryCarveout,
            cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            gl_ana_fft_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)stage_bytes);
    if (err != cudaSuccess) return (int)err;
    const dim3 fft_grid((rows + G - 1) / G, clips);
    const dim3 ola_grid((n_samples + THREADS - 1) / THREADS, clips);
    for (int it = 0; it < n_iter; ++it) {
        if (variant != NOSYN)
            gl_syn_fft_kernel<N><<<fft_grid, tacfft::FFT_THREADS, 0, st>>>(
                state, window, tw, fr, lay, rows);
        if (variant != NOOLA)
            gl_ola_kernel<<<ola_grid, THREADS, 0, st>>>(
                fr, inv_env, xv, rows, N, hop_length, N, n_samples);
        gl_ana_fft_kernel<N>
            <<<fft_grid, tacfft::FFT_THREADS, stage_bytes, st>>>(
                xv, window, tw, mag, state, prev, lay, rows, hop_length,
                n_samples, momentum, variant);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}

Layout layout_of(int rows, int ft, int tile_major) {
    Layout lay;
    lay.clip = (long long)rows * ft * 2 * FBT;
    lay.tile_stride = tile_major ? (long long)rows * 2 * FBT : 2 * FBT;
    lay.row_stride = tile_major ? 2 * FBT : (long long)ft * 2 * FBT;
    return lay;
}

// ---- the DFT route's host loop ---------------------------------------------

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
// frames; layout by `tile_major`, see the note at the top) on the DFT route,
// launching 3 * n_iter kernels on `stream`; returns the cudaError_t of the first
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
    const Layout lay = layout_of(rows, ft, tile_major);
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

// The same solve on the FFT route: fft_length a power of two from 256 to
// 2048, ft = fft_length / 128 + 1.  `window` is the fft_length window
// samples, `twiddle` the fft_length pairs of fft_smem.cuh's twiddle table;
// `fr` is (clips, rows, fft_length).  Otherwise as tac_fused_gl_solve.
int tac_fused_gl_solve_fft(float* state, float* prev, const float* mag,
                           const float* window, const float* twiddle,
                           const float* inv_env, float* fr, float* xv,
                           int clips, int rows, int fft_length,
                           int hop_length, int ft, int tile_major, int n_iter,
                           float momentum, int variant, void* stream) {
    if (clips <= 0 || rows <= 0 || n_iter <= 0) return 0;
    if (fft_length % 2 != 0 || !tacfft::fft_size_ok(fft_length / 2) ||
        hop_length < 1 || ft != fft_length / (2 * FBT) + 1 ||
        variant < FULL || variant > NOANA)
        return (int)cudaErrorInvalidValue;
    const Layout lay = layout_of(rows, ft, tile_major);
    const cudaStream_t st = (cudaStream_t)stream;
#define TAC_GL_FFT_CASE(n)                                                    \
    case n:                                                                   \
        return solve_fft<n>(state, prev, mag, window, twiddle, inv_env, fr,   \
                            xv, clips, rows, hop_length, lay, n_iter,         \
                            momentum, variant, st)
    switch (fft_length) {
        TAC_GL_FFT_CASE(256);
        TAC_GL_FFT_CASE(512);
        TAC_GL_FFT_CASE(1024);
        TAC_GL_FFT_CASE(2048);
        default: return (int)cudaErrorInvalidValue;
    }
#undef TAC_GL_FFT_CASE
}

// Tile constants the host wrapper lays its operands out for; 4 and 5 are the
// least and the largest fft_length of the FFT route.
int tac_fused_gl_tile(int which) {
    switch (which) {
        case 0: return TB;
        case 1: return FBT;
        case 2: return KT;
        case 3: return NT;
        case 4: return 2 * tacfft::FFT_MIN;
        case 5: return 2 * tacfft::FFT_MAX;
        default: return -1;
    }
}

}  // extern "C"
