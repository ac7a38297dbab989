// One Griffin-Lim iteration in two launches, f32, frames-major spectra
// [B*F, bins] (rows are (item, frame) pairs).
//
// Replaces forwardtacotron_tpu/ops/pallas/griffin_lim.py::griffin_lim_fused
// (kernel body _gl_iter_kernel, edge rows _edge_frames), which runs per
// iteration:
//   IDFT GEMM (synthesis window folded in)
//   -> banded OLA + re-frame: y_i[t] = q[t] * sum_d f_{i-d}[t + d*hop],
//      |d| < R = n_fft / hop, q = win / (hop-periodic OLA normalizer)
//   -> the first/last R frames of each item from the true normalizer and
//      reflect padding
//   -> DFT GEMM -> momentum (c = m / (1 + m)) -> phase normalize x magnitude
//
// Both launches run one GEMM core, gl_gemm_kernel: a CTA tile of BM rows x
// 128 columns, K in steps of 32 through a 4-stage ring, 8 warps of 16 x
// (128 / (8 / (BM / 16))) each on mma.sync m16n8k8 TF32 tensor cores in
// 3xTF32: each f32 operand is split into a TF32 head and a TF32 tail, and
// a x b is taken as a_hi b_hi + a_hi b_lo + a_lo b_hi (the tail-tail term,
// ~2^-22 relative, is dropped). That keeps the products at f32 accuracy
// (one TF32 product alone is ~1e-3 relative, outside the 1e-4 gate).
//   - The A tile (BM x 32) is staged through registers: each thread issues
//     its global loads for the stage three ahead before the current
//     stage's products and finishes it after them, splitting each element
//     once (cvt.rna) into head and tail tiles in shared memory.
//   - The weights come in as they are stored, by 16-byte cp.async (padded
//     to whole tiles: GLConstants.inv_pad / fwd_pad, no masks), and each
//     warp splits its B fragments with an integer add, a mask and a
//     subtraction, full-rate instructions where the A split's conversions
//     are not.
//   - The tensor cores round their sums toward zero, so each k8 step's
//     head product starts from zero and joins the f32 sum with a
//     round-to-nearest add, and the tail products chain only within a
//     stage (one chain of 3 x K / 8 truncating adds put the
//     phase-normalized spectrum 3.5x past its gate on the card).
//   - BM is 32 where the launch then has at least one CTA per SM, else 16
//     (a 400-frame request: 200 CTAs in the IDFT, 225 in the DFT); two
//     CTAs fit an SM.
//
// Launch 1 (IDFT): f = [re | im] @ inv_pad (bins = n_fft/2 + 1 is odd, so
// spectrum rows are loaded element by element); f [B*F, n_fft] stays in
// device memory (3.4 MB for a 10 s utterance, so it lives in L2 for
// launch 2).
// Launch 2 (DFT): the A tile is y, built while staging from f: for frame i
// and sample t, N = i*hop + t is the position in the item's overlap-added
// signal, which R frames j (j*hop <= N < j*hop + n_fft) cover, so
//   y_i[t] = q[t] * sum_j f_j[N - j*hop]                 (interior frames)
//   y_i[t] = win[t] * sum_j f_j[N' - j*hop] / winsq[N']  (first/last R)
// with N' = N reflected about the first and last sample of the trimmed
// signal (half = n_fft/2 and half + hop*(F-1) - 1): the edge rows are
// edge_frames' (and JAX's _edge_frames') rows, built in the kernel from f,
// so an iteration is its two launches and nothing else. Interior rows load
// f as float4 (hop % 4 == 0; the first 4 of the R frames ahead of the
// products), edge rows element by element. The weight
// columns interleave (re, im) per bin, so the m16n8 accumulator fragment of
// a thread holds the re and im sums of the same bins: momentum,
// normalization and magnitude are applied in registers and the new
// spectrum and the rebuilt one (next iteration's momentum term) are
// written once.
//
// Bound on an H100 (NVIDIA H100 80GB HBM3, 700 W), the longest request
// (~860 frames, n_fft 1024, hop 256): 3.6 GFLOP per iteration, 0.052 ms at
// the f32 FMA peak (67 TFLOP/s), the bound the kernel is held to; the
// 3xTF32 form does three times the products on the tensor cores, 0.022 ms
// at 495 TFLOP/s. Device memory is not the limit (~9 MB of spectra and 8.7
// MB of constants). What holds the kernel above both is its per-stage
// chain: each CTA streams its weight columns (K x 128) from L2 and each
// DFT CTA reads R values of f per element of its A tile, and on the card
// the weight stream, the A staging and the products add up rather than
// overlap (chip_smoke.py's Griffin-Lim parts; PERF.md). Carries live in
// device memory; the wrapper allocates every output.
//
// Built with -DGL_SKIP_A and/or -DGL_SKIP_PRODUCTS (chip_smoke.py's
// Griffin-Lim parts), the kernel skips the A staging and/or the products:
// its outputs are wrong, and its time says what each part adds.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int BN = 128, BK = 32, THREADS = 256, STAGES = 4;
constexpr int ALD = BK + 4;   // A row stride (floats): 16-byte rows, no bank conflicts
constexpr int WLD = BN + 8;   // W row stride (floats)

enum Mode { IDFT = 0, DFT_V4 = 1, DFT_V1 = 2 };

struct GLParams {
  const float* re;       // [M, bins] (IDFT)
  const float* im;
  const float* w;        // [Kp, Np] padded weights: inv_pad or fwd_pad
  const float* f;        // [M, n_fft] IDFT frames (DFT)
  const float* q;        // [n_fft]
  const float* win;      // [n_fft]
  const float* winsq;    // [(F - 1) hop + n_fft] true OLA normalizer
  const float* tp_re;    // [M, bins] previous rebuilt spectrum (DFT)
  const float* tp_im;
  const float* mag;
  float* out;            // IDFT: f; DFT: new spectrum re
  float* out_im;
  float* rb_re;
  float* rb_im;
  int M, F, bins, n_fft, hop, R, K, Np;  // K: the product's depth before padding
  float c;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = hi + lo with hi, lo TF32 (rounded to nearest, ties away): the A
// operand's split, once per element as it is staged
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  const float rest = x - __uint_as_float(h);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(rest));
  hi = __uint_as_float(h), lo = __uint_as_float(l);
}

// x = hi + lo, hi x rounded to 10 mantissa bits (half away from zero, by
// integer add and mask), lo the exact rest, which the tensor core reads as
// TF32 (its top 10 mantissa bits; |lo| <= 2^-11 |x|, so the split is good
// to 2^-21 |x|): the B operand's split, in full-rate instructions as each
// warp loads its fragments
__device__ __forceinline__ void split_fast(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Sample t of edge frame `fi` (first/last R of its item; see the header):
// the frames covering the reflected signal position over the true
// normalizer, times the window. f: the item's IDFT frames.
__device__ __forceinline__ float edge_value(const GLParams& p, const float* f, int fi, int t) {
  const int half = p.n_fft / 2;
  const int last = half + p.hop * (p.F - 1) - 1;  // the trimmed signal's last sample
  int n = fi * p.hop + t;
  if (n < half) n = 2 * half - n;
  if (n > last) n = 2 * last - n;
  const int jmax = n / p.hop;
  float s = 0.f;
  for (int b = 0; b < p.R; ++b) {
    const int j = jmax - b;
    if (j >= 0 && j < p.F) s += __ldcg(f + (size_t)j * p.n_fft + (n - j * p.hop));
  }
  return s / p.winsq[n] * p.win[t];
}

// C[M, cols] = A[M, K] @ W[K, cols] on BM x BN tiles (see the header).
template <int BM, int MODE>
__global__ void __launch_bounds__(THREADS) gl_gemm_kernel(const __grid_constant__ GLParams p) {
  constexpr int WM = BM / 16;        // warps along M
  constexpr int WN = 8 / WM;         // warps along N
  constexpr int NT = BN / WN / 8;    // n8 blocks per warp
  constexpr int A_FLOATS = BM * ALD, W_FLOATS = BK * WLD;
  constexpr int AE = BM * BK / THREADS;    // IDFT, DFT_V1: A elements per thread
  constexpr int AG = BM * BK / 4;          // DFT_V4: 4-sample groups, one per thread
  static_assert(AG <= THREADS, "DFT_V4 stages one group per thread");

  extern __shared__ __align__(16) float smem[];
  float* Ah = smem;                          // [STAGES][BM][ALD] A heads
  float* Al = Ah + STAGES * A_FLOATS;        // A tails
  float* Ws = Al + STAGES * A_FLOATS;        // [STAGES][BK][WLD] W as stored

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kt_n = (p.K + BK - 1) / BK;

  auto issue_w = [&](int slot, int kt) {  // 16-byte chunks, no masks
    float* w = Ws + slot * W_FLOATS;
#pragma unroll
    for (int i = 0; i < BK * BN / 4 / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / (BN / 4), c4 = c % (BN / 4);
      cp_async16(w + r * WLD + c4 * 4, p.w + (size_t)(kt * BK + r) * p.Np + n0 + c4 * 4);
    }
  };

  // A of a stage in two halves: fetch issues its global loads into
  // registers before the current stage's products, store finishes the
  // values after them (the DFT's sums and scales, its edge frames), splits
  // them and writes heads and tails to the stage's slot
  float araw[AE];
  float4 fr[4], qv;  // DFT_V4: up to 4 covering frames of the group, q
  auto fetch = [&](int kt) {
    if constexpr (MODE == IDFT) {
#pragma unroll
      for (int i = 0; i < AE; ++i) {
        const int e = tid + i * THREADS, row = m0 + e / BK, gk = kt * BK + e % BK;
        araw[i] = row >= p.M || gk >= p.K ? 0.f
                  : gk < p.bins          ? __ldg(p.re + (size_t)row * p.bins + gk)
                                         : __ldg(p.im + (size_t)row * p.bins + (gk - p.bins));
      }
    } else if constexpr (MODE == DFT_V4) {
      const int row = m0 + tid / (BK / 4), gk = kt * BK + (tid % (BK / 4)) * 4;
      const int item = row / p.F, fi = row - item * p.F;
      if (tid < AG && row < p.M && gk < p.K && fi >= p.R && fi < p.F - p.R) {
        const int n = fi * p.hop + gk, jmax = n / p.hop;
        const float* f = p.f + ((size_t)item * p.F + jmax) * p.n_fft + (n - jmax * p.hop);
#pragma unroll
        for (int b = 0; b < 4; ++b)  // frame jmax - b, at n - (jmax - b) hop
          if (b < p.R)
            fr[b] = __ldcg(reinterpret_cast<const float4*>(f - (size_t)b * (p.n_fft - p.hop)));
        qv = __ldg(reinterpret_cast<const float4*>(p.q + gk));
      }
    }
  };
  auto store = [&](int slot, int kt) {
    float* ah = Ah + slot * A_FLOATS;
    float* al = Al + slot * A_FLOATS;
    if constexpr (MODE == DFT_V4) {
      if (tid >= AG) return;
      const int r = tid / (BK / 4), k = (tid % (BK / 4)) * 4;
      const int row = m0 + r, gk = kt * BK + k;
      const int item = row / p.F, fi = row - item * p.F;
      float y[4] = {};
      if (row < p.M && gk < p.K) {
        const float* f = p.f + (size_t)item * p.F * p.n_fft;
        if (fi >= p.R && fi < p.F - p.R) {
          const int n = fi * p.hop + gk, jmax = n / p.hop;
          float4 s = fr[0];
#pragma unroll
          for (int b = 1; b < 4; ++b)
            if (b < p.R) s.x += fr[b].x, s.y += fr[b].y, s.z += fr[b].z, s.w += fr[b].w;
          for (int b = 4; b < p.R; ++b) {  // R > 4: the rest of the band
            const float4 v = __ldcg(reinterpret_cast<const float4*>(
                f + (size_t)(jmax - b) * p.n_fft + (n - (jmax - b) * p.hop)));
            s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
          }
          y[0] = s.x * qv.x, y[1] = s.y * qv.y, y[2] = s.z * qv.z, y[3] = s.w * qv.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) y[i] = edge_value(p, f, fi, gk + i);
        }
      }
      float4 hi, lo;
      split_tf32(y[0], hi.x, lo.x);
      split_tf32(y[1], hi.y, lo.y);
      split_tf32(y[2], hi.z, lo.z);
      split_tf32(y[3], hi.w, lo.w);
      *reinterpret_cast<float4*>(ah + r * ALD + k) = hi;
      *reinterpret_cast<float4*>(al + r * ALD + k) = lo;
    } else {
#pragma unroll
      for (int i = 0; i < AE; ++i) {
        const int e = tid + i * THREADS, r = e / BK, k = e % BK;
        float v = araw[i];
        if constexpr (MODE == DFT_V1) {  // hop % 4 != 0: element by element
          const int row = m0 + r, gk = kt * BK + k;
          const int item = row / p.F, fi = row - item * p.F;
          v = 0.f;
          if (row < p.M && gk < p.K) {
            const float* f = p.f + (size_t)item * p.F * p.n_fft;
            if (fi >= p.R && fi < p.F - p.R) {
              const int n = fi * p.hop + gk, jmax = n / p.hop;
              for (int b = 0; b < p.R; ++b)
                v += __ldcg(f + (size_t)(jmax - b) * p.n_fft + (n - (jmax - b) * p.hop));
              v *= p.q[gk];
            } else {
              v = edge_value(p, f, fi, gk);
            }
          }
        }
        split_tf32(v, ah[r * ALD + k], al[r * ALD + k]);
      }
    }
  };

  float acc[NT][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) {
      issue_w(s, s);
      fetch(s);
      store(s, s);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    // A's loads for stage kt + 3 go out first, into registers: they wait
    // for no slot, so their latency overlaps the wait for stage kt and its
    // products
    const int next = kt + STAGES - 1;
#ifndef GL_SKIP_A
    if (next < kt_n) fetch(next);
#endif
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt is in; every warp is done with stage kt - 1
    if (next < kt_n) issue_w(next % STAGES, next);
    cp_async_commit();
    const float* ah = Ah + (kt % STAGES) * A_FLOATS + (wm * 16) * ALD;
    const float* al = Al + (kt % STAGES) * A_FLOATS + (wm * 16) * ALD;
    const float* w = Ws + (kt % STAGES) * W_FLOATS + wn * NT * 8;
    // the tensor cores round their sums toward zero, so a long chain of
    // them in one accumulator drifts: each k8 step's head product starts
    // from zero and joins acc in f32 (round to nearest); the tail products
    // (2^-11 of it) chain over the stage
    float small[NT][4] = {};
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      const int o0 = g * ALD + kk + tq, o1 = (g + 8) * ALD + kk + tq;
      const uint32_t a_hi[4] = {__float_as_uint(ah[o0]), __float_as_uint(ah[o1]),
                                __float_as_uint(ah[o0 + 4]), __float_as_uint(ah[o1 + 4])};
      const uint32_t a_lo[4] = {__float_as_uint(al[o0]), __float_as_uint(al[o1]),
                                __float_as_uint(al[o0 + 4]), __float_as_uint(al[o1 + 4])};
#ifndef GL_SKIP_PRODUCTS
#pragma unroll
      for (int nb = 0; nb < NT; ++nb) {
        uint32_t b_hi[2], b_lo[2];
        split_fast(w[(kk + tq) * WLD + nb * 8 + g], b_hi[0], b_lo[0]);
        split_fast(w[(kk + tq + 4) * WLD + nb * 8 + g], b_hi[1], b_lo[1]);
        float big[4] = {};
        mma_tf32(small[nb], a_lo, b_hi);
        mma_tf32(small[nb], a_hi, b_lo);
        mma_tf32(big, a_hi, b_hi);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nb][i] += big[i];
      }
#endif
    }
#pragma unroll
    for (int nb = 0; nb < NT; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nb][i] += small[nb][i];
#ifndef GL_SKIP_A
    if (next < kt_n) store(next % STAGES, next);
#endif
  }
  cp_async_wait<0>();

  // epilogue: thread holds rows (g, g + 8) x columns (2 tq, 2 tq + 1) of
  // each n8 block
#pragma unroll
  for (int nb = 0; nb < NT; ++nb) {
    const int col = n0 + wn * NT * 8 + nb * 8 + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 16 + g + 8 * h;
      if (row >= p.M) continue;
      const float v0 = acc[nb][2 * h], v1 = acc[nb][2 * h + 1];
      if constexpr (MODE == IDFT) {
        float* dst = p.out + (size_t)row * p.n_fft;
        if (col < p.n_fft) dst[col] = v0;
        if (col + 1 < p.n_fft) dst[col + 1] = v1;
      } else {  // columns (2 bin, 2 bin + 1) = (re, im) of one bin
        const int bin = col / 2;
        if (bin >= p.bins) continue;
        const size_t o = (size_t)row * p.bins + bin;
        const float ur = v0 - p.c * p.tp_re[o];
        const float ui = v1 - p.c * p.tp_im[o];
        const float mod = fmaxf(sqrtf(ur * ur + ui * ui), 1e-16f);
        const float m = p.mag[o];
        p.out[o] = m * ur / mod;
        p.out_im[o] = m * ui / mod;
        p.rb_re[o] = v0;
        p.rb_im[o] = v1;
      }
    }
  }
}

template <int BM, int MODE>
int launch_gemm(const GLParams& p, int n_cols, cudaStream_t stream) {
  constexpr size_t smem = (size_t)STAGES * (2 * BM * ALD + BK * WLD) * sizeof(float);
  auto kernel = gl_gemm_kernel<BM, MODE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_cols + BN - 1) / BN, (p.M + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// BM 32 where that gives every SM a CTA, else 16
template <int MODE>
int launch_tiles(const GLParams& p, int n_cols, int n_sm, cudaStream_t stream) {
  const long tiles32 = (long)((p.M + 31) / 32) * ((n_cols + BN - 1) / BN);
  return tiles32 >= n_sm ? launch_gemm<32, MODE>(p, n_cols, stream)
                         : launch_gemm<16, MODE>(p, n_cols, stream);
}

}  // namespace

// The padded weights: inv_pad [round_up(2 bins, 32), round_up(n_fft, 128)]
// (inv_w with zero rows and columns), fwd_pad [round_up(n_fft, 32),
// round_up(2 bins, 128)] with columns (2 k, 2 k + 1) = (fwd_re, fwd_im) of
// bin k; winsq [(F - 1) hop + n_fft]; frames: [B*F, n_fft] scratch.
extern "C" int gl_iter_f32(const float* spec_re, const float* spec_im, const float* tp_re,
                           const float* tp_im, const float* mag, const float* winsq,
                           const float* inv_pad, const float* fwd_pad, const float* q,
                           const float* win, float* frames, float* out_re, float* out_im,
                           float* rb_re, float* rb_im, int B, int F, int bins, int n_fft,
                           int hop, float c, int device, cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (n_fft % hop || bins != n_fft / 2 + 1 || F < 2 * (n_fft / hop))
    return (int)cudaErrorInvalidValue;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  GLParams p = {};
  p.M = B * F, p.F = F, p.bins = bins, p.n_fft = n_fft, p.hop = hop, p.R = n_fft / hop;
  p.q = q, p.win = win, p.winsq = winsq, p.c = c;

  p.re = spec_re, p.im = spec_im, p.w = inv_pad, p.out = frames;
  p.K = 2 * bins, p.Np = (n_fft + BN - 1) / BN * BN;
  int st = launch_tiles<IDFT>(p, n_fft, n_sm, stream);
  if (st) return st;

  p.f = frames, p.w = fwd_pad, p.tp_re = tp_re, p.tp_im = tp_im, p.mag = mag;
  p.out = out_re, p.out_im = out_im, p.rb_re = rb_re, p.rb_im = rb_im;
  p.K = n_fft, p.Np = (2 * bins + BN - 1) / BN * BN;
  return hop % 4 ? launch_tiles<DFT_V1>(p, 2 * bins, n_sm, stream)
                 : launch_tiles<DFT_V4>(p, 2 * bins, n_sm, stream);
}
