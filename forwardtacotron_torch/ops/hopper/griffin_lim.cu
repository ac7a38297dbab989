// One Griffin-Lim iteration in two launches, f32, frames-major spectra
// [B*F, bins] (rows are (item, frame) pairs).
//
// Replaces forwardtacotron_tpu/ops/pallas/griffin_lim.py::griffin_lim_fused
// (kernel body _gl_iter_kernel), which runs per iteration:
//   IDFT GEMM (synthesis window folded in)
//   -> banded OLA + re-frame: y_i[t] = q[t] * sum_d f_{i-d}[t + d*hop],
//      |d| < R = n_fft / hop, q = win / (hop-periodic OLA normalizer)
//   -> the first/last R frames replaced by exact values computed outside
//   -> DFT GEMM -> momentum (c = m / (1 + m)) -> phase normalize x magnitude
//
// Launch 1 (gl_idft_kernel): f = [re | im] @ [inv_re_w ; inv_im_w], a tiled
// shared-memory SGEMM, f [B*F, n_fft] stays in device memory (3.5 MB for a
// 10 s utterance, so it lives in L2 for launch 2).
// Launch 2 (gl_dft_update_kernel): the same SGEMM tiling, but its A tile is
// the banded OLA of f computed while loading (or the replacement rows for
// edge frames); each thread holds the re and im sums of the same bins, so
// momentum, normalization and magnitude are applied in registers and the
// new spectrum and the rebuilt one (next iteration's momentum term) are
// written once.
//
// Bound on an H100: f32 FMAs of the two [rows, ~1k] x [~1k, ~1k] products.
// The 513 -> 640 bin padding of the TPU kernel is not needed: bins are
// masked at the tile edge. Carries live in device memory; the wrapper
// allocates every output.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
constexpr int APAD = BM + 4;   // keeps float4 alignment, spreads banks

// f[M, N] = A[M, K] @ W[K, N], A row = [re(bins) | im(bins)], K = 2*bins
__global__ void __launch_bounds__(THREADS)
gl_idft_kernel(const float* __restrict__ re, const float* __restrict__ im,
               const float* __restrict__ w, float* __restrict__ f,
               int M, int bins, int N) {
  __shared__ __align__(16) float As[BK][APAD];
  __shared__ __align__(16) float Bs[BK][BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int K = 2 * bins;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BK, kk = idx % BK;
      const int gr = m0 + r, gk = k0 + kk;
      float v = 0.f;
      if (gr < M && gk < K)
        v = gk < bins ? re[(long)gr * bins + gk] : im[(long)gr * bins + gk - bins];
      As[kk][r] = v;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx / BN, cc = idx % BN;
      const int gk = k0 + kk, gc = n0 + cc;
      Bs[kk][cc] = (gk < K && gc < N) ? w[(long)gk * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = m0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = n0 + tx * 4 + j;
      if (gc < N) f[(long)gr * N + gc] = acc[i][j];
    }
  }
}

// Pre-DFT frame value y[row][t]: replacement rows at the edges, the banded
// OLA of f times q in the interior.
__device__ __forceinline__ float frame_value(
    const float* __restrict__ f, const float* __restrict__ repl,
    const float* __restrict__ q, int row, int t, int F, int n_fft, int hop,
    int R) {
  const int item = row / F, fi = row - item * F;
  if (fi < R) return repl[((long)item * 2 * R + fi) * n_fft + t];
  if (fi >= F - R)
    return repl[((long)item * 2 * R + R + fi - (F - R)) * n_fft + t];
  float s = 0.f;
  for (int d = -(R - 1); d < R; ++d) {
    const int tt = t + d * hop;
    if (tt >= 0 && tt < n_fft) s += f[(long)(row - d) * n_fft + tt];
  }
  return s * q[t];
}

// rb = y @ [fwd_re | fwd_im] over BN/2 bins per tile; then
// up = rb - c * tprev, spec = mag * up / max(|up|, 1e-16), tprev' = rb.
__global__ void __launch_bounds__(THREADS)
gl_dft_update_kernel(const float* __restrict__ f,
                     const float* __restrict__ repl,    // [B, 2R, n_fft]
                     const float* __restrict__ q,       // [n_fft]
                     const float* __restrict__ fwd_re,  // [n_fft, bins]
                     const float* __restrict__ fwd_im,  // [n_fft, bins]
                     const float* __restrict__ tp_re,
                     const float* __restrict__ tp_im,
                     const float* __restrict__ mag,
                     float* __restrict__ out_re, float* __restrict__ out_im,
                     float* __restrict__ rb_re_out,
                     float* __restrict__ rb_im_out,
                     int M, int F, int bins, int n_fft, int hop, float c) {
  constexpr int NB = BN / 2;   // bins per tile
  __shared__ __align__(16) float As[BK][APAD];
  __shared__ __align__(16) float Bs[BK][BN];   // [re bins | im bins]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, b0 = blockIdx.x * NB;
  const int R = n_fft / hop;
  float acc_re[4][2] = {}, acc_im[4][2] = {};
  for (int k0 = 0; k0 < n_fft; k0 += BK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * THREADS;
      const int r = idx / BK, kk = idx % BK;
      const int gr = m0 + r, gk = k0 + kk;
      As[kk][r] = (gr < M && gk < n_fft)
                      ? frame_value(f, repl, q, gr, gk, F, n_fft, hop, R)
                      : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * THREADS;
      const int kk = idx / BN, cc = idx % BN;
      const int gk = k0 + kk;
      const int bin = b0 + (cc % NB);
      float v = 0.f;
      if (gk < n_fft && bin < bins)
        v = (cc < NB ? fwd_re : fwd_im)[(long)gk * bins + bin];
      Bs[kk][cc] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float2 br = *reinterpret_cast<const float2*>(&Bs[kk][tx * 2]);
      const float2 bi = *reinterpret_cast<const float2*>(&Bs[kk][NB + tx * 2]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc_re[i][0] = fmaf(av[i], br.x, acc_re[i][0]);
        acc_re[i][1] = fmaf(av[i], br.y, acc_re[i][1]);
        acc_im[i][0] = fmaf(av[i], bi.x, acc_im[i][0]);
        acc_im[i][1] = fmaf(av[i], bi.y, acc_im[i][1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = m0 + ty * 4 + i;
    if (gr >= M) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int bin = b0 + tx * 2 + j;
      if (bin >= bins) continue;
      const long o = (long)gr * bins + bin;
      const float rr = acc_re[i][j], ri = acc_im[i][j];
      const float ur = rr - c * tp_re[o];
      const float ui = ri - c * tp_im[o];
      const float mod = fmaxf(sqrtf(ur * ur + ui * ui), 1e-16f);
      const float m = mag[o];
      out_re[o] = m * ur / mod;
      out_im[o] = m * ui / mod;
      rb_re_out[o] = rr;
      rb_im_out[o] = ri;
    }
  }
}

}  // namespace

extern "C" int gl_iter_f32(const float* spec_re, const float* spec_im,
                           const float* tp_re, const float* tp_im,
                           const float* mag, const float* repl,
                           const float* inv_w, const float* fwd_re,
                           const float* fwd_im, const float* q, float* frames,
                           float* out_re, float* out_im, float* rb_re,
                           float* rb_im, int B, int F, int bins, int n_fft,
                           int hop, float c, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int M = B * F;
  dim3 g1((n_fft + BN - 1) / BN, (M + BM - 1) / BM);
  gl_idft_kernel<<<g1, THREADS, 0, stream>>>(spec_re, spec_im, inv_w, frames,
                                             M, bins, n_fft);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 g2((bins + BN / 2 - 1) / (BN / 2), (M + BM - 1) / BM);
  gl_dft_update_kernel<<<g2, THREADS, 0, stream>>>(
      frames, repl, q, fwd_re, fwd_im, tp_re, tp_im, mag, out_re, out_im,
      rb_re, rb_im, M, F, bins, n_fft, hop, c);
  return (int)cudaGetLastError();
}
