// The whole CBHG front in one kernel, f32:
//   for k = 1..K: conv_k -> ReLU -> folded BN -> maxpool(2, 1) with a -inf
//                 left pad -> x mask -> 3-tap partial proj1 product
//   then ReLU + folded BN of conv_project1.
//
// Replaces forwardtacotron_tpu/ops/pallas/cbhg.py::bank_pool_proj_pallas
// (kernel body _bank_pool_proj_kernel). As there, the [B, T, K*C] bank
// concatenation never exists: branches stream one at a time through shared
// memory and each feeds its slice of the projection.
//
// Bound on an H100: f32 FMAs (at the postnet, K=8, C_in=80, C=P=256, the
// bank is 1.5 MFLOP and the projection 3.1 MFLOP per frame, against 9.2 MB
// of weights read from L2). Design: one CTA per (item, tile of TT frames).
// The tile needs bank outputs at frames t0-2 .. t0+TT (the projection's
// +-1 taps over the pool's one-frame look-back), which need inputs at
// t0-2-K/2 .. t0+TT+K-1-K/2; that input halo sits in shared memory with
// zeros outside [0, T). Thread c computes bank column c for all TT+3
// frames in registers, applies ReLU/BN and the pool there, and writes the
// masked pooled column to shared memory (zero outside [0, T), the
// projection's padding). Thread p then accumulates output column p for the
// tile's TT frames in registers across all branches. The halo costs
// (TT+3)/TT of the bank work. Any T works: there is no whole-sequence block
// as on the TPU.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TT = 32;              // output frames per CTA
constexpr int BANK_ROWS = TT + 3;   // bank rows per tile: frames t0-2 .. t0+TT
constexpr int POOL_ROWS = TT + 2;   // pooled rows per tile: t0-1 .. t0+TT
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
cbhg_front_kernel(const float* __restrict__ x,          // [B, T, c_in]
                  const float* __restrict__ mask,       // [B, T]
                  const float* __restrict__ bank_w,     // branches' [k*c_in, c]
                  const float* __restrict__ bn_scale,   // [K, c]
                  const float* __restrict__ bn_bias,    // [K, c]
                  const float* __restrict__ proj_w,     // [3, K*c, p]
                  const float* __restrict__ proj_scale, // [p]
                  const float* __restrict__ proj_bias,  // [p]
                  float* __restrict__ out,              // [B, T, p]
                  int T, int c_in, int c, int p, int K) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);     // [BANK_ROWS+K-1][c_in]
  const int left = K / 2;
  const int xr = BANK_ROWS + K - 1;
  float* ps = xs + xr * c_in;                            // [POOL_ROWS][c]
  const int item = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x;
  const float* xb = x + (long)item * T * c_in;
  const float* mb = mask + (long)item * T;

  // input halo: xs row r holds frame t0 - 2 - left + r
  for (int i = tid; i < xr * c_in; i += THREADS) {
    const int r = i / c_in, ci = i - r * c_in;
    const int f = t0 - 2 - left + r;
    xs[i] = (f >= 0 && f < T) ? xb[(long)f * c_in + ci] : 0.f;
  }

  float acc[TT];
#pragma unroll
  for (int t = 0; t < TT; ++t) acc[t] = 0.f;
  const long kc = (long)K * c;
  long woff = 0;                                         // branch k's weights

  for (int k = 1; k <= K; ++k) {
    __syncthreads();   // xs ready (k = 1); previous branch's ps consumed
    const float* wk = bank_w + woff;
    const int shift = left - k / 2;
    for (int col = tid; col < c; col += THREADS) {
      float y[BANK_ROWS];
#pragma unroll
      for (int r = 0; r < BANK_ROWS; ++r) y[r] = 0.f;
      for (int j = 0; j < k; ++j) {
        const float* xj = xs + (j + shift) * c_in;
        const float* wj = wk + (long)j * c_in * c + col;
        for (int ci = 0; ci < c_in; ci += 4) {
          const float w0 = wj[(long)(ci + 0) * c];
          const float w1 = wj[(long)(ci + 1) * c];
          const float w2 = wj[(long)(ci + 2) * c];
          const float w3 = wj[(long)(ci + 3) * c];
#pragma unroll
          for (int r = 0; r < BANK_ROWS; ++r) {
            const float4 v = *reinterpret_cast<const float4*>(&xj[r * c_in + ci]);
            y[r] = fmaf(v.x, w0, y[r]);
            y[r] = fmaf(v.y, w1, y[r]);
            y[r] = fmaf(v.z, w2, y[r]);
            y[r] = fmaf(v.w, w3, y[r]);
          }
        }
      }
      // ReLU then the folded eval BN (reference order)
      const float s = bn_scale[(long)(k - 1) * c + col];
      const float bb = bn_bias[(long)(k - 1) * c + col];
#pragma unroll
      for (int r = 0; r < BANK_ROWS; ++r) y[r] = fmaxf(y[r], 0.f) * s + bb;
      // pooled frame u = t0 - 1 + r takes bank rows r (frame u-1) and r+1
#pragma unroll
      for (int r = 0; r < POOL_ROWS; ++r) {
        const int u = t0 - 1 + r;
        float v = 0.f;
        if (u >= 0 && u < T) {
          const float prev = (u == 0) ? -INFINITY : y[r];
          v = fmaxf(prev, y[r + 1]) * mb[u];
        }
        ps[r * c + col] = v;
      }
    }
    __syncthreads();
    // partial proj1: acc[t] += sum_d pooled[t0 + t - 1 + d] . proj_w[d, branch]
    if (tid < p) {
      const float* pw = proj_w + (long)(k - 1) * c * p + tid;
      for (int d = 0; d < 3; ++d) {
        const float* pwd = pw + d * kc * p;
        for (int ci = 0; ci < c; ci += 4) {
          const float w0 = pwd[(long)(ci + 0) * p];
          const float w1 = pwd[(long)(ci + 1) * p];
          const float w2 = pwd[(long)(ci + 2) * p];
          const float w3 = pwd[(long)(ci + 3) * p];
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            const float4 v = *reinterpret_cast<const float4*>(&ps[(t + d) * c + ci]);
            acc[t] = fmaf(v.x, w0, acc[t]);
            acc[t] = fmaf(v.y, w1, acc[t]);
            acc[t] = fmaf(v.z, w2, acc[t]);
            acc[t] = fmaf(v.w, w3, acc[t]);
          }
        }
      }
    }
    woff += (long)k * c_in * c;
  }

  if (tid < p) {
    const float s = proj_scale[tid], bb = proj_bias[tid];
    float* ob = out + (long)item * T * p;
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      if (t0 + t < T) ob[(long)(t0 + t) * p + tid] = fmaxf(acc[t], 0.f) * s + bb;
    }
  }
}

}  // namespace

extern "C" int cbhg_front_f32(const float* x, const float* mask,
                              const float* bank_w, const float* bn_scale,
                              const float* bn_bias, const float* proj_w,
                              const float* proj_scale, const float* proj_bias,
                              float* out, int B, int T, int c_in, int c, int p,
                              int K, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (p > THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)(BANK_ROWS + K - 1) * c_in + (size_t)POOL_ROWS * c)
      * sizeof(float);
  err = cudaFuncSetAttribute(cbhg_front_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + TT - 1) / TT, B);
  cbhg_front_kernel<<<grid, THREADS, smem, stream>>>(
      x, mask, bank_w, bn_scale, bn_bias, proj_w, proj_scale, proj_bias, out,
      T, c_in, c, p, K);
  return (int)cudaGetLastError();
}
