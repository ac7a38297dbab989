// Residual add + pre_highway Dense (no bias) + the CBHG highway stack, f32.
//
// Replaces forwardtacotron_tpu/ops/pallas/highway.py::pre_highway_stack_pallas
// (kernel body _pre_highway_kernel). Per row:
//   x = (a + res) @ pre_w
//   for each layer: [h | g] = x @ [W1 | W2] + [b1 | b2]
//                   x = x + sigmoid(g) * (relu(h) - x)
//
// Bound on an H100: f32 FMAs. Each layer is a [rows, C] x [C, 2C] product
// (8.4 MFLOP per 16 rows at C=256) against 2 MB of weights, so the work is
// operations, not bytes. Design: one CTA per tile of ROWS rows; the tile's
// activation stays in shared memory across the pre-projection and every
// layer (it never returns to device memory between layers, as in the TPU
// kernel), two buffers ping-pong between layers. Thread j owns output
// column j (both its h and g halves, so the blend is thread-local) for all
// ROWS rows: each weight element it loads from L2 feeds ROWS FMAs, and each
// float4 of activations is a shared-memory broadcast to the whole warp.
// A simple FMA design; wgmma/TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
pre_highway_stack_kernel(const float* __restrict__ a,
                         const float* __restrict__ res,
                         const float* __restrict__ pre_w,  // [c_in, c]
                         const float* __restrict__ w,      // [L, c, 2c]
                         const float* __restrict__ b,      // [L, 2c]
                         float* __restrict__ out,          // [n, c]
                         int n, int c_in, int c, int n_layers) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int width = c_in > c ? c_in : c;
  float* src = smem;                   // [ROWS][width]
  float* dst = smem + ROWS * width;    // [ROWS][width]
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;

  // input stage: a + res (rows past n are zero and never stored)
  for (int i = tid; i < ROWS * c_in; i += THREADS) {
    const int r = i / c_in, k = i - r * c_in;
    const long g = (long)(row0 + r) * c_in + k;
    src[r * width + k] = (row0 + r < n) ? a[g] + res[g] : 0.f;
  }
  __syncthreads();

  // pre_highway projection: dst = src @ pre_w
  for (int j = tid; j < c; j += THREADS) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int k = 0; k < c_in; k += 4) {
      const float w0 = pre_w[(long)(k + 0) * c + j];
      const float w1 = pre_w[(long)(k + 1) * c + j];
      const float w2 = pre_w[(long)(k + 2) * c + j];
      const float w3 = pre_w[(long)(k + 3) * c + j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(&src[r * width + k]);
        acc[r] = fmaf(x.x, w0, acc[r]);
        acc[r] = fmaf(x.y, w1, acc[r]);
        acc[r] = fmaf(x.z, w2, acc[r]);
        acc[r] = fmaf(x.w, w3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) dst[r * width + j] = acc[r];
  }
  __syncthreads();
  { float* t = src; src = dst; dst = t; }

  const int c2 = 2 * c;
  for (int l = 0; l < n_layers; ++l) {
    const float* wl = w + (long)l * c * c2;
    const float* bl = b + (long)l * c2;
    for (int j = tid; j < c; j += THREADS) {
      float h[ROWS], g[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) { h[r] = 0.f; g[r] = 0.f; }
      for (int k = 0; k < c; k += 4) {
        const float* wk = wl + (long)k * c2 + j;
        const float h0 = wk[0], h1 = wk[c2], h2 = wk[2 * c2], h3 = wk[3 * c2];
        const float g0 = wk[c], g1 = wk[c2 + c], g2 = wk[2 * c2 + c],
                    g3 = wk[3 * c2 + c];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float4 x = *reinterpret_cast<const float4*>(&src[r * width + k]);
          h[r] = fmaf(x.x, h0, h[r]);
          h[r] = fmaf(x.y, h1, h[r]);
          h[r] = fmaf(x.z, h2, h[r]);
          h[r] = fmaf(x.w, h3, h[r]);
          g[r] = fmaf(x.x, g0, g[r]);
          g[r] = fmaf(x.y, g1, g[r]);
          g[r] = fmaf(x.z, g2, g[r]);
          g[r] = fmaf(x.w, g3, g[r]);
        }
      }
      const float bh = bl[j], bg = bl[c + j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float hv = fmaxf(h[r] + bh, 0.f);
        const float gv = 1.f / (1.f + expf(-(g[r] + bg)));
        const float xv = src[r * width + j];
        dst[r * width + j] = xv + gv * (hv - xv);
      }
    }
    __syncthreads();
    float* t = src; src = dst; dst = t;
  }

  for (int i = tid; i < ROWS * c; i += THREADS) {
    const int r = i / c, j = i - r * c;
    if (row0 + r < n) out[(long)(row0 + r) * c + j] = src[r * width + j];
  }
}

}  // namespace

extern "C" int pre_highway_stack_f32(const float* a, const float* res,
                                     const float* pre_w, const float* w,
                                     const float* b, float* out, int n,
                                     int c_in, int c, int n_layers,
                                     int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int width = c_in > c ? c_in : c;
  const size_t smem = 2 * ROWS * width * sizeof(float);
  err = cudaFuncSetAttribute(pre_highway_stack_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + ROWS - 1) / ROWS;
  pre_highway_stack_kernel<<<grid, THREADS, smem, stream>>>(
      a, res, pre_w, w, b, out, n, c_in, c, n_layers);
  return (int)cudaGetLastError();
}
