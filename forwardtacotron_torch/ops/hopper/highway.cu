// The CBHG highway stack, in f32 or bf16, alone or behind the residual add
// and the pre_highway Dense (no bias).
//
// pre_highway_stack_* replaces
// forwardtacotron_tpu/ops/pallas/highway.py::pre_highway_stack_pallas
// (kernel body _pre_highway_kernel). Per row:
//   x = (a + res) @ pre_w
//   for each layer: [h | g] = x @ [W1 | W2] + [b1 | b2]
//                   x = x + sigmoid(g) * (relu(h) - x)
// highway_stack_* replaces highway.py::highway_stack_pallas (kernel body
// _highway_kernel): the same layers on rows x, with no input stage. Both are
// one template; PRE selects the residual add and the pre-projection.
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
// The row tile follows the width: two f32 tiles of ROWS x max(C_in, C) must
// fit a block's 232,448 bytes of shared memory, so ROWS is 32 up to 908
// channels and halves, down to 1 row (29,056 channels), as the width grows.
// A simple FMA design; wgmma/TMA are later work.
//
// bf16 entry: inputs, weights and output are bf16, the bias f32, and the
// shared-memory activations hold f32 values rounded to bf16 where the TPU
// kernels round: a + res, the pre-projection's output and each layer's
// output (_pre_highway_kernel and _highway_kernel cast x to the input dtype
// at those points); products accumulate in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
// the value a store into T would keep
__device__ __forceinline__ float rnd_as(float v, const float*) { return v; }
__device__ __forceinline__ float rnd_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return rnd_as(v, static_cast<const T*>(nullptr));
}

constexpr int THREADS = 256;
constexpr int SMEM_BYTES = 232448;

template <typename T, int ROWS, bool PRE>
__global__ void __launch_bounds__(THREADS)
highway_kernel(const T* __restrict__ a,        // [n, c_in]
               const T* __restrict__ res,      // [n, c_in] (PRE)
               const T* __restrict__ pre_w,    // [c_in, c] (PRE)
               const T* __restrict__ w,        // [L, c, 2c]
               const float* __restrict__ b,    // [L, 2c]
               T* __restrict__ out,            // [n, c]
               int n, int c_in, int c, int n_layers) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int width = c_in > c ? c_in : c;
  float* src = smem;                   // [ROWS][width]
  float* dst = smem + ROWS * width;    // [ROWS][width]
  const int row0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;

  // input stage: a + res, or (no PRE) the rows a themselves; rows past n
  // are zero and never stored
  for (int i = tid; i < ROWS * c_in; i += THREADS) {
    const int r = i / c_in, k = i - r * c_in;
    const long g = (long)(row0 + r) * c_in + k;
    float v = 0.f;
    if (row0 + r < n) v = PRE ? rnd<T>(ld(a + g) + ld(res + g)) : ld(a + g);
    src[r * width + k] = v;
  }
  __syncthreads();

  // pre_highway projection: dst = src @ pre_w
  if constexpr (PRE) {
    for (int j = tid; j < c; j += THREADS) {
      float acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
      for (int k = 0; k < c_in; k += 4) {
        const float w0 = ld(pre_w + (long)(k + 0) * c + j);
        const float w1 = ld(pre_w + (long)(k + 1) * c + j);
        const float w2 = ld(pre_w + (long)(k + 2) * c + j);
        const float w3 = ld(pre_w + (long)(k + 3) * c + j);
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
      for (int r = 0; r < ROWS; ++r) dst[r * width + j] = rnd<T>(acc[r]);
    }
    __syncthreads();
    { float* t = src; src = dst; dst = t; }
  }

  const int c2 = 2 * c;
  for (int l = 0; l < n_layers; ++l) {
    const T* wl = w + (long)l * c * c2;
    const float* bl = b + (long)l * c2;
    for (int j = tid; j < c; j += THREADS) {
      float h[ROWS], g[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) { h[r] = 0.f; g[r] = 0.f; }
      for (int k = 0; k < c; k += 4) {
        const T* wk = wl + (long)k * c2 + j;
        const float h0 = ld(wk), h1 = ld(wk + c2), h2 = ld(wk + 2 * c2),
                    h3 = ld(wk + 3 * c2);
        const float g0 = ld(wk + c), g1 = ld(wk + c2 + c),
                    g2 = ld(wk + 2 * c2 + c), g3 = ld(wk + 3 * c2 + c);
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
        dst[r * width + j] = rnd<T>(xv + gv * (hv - xv));
      }
    }
    __syncthreads();
    float* t = src; src = dst; dst = t;
  }

  for (int i = tid; i < ROWS * c; i += THREADS) {
    const int r = i / c, j = i - r * c;
    if (row0 + r < n) st(out + (long)(row0 + r) * c + j, src[r * width + j]);
  }
}

// rows per tile for rows of `width` channels: the largest of 32, 16, .., 1
// whose two f32 tiles fit shared memory, or 0 where even one row does not
inline int tile_rows(int width) {
  for (int r = 32; r >= 1; r /= 2)
    if ((size_t)2 * r * width * sizeof(float) <= SMEM_BYTES) return r;
  return 0;
}

template <typename T, int ROWS, bool PRE>
int launch_rows(const T* a, const T* res, const T* pre_w, const T* w,
                const float* b, T* out, int n, int c_in, int c, int n_layers,
                cudaStream_t stream) {
  const int width = c_in > c ? c_in : c;
  const size_t smem = 2 * ROWS * width * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      highway_kernel<T, ROWS, PRE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + ROWS - 1) / ROWS;
  highway_kernel<T, ROWS, PRE><<<grid, THREADS, smem, stream>>>(
      a, res, pre_w, w, b, out, n, c_in, c, n_layers);
  return (int)cudaGetLastError();
}

template <typename T, bool PRE>
int launch(const T* a, const T* res, const T* pre_w, const T* w, const float* b,
           T* out, int n, int c_in, int c, int n_layers, int device,
           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (tile_rows(c_in > c ? c_in : c)) {
#define HIGHWAY_ROWS(R)                                                  \
    case R:                                                              \
      return launch_rows<T, R, PRE>(a, res, pre_w, w, b, out, n, c_in, c, \
                                    n_layers, stream);
    HIGHWAY_ROWS(32)
    HIGHWAY_ROWS(16)
    HIGHWAY_ROWS(8)
    HIGHWAY_ROWS(4)
    HIGHWAY_ROWS(2)
    HIGHWAY_ROWS(1)
#undef HIGHWAY_ROWS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

typedef __nv_bfloat16 bf;

extern "C" int pre_highway_stack_f32(const float* a, const float* res,
                                     const float* pre_w, const float* w,
                                     const float* b, float* out, int n,
                                     int c_in, int c, int n_layers,
                                     int device, cudaStream_t stream) {
  return launch<float, true>(a, res, pre_w, w, b, out, n, c_in, c, n_layers,
                             device, stream);
}

extern "C" int pre_highway_stack_bf16(const void* a, const void* res,
                                      const void* pre_w, const void* w,
                                      const float* b, void* out, int n,
                                      int c_in, int c, int n_layers,
                                      int device, cudaStream_t stream) {
  return launch<bf, true>((const bf*)a, (const bf*)res, (const bf*)pre_w,
                          (const bf*)w, b, (bf*)out, n, c_in, c, n_layers,
                          device, stream);
}

extern "C" int highway_stack_f32(const float* x, const float* w,
                                 const float* b, float* out, int n, int c,
                                 int n_layers, int device,
                                 cudaStream_t stream) {
  return launch<float, false>(x, nullptr, nullptr, w, b, out, n, c, c,
                              n_layers, device, stream);
}

extern "C" int highway_stack_bf16(const void* x, const void* w,
                                  const float* b, void* out, int n, int c,
                                  int n_layers, int device,
                                  cudaStream_t stream) {
  return launch<bf, false>((const bf*)x, nullptr, nullptr, (const bf*)w, b,
                           (bf*)out, n, c, c, n_layers, device, stream);
}
