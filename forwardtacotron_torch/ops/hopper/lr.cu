// Length regulator: token features -> frames, [B, N, C] -> [B, T, C], in
// float32 or bfloat16.
//
// Replaces forwardtacotron_tpu/ops/pallas/length_regulator.py::
// length_regulator_pallas (_pallas_impl, kernel body _lr_kernel). The TPU
// kernel builds a one-hot [T_TILE, N] selection tile per item and contracts
// it with the tokens on the MXU; with f32 accumulation of a single nonzero
// term that is an exact copy, so on the GPU it is a gather: row (b, t)
// copies the token whose span [start, end) holds frame t, and is zero at or
// past the item's expanded length.
//
// Bound on an H100: bytes (read the tokens once, write [B, T, C] once; no
// arithmetic). Design: one warp per output row; the lanes find the token by
// a binary search over the item's span ends and copy the row in 16-byte
// words, neighbouring lanes on neighbouring addresses. The copy is
// byte-generic, so float32 and bfloat16 rows take the same kernel; every
// width the model uses is a multiple of 16 bytes, and the wrapper refuses
// any other.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_CTA = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
lr_kernel(const uint4* __restrict__ x,   // [B, N, row_vecs]
          const int* __restrict__ ends,  // [B, N] inclusive cumsum of durations
          uint4* __restrict__ out,       // [B, T, row_vecs]
          int B, int N, int T, int row_vecs) {
  const long row = (long)blockIdx.x * ROWS_PER_CTA + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long)B * T) return;
  const int b = (int)(row / T);
  const int t = (int)(row % T);
  const int* e = ends + (long)b * N;
  int n = -1;
  if (t < e[N - 1]) {  // first token whose span ends after t
    int lo = 0, hi = N - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (e[mid] > t) hi = mid; else lo = mid + 1;
    }
    n = lo;
  }
  uint4* dst = out + row * row_vecs;
  if (n < 0) {
    const uint4 zero{};
    for (int i = lane; i < row_vecs; i += 32) dst[i] = zero;
  } else {
    const uint4* src = x + ((long)b * N + n) * row_vecs;
    for (int i = lane; i < row_vecs; i += 32) dst[i] = src[i];
  }
}

}  // namespace

// row_bytes is a multiple of 16 and both pointers are 16-byte aligned;
// N >= 1. Returns a cudaError_t.
extern "C" int lr_expand(const void* x, const int* ends, void* out, int B, int N, int T,
                         int row_bytes, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (N < 1 || row_bytes % 16) return (int)cudaErrorInvalidValue;
  const long grid = ((long)B * T + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  lr_kernel<<<(unsigned)grid, THREADS, 0, stream>>>((const uint4*)x, ends, (uint4*)out, B, N,
                                                   T, row_bytes / 16);
  return (int)cudaGetLastError();
}
