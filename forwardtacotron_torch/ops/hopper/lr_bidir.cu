// Bidirectional length regulator: token features -> frames in the recurrent
// kernels' [T, 2, B, C] layout, direction 0 in frame order and direction 1
// in each item's length-flipped order.
//
// Replaces forwardtacotron_tpu/ops/pallas/length_regulator.py::
// length_regulator_bidir_pallas (kernel body _lr_bidir_kernel). The TPU
// kernel builds one-hot selection tiles and contracts them with the tokens
// on the MXU; with f32 accumulation of one nonzero term that is an exact
// copy, so on the GPU it is a gather: row (t, d, b) copies the token whose
// span [start, end) holds frame f, f = t for d = 0 and
// f = min(len - 1 - t, T - 1) for d = 1 (len = the item's expanded length,
// T = the output's frame count), and is zero when no span holds f.
//
// Bound on an H100: bytes (read x once, write [T, 2, B, C] once; no
// arithmetic). Design: one warp per output row; the lanes find the token by
// a binary search over the item's span ends and copy the row with 16-byte
// loads and stores, neighbouring lanes on neighbouring addresses. The copy
// is byte-generic, so bf16 and f32 rows take the same kernel.

#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_CTA = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
lr_bidir_kernel(const uint4* __restrict__ x,   // [B, N, row_vecs]
                const int* __restrict__ ends,  // [B, N] inclusive cumsum of durations
                uint4* __restrict__ out,       // [T, 2, B, row_vecs]
                int B, int N, int T, int row_vecs) {
  const long row = (long)blockIdx.x * ROWS_PER_CTA + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long)T * 2 * B) return;
  const int b = (int)(row % B);
  const int d = (int)((row / B) % 2);
  const int t = (int)(row / (2L * B));
  const int* e = ends + (long)b * N;
  const int len = N > 0 ? e[N - 1] : 0;
  int f = d == 0 ? t : min(len - 1 - t, T - 1);
  int n = -1;
  if (f >= 0 && f < len) {  // first token whose span ends after f
    int lo = 0, hi = N - 1;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (e[mid] > f) hi = mid; else lo = mid + 1;
    }
    n = lo;
  }
  uint4* dst = out + row * row_vecs;
  if (n < 0) {
    for (int i = lane; i < row_vecs; i += 32) dst[i] = make_uint4(0, 0, 0, 0);
  } else {
    const uint4* src = x + ((long)b * N + n) * row_vecs;
    for (int i = lane; i < row_vecs; i += 32) dst[i] = src[i];
  }
}

}  // namespace

// row_bytes = C * element size, a multiple of 16. Returns a cudaError_t.
extern "C" int lr_bidir(const void* x, const int* ends, void* out, int B, int N, int T,
                        int row_bytes, int device, cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (row_bytes % 16) return (int)cudaErrorInvalidValue;
  const long rows = (long)T * 2 * B;
  const long grid = (rows + ROWS_PER_CTA - 1) / ROWS_PER_CTA;
  lr_bidir_kernel<<<(unsigned)grid, THREADS, 0, stream>>>(
      (const uint4*)x, ends, (uint4*)out, B, N, T, row_bytes / 16);
  return (int)cudaGetLastError();
}
