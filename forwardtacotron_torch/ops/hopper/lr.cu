// Length regulator: token features -> frames, [B, N, C] -> [B, T, C], in
// float32 or bfloat16.
//
// Replaces forwardtacotron_tpu/ops/pallas/length_regulator.py::
// length_regulator_pallas (_pallas_impl, kernel body _lr_kernel). The TPU
// kernel builds a one-hot [T_TILE, N] selection tile per item and contracts
// it with the tokens on the MXU; with f32 accumulation of a single nonzero
// term that is an exact copy, so on the GPU it is a copy: frame t of item b
// is the row of the token whose span [ends[n-1], ends[n]) holds t, that is
// token #{n : ends[n] <= t}, and is zero at or past the item's expanded
// length ends[b, N-1].
//
// Bound on an H100: bytes (read the tokens once, write [B, T, C] once; no
// arithmetic). Design: one CTA per (item, tile of `tile` frames; lr.py
// ``plan`` picks the tile so that the grid fills the SMs several times).
// The tile's output rows are one contiguous block of tile * C values.
//   1. Warp 0 finds the tile's first token n0 = #{n : ends[n] <= t0} with a
//      32-way ballot search over the item's ends: each probe reads 32 ends,
//      one a lane, and narrows the range 32-fold (two probes at N = 160).
//   2. It walks the ends from n0 on, 32 a ballot, until they pass the tile:
//      a token that ends at frame t0 + f adds one to cnt[f], and the prefix
//      sum n0 + cnt[0] + ... + cnt[f] is the token of frame t0 + f (frames
//      are monotone in tokens, so no frame is searched for).
//   3. All threads copy the tile as one stream of 16-byte words: word i of
//      the block is word i % W of the row of token tok[i / W] (W words a
//      row), UNROLL loads in flight a thread, read through the non-coherent
//      cache (a token's row repeats over its frames: L1 / L2 serve the
//      repeats); then the frames at or past the item's end are zeros. The
//      stores are streaming (st.global.cs, evict-first): the output is
//      written once and is larger than the tokens that repeat, and on an
//      H100 (700 W) they took the train shape from 0.0301 to 0.0259 ms in
//      f32 and from 0.0130 to 0.0115 ms in bf16 (chip_smoke.py's lr lines;
//      8 loads in flight a thread instead of 4 gave nothing).
// A tile wholly past the item's end reads one int (ends[N-1]) and stores
// zeros. The copy is byte-generic, so float32 and bfloat16 rows take the
// same kernel; every width the model uses is a multiple of 16 bytes, and the
// wrapper refuses any other.

#include <cuda_runtime.h>
#include <limits.h>

#include "device_guard.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_TILE = 256;   // frames of a tile (lr.py MAX_TILE)
constexpr int UNROLL = 4;       // 16-byte loads in flight a thread
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
lr_tile_kernel(const uint4* __restrict__ x,   // [B, N, row_vecs]
               const int* __restrict__ ends,  // [B, N] inclusive cumsum
               uint4* __restrict__ out,       // [B, T, row_vecs]
               int N, int T, int row_vecs, int tile, int tiles) {
  __shared__ int tok[MAX_TILE];   // cnt[f], then the token of frame t0 + f
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * tile;
  const int tid = threadIdx.x;
  const int* e = ends + (size_t)b * N;
  const int t_end = min(t0 + tile, T);
  // frames [t0, t_hi) copy a token, [t_hi, t_end) are zero
  const int t_hi = max(t0, min(t_end, __ldg(e + N - 1)));
  uint4* dst = out + ((size_t)b * T + t0) * row_vecs;
  if (t_hi > t0) {   // the same for every thread of the CTA
    if (tid < 32) {
      const int lane = tid;
      // 1. n0 in [lo, hi]: ends[lo - 1] <= t0 < ends[hi] (ends[N] = inf)
      int lo = 0, hi = N;
      while (lo < hi) {
        const int step = (hi - lo + 31) / 32, base = lo;
        const int p = base + lane * step;
        // ends are non-decreasing: the probes at or below t0 are a prefix
        const int k = __popc(__ballot_sync(FULL, p < hi && __ldg(e + p) <= t0));
        hi = k ? min(hi, base + k * step) : base;
        lo = k ? min(hi, base + (k - 1) * step + 1) : base;
      }
      const int n0 = lo;
      // 2. cnt[f] = #{n >= n0 : ends[n] = t0 + f}, f < t_hi - t0
      for (int f = lane; f < tile; f += 32) tok[f] = 0;
      __syncwarp();
      for (int base = n0; base < N; base += 32) {
        const int n = base + lane;
        const int en = n < N ? __ldg(e + n) : INT_MAX;
        if (en > t0 && en < t_hi) atomicAdd(&tok[en - t0], 1);
        if (__shfl_sync(FULL, en, 31) >= t_hi) break;   // past the tile
      }
      __syncwarp();
      // the prefix sum: lane l owns `per` consecutive frames
      const int per = (tile + 31) / 32, f0 = lane * per;
      int own = 0;
      for (int j = 0; j < per; ++j)
        if (f0 + j < tile) own += tok[f0 + j];
      int incl = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      int acc = n0 + incl - own;
      for (int j = 0; j < per; ++j)
        if (f0 + j < tile) {
          acc += tok[f0 + j];
          tok[f0 + j] = min(acc, N - 1);
        }
    }
    __syncthreads();
    // 3. the copy, word i of the tile's block from row tok[i / row_vecs]
    const uint4* xb = x + (size_t)b * N * row_vecs;
    const int n_words = (t_hi - t0) * row_vecs;
    for (int i0 = tid; i0 < n_words; i0 += THREADS * UNROLL) {
      uint4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i < n_words) {
          const int f = i / row_vecs;
          v[u] = __ldg(xb + (size_t)tok[f] * row_vecs + (i - f * row_vecs));
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i < n_words) __stcs(dst + i, v[u]);
      }
    }
  }
  const uint4 zero{};
  for (int i = (t_hi - t0) * row_vecs + tid; i < (t_end - t0) * row_vecs;
       i += THREADS)
    __stcs(dst + i, zero);
}

}  // namespace

// x [B, N, row_bytes / 16] and out [B, T, row_bytes / 16] in 16-byte words,
// both 16-byte aligned; ends [B, N] non-decreasing; N >= 1, B, T >= 1, and
// 1 <= tile <= MAX_TILE. Returns a cudaError_t.
extern "C" int lr_expand(const void* x, const int* ends, void* out, int B,
                         int N, int T, int row_bytes, int tile, int device,
                         cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || N < 1 || T < 1 || row_bytes < 16 || row_bytes % 16 ||
      tile < 1 || tile > MAX_TILE)
    return (int)cudaErrorInvalidValue;
  const int row_vecs = row_bytes / 16;
  const int tiles = (T + tile - 1) / tile;
  if ((long)B * tiles > INT_MAX || (long)tile * row_vecs > INT_MAX)
    return (int)cudaErrorInvalidValue;
  lr_tile_kernel<<<(unsigned)(B * tiles), THREADS, 0, stream>>>(
      (const uint4*)x, ends, (uint4*)out, N, T, row_vecs, tile, tiles);
  return (int)cudaGetLastError();
}
