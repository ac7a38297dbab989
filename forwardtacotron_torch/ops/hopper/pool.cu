// The CBHG's max pool + tail mask, alone (pool_mask_*) or with the first
// projection convolution behind it (pool_proj1_*), on the bank
// concatenation x [B, T, KC], in f32 or bf16.
//
// pool_mask_* replaces forwardtacotron_tpu/ops/pallas/cbhg.py::
// pool_mask_pallas (kernel body _pool_mask_kernel):
//   out[t] = max(x[t-1], x[t]) * mask[t],  out[0] = x[0] * mask[0]
// (MaxPool1d(2, 1, pad 1)[:T] with its -inf left pad, then the tail mask);
// the mask is rounded to x's type and multiplied, not selected, in x's type.
// Bound on an H100: bytes (x read once, out written once; 2 x 4.3 GB at the
// postnet's serving shape, 2.56 ms at 3.35 TB/s). Design: a thread owns one
// 16-byte vector of channels (8 bf16 or 4 f32) over POOL_FRAMES consecutive
// frames and carries x[t-1] in registers, so each row is read once;
// neighbouring threads hold neighbouring vectors of a row. Where KC is not a
// multiple of the vector width the rows lose their 16-byte alignment and
// every access is scalar (VEC = 1).
//
// pool_proj1_* replaces cbhg.py::pool_proj1_pallas (kernel body
// _pool_proj_kernel):
//   pooled[t] = round(max(x[t-1], x[t]) * mask[t])   (f32 product, rounded
//                                                    to x's type; 0 outside
//                                                    [0, T))
//   out[t]    = round(sum_d pooled[t + d - 1] @ w[d])   (d = 0, 1, 2; f32 sum)
// the pre-ReLU/BN output of conv_project1 (k = 3, no bias, zero boundary).
// Bound on an H100: operations (2 * 3 * KC * P FLOPs per frame: 3.3 TFLOP at
// the postnet's serving shape against 4.3 GB of input, 3.3 ms at the bf16
// peak; the prenet's 2.1 TFLOP, 2.1 ms).
//
// bf16 (pool_proj1_mma_kernel<N>): an implicit GEMM, M = frames, N = output
// channels, K = 3 taps x KC, on wgmma m64nNk16 with A and B from shared
// memory and f32 sums in registers.
//   - Frames are tiled over the flattened axis of all items, with one zero
//     gap frame after each item: virtual frame v = b (T + 1) + t, t = T the
//     gap. A CTA owns 128 consecutive virtual frames (two consumer
//     warpgroups of 64), so a short sequence (the prenet's 81 tokens) does
//     not leave most of a per-item tile idle, and a tap or pool neighbour
//     that would cross into another item reads the gap's zeros: the gap is
//     the zero boundary of both neighbours.
//   - One CTA computes all N <= 256 output channels of its frames, so each
//     x element is read and pooled once (P > 256: ceil(P / 256) column
//     blocks of equal width, a CTA each, x pooled once per block).
//   - A producer warp loads, per K chunk of KCH = 32 channels, the raw x
//     rows the tile needs (the real frames of virtual frames v0-2 ..
//     v0+128, at most 131 rows; rows past the last frame read zero) by TMA
//     into a ring of raw stages, and the chunk's three weight taps (packed
//     by the wrapper as their shared-memory image: core matrices, K-major)
//     by one bulk copy into the stage of the main ring. Three pool warps
//     turn each raw stage into 130 pooled rows (v0-1 .. v0+128: max, f32
//     mask product, bf16 round; zero at gaps and outside) in the same
//     stage, so the pool runs on other warps while the consumers multiply
//     the chunk before.
//     Each pooled row's source (its x row, whether it has a left
//     neighbour, its mask value) is the same in every chunk: a table made
//     once per CTA, so a chunk's pool is two 16-byte shared loads, a max
//     and a product per 8 channels.
//   - The pooled rows are planar: four 8-channel planes of 16-byte rows, so
//     any 8 consecutive rows of a plane are one core matrix and the three
//     taps are three A descriptors on the same rows, shifted by one row
//     (16 bytes) each, as in mrf.cu's windows; nothing is copied per tap.
//   - Stages go back to the producer and the pool warps through empty
//     mbarriers once the consumers' products of the next chunk are issued.
//   - Why chunks of 32 channels, not 64: at N = 256 (both CBHGs' P) a
//     main stage is the pooled rows (KCH / 8 planes of 130 x 16 B: 8,320 B
//     at KCH = 32, 16,640 B at 64) plus three weight taps of 256 x KCH
//     bf16 (49,152 B at 32, 98,304 B at 64). Beside the barriers and the
//     row table (1,408 B) and a raw x ring of 4 stages of 131 rows (33,792
//     B at 32, 67,072 B at 64), KCH = 32 fits three main stages (207,616 B
//     of 232,448); KCH = 64 fits two main stages only with no x ring at
//     all (231,296 B), and the pool could then not run ahead of the
//     products. Splitting N = 256 across two CTAs to make room would pool
//     every x element twice, which this design exists to avoid.
//   Weight traffic (L2 -> SM): 3 x N x 32 x 2 B per chunk for 128 frames,
//   about 25 GB per postnet call (3 MB per tile), one bulk copy per stage
//   and CTA. Sharing each stage across a cluster of neighbouring tiles by
//   multicast measured slower on the H100 than one copy per CTA (PERF.md,
//   section 6): the L2 stream is not what bounds the kernel. What a chunk
//   costs is measured with copies built with -DPOOL_SKIP_POOL (no pool)
//   and -DPOOL_SKIP_W (no weight copies): chip_smoke.py --kernel-parts
//   (wrong sums, times only).
// f32 (pool_proj1_kernel, FMA; TF32 would miss the f32 gate): one CTA per
// (item, tile of TT = 64 frames, tile of PT = 64 output columns) loops over
// the KC input channels in chunks of KCH = 32: per chunk the pooled, masked
// chunk of frames t0-1 .. t0+TT into shared memory, the chunk's weight taps
// (w packed as [3, P_pad, KC]) through a double-buffered cp.async stage; a
// thread owns 4 output columns x 8 frames, 128 threads. Requests give few
// tiles (one 92-token prenet: 8), so it also splits KC across CTAs and sums
// into the zeroed output with atomicAdd (float32 needs no rounding of the
// sum). That design is kept unchanged: 0.17 ms at a request, one launch.
// KC must be a multiple of 32 (the JAX gate admits multiples of 128); every
// B, T and P launches. The bf16 launch plan (N, column blocks, ring stages,
// the carve) comes from cbhg.py ``pool_proj1_plan``, which needs no card;
// the entry recomputes the carve and refuses a plan that does not fit.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) { *p = __float2bfloat16(v); }

// the value a store into T keeps
__device__ __forceinline__ float rnd_as(float v, const float*) { return v; }
__device__ __forceinline__ float rnd_as(float v, const bf16*) {
  return __bfloat162float(__float2bfloat16(v));
}
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return rnd_as(v, static_cast<const T*>(nullptr));
}

// VEC elements of T from / to p: one 16-byte access, or one scalar (VEC 1)
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (VEC == 1) {
    v[0] = ld(p);
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = ld(e + i);
  }
}
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (VEC == 1) {
    st(p, v[0]);
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int i = 0; i < VEC; ++i) st(e + i, v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// ---------------------------------------------------------------- pool_mask

constexpr int POOL_THREADS = 256;
constexpr int POOL_FRAMES = 16;

template <typename T, int VEC>
__global__ void __launch_bounds__(POOL_THREADS)
pool_mask_kernel(const T* __restrict__ x,         // [B, T, kc]
                 const float* __restrict__ mask,  // [B, T]
                 T* __restrict__ out,             // [B, T, kc]
                 int t_len, int kc, int n_chunks, int n_colblocks) {
  long blk = blockIdx.x;
  const int colblock = (int)(blk % n_colblocks);
  blk /= n_colblocks;
  const int chunk = (int)(blk % n_chunks);
  const long item = blk / n_chunks;
  const int col = (colblock * POOL_THREADS + threadIdx.x) * VEC;
  if (col >= kc) return;
  const int t0 = chunk * POOL_FRAMES;
  const int t1 = min(t_len, t0 + POOL_FRAMES);
  const T* xb = x + item * t_len * kc + col;
  T* ob = out + item * t_len * kc + col;
  const float* mb = mask + item * t_len;
  float prev[VEC], cur[VEC], o[VEC];
  if (t0 > 0) load_vec<T, VEC>(xb + (long)(t0 - 1) * kc, prev);
  for (int t = t0; t < t1; ++t) {
    load_vec<T, VEC>(xb + (long)t * kc, cur);
    const float m = rnd<T>(mb[t]);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      o[i] = rnd<T>((t == 0 ? cur[i] : fmaxf(prev[i], cur[i])) * m);
      prev[i] = cur[i];
    }
    store_vec<T, VEC>(ob + (long)t * kc, o);
  }
}

template <typename T>
int pool_mask_launch(const T* x, const float* mask, T* out, int B, int t_len,
                     int kc, int device, cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  constexpr int V = 16 / sizeof(T);
  const bool vec = kc % V == 0;
  const int n_chunks = (t_len + POOL_FRAMES - 1) / POOL_FRAMES;
  const int cols = vec ? kc / V : kc;
  const int n_colblocks = (cols + POOL_THREADS - 1) / POOL_THREADS;
  const long grid = (long)B * n_chunks * n_colblocks;
  if (grid > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  if (vec) {
    pool_mask_kernel<T, V><<<(unsigned)grid, POOL_THREADS, 0, stream>>>(
        x, mask, out, t_len, kc, n_chunks, n_colblocks);
  } else {
    pool_mask_kernel<T, 1><<<(unsigned)grid, POOL_THREADS, 0, stream>>>(
        x, mask, out, t_len, kc, n_chunks, n_colblocks);
  }
  return (int)cudaGetLastError();
}

// --------------------------------------------------------------- pool_proj1

constexpr int KCH = 32;   // input channels per chunk (both entries)

// ------------------------------------------------------ f32: FMA tiles

constexpr int F32_TT = 64, F32_PT = 64, F32_THREADS = 128, F32_PAD = 4;
constexpr int F32_LD = KCH + F32_PAD;          // row stride, elements
constexpr int F32_ROWS = F32_TT + 2;           // pooled frames
constexpr int F32_STAGE = 3 * F32_PT * F32_LD; // one chunk's weights
constexpr size_t F32_BYTES = (2 * F32_STAGE + F32_ROWS * F32_LD) * sizeof(float);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// chunk `ch`'s weight taps wt[d, p0 .. p0+PT, ch*KCH .. +KCH] into a stage
__device__ __forceinline__ void stage_weights(float* ws, const float* wt,
                                              int p0, int p_pad, int kc,
                                              int ch) {
  constexpr int PIECES = KCH * sizeof(float) / 16;
  for (int i = threadIdx.x; i < 3 * F32_PT * PIECES; i += F32_THREADS) {
    const int q = i % PIECES, row = i / PIECES;   // row = d * PT + m
    const int d = row / F32_PT, m = row - d * F32_PT;
    cp_async16(ws + row * F32_LD + q * 4,
               wt + ((long)d * p_pad + p0 + m) * kc + ch * KCH + q * 4);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// pooled rows of chunk `ch`: row r holds frame t0 - 1 + r, 0 outside [0, T)
__device__ __forceinline__ void pool_chunk(float* ps, const float* xb,
                                           const float* mb, int t0,
                                           int t_len, int kc, int ch) {
  constexpr int VECS = KCH / 4;
  for (int i = threadIdx.x; i < F32_ROWS * VECS; i += F32_THREADS) {
    const int r = i / VECS, q = i - r * VECS;
    const int u = t0 - 1 + r;
    float v[4];
    if (u >= 0 && u < t_len) {
      const float* p = xb + (long)u * kc + ch * KCH + q * 4;
      load_vec<float, 4>(p, v);
      if (u > 0) {
        float prev[4];
        load_vec<float, 4>(p - kc, prev);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = fmaxf(prev[e], v[e]);
      }
      const float m = mb[u];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] *= m;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = 0.f;
    }
    store_vec<float, 4>(ps + r * F32_LD + q * 4, v);
  }
}

// thread u owns output columns co .. co+4 and frames f0 .. f0+8
struct FmaTile {
  float acc[4][8];
  int co, f0;
  __device__ FmaTile() {
    constexpr int GROUPS = F32_PT / 4;
    co = (threadIdx.x % GROUPS) * 4;
    f0 = (threadIdx.x / GROUPS) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][r] = 0.f;
  }
  __device__ __forceinline__ void chunk(const float* ws, const float* ps) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      for (int k = 0; k < KCH; k += 4) {
        float4 wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[i] = *reinterpret_cast<const float4*>(
              ws + (d * F32_PT + co + i) * F32_LD + k);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(
              ps + (f0 + r + d) * F32_LD + k);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][r] = fmaf(wv[i].x, v.x, acc[i][r]);
            acc[i][r] = fmaf(wv[i].y, v.y, acc[i][r]);
            acc[i][r] = fmaf(wv[i].z, v.z, acc[i][r]);
            acc[i][r] = fmaf(wv[i].w, v.w, acc[i][r]);
          }
        }
      }
    }
  }
  __device__ __forceinline__ void store(float* ob, int t0, int p0, int t_len,
                                        int p, bool split) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int col = p0 + co + i, t = t0 + f0 + r;
        if (t < t_len && col < p) {
          float* o = ob + (long)t * p + col;
          if (split) atomicAdd(o, acc[i][r]); else *o = acc[i][r];
        }
      }
  }
};

__global__ void __launch_bounds__(F32_THREADS)
pool_proj1_kernel(const float* __restrict__ x,     // [B, T, kc]
                  const float* __restrict__ mask,  // [B, T]
                  const float* __restrict__ wt,    // [3, p_pad, kc]
                  float* __restrict__ out,         // [B, T, p]
                  int t_len, int kc, int p, int p_pad, int n_ttiles,
                  int n_ptiles, int chunks_per_cta) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);     // [2][3][PT][LD]
  float* ps = ws + 2 * F32_STAGE;                  // [ROWS][LD]
  long blk = blockIdx.x;
  const int ptile = (int)(blk % n_ptiles);
  blk /= n_ptiles;
  const int ttile = (int)(blk % n_ttiles);
  const long item = blk / n_ttiles;
  const int t0 = ttile * F32_TT, p0 = ptile * F32_PT;
  const int n_chunks = kc / KCH;
  const int c_begin = blockIdx.y * chunks_per_cta;
  const int c_end = min(n_chunks, c_begin + chunks_per_cta);
  const float* xb = x + item * t_len * kc;
  const float* mb = mask + item * t_len;

  FmaTile acc;
  stage_weights(ws, wt, p0, p_pad, kc, c_begin);
  for (int ch = c_begin; ch < c_end; ++ch) {
    pool_chunk(ps, xb, mb, t0, t_len, kc, ch);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // chunk ch's weights and pooled rows are ready
    const int s = (ch - c_begin) & 1;
    if (ch + 1 < c_end)
      stage_weights(ws + (s ^ 1) * F32_STAGE, wt, p0, p_pad, kc, ch + 1);
    acc.chunk(ws + s * F32_STAGE, ps);
    __syncthreads();   // every warp is done with ps and stage s
  }
  acc.store(out + item * t_len * p, t0, p0, t_len, p, gridDim.y > 1);
}

int pool_proj1_f32_launch(const float* x, const float* mask, const float* wt,
                          float* out, int B, int t_len, int kc, int p,
                          int p_pad, int device, cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (kc % KCH || p_pad % F32_PT || p > p_pad) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(pool_proj1_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)F32_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int n_ttiles = (t_len + F32_TT - 1) / F32_TT, n_ptiles = p_pad / F32_PT;
  const long tiles = (long)B * n_ttiles * n_ptiles;
  if (tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int n_chunks = kc / KCH;
  // enough CTAs for two waves of the SMs, summed with atomicAdd
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long want = (2L * sms + tiles - 1) / tiles;
  int split = (int)(want < n_chunks ? want : n_chunks);
  const int per = (n_chunks + split - 1) / split;
  split = (n_chunks + per - 1) / per;
  if (split > 1) {
    err = cudaMemsetAsync(out, 0, (size_t)B * t_len * p * sizeof(float), stream);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)tiles, split);
  pool_proj1_kernel<<<grid, F32_THREADS, F32_BYTES, stream>>>(
      x, mask, wt, out, t_len, kc, p, p_pad, n_ttiles, n_ptiles, per);
  return (int)cudaGetLastError();
}

// ----------------------------------------------- bf16: wgmma implicit GEMM

constexpr int PM = 128;                 // virtual frames of a CTA tile
constexpr int PROWS = PM + 2;           // pooled rows: the taps' halo
constexpr int XROWS = PM + 3;           // x rows: the pool's left neighbour too
constexpr int PLANE = PROWS * 16;       // bytes of one 8-channel pooled plane
constexpr int A_BYTES = 4 * PLANE;      // the pooled stage: 4 planes
constexpr int X_BYTES = (XROWS * KCH * 2 + 127) / 128 * 128;  // a raw x stage
constexpr int X_STAGES = 4;
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 8;
constexpr int POOL_WARPS = 3;
constexpr int MMA_THREADS = 256 + 32 * POOL_WARPS + 32;  // consumers, pool warps, producer
constexpr int BARS_BYTES = 256;
constexpr int TABLE_BYTES = (PROWS * 8 + 127) / 128 * 128;  // the pooled rows' sources

// bytes of one main-ring stage: the pooled rows, then the three weight taps
// of N columns x KCH channels
__host__ __device__ constexpr int stage_bytes(int n) { return A_BYTES + 3 * n * KCH * 2; }

// Shared memory of one bf16 CTA: the mbarriers, the pooled rows' source
// table, the raw x ring, the main ring. cbhg.py ``pool_proj1_plan``
// repeats this sum.
__host__ __device__ inline size_t mma_smem(int n, int stages) {
  return BARS_BYTES + TABLE_BYTES + (size_t)X_STAGES * X_BYTES + (size_t)stages * stage_bytes(n);
}

struct MmaParams {
  CUtensorMap xmap;   // x as [B*T rows, KC] in boxes {KCH, XROWS}, no swizzle
  const float* mask;  // [B*T]
  const bf16* wpk;    // [n_blocks][KC / KCH][3][N/8][KCH/8][8][8]: the stage images
  bf16* out;          // [B*T, P]
  int T, B, KC, P, n_blocks, stages;
  int tiles;          // CTA tiles of PM virtual frames per column block
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes global -> shared by the TMA unit, completion
// counted in bytes on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups of the warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor of a K-major operand without swizzle:
// core matrices of 8 rows x 16 bytes (128 contiguous bytes), k-neighbours
// `lbo` bytes apart, 8-row groups `sbo` bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// wgmma m64nNk16, bf16 x bf16 -> f32, A and B K-major in shared memory:
// D = A B + (acc ? D : 0); N = 2 x the accumulator's length
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[48], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[96], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[128], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}


// CTA (tile, column block nb): virtual frames [128 tile, 128 tile + 128),
// output channels [N nb, N nb + N) of P.
template <int N>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    pool_proj1_mma_kernel(const __grid_constant__ MmaParams p) {
  const int nb = blockIdx.x / p.tiles;
  const int v0 = (blockIdx.x % p.tiles) * PM;
  const int T = p.T, T1 = p.T + 1, nv = p.B * T1, S = p.stages;
  const int nch = p.KC / KCH;
  // the first real frame at or after virtual frame v0 - 2: x row 0 of the
  // raw stages
  int fr0 = 0;
  if (v0 >= 2) {
    const int b = (v0 - 2) / T1, t = (v0 - 2) - b * T1;
    fr0 = b * T + min(t, T);
  }
  const int tid = threadIdx.x, lane = tid & 31;

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full = smem_u32(smem), empty = full + 8 * MAX_STAGES;
  const uint32_t xfull = empty + 8 * MAX_STAGES, xempty = xfull + 8 * X_STAGES;
  int2* table = reinterpret_cast<int2*>(smem + BARS_BYTES);
  unsigned char* xring = smem + BARS_BYTES + TABLE_BYTES;
  unsigned char* ring = xring + X_STAGES * X_BYTES;
  constexpr int STAGE = stage_bytes(N), W_BYTES = 3 * N * KCH * 2;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1 + POOL_WARPS);  // the weights' bytes + the pool warps
      mbar_init(empty + 8 * i, 8);              // each consumer warp
    }
    for (int i = 0; i < X_STAGES; ++i) {
      mbar_init(xfull + 8 * i, 1);
      mbar_init(xempty + 8 * i, POOL_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are set before any copy counts on them

  if (tid >= 256 + 32 * POOL_WARPS) {
    // the producer: per chunk the raw x rows, then the three weight taps
    if (lane == 0) {
      const unsigned char* w =
          reinterpret_cast<const unsigned char*>(p.wpk) + (size_t)nb * nch * W_BYTES;
      for (int c = 0; c < nch; ++c) {
        const int xs = c % X_STAGES, s = c % S;
        if (c >= X_STAGES) mbar_wait(xempty + 8 * xs, (c / X_STAGES - 1) & 1);
        mbar_expect_tx(xfull + 8 * xs, XROWS * KCH * 2);
        tma_load_2d(smem_u32(xring + xs * X_BYTES), &p.xmap, c * KCH, fr0, xfull + 8 * xs);
        if (c >= S) mbar_wait(empty + 8 * s, (c / S - 1) & 1);
#ifdef POOL_SKIP_W  // diagnostic: the weights stay as they are
        mbar_arrive(full + 8 * s);
#else
        mbar_expect_tx(full + 8 * s, W_BYTES);
        bulk_copy(smem_u32(ring + s * STAGE + A_BYTES), w + (size_t)c * W_BYTES, W_BYTES,
                  full + 8 * s);
#endif
      }
    }
  } else if (tid >= 256) {
    // the pool warps: raw stage -> 130 pooled rows v0-1 .. v0+128 in 4
    // planes; zero at gap frames and outside [0, B (T+1)). Each row's
    // source (x row, whether it has a left neighbour, its mask) is the same
    // for every chunk: a table made once
    const int ptid = tid - 256;
    for (int j = ptid; j < PROWS; j += 32 * POOL_WARPS) {
      const int v = v0 - 1 + j;
      int2 e = make_int2(-1, 0);
      if (v >= 0 && v < nv) {
        const int b = v / T1, t = v - b * T1;
        if (t < T) {
          const int f = b * T + t;
          e = make_int2(2 * (f - fr0) + (t > 0), __float_as_int(__ldg(p.mask + f)));
        }
      }
      table[j] = e;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * POOL_WARPS) : "memory");
    for (int c = 0; c < nch; ++c) {
      const int xs = c % X_STAGES, s = c % S;
      mbar_wait(xfull + 8 * xs, (c / X_STAGES) & 1);
      if (c >= S) mbar_wait(empty + 8 * s, (c / S - 1) & 1);
      const unsigned char* xr = xring + xs * X_BYTES;
      unsigned char* a = ring + s * STAGE;
#ifndef POOL_SKIP_POOL  // diagnostic: the pooled rows stay as they are
      for (int item = ptid; item < PROWS * 4; item += 32 * POOL_WARPS) {
        const int j = item >> 2, pl = item & 3;
        const int2 e = table[j];
        uint4 o = make_uint4(0, 0, 0, 0);
        if (e.x >= 0) {
          const unsigned char* src = xr + (e.x >> 1) * (KCH * 2) + pl * 16;
          uint4 cur = *reinterpret_cast<const uint4*>(src);
          __nv_bfloat162* cp = reinterpret_cast<__nv_bfloat162*>(&cur);
          if (e.x & 1) {
            const uint4 prev = *reinterpret_cast<const uint4*>(src - KCH * 2);
            const __nv_bfloat162* pp = reinterpret_cast<const __nv_bfloat162*>(&prev);
#pragma unroll
            for (int k = 0; k < 4; ++k) cp[k] = __hmax2(pp[k], cp[k]);
          }
          const float m = __int_as_float(e.y);
          __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float2 fv = __bfloat1622float2(cp[k]);
            op[k] = __floats2bfloat162_rn(fv.x * m, fv.y * m);
          }
        }
        *reinterpret_cast<uint4*>(a + pl * PLANE + j * 16) = o;
      }
#endif
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(full + 8 * s);
        mbar_arrive(xempty + 8 * xs);
      }
    }
  } else {
    // consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of the tile; tap d
    // reads pooled rows from 64 wg + d, one 16-byte row further per tap
    const int wg = tid >> 7, warp4 = (tid >> 5) & 3;
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    const uint32_t ring0 = smem_u32(ring);
    for (int c = 0; c < nch; ++c) {
      const int s = c % S;
      mbar_wait(full + 8 * s, (c / S) & 1);
      const uint32_t a0 = ring0 + s * STAGE + 64 * wg * 16;
      const uint32_t w0 = ring0 + s * STAGE + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int ks = 0; ks < KCH / 16; ++ks)
          wgmma(acc, desc(a0 + 2 * ks * PLANE + d * 16, PLANE, 128),
                desc(w0 + d * N * KCH * 2 + ks * 256, 128, (KCH / 8) * 128), 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (c > 0 && lane == 0) mbar_arrive(empty + 8 * ((c - 1) % S));
    }
    wgmma_wait<0>();

    // epilogue: rows row0 + 8 i, columns 8 j + 2 (lane % 4) + e of the
    // block, acc[4 j + 2 i + e]; gap frames and columns past P are not
    // stored
    const bool pairs = !(p.P & 1);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int v = v0 + 64 * wg + warp4 * 16 + (lane >> 2) + 8 * i;
      const int b = v / T1, t = v - b * T1;
      if (v >= nv || t >= T) continue;
      bf16* o = p.out + (size_t)(b * T + t) * p.P;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        const int col = nb * N + 8 * j + 2 * (lane & 3);
        const float a = acc[4 * j + 2 * i], bv = acc[4 * j + 2 * i + 1];
        if (pairs && col + 1 < p.P) {
          *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(a, bv);
        } else {
          if (col < p.P) o[col] = __float2bfloat16(a);
          if (col + 1 < p.P) o[col + 1] = __float2bfloat16(bv);
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// x [rows, kc] bf16 in boxes {KCH, XROWS}, no swizzle; rows past the end
// read zero
int x_map(CUtensorMap* map, const void* x, long long rows, int kc) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)kc, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)kc * 2};
  const cuuint32_t box[2] = {KCH, XROWS};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
                              strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int N>
int mma_launch(MmaParams& p, const void* x, int smem, int device, cudaStream_t stream) {
  int max_smem = 0;
  cudaError_t err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  if ((size_t)smem != mma_smem(N, p.stages) || smem > max_smem) return (int)cudaErrorInvalidValue;
  const int st = x_map(&p.xmap, x, (long long)p.B * p.T, p.KC);
  if (st) return st;
  auto kernel = pool_proj1_mma_kernel<N>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((long)p.tiles * p.n_blocks), MMA_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int pool_proj1_bf16_launch(const bf16* x, const float* mask, const bf16* wpk, bf16* out, int B,
                           int t_len, int kc, int p, int n, int n_blocks, int stages,
                           int smem, int device, cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  const long nv = (long)B * (t_len + 1);
  const long tiles = (nv + PM - 1) / PM;
  if (kc % KCH || n_blocks < 1 || (long)n * n_blocks < p || stages < MIN_STAGES ||
      stages > MAX_STAGES || nv > 0x7fffffffL - 8 * PM || tiles * n_blocks > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  MmaParams prm = {};
  prm.mask = mask, prm.wpk = wpk, prm.out = out;
  prm.T = t_len, prm.B = B, prm.KC = kc, prm.P = p, prm.n_blocks = n_blocks, prm.stages = stages;
  prm.tiles = (int)tiles;
  switch (n) {
    case 64: return mma_launch<64>(prm, x, smem, device, stream);
    case 96: return mma_launch<96>(prm, x, smem, device, stream);
    case 128: return mma_launch<128>(prm, x, smem, device, stream);
    case 192: return mma_launch<192>(prm, x, smem, device, stream);
    case 256: return mma_launch<256>(prm, x, smem, device, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pool_mask_f32(const float* x, const float* mask, float* out,
                             int B, int t_len, int kc, int device,
                             cudaStream_t stream) {
  return pool_mask_launch(x, mask, out, B, t_len, kc, device, stream);
}

extern "C" int pool_mask_bf16(const void* x, const float* mask, void* out,
                              int B, int t_len, int kc, int device,
                              cudaStream_t stream) {
  return pool_mask_launch((const bf16*)x, mask, (bf16*)out, B, t_len, kc,
                          device, stream);
}

// wt [3, p_pad, KC] (cbhg.py pack_proj_weight), p_pad a multiple of 64.
extern "C" int pool_proj1_f32(const float* x, const float* mask,
                              const float* wt, float* out, int B, int t_len,
                              int kc, int p, int p_pad, int device,
                              cudaStream_t stream) {
  return pool_proj1_f32_launch(x, mask, wt, out, B, t_len, kc, p, p_pad,
                               device, stream);
}

// wpk: the stage images of cbhg.py pack_proj_stages; n (64, 96, 128, 192
// or 256), n_blocks, stages and smem from cbhg.py pool_proj1_plan.
extern "C" int pool_proj1_bf16(const void* x, const float* mask,
                               const void* wpk, void* out, int B, int t_len,
                               int kc, int p, int n, int n_blocks, int stages,
                               int smem, int device, cudaStream_t stream) {
  return pool_proj1_bf16_launch((const bf16*)x, mask, (const bf16*)wpk,
                                (bf16*)out, B, t_len, kc, p, n, n_blocks,
                                stages, smem, device, stream);
}
