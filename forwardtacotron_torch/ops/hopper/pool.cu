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
// the postnet's serving shape against 4.3 GB of input). Design: one CTA per
// (item, tile of TT frames, tile of PT output columns) loops over the KC
// input channels in chunks of KCH. Per chunk it computes the pooled, masked
// and rounded chunk of frames t0-1 .. t0+TT (the taps' one-frame halo on
// each side, zero outside [0, T)) from x into shared memory, and stages the
// chunk's three [PT, KCH] weight taps (w packed as [3, P_pad, KC], each
// column's KC inputs contiguous, P padded with zero columns to a multiple of
// PT) through a double-buffered cp.async stage, so the next chunk's weights
// arrive while this chunk's products run. The whole-T blocks of the TPU
// kernel become time tiles: the halo is recomputed, the arithmetic is the
// same.
//   bf16: tensor cores, mma.sync m16n8k16 with f32 accumulation; a warp owns
//         32 output columns x 64 frames, TT = PT = 128, 8 warps;
//   f32:  FMA; a thread owns 4 output columns x 8 frames, TT = PT = 64, 128
//         threads. Requests give few tiles (one 92-token prenet: 8), so the
//         f32 kernel also splits KC across CTAs and sums into the zeroed
//         output with atomicAdd (float32 needs no rounding of the sum).
// KC must be a multiple of KCH = 32 (the JAX gate admits multiples of 128).
// Shared memory: bf16 2 x 3 x 128 x 40 x 2 B of weights + 130 x 40 x 2 B of
// pooled rows = 71,840 B (at 128 registers a thread, two CTAs per SM); f32
// 2 x 3 x 64 x 36 x 4 + 66 x 36 x 4 = 64,800 B (three CTAs per SM). A
// simple first kernel: wgmma, TMA and ldmatrix are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  cudaError_t err = cudaSetDevice(device);
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

constexpr int KCH = 32;   // input channels per chunk

template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int TT = 128, PT = 128, THREADS = 256, PAD = 8;
};
template <> struct Tile<float> {
  static constexpr int TT = 64, PT = 64, THREADS = 128, PAD = 4;
};

template <typename T>
struct ProjSmem {
  static constexpr int LD = KCH + Tile<T>::PAD;        // row stride, elements
  static constexpr int ROWS = Tile<T>::TT + 2;         // pooled frames
  static constexpr int STAGE = 3 * Tile<T>::PT * LD;   // one chunk's weights
  static constexpr size_t BYTES = (2 * STAGE + ROWS * LD) * sizeof(T);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// chunk `ch`'s weight taps wt[d, p0 .. p0+PT, ch*KCH .. +KCH] into a stage
template <typename T>
__device__ __forceinline__ void stage_weights(T* ws, const T* wt, int p0,
                                              int p_pad, int kc, int ch) {
  constexpr int PT = Tile<T>::PT, LD = ProjSmem<T>::LD;
  constexpr int PIECES = KCH * sizeof(T) / 16;
  for (int i = threadIdx.x; i < 3 * PT * PIECES; i += Tile<T>::THREADS) {
    const int q = i % PIECES, row = i / PIECES;   // row = d * PT + m
    const int d = row / PT, m = row - d * PT;
    cp_async16(ws + row * LD + q * (16 / sizeof(T)),
               wt + ((long)d * p_pad + p0 + m) * kc + ch * KCH
                  + q * (16 / sizeof(T)));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// pooled rows of chunk `ch`: row r holds frame t0 - 1 + r, 0 outside [0, T)
template <typename T>
__device__ __forceinline__ void pool_chunk(T* ps, const T* xb,
                                           const float* mb, int t0,
                                           int t_len, int kc, int ch) {
  constexpr int V = 16 / sizeof(T), LD = ProjSmem<T>::LD;
  constexpr int VECS = KCH / V;
  for (int i = threadIdx.x; i < ProjSmem<T>::ROWS * VECS;
       i += Tile<T>::THREADS) {
    const int r = i / VECS, q = i - r * VECS;
    const int u = t0 - 1 + r;
    float v[V];
    if (u >= 0 && u < t_len) {
      const T* p = xb + (long)u * kc + ch * KCH + q * V;
      load_vec<T, V>(p, v);
      if (u > 0) {
        float prev[V];
        load_vec<T, V>(p - kc, prev);
#pragma unroll
        for (int e = 0; e < V; ++e) v[e] = fmaxf(prev[e], v[e]);
      }
      const float m = mb[u];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = rnd<T>(v[e] * m);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = 0.f;
    }
    store_vec<T, V>(ps + r * LD + q * V, v);
  }
}

// bf16: warp w owns output columns m0 .. m0+32 (two m16 blocks) and frames
// n0 .. n0+64 (eight n8 tiles) of the CTA's [PT, TT] tile
struct MmaTile {
  static constexpr int NT = 8;
  float acc[2][NT][4];
  int m0, n0;
  __device__ MmaTile() {
    const int warp = threadIdx.x >> 5;
    m0 = (warp % 4) * 32;
    n0 = (warp / 4) * 64;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mb][nt][q] = 0.f;
  }
  __device__ __forceinline__ void chunk(const bf16* ws, const bf16* ps) {
    constexpr int LD = ProjSmem<bf16>::LD, PT = Tile<bf16>::PT;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int k0 = 0; k0 < KCH; k0 += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          const bf16* w = ws + (d * PT + m0 + mb * 16 + g) * LD + k0 + 2 * tg;
          a[mb][0] = *reinterpret_cast<const uint32_t*>(w);
          a[mb][1] = *reinterpret_cast<const uint32_t*>(w + 8 * LD);
          a[mb][2] = *reinterpret_cast<const uint32_t*>(w + 8);
          a[mb][3] = *reinterpret_cast<const uint32_t*>(w + 8 * LD + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // frame t = t0 + n0 + nt*8 + g reads pooled row t - t0 + d
          const bf16* p = ps + (n0 + nt * 8 + g + d) * LD + k0 + 2 * tg;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(p);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(p + 8);
          mma_16816(acc[0][nt], a[0], b0, b1);
          mma_16816(acc[1][nt], a[1], b0, b1);
        }
      }
    }
  }
  __device__ __forceinline__ void store(bf16* ob, int t0, int p0, int t_len,
                                        int p, bool) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = p0 + m0 + mb * 16 + g + (q >> 1) * 8;
          const int t = t0 + n0 + nt * 8 + 2 * tg + (q & 1);
          if (t < t_len && col < p)
            st(ob + (long)t * p + col, acc[mb][nt][q]);
        }
  }
};

// f32: thread u owns output columns co .. co+4 and frames f0 .. f0+8
struct FmaTile {
  float acc[4][8];
  int co, f0;
  __device__ FmaTile() {
    constexpr int GROUPS = Tile<float>::PT / 4;
    co = (threadIdx.x % GROUPS) * 4;
    f0 = (threadIdx.x / GROUPS) * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][r] = 0.f;
  }
  __device__ __forceinline__ void chunk(const float* ws, const float* ps) {
    constexpr int LD = ProjSmem<float>::LD, PT = Tile<float>::PT;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      for (int k = 0; k < KCH; k += 4) {
        float4 wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[i] = *reinterpret_cast<const float4*>(
              ws + (d * PT + co + i) * LD + k);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(
              ps + (f0 + r + d) * LD + k);
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

template <typename T> struct Acc;
template <> struct Acc<bf16> { typedef MmaTile type; };
template <> struct Acc<float> { typedef FmaTile type; };

template <typename T>
__global__ void __launch_bounds__(Tile<T>::THREADS)
pool_proj1_kernel(const T* __restrict__ x,         // [B, T, kc]
                  const float* __restrict__ mask,  // [B, T]
                  const T* __restrict__ wt,        // [3, p_pad, kc]
                  T* __restrict__ out,             // [B, T, p]
                  int t_len, int kc, int p, int p_pad, int n_ttiles,
                  int n_ptiles, int chunks_per_cta) {
  constexpr int TT = Tile<T>::TT, PT = Tile<T>::PT;
  extern __shared__ float4 smem4[];
  T* ws = reinterpret_cast<T*>(smem4);                 // [2][3][PT][LD]
  T* ps = ws + 2 * ProjSmem<T>::STAGE;                 // [ROWS][LD]
  long blk = blockIdx.x;
  const int ptile = (int)(blk % n_ptiles);
  blk /= n_ptiles;
  const int ttile = (int)(blk % n_ttiles);
  const long item = blk / n_ttiles;
  const int t0 = ttile * TT, p0 = ptile * PT;
  const int n_chunks = kc / KCH;
  const int c_begin = blockIdx.y * chunks_per_cta;
  const int c_end = min(n_chunks, c_begin + chunks_per_cta);
  const T* xb = x + item * t_len * kc;
  const float* mb = mask + item * t_len;

  typename Acc<T>::type acc;
  stage_weights(ws, wt, p0, p_pad, kc, c_begin);
  for (int ch = c_begin; ch < c_end; ++ch) {
    pool_chunk(ps, xb, mb, t0, t_len, kc, ch);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // chunk ch's weights and pooled rows are ready
    const int s = (ch - c_begin) & 1;
    if (ch + 1 < c_end)
      stage_weights(ws + (s ^ 1) * ProjSmem<T>::STAGE, wt, p0, p_pad, kc,
                    ch + 1);
    acc.chunk(ws + s * ProjSmem<T>::STAGE, ps);
    __syncthreads();   // every warp is done with ps and stage s
  }
  acc.store(out + item * t_len * p, t0, p0, t_len, p, gridDim.y > 1);
}

template <typename T>
int pool_proj1_launch(const T* x, const float* mask, const T* wt, T* out,
                      int B, int t_len, int kc, int p, int p_pad, int device,
                      cudaStream_t stream) {
  constexpr int TT = Tile<T>::TT, PT = Tile<T>::PT;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kc % KCH || p_pad % PT || p > p_pad) return (int)cudaErrorInvalidValue;
  const size_t smem = ProjSmem<T>::BYTES;
  err = cudaFuncSetAttribute(pool_proj1_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ttiles = (t_len + TT - 1) / TT, n_ptiles = p_pad / PT;
  const long tiles = (long)B * n_ttiles * n_ptiles;
  if (tiles > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  const int n_chunks = kc / KCH;
  int split = 1;
  if (sizeof(T) == 4) {
    // f32: enough CTAs for two waves of the SMs, summed with atomicAdd
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long want = (2L * sms + tiles - 1) / tiles;
    split = (int)(want < n_chunks ? want : n_chunks);
  }
  const int per = (n_chunks + split - 1) / split;
  split = (n_chunks + per - 1) / per;
  if (split > 1) {
    err = cudaMemsetAsync(out, 0, (size_t)B * t_len * p * sizeof(T), stream);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)tiles, split);
  pool_proj1_kernel<T><<<grid, Tile<T>::THREADS, smem, stream>>>(
      x, mask, wt, out, t_len, kc, p, p_pad, n_ttiles, n_ptiles, per);
  return (int)cudaGetLastError();
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

extern "C" int pool_proj1_f32(const float* x, const float* mask,
                              const float* wt, float* out, int B, int t_len,
                              int kc, int p, int p_pad, int device,
                              cudaStream_t stream) {
  return pool_proj1_launch(x, mask, wt, out, B, t_len, kc, p, p_pad, device,
                           stream);
}

extern "C" int pool_proj1_bf16(const void* x, const float* mask,
                               const void* wt, void* out, int B, int t_len,
                               int kc, int p, int p_pad, int device,
                               cudaStream_t stream) {
  return pool_proj1_launch((const bf16*)x, mask, (const bf16*)wt, (bf16*)out,
                           B, t_len, kc, p, p_pad, device, stream);
}
