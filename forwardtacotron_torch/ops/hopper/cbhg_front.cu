// The whole CBHG front in one kernel, in f32 or bf16:
//   for k = 1..K: conv_k -> ReLU -> folded BN -> maxpool(2, 1) with a -inf
//                 left pad -> x mask -> 3-tap partial proj1 product
//   then ReLU + folded BN of conv_project1.
//
// Replaces forwardtacotron_tpu/ops/pallas/cbhg.py::bank_pool_proj_pallas
// (kernel body _bank_pool_proj_kernel). As there, the [B, T, K*C] bank
// concatenation never exists: branches stream one at a time through shared
// memory and each feeds its slice of the projection.
//
// Bound on an H100: operations. At the postnet (K=8, C_in=80, C=P=256) the
// bank is 1.5 MFLOP and the projection 3.1 MFLOP per frame against 4.6 MB
// of bf16 weights: 4.84 TFLOP for one bf16 serving call (B 4096, T 256),
// 4.9 ms at the 989 TFLOP/s bf16 peak.
//
// Each CTA takes one (item, tile of frames, tile of P). The tile needs bank
// outputs at frames t0-2 .. t0+tile (the projection's +-1 taps over the
// pool's one-frame look-back), which need inputs at t0-2-K/2 .. ; that
// input halo sits in shared memory with zeros outside [0, T), resident
// over all branches where it fits, else in chunks of input channels
// reloaded for each bank chunk (plan in ops/hopper/cbhg.py). The bank walks
// C in column chunks: a chunk's ReLU/BN/pool/mask runs in f32 and its
// pooled, masked rows (0 outside [0, T), the projection's padding) meet
// the chunk's slice of the three proj1 taps in an accumulator that lives
// across all branches. Any T, C_in, C and P.
//
// bf16 entry (cbhg_front_mma_kernel): tensor cores, mma.sync m16n8k16 with
// f32 accumulation, operands by ldmatrix. mma.sync and not wgmma: both
// products read the tile's rows shifted by a frame (the bank's taps at
// j + K/2 - k/2, the projection's taps at d), which ldmatrix takes as any
// row address, while wgmma's shared-memory descriptors need 8-row-aligned
// core matrices (A from registers would need the same ldmatrix loads).
//   - 128 frames per CTA, 256 threads (8 warps). The projection's [128 x
//     256] f32 accumulator is 128 registers a thread (warps 2 x 4, each 64
//     frames x 64 columns); the bank runs per branch in chunks of 64
//     columns over 144 rows (nine 16-row tiles, frames t0-2 .. t0+141, of
//     which 131 feed the pool): warps 4 x 2 over row tiles {w, w+4} and 32
//     columns, the ninth tile split by n8 tile across the warps, 9
//     products a warp per k-step. The chunk goes as f32 rows into shared
//     memory; ReLU/BN, the pool and the mask (both from shared memory)
//     round it to bf16 [130, 64] rows, and its three proj taps ([128, 64]
//     x [64, 256]) go into the accumulator.
//   - Weights arrive through a ring of 2-4 stages. The wrapper packs every
//     stage as one contiguous block that is its shared-memory image (a
//     bank stage up to 256 rows of (tap, input channel) for 64 columns,
//     k-major, read by ldmatrix .trans; a proj stage one tap's [256, 64]
//     slice, n-major), so one thread moves it with one bulk copy (TMA,
//     mbarrier completion). Per-thread cp.async copies, the first design,
//     spent more time issuing and waiting than the products took. Rows
//     are 72 elements (odd multiples of 16 bytes), so ldmatrix reads are
//     free of bank conflicts. The input halo is held in bf16.
//   - L2: every CTA reads all of the front's weights once (1.47 MB of bank,
//     3.15 MB of proj1 at the postnet, 12.5% more with the row padding).
//     At 128 frames the serving call has 8,192 CTAs, ~37.7 GB out of L2,
//     ~9 ms at the ~4.1 TB/s measured for L2 in this port (PERF.md, section 6),
//     against ~10 ms of products at half the bf16 peak; the ring overlaps
//     the two. At 32 frames it was 151 GB. A wider tile would need more
//     than the 255 registers a thread has.
//   - Shared memory at the postnet: 4 stages x 36,864 B, halo 151 x 88 x 2
//     B, f32 bank rows 131 x 72 x 4 B, pooled rows 130 x 72 x 2 B, the
//     tile's mask, a chunk's BN and the mbarriers: 231,584 B, one CTA per
//     SM.
//   The bank, its ReLU/BN and the pool run in f32 and the pooled branch is
//   rounded to bf16 before it enters the projection, as the TPU kernel
//   casts it before each proj1 tap; the output is rounded to bf16 once.
//
// f32 entry (cbhg_front_kernel): FP32 FMA (tensor cores in f32 would be
// TF32). 32 frames per CTA; thread c computes bank column c of a 256-column
// chunk for all 35 rows in registers, applies ReLU/BN and the pool there,
// and writes the masked pooled column to shared memory; thread p then
// accumulates output column p of a 256-column P tile for the tile's 32
// frames across all branches. The halo costs (TT+3)/TT of the bank work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SMEM_LIMIT = 232448;

// ------------------------------------------------------ f32 entry (FMA)

constexpr int F_TT = 32;                // output frames per CTA
constexpr int F_BANK_ROWS = F_TT + 3;   // bank rows: frames t0-2 .. t0+TT
constexpr int F_POOL_ROWS = F_TT + 2;   // pooled rows: t0-1 .. t0+TT
constexpr int F_CB = 256;               // bank columns per chunk
constexpr int F_PT = 256;               // output columns per CTA
constexpr int F_THREADS = 256;

__global__ void __launch_bounds__(F_THREADS, 1)
cbhg_front_kernel(const float* __restrict__ x,            // [B, T, c_in]
                  const float* __restrict__ mask,         // [B, T]
                  const float* __restrict__ bank_w,       // branches' [k*c_in, c]
                  const float* __restrict__ bn_scale,     // [K, c]
                  const float* __restrict__ bn_bias,      // [K, c]
                  const float* __restrict__ proj_w,       // [3, K*c, p]
                  const float* __restrict__ proj_scale,   // [p]
                  const float* __restrict__ proj_bias,    // [p]
                  float* __restrict__ out,                // [B, T, p]
                  int T, int c_in, int c, int p, int K, int ki, int n_ci,
                  int n_ttiles, int n_ptiles) {
  extern __shared__ float4 smem4[];
  const int xr = F_BANK_ROWS + K - 1;
  float* xs = reinterpret_cast<float*>(smem4);    // [xr][ki]
  float* ps = xs + xr * ki;                       // [F_POOL_ROWS][F_CB]
  long blk = blockIdx.x;
  const int ptile = (int)(blk % n_ptiles);
  blk /= n_ptiles;
  const int ttile = (int)(blk % n_ttiles);
  const long item = blk / n_ttiles;
  const int t0 = ttile * F_TT;
  const int tid = threadIdx.x;
  const int pcol = ptile * F_PT + tid;
  const int left = K / 2;
  const float* xb = x + item * T * c_in;
  const float* mb = mask + item * T;

  // input chunk q: xs row r, column i holds channel q*ki + i of frame
  // t0 - 2 - left + r (0 outside [0, T))
  auto load_halo = [&](int q) {
    const int ci0 = q * ki, w = min(ki, c_in - ci0);
    for (int i = tid; i < xr * w; i += F_THREADS) {
      const int r = i / w, ci = i - r * w;
      const int f = t0 - 2 - left + r;
      xs[r * ki + ci] = (f >= 0 && f < T) ? xb[(long)f * c_in + ci0 + ci]
                                          : 0.f;
    }
  };

  float acc[F_TT];
#pragma unroll
  for (int t = 0; t < F_TT; ++t) acc[t] = 0.f;
  if (n_ci == 1) load_halo(0);
  const long kc = (long)K * c;
  long woff = 0;                                  // branch k's weights

  for (int k = 1; k <= K; ++k) {
    const int shift = left - k / 2;
    for (int cc = 0; cc < c; cc += F_CB) {
      const int col = cc + tid;
      const bool live = col < c;
      float y[F_BANK_ROWS];
#pragma unroll
      for (int r = 0; r < F_BANK_ROWS; ++r) y[r] = 0.f;
      for (int q = 0; q < n_ci; ++q) {
        if (n_ci > 1) {
          __syncthreads();   // every thread is done with the last chunk
          load_halo(q);
        }
        __syncthreads();     // input ready; the last pooled rows consumed
        if (!live) continue;
        const int ci0 = q * ki, w = min(ki, c_in - ci0);
        for (int j = 0; j < k; ++j) {
          const float* xj = xs + (j + shift) * ki;
          const float* wj = bank_w + woff + ((long)j * c_in + ci0) * c + col;
          for (int ci = 0; ci < w; ci += 4) {
            const float w0 = wj[(long)(ci + 0) * c];
            const float w1 = wj[(long)(ci + 1) * c];
            const float w2 = wj[(long)(ci + 2) * c];
            const float w3 = wj[(long)(ci + 3) * c];
#pragma unroll
            for (int r = 0; r < F_BANK_ROWS; ++r) {
              const float4 v =
                  *reinterpret_cast<const float4*>(&xj[r * ki + ci]);
              y[r] = fmaf(v.x, w0, y[r]);
              y[r] = fmaf(v.y, w1, y[r]);
              y[r] = fmaf(v.z, w2, y[r]);
              y[r] = fmaf(v.w, w3, y[r]);
            }
          }
        }
      }
      // ReLU then the folded eval BN (reference order); pooled frame
      // u = t0 - 1 + r takes bank rows r (frame u-1) and r+1
      const float s = live ? bn_scale[(long)(k - 1) * c + col] : 0.f;
      const float bb = live ? bn_bias[(long)(k - 1) * c + col] : 0.f;
#pragma unroll
      for (int r = 0; r < F_BANK_ROWS; ++r) y[r] = fmaxf(y[r], 0.f) * s + bb;
#pragma unroll
      for (int r = 0; r < F_POOL_ROWS; ++r) {
        const int u = t0 - 1 + r;
        float v = 0.f;
        if (live && u >= 0 && u < T) {
          const float prev = (u == 0) ? -INFINITY : y[r];
          v = fmaxf(prev, y[r + 1]) * mb[u];
        }
        ps[r * F_CB + tid] = v;
      }
      __syncthreads();
      // partial proj1: acc[t] += sum_d pooled[t0 + t - 1 + d] . proj_w[d]
      if (pcol < p) {
        const int cw = min(F_CB, c - cc);
        const float* pw = proj_w + ((long)(k - 1) * c + cc) * p + pcol;
        for (int d = 0; d < 3; ++d) {
          const float* pwd = pw + d * kc * p;
          for (int ci = 0; ci < cw; ci += 4) {
            const float w0 = pwd[(long)(ci + 0) * p];
            const float w1 = pwd[(long)(ci + 1) * p];
            const float w2 = pwd[(long)(ci + 2) * p];
            const float w3 = pwd[(long)(ci + 3) * p];
#pragma unroll
            for (int t = 0; t < F_TT; ++t) {
              const float4 v =
                  *reinterpret_cast<const float4*>(&ps[(t + d) * F_CB + ci]);
              acc[t] = fmaf(v.x, w0, acc[t]);
              acc[t] = fmaf(v.y, w1, acc[t]);
              acc[t] = fmaf(v.z, w2, acc[t]);
              acc[t] = fmaf(v.w, w3, acc[t]);
            }
          }
        }
      }
    }
    woff += (long)k * c_in * c;
  }

  if (pcol < p) {
    const float s = proj_scale[pcol], bb = proj_bias[pcol];
    float* ob = out + item * T * p;
#pragma unroll
    for (int t = 0; t < F_TT; ++t) {
      if (t0 + t < T) ob[(long)(t0 + t) * p + pcol] = fmaxf(acc[t], 0.f) * s + bb;
    }
  }
}

int launch_f32(const float* x, const float* mask, const float* bank_w,
               const float* bn_scale, const float* bn_bias,
               const float* proj_w, const float* proj_scale,
               const float* proj_bias, float* out, int B, int T, int c_in,
               int c, int p, int K, int ki, int n_ci, int device,
               cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (c_in % 4 || c % 4 || ki % 4 || ki <= 0 || n_ci != (c_in + ki - 1) / ki)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)(F_BANK_ROWS + K - 1) * ki
                       + (size_t)F_POOL_ROWS * F_CB) * sizeof(float);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(cbhg_front_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ttiles = (T + F_TT - 1) / F_TT;
  const int n_ptiles = (p + F_PT - 1) / F_PT;
  const long grid = (long)B * n_ttiles * n_ptiles;
  if (grid > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cbhg_front_kernel<<<(unsigned)grid, F_THREADS, smem, stream>>>(
      x, mask, bank_w, bn_scale, bn_bias, proj_w, proj_scale, proj_bias, out,
      T, c_in, c, p, K, ki, n_ci, n_ttiles, n_ptiles);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- bf16 entry (mma.sync)

constexpr int TM = 128;               // output frames per CTA
constexpr int BANK_ROWS = 144;        // bank rows computed: t0-2 .. t0+141
constexpr int BANK_USED = TM + 3;     // bank rows the pool reads
constexpr int POOL_ROWS = TM + 2;     // pooled rows: t0-1 .. t0+TM
constexpr int CB = 64;                // bank columns per chunk
constexpr int PT = 256;               // projection columns per CTA
constexpr int KS = 256;               // bank (tap, channel) rows per stage
constexpr int THREADS = 256;
constexpr int LD = CB + 8;            // stage, pooled and packed row stride
constexpr int YLD = CB + 8;           // f32 bank row stride
constexpr int STAGE = KS * LD;        // elements; = PT * LD
constexpr int MIN_STAGES = 2, MAX_STAGES = 4;
constexpr int BARS = 64;              // bytes for the ring's mbarriers
constexpr int MASK_ROWS = POOL_ROWS + 2;   // the tile's mask (f32)
constexpr int POOL_WARP_ROWS = (POOL_ROWS + 7) / 8;   // pool rows a warp
static_assert(CB == 64, "the pool pass gives each lane two columns");
static_assert(PT * LD == STAGE, "bank and proj stages share a slot size");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}

// `bytes` contiguous bytes global -> shared by the TMA unit, completion
// counted on `bar` (one arrival with the byte count)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FrontArgs {
  const bf16* x;            // [B, T, c_in]
  const float* mask;        // [B, T]
  const bf16* bank;         // [n_cc, n_ci, sum(k)*ki, LD]
  const float* bn_scale;    // [K, n_cc*CB]
  const float* bn_bias;     // [K, n_cc*CB]
  const bf16* proj;         // [n_pt, K, n_cc, 3, PT, LD]
  const float* proj_scale;  // [p]
  const float* proj_bias;   // [p]
  bf16* out;                // [B, T, p]
  int T, c_in, p, K, ki, n_ci, n_cc, stages, n_ttiles, n_ptiles;
};

// The weight stages in the order the CTA consumes them: for each branch k
// and bank column chunk cc, the bank's stages (input-channel chunk q,
// sub-stage sub of at most KS rows), then the three proj taps d.
struct Cursor {
  int k = 1, cc = 0, q = 0, sub = 0, d = -1;   // d < 0: bank phase
  bool done = false;
};

__device__ __forceinline__ int bank_subs(int k, int ki) {
  return (k * ki + KS - 1) / KS;
}

// (thread 0) the cursor's stage into `stage` by one bulk copy, completing
// on `bar`; advance the cursor. Every stage is one contiguous block of the
// packed weights, its shared-memory image.
__device__ __forceinline__ void issue(bf16* stage, uint32_t bar, Cursor& cur,
                                      const FrontArgs& a, int ptile) {
  if (cur.done) return;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (cur.d < 0) {
    const int krows = cur.k * a.ki;
    const int kr0 = cur.sub * KS, width = min(KS, krows - kr0);
    const int taps = a.K * (a.K + 1) / 2;
    const long off = (((long)(cur.cc * a.n_ci + cur.q) * taps
                       + cur.k * (cur.k - 1) / 2) * a.ki + kr0) * LD;
    bulk_load(smem_u32(stage), a.bank + off, width * LD * 2, bar);
    if (++cur.sub == bank_subs(cur.k, a.ki)) {
      cur.sub = 0;
      if (++cur.q == a.n_ci) {
        cur.q = 0;
        cur.d = 0;
      }
    }
  } else {
    const long off = ((((long)ptile * a.K + cur.k - 1) * a.n_cc + cur.cc) * 3
                      + cur.d) * STAGE;
    bulk_load(smem_u32(stage), a.proj + off, STAGE * 2, bar);
    if (++cur.d == 3) {
      cur.d = -1;
      if (++cur.cc == a.n_cc) {
        cur.cc = 0;
        if (++cur.k > a.K) cur.done = true;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
cbhg_front_mma_kernel(const FrontArgs a) {
  extern __shared__ float4 smem4[];
  const int hld = a.ki + 8;                        // halo row stride
  const int halo_rows = BANK_ROWS + a.K - 1;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);   // [stages]
  bf16* ring = reinterpret_cast<bf16*>(reinterpret_cast<char*>(smem4) + BARS);
  bf16* halo = ring + a.stages * STAGE;            // [halo_rows][hld]
  float* ybuf = reinterpret_cast<float*>(halo + halo_rows * hld);
  float* msk = ybuf + BANK_USED * YLD;             // [MASK_ROWS]
  float* bnp = msk + MASK_ROWS;                    // [2][CB]: scale, bias
  bf16* pooled = reinterpret_cast<bf16*>(bnp + 2 * CB);

  long blk = blockIdx.x;
  const int ptile = (int)(blk % a.n_ptiles);
  blk /= a.n_ptiles;
  const int ttile = (int)(blk % a.n_ttiles);
  const long item = blk / a.n_ttiles;
  const int t0 = ttile * TM, p0 = ptile * PT;
  const int tid = threadIdx.x, wid = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int left = a.K / 2;
  const bf16* xb = a.x + item * a.T * a.c_in;
  const float* mb = a.mask + item * a.T;
  const int c_pad = a.n_cc * CB;

  // input chunk q: halo row r, column i holds channel q*ki + i of frame
  // t0 - 2 - left + r (0 outside [0, T) and past c_in; c_in % 8 == 0)
  auto load_halo = [&](int q) {
    const int vecs = a.ki / 8, ci0 = q * a.ki;
    for (int i = tid; i < halo_rows * vecs; i += THREADS) {
      const int r = i / vecs, v = i - r * vecs;
      const int f = t0 - 2 - left + r, ci = ci0 + v * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (f >= 0 && f < a.T && ci < a.c_in)
        val = *reinterpret_cast<const uint4*>(xb + (long)f * a.c_in + ci);
      *reinterpret_cast<uint4*>(halo + r * hld + v * 8) = val;
    }
  };

  Cursor cur;
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < a.stages - 1; ++s)
      issue(ring + s * STAGE, smem_u32(bars + s), cur, a, ptile);
  }
  if (a.n_ci == 1) load_halo(0);
  // pooled row r (frame t0 - 1 + r) is masked by msk[r]; 0 outside [0, T)
  for (int r = tid; r < POOL_ROWS; r += THREADS) {
    const int u = t0 - 1 + r;
    msk[r] = (u >= 0 && u < a.T) ? mb[u] : 0.f;
  }
  __syncthreads();   // the barriers are initialised
  int use = 0;
  uint32_t phase = 0;
  // the next stage: wait for its bytes, then (thread 0) refill the slot
  // every thread finished with a stage ago
  auto acquire = [&]() -> const bf16* {
    mbar_wait(smem_u32(bars + use), phase);
    __syncthreads();
    if (tid == 0) {
      const int refill = use == 0 ? a.stages - 1 : use - 1;
      issue(ring + refill * STAGE, smem_u32(bars + refill), cur, a, ptile);
    }
    const bf16* st = ring + use * STAGE;
    if (++use == a.stages) {
      use = 0;
      phase ^= 1;
    }
    return st;
  };

  // ldmatrix lane roles. A tiles (16 rows x 16 k, row-major): row lane & 15,
  // k half lane >> 4. B pairs of n8 tiles from n-major rows (proj stages):
  // n ((lane >> 4) << 3) + (lane & 7), k half (lane >> 3) & 1; from
  // k-major rows (bank stages, .trans): k ((lane >> 3) & 1) * 8 + (lane &
  // 7), n half lane >> 4.
  const int a_row = lane & 15, a_k = (lane >> 4) * 8;
  const int b_n = ((lane >> 4) << 3) + (lane & 7), b_k = ((lane >> 3) & 1) * 8;
  const int bt_k = ((lane >> 3) & 1) * 8 + (lane & 7), bt_n = (lane >> 4) * 8;
  // bank warp tile: row tiles bwm and bwm + 4 by 32 columns, and of the
  // ninth row tile (rows 128..143) the n8 tile bwm of those 32 columns
  const int bwm = wid >> 1, bwn = wid & 1;
  // proj warp tile: 64 frames x 64 columns
  const int pwm = wid >> 2, pwn = wid & 3;

  float pacc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pacc[i][j][e] = 0.f;

  for (int k = 1; k <= a.K; ++k) {
    const int off = left - k / 2;
    const int krows = k * a.ki, subs = bank_subs(k, a.ki);
    for (int cc = 0; cc < a.n_cc; ++cc) {
      float bacc[2][4][4], bacc8[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) bacc[i][j][e] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) bacc8[e] = 0.f;
      // this chunk's folded BN, loaded now and stored before the pool
      const float bn_v = tid < 2 * CB
          ? (tid < CB ? a.bn_scale : a.bn_bias)[(long)(k - 1) * c_pad
                                                 + cc * CB + (tid & (CB - 1))]
          : 0.f;
      for (int q = 0; q < a.n_ci; ++q) {
        if (a.n_ci > 1) {
          __syncthreads();   // every warp is done with the last chunk
          load_halo(q);      // visible after the next acquire's barrier
        }
        int j = 0, ci = 0;   // the tap and channel of the next 16 rows
        for (int sub = 0; sub < subs; ++sub) {
          const bf16* st = acquire();
          const int width = min(KS, krows - sub * KS);
#pragma unroll 2
          for (int kk = 0; kk < width; kk += 16) {
            uint32_t bfr[4][2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              uint32_t r[4];
              ldsm_x4_t(r, smem_u32(st + (kk + bt_k) * LD + bwn * 32 + h * 16
                                    + bt_n));
              bfr[2 * h][0] = r[0];
              bfr[2 * h][1] = r[1];
              bfr[2 * h + 1][0] = r[2];
              bfr[2 * h + 1][1] = r[3];
            }
            const bf16* hrow = halo + (a_row + j + off) * hld + ci + a_k;
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              uint32_t af[4];
              ldsm_x4(af, smem_u32(hrow + (bwm + 4 * mi) * 16 * hld));
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_16816(bacc[mi][nt], af, bfr[nt][0], bfr[nt][1]);
            }
            // n8 tile bwm by selects: an index into bfr would put it in
            // local memory
            uint32_t b8[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              b8[e] = bwm == 0 ? bfr[0][e] : bwm == 1 ? bfr[1][e]
                      : bwm == 2 ? bfr[2][e] : bfr[3][e];
            uint32_t af[4];
            ldsm_x4(af, smem_u32(hrow + 8 * 16 * hld));
            mma_16816(bacc8, af, b8[0], b8[1]);
            ci += 16;
            if (ci == a.ki) {
              ci = 0;
              ++j;
            }
          }
        }
      }
      // the chunk's f32 bank rows; ReLU and BN follow in the pool pass
#pragma unroll
      for (int mi = 0; mi < 3; ++mi)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (mi == 2 && nt != bwm) continue;
          const float* acc = mi == 2 ? bacc8 : bacc[mi][nt];
          const int col = bwn * 32 + nt * 8 + 2 * tg;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int row = (mi == 2 ? 8 : bwm + 4 * mi) * 16 + g + hh * 8;
            if (row < BANK_USED)
              *reinterpret_cast<float2*>(ybuf + row * YLD + col) =
                  make_float2(acc[2 * hh], acc[2 * hh + 1]);
          }
        }
      if (tid < 2 * CB) bnp[tid] = bn_v;
      __syncthreads();
      // ReLU then the folded eval BN (reference order); pooled frame
      // u = t0 - 1 + r takes bank rows r (frame u-1) and r+1; masked in
      // f32, rounded to bf16, 0 outside [0, T). Warp w walks rows
      // [w * POOL_WARP_ROWS, ..) carrying the previous bank row; lane l
      // owns columns 2l, 2l+1.
      {
        const int col = 2 * lane, r0 = wid * POOL_WARP_ROWS;
        const int r1 = min(POOL_ROWS, r0 + POOL_WARP_ROWS);
        const float s0 = bnp[col], s1 = bnp[col + 1];
        const float b0 = bnp[CB + col], b1 = bnp[CB + col + 1];
        float2 y = *reinterpret_cast<const float2*>(ybuf + r0 * YLD + col);
        float p0 = fmaxf(y.x, 0.f) * s0 + b0, p1 = fmaxf(y.y, 0.f) * s1 + b1;
#pragma unroll 4
        for (int r = r0; r < r1; ++r) {
          y = *reinterpret_cast<const float2*>(ybuf + (r + 1) * YLD + col);
          const float v0 = fmaxf(y.x, 0.f) * s0 + b0;
          const float v1 = fmaxf(y.y, 0.f) * s1 + b1;
          const bool first = t0 - 1 + r == 0;   // the -inf left pad
          const float m = msk[r];
          *reinterpret_cast<__nv_bfloat162*>(pooled + r * LD + col) =
              __floats2bfloat162_rn((first ? v0 : fmaxf(p0, v0)) * m,
                                    (first ? v1 : fmaxf(p1, v1)) * m);
          p0 = v0;
          p1 = v1;
        }
      }
      // partial proj1 (the first acquire's barrier publishes the pooled
      // rows): pacc[t] += pooled[t + d] . proj[d] over this chunk
      for (int d = 0; d < 3; ++d) {
        const bf16* st = acquire();
#pragma unroll
        for (int kk = 0; kk < CB; kk += 16) {
          uint32_t af[4][4];
#pragma unroll
          for (int mi = 0; mi < 4; ++mi)
            ldsm_x4(af[mi], smem_u32(pooled + (pwm * 64 + mi * 16 + a_row + d)
                                                  * LD + kk + a_k));
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            uint32_t r[4];
            ldsm_x4(r, smem_u32(st + (pwn * 64 + h * 16 + b_n) * LD + kk
                                + b_k));
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
              mma_16816(pacc[mi][2 * h], af[mi], r[0], r[1]);
              mma_16816(pacc[mi][2 * h + 1], af[mi], r[2], r[3]);
            }
          }
        }
      }
    }
  }

  // ReLU then proj1's folded BN, rounded to bf16 once
  bf16* ob = a.out + item * a.T * a.p;
  const bool pairs = (a.p & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = p0 + pwn * 64 + nt * 8 + 2 * tg;
    if (col >= a.p) continue;
    const bool two = col + 1 < a.p;
    const float s0 = a.proj_scale[col], b0 = a.proj_bias[col];
    const float s1 = two ? a.proj_scale[col + 1] : 0.f;
    const float b1 = two ? a.proj_bias[col + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + pwm * 64 + mi * 16 + g + hh * 8;
        if (t >= a.T) continue;
        const float v0 = fmaxf(pacc[mi][nt][2 * hh], 0.f) * s0 + b0;
        const float v1 = fmaxf(pacc[mi][nt][2 * hh + 1], 0.f) * s1 + b1;
        bf16* o = ob + (long)t * a.p + col;
        if (two && pairs) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (two) o[1] = __float2bfloat16(v1);
        }
      }
  }
}

int launch_bf16(FrontArgs a, int B, int device, cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  // the plan of ops/hopper/cbhg.py::plan: ki a multiple of 16 covering
  // c_in in n_ci chunks, rows of whole 16-byte vectors, 2..4 stages
  if (a.ki <= 0 || a.ki % 16 || a.c_in % 8 || a.n_ci <= 0
      || (long)a.ki * a.n_ci < a.c_in || (long)a.ki * (a.n_ci - 1) >= a.c_in
      || a.stages < MIN_STAGES || a.stages > MAX_STAGES || a.K <= 0
      || a.n_cc <= 0 || a.p <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = BARS + (size_t)a.stages * STAGE * sizeof(bf16)
                      + (size_t)(BANK_ROWS + a.K - 1) * (a.ki + 8) * sizeof(bf16)
                      + (size_t)(BANK_USED * YLD + MASK_ROWS + 2 * CB)
                            * sizeof(float)
                      + (size_t)POOL_ROWS * LD * sizeof(bf16);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(cbhg_front_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  a.n_ttiles = (a.T + TM - 1) / TM;
  a.n_ptiles = (a.p + PT - 1) / PT;
  const long grid = (long)B * a.n_ttiles * a.n_ptiles;
  if (grid > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cbhg_front_mma_kernel<<<(unsigned)grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cbhg_front_f32(const float* x, const float* mask,
                              const float* bank_w, const float* bn_scale,
                              const float* bn_bias, const float* proj_w,
                              const float* proj_scale, const float* proj_bias,
                              float* out, int B, int T, int c_in, int c, int p,
                              int K, int ki, int n_ci, int stages, int device,
                              cudaStream_t stream) {
  (void)stages;
  return launch_f32(x, mask, bank_w, bn_scale, bn_bias, proj_w, proj_scale,
                    proj_bias, out, B, T, c_in, c, p, K, ki, n_ci, device,
                    stream);
}

// c is the padded bank width (a multiple of CB), c_in x's row width
extern "C" int cbhg_front_bf16(const void* x, const float* mask,
                               const void* bank, const float* bn_scale,
                               const float* bn_bias, const void* proj,
                               const float* proj_scale, const float* proj_bias,
                               void* out, int B, int T, int c_in, int c, int p,
                               int K, int ki, int n_ci, int stages, int device,
                               cudaStream_t stream) {
  if (c <= 0 || c % CB) return (int)cudaErrorInvalidValue;
  FrontArgs a;
  a.x = (const bf16*)x;
  a.mask = mask;
  a.bank = (const bf16*)bank;
  a.bn_scale = bn_scale;
  a.bn_bias = bn_bias;
  a.proj = (const bf16*)proj;
  a.proj_scale = proj_scale;
  a.proj_bias = proj_bias;
  a.out = (bf16*)out;
  a.T = T;
  a.c_in = c_in;
  a.p = p;
  a.K = K;
  a.ki = ki;
  a.n_ci = n_ci;
  a.n_cc = c / CB;
  a.stages = stages;
  return launch_bf16(a, B, device, stream);
}
