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
// _highway_kernel): the same layers on rows x, with no input stage. Each
// dtype has one template; PRE selects the residual add and the
// pre-projection.
//
// Bound on an H100: operations. Each layer is a [rows, C] x [C, 2C] product
// (8.4 MFLOP per 16 rows at C=256) against 0.26 MB of bf16 weights; one
// bf16 serving call (prenet 331,776 rows of 256 -> 256, postnet 1,048,576
// rows of 80 -> 256, 4 layers each) is 1.53 TFLOP, 1.55 ms at the 989
// TFLOP/s bf16 peak. In both designs the tile's activation stays in shared
// memory across the pre-projection and every layer (it never returns to
// device memory between layers, as in the TPU kernel), two buffers
// ping-pong between layers.
//
// bf16 entries (highway_mma_kernel<MT, NT, PRE>): tensor cores, mma.sync
// m16n8k16 with f32 accumulation, operands by ldmatrix (the same product
// code as cbhg_front.cu; wgmma is later work). 256 threads (8 warps).
//   - Row tile: the largest that leaves two ring stages beside the two bf16
//     activation buffers: 128 rows to 256 channels (the CBHGs' width), 64
//     to 640, 32 to 1,408, 16 to 2,816, then fewer than 16 rows (m16 tiles
//     whose missing rows read a zero row), so every width the f32 entry
//     takes is taken.
//   - A layer runs in chunks of 128 output columns. The wrapper packs
//     [W1 | W2] so that a chunk's h and g columns land in the same warp's
//     accumulators at the same places: each warp owns G output columns of
//     the chunk (G = 32 at 128 rows: warps 2 x 4, each 64 rows x 32 h + 32
//     g columns, a [64, 64] f32 accumulator pair, 128 registers; G = 16 at
//     the smaller tiles, warps 1 x 8), so the blend is thread-local. The
//     pre-projection runs in chunks of 256 output columns.
//   - Weights stream through a ring of 2-4 stages, each [256 columns, 32
//     k] of one chunk: the wrapper packs every stage as one contiguous
//     block that is its shared-memory image (rows padded to 40 elements),
//     so one thread moves it with one bulk copy (TMA, mbarrier
//     completion). Per-thread cp.async copies, the first design, spent
//     more time issuing and waiting than the products took.
//   - L2: each 128-row tile reads every layer's weights once, ~1.1 MB at
//     the postnet (80 -> 256, 4 layers of 256 -> 512): ~9 GB at the bf16
//     serving call's postnet and ~3 GB at its prenet, ~3 ms at the ~4.1
//     TB/s measured for L2 in this port (PERF.md, section 6), which the ring
//     overlaps with the products (at 32 rows it was ~49 GB).
//   - Shared memory at C = 256, 128 rows: 4 stages x 20,480 B, two
//     activation buffers and a zero row of 264 bf16 a row, the ring's
//     mbarriers: 217,680 B.
//   - The blend's sigmoid is branch-free (expf of -|v| and a refined
//     approximate reciprocal, as rnn.cu's gates): the IEEE division's
//     slow-path branch kept ptxas from interleaving a thread's 64 outputs.
//   Activations hold bf16 values, rounded where the TPU kernels round:
//   a + res, the pre-projection's output and each layer's output
//   (_pre_highway_kernel and _highway_kernel cast x to the input dtype at
//   those points); products and the blend run in f32.
//
// f32 entries (highway_kernel<ROWS, PRE>): FP32 FMA (tensor cores in f32
// would be TF32). Thread j owns output column j (both its h and g halves)
// for all ROWS rows: each weight element it loads from L2 feeds ROWS FMAs,
// and each float4 of activations is a shared-memory broadcast to the whole
// warp. Two f32 tiles of ROWS x max(C_in, C) must fit a block's 232,448
// bytes of shared memory, so ROWS is 32 up to 908 channels and halves,
// down to 1 row (29,056 channels), as the width grows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int SMEM_BYTES = 232448;

// ------------------------------------------------------ f32 entries (FMA)

template <int ROWS, bool PRE>
__global__ void __launch_bounds__(THREADS)
highway_kernel(const float* __restrict__ a,        // [n, c_in]
               const float* __restrict__ res,      // [n, c_in] (PRE)
               const float* __restrict__ pre_w,    // [c_in, c] (PRE)
               const float* __restrict__ w,        // [L, c, 2c]
               const float* __restrict__ b,        // [L, 2c]
               float* __restrict__ out,            // [n, c]
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
    if (row0 + r < n) v = PRE ? a[g] + res[g] : a[g];
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
  }

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

// rows per tile for rows of `width` channels: the largest of 32, 16, .., 1
// whose two f32 tiles fit shared memory, or 0 where even one row does not
inline int tile_rows(int width) {
  for (int r = 32; r >= 1; r /= 2)
    if ((size_t)2 * r * width * sizeof(float) <= SMEM_BYTES) return r;
  return 0;
}

template <int ROWS, bool PRE>
int launch_rows(const float* a, const float* res, const float* pre_w,
                const float* w, const float* b, float* out, int n, int c_in,
                int c, int n_layers, cudaStream_t stream) {
  const int width = c_in > c ? c_in : c;
  const size_t smem = 2 * ROWS * width * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      highway_kernel<ROWS, PRE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n + ROWS - 1) / ROWS;
  highway_kernel<ROWS, PRE><<<grid, THREADS, smem, stream>>>(
      a, res, pre_w, w, b, out, n, c_in, c, n_layers);
  return (int)cudaGetLastError();
}

template <bool PRE>
int launch_f32(const float* a, const float* res, const float* pre_w,
               const float* w, const float* b, float* out, int n, int c_in,
               int c, int n_layers, int device, cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  switch (tile_rows(c_in > c ? c_in : c)) {
#define HIGHWAY_ROWS(R)                                                   \
    case R:                                                               \
      return launch_rows<R, PRE>(a, res, pre_w, w, b, out, n, c_in, c,    \
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

// ------------------------------------------------ bf16 entries (mma.sync)

constexpr int KS = 32;                 // k per ring stage
constexpr int LD = KS + 8;             // stage row stride, elements
constexpr int STAGE = 256 * LD;        // one stage: 256 columns x KS
constexpr int MIN_STAGES = 2, MAX_STAGES = 4;
constexpr int BARS = 64;               // bytes for the ring's mbarriers

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

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 1 / y for y in [1, 2]: the approximate reciprocal and one Newton step,
// within an ulp
__device__ __forceinline__ float rcp_1_2(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return fmaf(r, fmaf(-y, r, 1.f), r);
}

// sigmoid to a few ulp (expf's 2, the reciprocal's 1) without the IEEE
// division's slow-path branch, as rnn.cu's step-major gates: e = exp(-|v|)
// lies in (0, 1], so 1 + e needs no range check
__device__ __forceinline__ float sigmoid_nb(float v) {
  const float e = expf(-fabsf(v));
  const float r = rcp_1_2(1.f + e);
  return v >= 0.f ? r : e * r;
}

struct HighwayArgs {
  const bf16* a;       // [n, c_in]
  const bf16* res;     // [n, c_in] (PRE)
  const bf16* pre_t;   // [n_pre, c_in_p / KS, 256, LD]: pre_w^T (PRE)
  const bf16* w;       // [L, cp / 128, cp / KS, 256 (h, g by group), LD]
  const float* b;      // [L, 2c]
  bf16* out;           // [n, c]
  int n, c_in, c_in_p, c, cp, n_layers, rows, stages;
};

// The weight stages in the order the CTA consumes them: the
// pre-projection's chunks of 256 output columns (PRE), then each layer's
// chunks of 128 output columns (256 h and g columns), KS k at a time;
// each stage one contiguous block of the packed weights, its
// shared-memory image.
struct Cursor {
  int phase, l = 0, oc = 0, ks = 0;   // phase 0 pre, 1 layers, 2 done
};

// (thread 0) the cursor's stage into `stage` by one bulk copy, completing
// on `bar`; advance the cursor
__device__ __forceinline__ void issue(bf16* stage, uint32_t bar, Cursor& cur,
                                      const HighwayArgs& a) {
  if (cur.phase == 2) return;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const bool pre = cur.phase == 0;
  const int n_ks = (pre ? a.c_in_p : a.cp) / KS;
  const bf16* src =
      pre ? a.pre_t + ((long)cur.oc * n_ks + cur.ks) * STAGE
          : a.w + (((long)cur.l * (a.cp / 128) + cur.oc) * n_ks + cur.ks)
                * STAGE;
  bulk_load(smem_u32(stage), src, STAGE * 2, bar);
  if (++cur.ks == n_ks) {
    cur.ks = 0;
    ++cur.oc;
    if (pre && cur.oc * 256 >= a.cp) {
      cur.oc = 0;
      cur.phase = a.n_layers > 0 ? 1 : 2;
    } else if (!pre && cur.oc * 128 >= a.cp) {
      cur.oc = 0;
      if (++cur.l == a.n_layers) cur.phase = 2;
    }
  }
}

// MT 16-row tiles and NT n8 column tiles per warp; warps WM x WN over the
// row tile; a layer's n8 tiles are NT/2 of h, then NT/2 of g
template <int MT, int NT, bool PRE>
__global__ void __launch_bounds__(THREADS, 1)
highway_mma_kernel(const HighwayArgs a) {
  constexpr int WM = NT == 8 ? 2 : 1, WN = 8 / WM;
  constexpr int G = NT / 2 * 8;          // output columns per warp (layers)
  static_assert(WN * G == 128 && WN * NT * 8 == 256, "warp tiling");
  extern __shared__ float4 smem4[];
  const int width = a.c_in_p > a.cp ? a.c_in_p : a.cp;
  const int xld = width + 8;             // activation row stride
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);   // [stages]
  bf16* ring = reinterpret_cast<bf16*>(reinterpret_cast<char*>(smem4) + BARS);
  bf16* src = ring + a.stages * STAGE;           // [rows][xld]
  bf16* dst = src + a.rows * xld;                // [rows][xld]
  bf16* zero = dst + a.rows * xld;               // [xld]
  const int row0 = blockIdx.x * a.rows;
  const int tid = threadIdx.x, wid = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = wid / WN, wn = wid % WN;

  Cursor cur;
  cur.phase = PRE ? 0 : (a.n_layers > 0 ? 1 : 2);
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(smem_u32(bars + s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < a.stages - 1; ++s)
      issue(ring + s * STAGE, smem_u32(bars + s), cur, a);
  }

  // input stage, 4 channels at a time: round(a + res) (PRE) or the rows
  // themselves; zero past n and past the input width, and the zero row
  const int c_src = PRE ? a.c_in : a.c;
  const int q_in = c_src / 4, q_all = width / 4;
#pragma unroll 4
  for (int i = tid; i < a.rows * q_in; i += THREADS) {
    const int r = i / q_in, v = (i - r * q_in) * 4;
    uint2 val = make_uint2(0, 0);
    if (row0 + r < a.n) {
      const long gi = (long)(row0 + r) * c_src + v;
      val = *reinterpret_cast<const uint2*>(a.a + gi);
      if constexpr (PRE) {
        const uint2 rv = *reinterpret_cast<const uint2*>(a.res + gi);
        const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&val);
        const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv);
        __nv_bfloat162 s0 = __floats2bfloat162_rn(
            __low2float(x2[0]) + __low2float(r2[0]),
            __high2float(x2[0]) + __high2float(r2[0]));
        __nv_bfloat162 s1 = __floats2bfloat162_rn(
            __low2float(x2[1]) + __low2float(r2[1]),
            __high2float(x2[1]) + __high2float(r2[1]));
        val.x = *reinterpret_cast<uint32_t*>(&s0);
        val.y = *reinterpret_cast<uint32_t*>(&s1);
      }
    }
    *reinterpret_cast<uint2*>(src + r * xld + v) = val;
  }
  for (int i = tid; i < a.rows * (q_all - q_in); i += THREADS) {
    const int r = i / (q_all - q_in), v = (q_in + i - r * (q_all - q_in)) * 4;
    *reinterpret_cast<uint2*>(src + r * xld + v) = make_uint2(0, 0);
  }
  for (int i = tid; i < xld / 4; i += THREADS)
    *reinterpret_cast<uint2*>(zero + i * 4) = make_uint2(0, 0);
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
      issue(ring + refill * STAGE, smem_u32(bars + refill), cur, a);
    }
    const bf16* st = ring + use * STAGE;
    if (++use == a.stages) {
      use = 0;
      phase ^= 1;
    }
    return st;
  };

  // ldmatrix lane roles (see cbhg_front.cu); A rows past `rows` read the
  // zero row
  const int a_k = (lane >> 4) * 8;
  const int b_n = ((lane >> 4) << 3) + (lane & 7), b_k = ((lane >> 3) & 1) * 8;
  int a_row[MT];   // the lane's A row of each tile, -1 past `rows`
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int r = (wm * MT + mi) * 16 + (lane & 15);
    a_row[mi] = r < a.rows ? r : -1;
  }

  float acc[MT][NT][4];
  // acc = x[:, :kdim] @ the chunk's columns, its stages acquired in turn
  auto product = [&](const bf16* x, int kdim) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.f;
    for (int k0 = 0; k0 < kdim; k0 += KS) {
      const bf16* st = acquire();
#pragma unroll
      for (int kk = 0; kk < KS; kk += 16) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          const bf16* base = a_row[mi] < 0 ? zero : x + a_row[mi] * xld;
          ldsm_x4(af[mi], smem_u32(base + k0 + kk + a_k));
        }
#pragma unroll
        for (int h = 0; h < NT / 2; ++h) {
          uint32_t r[4];
          ldsm_x4(r, smem_u32(st + (wn * NT * 8 + h * 16 + b_n) * LD + kk
                              + b_k));
#pragma unroll
          for (int mi = 0; mi < MT; ++mi) {
            mma_16816(acc[mi][2 * h], af[mi], r[0], r[1]);
            mma_16816(acc[mi][2 * h + 1], af[mi], r[2], r[3]);
          }
        }
      }
    }
  };

  if constexpr (PRE) {
    // pre_highway projection in chunks of 256 columns: dst = round(src @ pre_w)
    for (int oc = 0; oc * 256 < a.cp; ++oc) {
      product(src, a.c_in_p);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = oc * 256 + wn * NT * 8 + nt * 8 + 2 * tg;
          if (col >= a.cp) continue;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = (wm * MT + mi) * 16 + g + hh * 8;
            if (r < a.rows)
              *reinterpret_cast<__nv_bfloat162*>(dst + r * xld + col) =
                  __floats2bfloat162_rn(acc[mi][nt][2 * hh],
                                        acc[mi][nt][2 * hh + 1]);
          }
        }
    }
    bf16* t = src; src = dst; dst = t;
  }

  for (int l = 0; l < a.n_layers; ++l) {
    const float* bl = a.b + (long)l * 2 * a.c;
    for (int oc = 0; oc * 128 < a.cp; ++oc) {
      product(src, a.cp);
      // x = round(x + sigmoid(g) * (relu(h) - x)), thread-local
#pragma unroll
      for (int nt = 0; nt < NT / 2; ++nt) {
        const int col = oc * 128 + wn * G + nt * 8 + 2 * tg;
        float bh[2], bg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool live = col + e < a.c;
          bh[e] = live ? bl[col + e] : 0.f;
          bg[e] = live ? bl[a.c + col + e] : 0.f;
        }
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = (wm * MT + mi) * 16 + g + hh * 8;
            if (r >= a.rows) continue;
            const __nv_bfloat162 x2 =
                *reinterpret_cast<const __nv_bfloat162*>(src + r * xld + col);
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float xv = e ? __high2float(x2) : __low2float(x2);
              const float hv = fmaxf(acc[mi][nt][2 * hh + e] + bh[e], 0.f);
              const float gv =
                  sigmoid_nb(acc[mi][nt + NT / 2][2 * hh + e] + bg[e]);
              v[e] = xv + gv * (hv - xv);
            }
            *reinterpret_cast<__nv_bfloat162*>(dst + r * xld + col) =
                __floats2bfloat162_rn(v[0], v[1]);
          }
      }
    }
    bf16* t = src; src = dst; dst = t;
  }
  __syncthreads();

  for (int i = tid; i < a.rows * (a.c / 4); i += THREADS) {
    const int r = i / (a.c / 4), v = (i - r * (a.c / 4)) * 4;
    if (row0 + r < a.n)
      *reinterpret_cast<uint2*>(a.out + (long)(row0 + r) * a.c + v) =
          *reinterpret_cast<const uint2*>(src + r * xld + v);
  }
}

template <int MT, int NT, bool PRE>
int launch_mma(const HighwayArgs& a, cudaStream_t stream) {
  constexpr int TM = 16 * MT * (NT == 8 ? 2 : 1);
  if (a.rows <= 0 || a.rows > TM || (TM > 16 && a.rows != TM))
    return (int)cudaErrorInvalidValue;
  const int width = a.c_in_p > a.cp ? a.c_in_p : a.cp;
  const size_t smem = BARS + (size_t)a.stages * STAGE * sizeof(bf16)
                      + (size_t)(2 * a.rows + 1) * (width + 8) * sizeof(bf16);
  if (smem > SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      highway_mma_kernel<MT, NT, PRE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long grid = ((long)a.n + a.rows - 1) / a.rows;
  if (grid > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  highway_mma_kernel<MT, NT, PRE><<<(unsigned)grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the plan of ops/hopper/highway.py::plan: (MT, NT) one of the four tiles,
// C_in_p a multiple of KS, cp of 128, 2..4 stages
template <bool PRE>
int launch_bf16(const HighwayArgs& a, int mt, int nt, int device,
                cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (a.c_in_p % KS || a.c_in_p < a.c_in || a.cp % 128 || a.cp < a.c
      || a.c_in % 4 || a.c % 4 || a.c <= 0 || a.stages < MIN_STAGES
      || a.stages > MAX_STAGES || a.n_layers < 0)
    return (int)cudaErrorInvalidValue;
  if (mt == 4 && nt == 8) return launch_mma<4, 8, PRE>(a, stream);
  if (mt == 4 && nt == 4) return launch_mma<4, 4, PRE>(a, stream);
  if (mt == 2 && nt == 4) return launch_mma<2, 4, PRE>(a, stream);
  if (mt == 1 && nt == 4) return launch_mma<1, 4, PRE>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pre_highway_stack_f32(const float* a, const float* res,
                                     const float* pre_w, const float* w,
                                     const float* b, float* out, int n,
                                     int c_in, int c, int n_layers,
                                     int device, cudaStream_t stream) {
  return launch_f32<true>(a, res, pre_w, w, b, out, n, c_in, c, n_layers,
                          device, stream);
}

extern "C" int highway_stack_f32(const float* x, const float* w,
                                 const float* b, float* out, int n, int c,
                                 int n_layers, int device,
                                 cudaStream_t stream) {
  return launch_f32<false>(x, nullptr, nullptr, w, b, out, n, c, c,
                           n_layers, device, stream);
}

// pre_t, w: packed by ops/hopper/highway.py::pack_weights for the plan
// (rows, mt, nt, stages)
extern "C" int pre_highway_stack_bf16(const void* a, const void* res,
                                      const void* pre_t, const void* w,
                                      const float* b, void* out, int n,
                                      int c_in, int c_in_p, int c, int cp,
                                      int n_layers, int rows, int mt, int nt,
                                      int stages, int device,
                                      cudaStream_t stream) {
  const HighwayArgs args{(const bf16*)a, (const bf16*)res, (const bf16*)pre_t,
                         (const bf16*)w, b, (bf16*)out, n, c_in, c_in_p, c,
                         cp, n_layers, rows, stages};
  return launch_bf16<true>(args, mt, nt, device, stream);
}

extern "C" int highway_stack_bf16(const void* x, const void* w,
                                  const float* b, void* out, int n, int c,
                                  int cp, int n_layers, int rows, int mt,
                                  int nt, int stages, int device,
                                  cudaStream_t stream) {
  const HighwayArgs args{(const bf16*)x, nullptr, nullptr, (const bf16*)w, b,
                         (bf16*)out, n, c, cp, c, cp, n_layers, rows, stages};
  return launch_bf16<false>(args, mt, nt, device, stream);
}
