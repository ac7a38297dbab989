// One whole HiFi-GAN MRF level (multi-receptive-field fusion), in f32 or
// bf16, alone (mrf_*) or behind its level's leaky and transposed-conv
// upsample on phase-stacked activations (ups_mrf_*).
//
// mrf_* replaces forwardtacotron_tpu/ops/pallas/mrf.py::mrf_pallas (kernel
// body _mrf_kernel). On channels-major x [B, C, T], per kernel size kr:
//   cur = x
//   for each dilation d:  y   = conv(kr, d)(leaky(cur) * mask) (+ b1)
//                         cur = cur + conv(kr, 1)(leaky(y) * mask) (+ b2)
//   acc += cur                                   (float32)
// out = round(acc / n_branches) * mask
// with mask = 1 at positions in [0, T): every convolution sees zeros outside
// the sequence (torch's zero padding at the true sequence ends). Tap j of a
// convolution reads the sample (j - kr / 2) * d away, for odd and even kr.
//
// ups_mrf_* replaces mrf.py::ups_mrf_pallas (kernel body _ups_mrf_kernel):
// one level of the phase-stacked tail. x [B, s_in*C_in, T_ps] holds input
// sample s_in*t + r of channel c at row r*C_in + c, lane t; lanes at or past
// t_valid are padding. The level computes
//   u   = round(conv_transpose(leaky(x) * mask_in, stride s_up) + b_up)
//   out = the MRF above on u, written phase-stacked: [B, s_out*C, T_ps] with
//         s_out = s_in * s_up, 0 at padding lanes.
// The phase-stacked layout is the contract in device memory only: each CTA
// de-interleaves its input tile into sample order in shared memory and
// computes the upsample there as one product per output phase of the stride
// (the taps of that phase on consecutive input rows, so no zero is ever
// multiplied); the interleave is an address computation on the tile's load
// and on the output's store.
//
// Rounding points, in the activation's type T: leaky = max(v, round(s * v))
// with s = 0.1 in T; each convolution's f32 product, then its bias added,
// where the bias is in T (mrf_*); the f32 product plus the f32 bias, rounded
// once, where the bias is f32 (ups_mrf_*: the TPU kernel stacks its biases
// in f32, mrf.py:247); cur + y2. The branch sum is f32 and divided (not
// multiplied) by the count. ups_mrf_*: the upsample's f32 sum plus its f32
// bias, rounded once.
//
// Bound on an H100: operations. One level is 2 * C^2 * (2 * U * sum(kr)) * T
// FLOPs per item (126 convolution taps for kr = 3, 7, 11 and U = 3): 63 * C
// FLOPs per byte of bf16 input and output, far above the 295 at which the
// bf16 tensor cores become the limit, and 31.5 * C in f32, far above the f32
// FMA units' 20. The upsample adds 2 * C_in * C * k / s_up FLOPs per output
// sample (3% at HiFi-GAN v1's levels 2 and 3). HiFi-GAN v1's four levels at
// batch 128 x 256 frames: 19.5 TFLOP, 19.7 ms at the bf16 peak.
//
// Design. One CTA per (batch item, time tile, channel slice). The tile's
// window of TW = t_tile + 2 * HALO samples stays in shared memory through
// every convolution of the level, so no intermediate touches device memory:
// what the TPU kernel keeps in VMEM stays on chip here too. Blocks run in no
// order, so each recomputes its own halo; each convolution computes only the
// rows that later convolutions of its branch still read (the exact region
// widens by every later convolution's span), and a branch loads only the
// input rows it reads.
//   - Channel slices. A CTA owns CS output channels (16, 32 or 64) of its
//     tile; where C > CS, the C / CS CTAs of a tile form a thread-block
//     cluster. Each keeps its slice of `cur` (the branch's running
//     residual), `ybuf` (leaky(y) * mask of a unit's first convolution) and,
//     for ups_mrf, `ubuf` (the upsample's output, kept across the branches)
//     over the whole window, plus `src`, the full-width source of the next
//     convolution: after each convolution the CTAs meet at a cluster
//     barrier and every CTA copies its peers' slices of what was just
//     written into its `src` through distributed shared memory
//     (ld.shared::cluster), applying leaky as it copies where the source is
//     cur. One barrier per convolution, 18 per level, not one per tap: the
//     copy reads the buffer the last convolution wrote and the next one
//     writes the other, so the next barrier protects both.
//   - bf16 products on wgmma (m64nCSk16, f32 accumulation), A and B both
//     from shared memory: time is the M dimension, 64-row tiles, N = CS, K
//     = the source's channels. The window buffers are planar, 8-channel
//     planes of rows of 16 bytes, so any 8 consecutive rows of a plane are
//     one 128-byte core matrix: a tile shifted by any tap offset (j - kr/2)
//     * d is a descriptor (8-row groups 128 B apart, planes one plane
//     apart), with no ldmatrix and no A registers. wgmma cannot apply the
//     leaky, so the first convolution's source is the activated copy in
//     `src` (with one CTA per tile the second convolution writes it beside
//     the residual; with clusters the copy applies it). Two consumer
//     warpgroups take alternate M tiles (up to 3 each: a window of 384
//     rows); tile t starts at min(64 t, rows - 64), so no tile reads past
//     the product's rows, and the tile count is a template argument of the
//     main loop (a branch between wgmmas makes ptxas serialize them). The
//     weights are the B operand: the wrapper packs every ring stage as its
//     shared-memory image in core matrices ([CS, 64] bf16, K-major, the
//     CTA's channels only: a 64-column K chunk of one tap, or 64 / K taps
//     side by side where K < 64), and a producer warp moves each with one
//     bulk copy (TMA) into a ring of `stages` slots guarded by full / empty
//     mbarriers, in the order the consumers use them, across convolution
//     boundaries. One stage's products stay in flight while the next
//     stage's are issued. Epilogues (bias, leaky, mask, residual, branch
//     sum) run on bf16x2 pairs at the scalar formulas' rounding points.
//     They do not overlap the products: each convolution reads rows that
//     every tile of the one before wrote, and every tile of a warpgroup
//     shares each weight stage, so an epilogue could overlap only by
//     streaming the weights once per tile or holding two convolutions'
//     accumulators (registers: 96 of the 168 a thread has at 288 threads).
//     What an overlap could save at most, measured by the cycle spans
//     below on an H100 at HiFi-GAN v1's levels (batch 128 x 256 frames):
//     the epilogues take 11-12% of a CTA's cycles at C <= 64 and in
//     ups_mrf, 2-5% at C >= 128; the products take 60-74%.
//   - f32 products on FP32 FMA (TF32 would miss the f32 gate): a thread
//     owns 4 output channels x 8 rows, weights as float4 through the
//     read-only cache, activations as float4 from row-major buffers; 512
//     threads, no ring; the first convolution applies leaky as it loads.
//   - The f32 branch sum of the tile's own rows lives in shared memory
//     ([t_tile, CS + 1]); the last convolution of each branch adds to it in
//     its epilogue, and the tile's output is stored from it once.
//   - ups_mrf: the input tile ([TW / s_up + 17 rows, C_in] in sample order,
//     leaky applied) shares its bytes with src, ybuf and the sum, which are
//     dead while the upsample runs; u is computed once into ubuf (one
//     product per output phase of the stride) and copied into cur at each
//     branch's start. Any rate with s_in * s_up <= 4, any k_up whose taps
//     reach at most IN_HALO input rows.
// The launch plan (CS, t_tile, ring stages, the shared-memory carve) comes
// from the wrapper (mrf.py ``plan``, which needs no card); the entries
// recompute the carve and refuse a plan that does not fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "device_guard.cuh"

// Cycle spans, compiled in only with -DMRF_CYCLES (chip_smoke.py builds
// a second copy of this library with it for its "mrf cycle spans" lines):
// the clock64() cycles thread 0 of CTA (0, 0) (the producer spans: the
// producer warp's lane 0) spends in each part of the kernel, summed over
// the launches since mrf_cycles(h, 1) set them to 0.
enum CycleSpan {
  CY_RING_WAIT, CY_PRODUCTS, CY_EPILOGUES, CY_CLUSTER_SYNC, CY_BRANCH_START,
  CY_KERNEL, CY_PRODUCER_EMPTY_WAIT, CY_PRODUCER_CLUSTER_WAIT, CY_SPANS
};
#ifdef MRF_CYCLES
__device__ unsigned long long g_cycles[CY_SPANS];
#define SPAN_START(v) const long long v = clock64()
#define SPAN_END(span, v, who)                                        \
  do {                                                                \
    if ((who) && blockIdx.x == 0 && blockIdx.y == 0)                  \
      atomicAdd(&g_cycles[span], (unsigned long long)(clock64() - v)); \
  } while (0)
#else
#define SPAN_START(v)
#define SPAN_END(span, v, who)
#endif

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HALO = 64;
constexpr int IN_HALO = 8;      // input rows of halo on each side of the tile
// The level's branches (kernel sizes) and units (dilations) travel in the
// launch's parameter block (Params, ~1.7 KB of the 4 KB a launch takes).
// Every unit of a kernel size of at least 2 adds at least 2 samples to its
// branch's span, which the halo bounds: HALO / 2 units; branches are held
// to the same count (mrf.py MAX_BRANCHES, MAX_UNITS).
constexpr int MAX_BRANCHES = HALO / 2;
constexpr int MAX_UNITS = HALO / 2;
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 8;
constexpr int KC = 64;          // K columns of a ring stage
constexpr int MT_MAX = 3;       // 64-row M tiles per consumer warpgroup
constexpr int MAX_TW = 2 * 64 * MT_MAX;
constexpr int SMEM_LIMIT = 232448;
constexpr int GUARD = 1024;    // bytes of zeros before cur: 64 rows of a plane

template <typename T> struct Cfg;
template <> struct Cfg<bf16> {
  static constexpr int CONSUMERS = 256;   // two warpgroups
  static constexpr int THREADS = 288;     // + the producer warp
  static constexpr int PAD = 0;           // planar: no row padding
};
template <> struct Cfg<float> {
  static constexpr int CONSUMERS = 512;
  static constexpr int THREADS = 512;
  static constexpr int PAD = 4;
};

__host__ __device__ inline size_t al128(size_t n) {
  return (n + 127) & ~(size_t)127;
}

// Shared memory of one CTA, byte offsets in carve order: the ring (bf16),
// its mbarriers, a zero guard (bf16: a tile's rows shifted before the
// window read it), cur, ubuf (ups_mrf), src (bf16, and f32 clusters), ybuf,
// the f32 branch sum; the ups_mrf input tile starts at src and may reach
// past the sum. bf16 buffers are planar (no row padding), f32 rows padded
// by 16 bytes. mrf.py ``carve`` repeats this computation.
struct Carve {
  size_t ring, bars, guard, cur, ubuf, src, ybuf, sum, total;
};

__host__ __device__ inline Carve carve(int elt, int c, int cs, int t_tile,
                                       int stages, bool ups, int c_in,
                                       int in_rows) {
  const bool mma = elt == 2;
  const int pad = mma ? 0 : 16 / elt;
  const int tw = t_tile + 2 * HALO;
  const size_t slice = al128((size_t)tw * (cs + pad) * elt);
  Carve v;
  v.ring = 0;
  v.bars = mma ? (size_t)stages * cs * KC * 2 : 0;
  v.guard = v.bars + al128(2 * MAX_STAGES * 8);
  v.cur = v.guard + (mma ? GUARD : 0);
  v.ubuf = v.cur + slice;
  v.src = v.ubuf + (ups ? slice : 0);
  v.ybuf = v.src + (mma || cs < c ? al128((size_t)tw * (c + pad) * elt) : 0);
  v.sum = v.ybuf + slice;
  v.total = v.sum + al128((size_t)t_tile * (cs + 1) * 4);
  if (ups) {
    const size_t tile_end = v.src + al128((size_t)in_rows * (c_in + pad) * elt);
    if (tile_end > v.total) v.total = tile_end;
  }
  return v;
}

struct Branch {
  const void* w1;
  const void* b1;
  const void* w2;
  const void* b2;
  int kr;
};

struct Params {
  Branch br[MAX_BRANCHES];
  int n_br;
  int dils[MAX_UNITS];
  int n_units;
  const void* x;
  void* out;
  const bf16* packed;     // bf16: the ring's stage images, rank after rank
  long long rank_elems;   // elements of packed per cluster rank
  int c;                  // channels (padded), cs per CTA, n CTAs per tile
  int cs, n;
  int t_tile;
  int t;                  // mrf: sequence length; ups_mrf: lanes T_ps
  int stages;
  // ups_mrf only
  const void* up_w;       // f32: [k_up, C, C_in], taps reversed
  const float* up_b;      // [C]
  int c_in, s_in, s_up, k_up, t_valid, in_rows;
  Carve cv;
};

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

// leaky(v) = max(v, s * v), slope and product in T
template <typename T>
__device__ __forceinline__ float leaky(float v) {
  const float s = rnd<T>(0.1f);
  return fmaxf(v, rnd<T>(s * v));
}

__device__ __forceinline__ uint32_t leaky2(uint32_t v) {
  const __nv_bfloat162 s2 = __float2bfloat162_rn(0.1f);
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hmax2(h, __hmul2(h, s2));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Pairs of adjacent channels, the unit of the epilogues: the rounding
// points of the scalar formulas, on bf16x2 where the activations are bf16
// (an add or product of two bf16 values rounded once, as torch's bf16
// arithmetic rounds it).
template <typename T> struct Pair;
template <> struct Pair<bf16> { typedef __nv_bfloat162 type; };
template <> struct Pair<float> { typedef float2 type; };

__device__ __forceinline__ __nv_bfloat162 p_add(__nv_bfloat162 a,
                                                __nv_bfloat162 b) {
  return __hadd2(a, b);
}
__device__ __forceinline__ float2 p_add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ __nv_bfloat162 p_leaky(__nv_bfloat162 v) {
  return __hmax2(v, __hmul2(v, __float2bfloat162_rn(0.1f)));
}
__device__ __forceinline__ float2 p_leaky(float2 v) {
  return make_float2(leaky<float>(v.x), leaky<float>(v.y));
}
__device__ __forceinline__ float p_lo(__nv_bfloat162 v) { return __low2float(v); }
__device__ __forceinline__ float p_hi(__nv_bfloat162 v) { return __high2float(v); }
__device__ __forceinline__ float p_lo(float2 v) { return v.x; }
__device__ __forceinline__ float p_hi(float2 v) { return v.y; }

// a product pair plus its bias pair, rounded to the activation's type: a
// bf16 bias follows the product's own rounding, an f32 bias joins the f32
// product (in f32 the two orders agree)
__device__ __forceinline__ __nv_bfloat162 p_bias(float a0, float a1,
                                                 __nv_bfloat162 b) {
  return __hadd2(__floats2bfloat162_rn(a0, a1), b);
}
__device__ __forceinline__ __nv_bfloat162 p_bias(float a0, float a1,
                                                 float2 b) {
  return __floats2bfloat162_rn(a0 + b.x, a1 + b.y);
}
__device__ __forceinline__ float2 p_bias_f(float a0, float a1, float2 b) {
  return make_float2(a0 + b.x, a1 + b.y);
}

template <typename T>
__device__ __forceinline__ typename Pair<T>::type p_load(const T* a) {
  return *reinterpret_cast<const typename Pair<T>::type*>(a);
}
template <typename B>
__device__ __forceinline__ typename Pair<B>::type bias_pair(const B* b) {
  if constexpr (sizeof(B) == 2) {
    return __halves2bfloat162(b[0], b[1]);
  } else {
    return make_float2(b[0], b[1]);
  }
}

// VEC = 16 / sizeof(T) values into 16 bytes of T, leaky applied where asked
__device__ __forceinline__ void st_vec(bf16* dst, const float* v, bool act) {
  uint4 w;
  uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    if (act) h = p_leaky(h);
    u[k] = *reinterpret_cast<uint32_t*>(&h);
  }
  *reinterpret_cast<uint4*>(dst) = w;
}
__device__ __forceinline__ void st_vec(float* dst, const float* v, bool act) {
  float4 w = make_float4(v[0], v[1], v[2], v[3]);
  if (act) {
    w.x = leaky<float>(w.x);
    w.y = leaky<float>(w.y);
    w.z = leaky<float>(w.z);
    w.w = leaky<float>(w.w);
  }
  *reinterpret_cast<float4*>(dst) = w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ cluster

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

// every thread of every CTA of the cluster: writes before it are seen by
// reads after it, in every CTA's shared memory
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the consumer threads of this CTA
template <typename T>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(Cfg<T>::CONSUMERS) : "memory");
}

// 16 bytes at the same shared-memory offset in cluster CTA `rank`
__device__ __forceinline__ uint4 ld_peer(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(remote)
               : "memory");
  return v;
}

// ------------------------------------------------- ring and tensor cores

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
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
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// wgmma m64nNk16, bf16 x bf16 -> f32, A and B K-major in shared memory:
// D += A B, N = 2 x the accumulator's length
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// ---------------------------------------------------------- products

// Element (row, ch) of a window buffer: f32 row-major with a row stride of
// `ld` elements; bf16 planar, 8-channel planes of `ld` rows of 16 bytes, so
// that any 8 consecutive rows of a plane are one wgmma core matrix.
template <typename T>
__device__ __forceinline__ size_t at(int row, int ch, int ld) {
  if constexpr (sizeof(T) == 2) {
    return ((size_t)(ch >> 3) * ld + row) * 8 + (ch & 7);
  } else {
    return (size_t)row * ld + ch;
  }
}

// One product of the level: output rows o0 + ostride * i, i in [0, rows),
// each the sum over taps j and input channels of W_j[co][ci] times
// src[a0 + i + off0 + j * dstep][ci].
template <typename T>
struct Prod {
  const T* src;
  int ld;          // the source's layout stride (at<T>)
  int src_rows;
  bool leaky;      // f32: leaky on the source as it is loaded
  int k;           // input channels (a multiple of 16)
  int n_taps, off0, dstep;
  int a0, rows, o0, ostride;
};

// The ring's consumer side: every consumer thread walks the same sequence
// of stages; lane 0 of each consumer warp hands a stage back once its
// warpgroup's products on it are done.
struct Ring {
  uint32_t base, full, empty;
  int stages, slot_bytes;
  uint32_t g;   // stages acquired so far
  __device__ uint32_t acquire() {
    const uint32_t slot = g % stages;
    SPAN_START(t0);
    mbar_wait(full + 8 * slot, (g / stages) & 1);
    SPAN_END(CY_RING_WAIT, t0, threadIdx.x == 0);
    ++g;
    return base + slot * slot_bytes;
  }
  __device__ void release(uint32_t i) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * (i % stages));
  }
};

// The products of one warpgroup's NT tiles over every stage of a product:
// the tile count is a template argument, so no branch sits between the
// wgmmas of a stage (a branch there makes ptxas serialize them all). Every
// stage holds KC columns of K: a K chunk of one tap where K >= KC, else
// KC / K taps side by side (the last group padded with zero taps, which
// read the last tap's rows). One stage's products stay in flight while the
// next stage's are issued.
template <int NT, int CS>
__device__ __forceinline__ void mainloop(const Prod<bf16>& pr, Ring& ring,
                                         const int (&start)[MT_MAX],
                                         float (&acc)[MT_MAX][CS / 2]) {
  const int kc = min(pr.k, KC), ksteps = kc / 16;
  const int kchunks = pr.k / kc, tps = KC / kc;
  const uint32_t lbo_a = pr.ld * 16;
  const uint32_t src = smem_u32(pr.src);
  const uint32_t first = ring.g;
  SPAN_START(t0);
  for (int j0 = 0; j0 < pr.n_taps; j0 += tps) {
    for (int q = 0; q < kchunks; ++q) {
      const uint32_t stage = ring.acquire();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        const int t = kk / ksteps, ks = kk - t * ksteps;
        const int j = min(j0 + t, pr.n_taps - 1);
        const uint32_t a_k = src + (uint32_t)(q * kc / 8 + 2 * ks) * lbo_a +
                             (uint32_t)((pr.a0 + pr.off0 + j * pr.dstep) * 16);
#pragma unroll
        for (int mt = 0; mt < NT; ++mt)
          wgmma_ss(acc[mt], desc(a_k + start[mt] * 16, lbo_a, 128),
                   desc(stage + kk * 256, 128, KC * 16));
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (ring.g - first > 1) ring.release(ring.g - 2);
    }
  }
  wgmma_wait<0>();
  ring.release(ring.g - 1);
  SPAN_END(CY_PRODUCTS, t0, threadIdx.x == 0);
}

// bf16 product on wgmma, A and B from shared memory. Warpgroup wg takes the
// 64-row tiles wg, wg + 2, wg + 4 of the product; tile t starts at row
// min(64 t, rows - 64), so no tile reaches past the rows (the last one
// overlaps its neighbour and stores only the rows that are its own). A: the
// planar source, tap j of tile t at row a0 + start + off0 + j * dstep, any
// row: planes `ld` * 16 bytes apart, 8-row groups 128. B: the ring's stage
// of KC columns. Per pair of adjacent output channels, pre(row, channel)
// reads what the epilogue needs of the old window (a row's reads first: a
// read after the previous pair's stores would wait for them), then
// epi(row, channel, y, old), y the product plus the bias (B: the bias's
// type) rounded to bf16.
template <int CS, typename B, typename Pre, typename Epi>
__device__ void product_mma(const Prod<bf16>& pr, Ring& ring, const B* bias,
                            Pre pre, Epi epi) {
  const int tid = threadIdx.x, wg = tid >> 7, warp4 = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n_mt = (pr.rows + 63) >> 6;
  const int my_n = (n_mt - wg + 1) / 2;     // this warpgroup's tiles, 0..3
  int start[MT_MAX];
#pragma unroll
  for (int mt = 0; mt < MT_MAX; ++mt)
    start[mt] = min(64 * (wg + 2 * mt), max(pr.rows - 64, 0));
  // this thread's bias pairs: channels nb * 8 + 2 * (lane & 3) + {0, 1}
  typename Pair<B>::type bv[CS / 8];
#pragma unroll
  for (int nb = 0; nb < CS / 8; ++nb)
    bv[nb] = bias_pair(bias + nb * 8 + 2 * (lane & 3));
  float acc[MT_MAX][CS / 2];
#pragma unroll
  for (int mt = 0; mt < MT_MAX; ++mt)
#pragma unroll
    for (int e = 0; e < CS / 2; ++e) acc[mt][e] = 0.f;
  // a warpgroup without a tile still walks the ring
  if (my_n >= 3) {
    mainloop<3, CS>(pr, ring, start, acc);
  } else if (my_n == 2) {
    mainloop<2, CS>(pr, ring, start, acc);
  } else if (my_n == 1) {
    mainloop<1, CS>(pr, ring, start, acc);
  } else {
    mainloop<0, CS>(pr, ring, start, acc);
  }
  SPAN_START(t_epi);
#pragma unroll
  for (int mt = 0; mt < MT_MAX; ++mt) {
    const int tile = wg + 2 * mt;
    if (mt >= my_n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = start[mt] + warp4 * 16 + (lane >> 2) + 8 * h;
      if (i < 64 * tile || i >= pr.rows) continue;
      const int o = pr.o0 + pr.ostride * i;
      __nv_bfloat162 old[CS / 8];
#pragma unroll
      for (int nb = 0; nb < CS / 8; ++nb)
        old[nb] = pre(o, nb * 8 + 2 * (lane & 3));
#pragma unroll
      for (int nb = 0; nb < CS / 8; ++nb)
        epi(o, nb * 8 + 2 * (lane & 3),
            p_bias(acc[mt][nb * 4 + 2 * h], acc[mt][nb * 4 + 2 * h + 1],
                   bv[nb]),
            old[nb]);
    }
  }
  SPAN_END(CY_EPILOGUES, t_epi, threadIdx.x == 0);
}

// f32 product on FMA: a thread owns 4 output channels x 8 rows. Tap j's
// weights start at w + j * tap_stride, output channel co's row at
// co * row_stride (co counted from the CTA's first channel). Source rows
// are clamped to [0, src_rows): only rows outside the output's dependency
// cone read past the window.
template <typename Pre, typename Epi>
__device__ void product_fma(const Prod<float>& pr, const float* __restrict__ w,
                            long tap_stride, long row_stride, int cs,
                            const float* bias, Pre pre, Epi epi) {
  constexpr int NC = Cfg<float>::CONSUMERS;
  const int cgs = cs / 4;
  const int n_units = cgs * ((pr.rows + 7) / 8);
  for (int unit = threadIdx.x; unit < n_units; unit += NC) {
    const int co = (unit % cgs) * 4;
    const int i0 = (unit / cgs) * 8;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][r] = 0.f;
    for (int j = 0; j < pr.n_taps; ++j) {
      const float* wj = w + j * tap_stride + co * row_stride;
      const int a = pr.a0 + i0 + pr.off0 + j * pr.dstep;
      const float* sp[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        sp[r] = pr.src + (size_t)min(max(a + r, 0), pr.src_rows - 1) * pr.ld;
      for (int ci = 0; ci < pr.k; ci += 4) {
        float4 wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[i] = __ldg(reinterpret_cast<const float4*>(wj + i * row_stride + ci));
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float4 v = *reinterpret_cast<const float4*>(sp[r] + ci);
          if (pr.leaky) {
            v.x = leaky<float>(v.x);
            v.y = leaky<float>(v.y);
            v.z = leaky<float>(v.z);
            v.w = leaky<float>(v.w);
          }
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
    const float2 bv[2] = {bias_pair(bias + co), bias_pair(bias + co + 2)};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (i0 + r >= pr.rows) break;
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int o = pr.o0 + pr.ostride * (i0 + r);
        epi(o, co + i, p_bias_f(acc[i][r], acc[i + 1][r], bv[i / 2]),
            pre(o, co + i));
      }
    }
  }
}

// ----------------------------------------------------------- the level

// src[row][peer * cs + c] = the cluster CTAs' slices [row][c] of `slice`
// over rows [lo, hi), leaky applied where asked: 16-byte pieces (a row of
// 8 bf16 channels of a plane, or 4 f32 channels) read through distributed
// shared memory (with one CTA per tile, from its own)
template <typename T>
__device__ void gather(const Params& p, T* src, const T* slice, int lo,
                       int hi, int lds, int ldc, bool act) {
  constexpr int NC = Cfg<T>::CONSUMERS, VEC = 16 / sizeof(T);
  constexpr int BATCH = 4;   // remote loads in flight per thread
  const int pieces = p.c / VEC, per_peer = p.cs / VEC;
  const int rows = hi - lo, n = rows * pieces;
  const uint32_t base = smem_u32(slice);
  for (int i0 = threadIdx.x; i0 < n; i0 += BATCH * NC) {
    uint4 v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = min(i0 + k * NC, n - 1);
      const int piece = i / rows, row = lo + i % rows;
      const int peer = piece / per_peer;
      const int c0 = (piece - peer * per_peer) * VEC;
      v[k] = p.n == 1 ? *reinterpret_cast<const uint4*>(slice + at<T>(row, c0, lds))
                      : ld_peer(base + at<T>(row, c0, lds) * sizeof(T), peer);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * NC;
      if (i >= n) break;
      const int piece = i / rows, row = lo + i % rows;
      if (act) {
        if constexpr (sizeof(T) == 2) {
          v[k].x = leaky2(v[k].x);
          v[k].y = leaky2(v[k].y);
          v[k].z = leaky2(v[k].z);
          v[k].w = leaky2(v[k].w);
        } else {
          float* f = reinterpret_cast<float*>(&v[k]);
#pragma unroll
          for (int e = 0; e < 4; ++e) f[e] = leaky<float>(f[e]);
        }
      }
      *reinterpret_cast<uint4*>(src + at<T>(row, piece * VEC, ldc)) = v[k];
    }
  }
}

// The producer warp: lane 0 moves every stage of the level into the ring,
// in the consumers' order, `stages` ahead of them; the warp takes part in
// the cluster barrier that ends each product (it arrives after issuing the
// product's stages and waits for that barrier only after issuing the next
// product's, so the ring fills across boundaries).
template <bool UPS>
__device__ void producer(const Params& p, uint32_t ring, uint32_t full,
                         uint32_t empty, int rank) {
  const bool lead = (threadIdx.x & 31) == 0;
  const char* src = reinterpret_cast<const char*>(p.packed) +
                    (size_t)rank * p.rank_elems * sizeof(bf16);
  const int slot_bytes = p.cs * KC * 2;
  uint32_t g = 0;
  bool pending = false;
  // a product's stages of KC columns: per tap its K chunks, or groups of
  // KC / K taps (mrf.py ``product_images``)
  auto issue = [&](int n_taps, int k) {
    const int kc = min(k, KC), tps = KC / kc;
    const int bytes = p.cs * KC * 2;
    const int n = (n_taps + tps - 1) / tps * (k / kc);
    for (int s = 0; s < n; ++s, ++g, src += bytes) {
      if (!lead) continue;
      const uint32_t slot = g % p.stages;
      SPAN_START(t0);
      if (g >= (uint32_t)p.stages) mbar_wait(empty + 8 * slot, (g / p.stages - 1) & 1);
      SPAN_END(CY_PRODUCER_EMPTY_WAIT, t0, true);
      bulk_load(ring + slot * slot_bytes, src, bytes, full + 8 * slot);
    }
  };
  auto boundary = [&]() {
    __syncwarp();
    SPAN_START(t0);
    if (pending) cluster_wait();
    SPAN_END(CY_PRODUCER_CLUSTER_WAIT, t0, lead);
    cluster_arrive();
    pending = true;
  };
  if (UPS) {
    const int pad_up = p.k_up - 1 - (p.k_up - p.s_up) / 2;
    for (int r = 0; r < p.s_up; ++r) {
      const int m_first = ((pad_up - r) % p.s_up + p.s_up) % p.s_up;
      issue((p.k_up - m_first + p.s_up - 1) / p.s_up, p.c_in);
    }
    boundary();
  }
  for (int b = 0; b < p.n_br; ++b)
    for (int u = 0; u < 2 * p.n_units; ++u) {
      issue(p.br[b].kr, p.c);
      boundary();
    }
  if (pending) cluster_wait();
}

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <typename T, bool UPS, int CS>
__global__ void __launch_bounds__(Cfg<T>::THREADS, 1)
    level_kernel(const __grid_constant__ Params p) {
  constexpr bool MMA = sizeof(T) == 2;
  constexpr int NC = Cfg<T>::CONSUMERS, PAD = Cfg<T>::PAD, VEC = 16 / sizeof(T);
  typedef typename std::conditional<UPS, float, T>::type B;
  extern __shared__ __align__(128) unsigned char smem[];
  const Carve& cv = p.cv;
  const int tid = threadIdx.x;
  const int rank = cluster_rank();
  const int cs = CS ? CS : p.cs;
  const int c = p.c, tw = p.t_tile + 2 * HALO;
  const int b = blockIdx.y;
  const int tile0 = (blockIdx.x / p.n) * p.t_tile;
  const int pos0 = tile0 - HALO;   // sequence position of window row 0
  const int s_out = p.s_in * p.s_up;
  const int t_len = UPS ? s_out * p.t_valid : p.t;   // valid positions
  const bool gathers = p.n > 1;
  // layout strides (at<T>): planes of tw rows in bf16, padded rows in f32
  const int lds = MMA ? tw : cs + PAD, ldc = MMA ? tw : c + PAD;
  T* cur = reinterpret_cast<T*>(smem + cv.cur);
  T* ubuf = reinterpret_cast<T*>(smem + cv.ubuf);
  T* src = reinterpret_cast<T*>(smem + cv.src);
  T* ybuf = reinterpret_cast<T*>(smem + cv.ybuf);
  float* sum = reinterpret_cast<float*>(smem + cv.sum);
  const uint32_t full = smem_u32(smem + cv.bars);
  const uint32_t empty = full + 8 * MAX_STAGES;

  // every buffer starts at 0: rows a product leaves unwritten are read only
  // for rows outside the output's dependency cone
  for (size_t i = tid; i < (cv.total - cv.guard) / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem + cv.guard)[i] = make_uint4(0, 0, 0, 0);
  if (MMA && tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + 8 * i, 1);    // the producer's arrive + the bytes
      mbar_init(empty + 8 * i, NC / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  if constexpr (MMA) {
    if (tid >= NC) {
      producer<UPS>(p, smem_u32(smem + cv.ring), full, empty, rank);
      return;
    }
  }
  SPAN_START(t_kernel);
  Ring ring{smem_u32(smem + cv.ring), full, empty, p.stages, cs * KC * 2, 0};

  auto valid = [&](int row) {
    const int pos = pos0 + row;
    return pos >= 0 && pos < t_len;
  };
  auto run = [&](const Prod<T>& pr, const T* w, long tap_stride,
                 long row_stride, const auto* bias, auto pre, auto epi) {
    if constexpr (MMA) {
      product_mma<CS>(pr, ring, bias, pre, epi);
    } else {
      product_fma(pr, reinterpret_cast<const float*>(w), tap_stride,
                  row_stride, cs, bias, pre, epi);
    }
  };
  typedef typename Pair<T>::type P;
  P zero;
  if constexpr (MMA) {
    zero = __float2bfloat162_rn(0.f);
  } else {
    zero = make_float2(0.f, 0.f);
  }
  // a pair of adjacent channels (col even) of a window buffer
  auto pair = [&](T* buf, int row, int col, int ld_) {
    return reinterpret_cast<P*>(buf + at<T>(row, col, ld_));
  };
  // the old window an epilogue reads: none, or the residual
  auto no_pre = [&](int, int) { return zero; };
  auto cur_pre = [&](int o, int col) { return *pair(cur, o, col, lds); };

  if constexpr (UPS) {
    // the input tile in sample order: row i holds input sample in0 + i,
    // leaky applied, 0 outside [0, s_in * t_valid)
    const int s = p.s_up, ci = p.c_in;
    const int ldi = MMA ? p.in_rows : ci + PAD;
    const int in0 = floordiv(pos0, s) - IN_HALO;
    T* tin = src;
    const T* x = static_cast<const T*>(p.x) + (size_t)b * p.s_in * ci * p.t;
    // a thread takes VEC channels of a row: independent loads, coalesced
    // across the warp's rows, one 16-byte store
    const int n_in = ci / VEC * p.in_rows;
    for (int it = tid; it < n_in; it += NC) {
      const int ch = it / p.in_rows * VEC, row = it % p.in_rows;
      const int q = in0 + row;
      const int lane = floordiv(q, p.s_in), r_in = q - lane * p.s_in;
      const bool ok = q >= 0 && lane < p.t_valid;
      const T* xq = x + ((size_t)r_in * ci + ch) * p.t + lane;
      float v[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[k] = ok ? ld(xq + (size_t)k * p.t) : 0.f;
      st_vec(tin + at<T>(row, ch, ldi), v, true);
    }
    consumers_sync<T>();
    // per output phase r of the stride: window rows o_r + s * i take taps
    // m_first + j * s from input rows (sample order) q_r + i + offset
    const int pad_up = p.k_up - 1 - (p.k_up - s) / 2;
    const float* ub = p.up_b + rank * cs;
    for (int r = 0; r < s; ++r) {
      const int m_first = ((pad_up - r) % s + s) % s;
      const int o_r = ((r - pos0) % s + s) % s;
      Prod<T> pr;
      pr.src = tin;
      pr.ld = ldi;
      pr.src_rows = p.in_rows;
      pr.leaky = false;
      pr.k = ci;
      pr.n_taps = (p.k_up - m_first + s - 1) / s;
      pr.off0 = (r + m_first - pad_up) / s;    // exact
      pr.dstep = 1;
      pr.a0 = (pos0 + o_r - r) / s - in0;     // exact division
      pr.rows = (tw - o_r + s - 1) / s;
      pr.o0 = o_r;
      pr.ostride = s;
      run(pr, static_cast<const T*>(p.up_w) + ((size_t)m_first * c + rank * cs) * ci,
          (long)s * c * ci, ci, ub, no_pre, [&](int o, int col, P y, P) {
            *pair(ubuf, o, col, lds) = valid(o) ? y : zero;
          });
    }
    cluster_sync();
  }

  for (int br = 0; br < p.n_br; ++br) {
    const Branch& bp = p.br[br];
    const int kr = bp.kr;
    SPAN_START(t_branch);
    // cur = the level's input over the window, and (bf16, clusters) src its
    // activated copy, leaky(input)
    if constexpr (UPS) {
      for (int i = tid; i < (int)((cv.src - cv.ubuf) / 16); i += NC)
        reinterpret_cast<uint4*>(cur)[i] = reinterpret_cast<const uint4*>(ubuf)[i];
      if (MMA || gathers) gather(p, src, ubuf, 0, tw, lds, ldc, true);
    } else {
      // the rows this branch reads, VEC channels of a row per thread:
      // independent loads, coalesced across the warp's rows, 16-byte stores
      int span = 0;
      for (int u = 0; u < p.n_units; ++u) span += (kr / 2) * (p.dils[u] + 1);
      const int r_lo = HALO - span, rows = p.t_tile + 2 * span;
      const T* x = static_cast<const T*>(p.x) + (size_t)b * c * p.t;
      const int n_x = (gathers ? c : cs) / VEC * rows;
      for (int it = tid; it < n_x; it += NC) {
        const int ch = it / rows * VEC, row = r_lo + it % rows;
        const int pos = pos0 + row;
        const bool ok = pos >= 0 && pos < p.t;
        const T* xp = x + (size_t)ch * p.t + pos;
        float v[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = ok ? ld(xp + (size_t)k * p.t) : 0.f;
        if (MMA || gathers) st_vec(src + at<T>(row, ch, ldc), v, true);
        const int own = gathers ? ch - rank * cs : ch;
        if (own >= 0 && own < cs) st_vec(cur + at<T>(row, own, lds), v, false);
      }
    }
    consumers_sync<T>();
    SPAN_END(CY_BRANCH_START, t_branch, tid == 0);
    // span still to come after each convolution of this branch
    int rest = 0;
    for (int u = 0; u < p.n_units; ++u) rest += (kr / 2) * (p.dils[u] + 1);
    for (int u = 0; u < p.n_units; ++u) {
      const int d = p.dils[u];
      const size_t wo = (size_t)u * c * kr * c;
      for (int half = 0; half < 2; ++half) {
        const bool first = half == 0;
        const int dil = first ? d : 1;
        rest -= (kr / 2) * dil;
        const bool last = !first && u == p.n_units - 1;
        const int lo = max(0, HALO - rest);
        const int hi = min(tw, HALO + p.t_tile + rest);
        // sources: bf16 reads the activated copy in src (the first
        // convolution's, or with clusters either's); f32 reads cur (leaky on
        // load) or ybuf, or with clusters src
        const bool from_src = gathers || (MMA && first);
        Prod<T> pr;
        pr.src = from_src ? src : first ? cur : ybuf;
        pr.ld = from_src ? ldc : lds;
        pr.src_rows = tw;
        pr.leaky = !from_src && first;
        pr.k = c;
        pr.n_taps = kr;
        pr.off0 = -(kr / 2) * dil;
        pr.dstep = dil;
        pr.a0 = lo;
        pr.rows = hi - lo;
        pr.o0 = lo;
        pr.ostride = 1;
        const B* bias = static_cast<const B*>(first ? bp.b1 : bp.b2) + u * c + rank * cs;
        const T* wgt = static_cast<const T*>(first ? bp.w1 : bp.w2) + wo +
                       (size_t)rank * cs * kr * c;
        if (first) {
          run(pr, wgt, c, (long)kr * c, bias, no_pre,
              [&](int o, int col, P y, P) {
                *pair(ybuf, o, col, lds) = valid(o) ? p_leaky(y) : zero;
              });
        } else {
          // one CTA per tile in bf16: the next unit's activated source is
          // written here, as the residual is
          const bool act = MMA && !gathers && !last;
          run(pr, wgt, c, (long)kr * c, bias, cur_pre,
              [&](int o, int col, P y, P old) {
                const P nv = valid(o) ? p_add(old, y) : zero;
                *pair(cur, o, col, lds) = nv;
                if (act) *pair(src, o, col, ldc) = p_leaky(nv);
                if (last) {
                  float* sp = sum + (o - HALO) * (cs + 1) + col;
                  sp[0] = br == 0 ? p_lo(nv) : sp[0] + p_lo(nv);
                  sp[1] = br == 0 ? p_hi(nv) : sp[1] + p_hi(nv);
                }
              });
        }
        SPAN_START(t_sync);
        cluster_sync();
        SPAN_END(CY_CLUSTER_SYNC, t_sync, tid == 0);
        if (gathers && !last) {
          gather(p, src, first ? ybuf : cur, lo, hi, lds, ldc, !first);
          consumers_sync<T>();
        }
      }
    }
  }

  SPAN_END(CY_KERNEL, t_kernel, tid == 0);
  // the tile's output from the branch sum, lane-contiguous stores
  const float nb = (float)p.n_br;
  if constexpr (UPS) {
    // out[b, r*C + c, t] holds output sample s_out*t + r, 0 at padding lanes
    const int tpp = p.t_tile / s_out;
    const int lane0 = tile0 / s_out;
    T* out = static_cast<T*>(p.out) + (size_t)b * s_out * c * p.t;
    for (int i = tid; i < cs * p.t_tile; i += NC) {
      const int ch = i / p.t_tile, rem = i - ch * p.t_tile;
      const int r = rem / tpp, tt = rem - r * tpp;
      const int lane = lane0 + tt;
      if (lane < p.t)
        st(out + ((size_t)r * c + rank * cs + ch) * p.t + lane,
           lane < p.t_valid ? sum[(s_out * tt + r) * (cs + 1) + ch] / nb : 0.f);
    }
  } else {
    T* out = static_cast<T*>(p.out) + ((size_t)b * c + rank * cs) * p.t;
    for (int i = tid; i < cs * p.t_tile; i += NC) {
      const int ch = i / p.t_tile, r = i - ch * p.t_tile;
      const int pos = tile0 + r;
      if (pos < p.t) st(out + (size_t)ch * p.t + pos, sum[r * (cs + 1) + ch] / nb);
    }
  }
}

// ---------------------------------------------------------------- host

// The branches' weights and spans into p; false on a shape the kernel does
// not take.
bool set_branches(Params& p, const void* const* wb, const int* krs, int n_br,
                  const int* dils, int n_units) {
  if (n_br < 1 || n_br > MAX_BRANCHES || n_units < 1 || n_units > MAX_UNITS)
    return false;
  for (int u = 0; u < n_units; ++u)
    if (dils[u] < 1) return false;
  for (int i = 0; i < n_br; ++i) {
    int span = 0;
    for (int u = 0; u < n_units; ++u) span += (krs[i] / 2) * (dils[u] + 1);
    if (krs[i] < 1 || span > HALO) return false;
    p.br[i] = Branch{wb[4 * i], wb[4 * i + 1], wb[4 * i + 2], wb[4 * i + 3],
                     krs[i]};
  }
  for (int u = 0; u < n_units; ++u) p.dils[u] = dils[u];
  p.n_br = n_br;
  p.n_units = n_units;
  return true;
}

// The plan's own checks: a channel slice the kernels take, a window of at
// most MAX_TW rows, a ring of MIN_STAGES..MAX_STAGES stages (bf16) and a
// carve within the H100's shared memory per block.
template <typename T>
bool set_plan(Params& p, int c, int cs, int t_tile, int stages, bool ups) {
  constexpr bool MMA = sizeof(T) == 2;
  if (c < 16 || c > 256 || (c & (c - 1)) || cs < 16 || cs > 64 || c % cs ||
      c / cs > 8 || t_tile < 16 || t_tile % 8 || t_tile + 2 * HALO > MAX_TW ||
      (MMA && (stages < MIN_STAGES || stages > MAX_STAGES)))
    return false;
  p.c = c;
  p.cs = cs;
  p.n = c / cs;
  p.t_tile = t_tile;
  p.stages = MMA ? stages : 0;
  p.cv = carve(sizeof(T), c, cs, t_tile, p.stages, ups, p.c_in, p.in_rows);
  return p.cv.total <= (size_t)SMEM_LIMIT;
}

template <typename K>
int start(K kernel, const Params& p, int threads, long tiles, int batch,
          int device, cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  if (tiles * p.n > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.cv.total);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * p.n), (unsigned)batch, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = p.cv.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool UPS>
int dispatch(const Params& p, long tiles, int batch, int device,
             cudaStream_t stream) {
  constexpr int TH = Cfg<T>::THREADS;
  if constexpr (sizeof(T) == 2) {
    switch (p.cs) {
      case 16: return start(level_kernel<T, UPS, 16>, p, TH, tiles, batch, device, stream);
      case 32: return start(level_kernel<T, UPS, 32>, p, TH, tiles, batch, device, stream);
      case 64: return start(level_kernel<T, UPS, 64>, p, TH, tiles, batch, device, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    return start(level_kernel<T, UPS, 0>, p, TH, tiles, batch, device, stream);
  }
}

template <typename T>
int launch(const void* x, void* out, const void* const* wb,
           const void* packed, long long rank_elems, const int* krs,
           int n_br, const int* dils, int n_units, int batch, int c, int t,
           int cs, int t_tile, int stages, int device, cudaStream_t stream) {
  Params p = {};
  if (!set_branches(p, wb, krs, n_br, dils, n_units) ||
      !set_plan<T>(p, c, cs, t_tile, stages, false) || batch < 1 ||
      batch > 65535 || t < 1 || (sizeof(T) == 2 && (!packed || rank_elems < 1)))
    return (int)cudaErrorInvalidValue;
  p.x = x;
  p.out = out;
  p.packed = static_cast<const bf16*>(packed);
  p.rank_elems = rank_elems;
  p.t = t;
  p.s_in = p.s_up = 1;
  return dispatch<T, false>(p, (t + t_tile - 1) / t_tile, batch, device, stream);
}

template <typename T>
int launch_ups(const void* x, void* out, const void* up_w, const float* up_b,
               const void* const* wb, const void* packed,
               long long rank_elems, const int* krs, int n_br,
               const int* dils, int n_units, int batch, int c_in, int c,
               int s_in, int s_up, int k_up, int t_ps, int t_valid, int cs,
               int t_tile, int stages, int device, cudaStream_t stream) {
  Params p = {};
  const int s_out = s_in * s_up;
  if (s_in < 1 || s_up < 2 || s_out > 4 || k_up < s_up || (k_up - s_up) % 2 ||
      k_up > 32 || c_in < 16 || c_in > 512 ||
      (c_in < KC ? KC % c_in : c_in % KC) || t_tile % s_out)
    return (int)cudaErrorInvalidValue;
  // every tap reaches at most IN_HALO input rows away
  const int pad_up = k_up - 1 - (k_up - s_up) / 2;
  if (pad_up > IN_HALO * s_up || s_up - 1 + k_up - 1 - pad_up > IN_HALO * s_up)
    return (int)cudaErrorInvalidValue;
  p.c_in = c_in;
  p.s_in = s_in;
  p.s_up = s_up;
  p.k_up = k_up;
  // the window's input rows (at least one 64-row tile) and IN_HALO + 1
  // more on each side
  p.in_rows = max((t_tile + 2 * HALO + s_up - 1) / s_up, 64) + 2 * IN_HALO + 1;
  if (!set_branches(p, wb, krs, n_br, dils, n_units) ||
      !set_plan<T>(p, c, cs, t_tile, stages, true) || batch < 1 ||
      batch > 65535 || t_ps < 1 || t_valid < 0 || t_valid > t_ps ||
      (sizeof(T) == 2 && (!packed || rank_elems < 1)))
    return (int)cudaErrorInvalidValue;
  p.x = x;
  p.out = out;
  p.up_w = up_w;
  p.up_b = up_b;
  p.packed = static_cast<const bf16*>(packed);
  p.rank_elems = rank_elems;
  p.t = t_ps;
  p.t_valid = t_valid;
  const long samples = (long)s_out * t_ps;
  return dispatch<T, true>(p, (samples + t_tile - 1) / t_tile, batch, device,
                           stream);
}

}  // namespace

// wb: per kernel size (w1, b1, w2, b2); the f32 entries read the weights
// there ([U, C, kr*C], j-major im2col columns), the bf16 entries read the
// biases there and the weights from `packed` (mrf.py ``pack_weights``)
extern "C" int mrf_f32(const void* x, void* out, const void* const* wb,
                       const void* packed, long long rank_elems,
                       const int* krs, int n_br, const int* dils, int n_units,
                       int batch, int c, int t, int cs, int t_tile,
                       int stages, int device, cudaStream_t stream) {
  return launch<float>(x, out, wb, packed, rank_elems, krs, n_br, dils,
                       n_units, batch, c, t, cs, t_tile, stages, device,
                       stream);
}

extern "C" int mrf_bf16(const void* x, void* out, const void* const* wb,
                        const void* packed, long long rank_elems,
                        const int* krs, int n_br, const int* dils,
                        int n_units, int batch, int c, int t, int cs,
                        int t_tile, int stages, int device,
                        cudaStream_t stream) {
  return launch<bf16>(x, out, wb, packed, rank_elems, krs, n_br, dils,
                      n_units, batch, c, t, cs, t_tile, stages, device,
                      stream);
}

extern "C" int ups_mrf_f32(const void* x, void* out, const void* up_w,
                           const float* up_b, const void* const* wb,
                           const void* packed, long long rank_elems,
                           const int* krs, int n_br, const int* dils,
                           int n_units, int batch, int c_in, int c, int s_in,
                           int s_up, int k_up, int t_ps, int t_valid, int cs,
                           int t_tile, int stages, int device,
                           cudaStream_t stream) {
  return launch_ups<float>(x, out, up_w, up_b, wb, packed, rank_elems, krs,
                           n_br, dils, n_units, batch, c_in, c, s_in, s_up,
                           k_up, t_ps, t_valid, cs, t_tile, stages, device,
                           stream);
}

extern "C" int ups_mrf_bf16(const void* x, void* out, const void* up_w,
                            const float* up_b, const void* const* wb,
                            const void* packed, long long rank_elems,
                            const int* krs, int n_br, const int* dils,
                            int n_units, int batch, int c_in, int c, int s_in,
                            int s_up, int k_up, int t_ps, int t_valid, int cs,
                            int t_tile, int stages, int device,
                            cudaStream_t stream) {
  return launch_ups<bf16>(x, out, up_w, up_b, wb, packed, rank_elems, krs,
                          n_br, dils, n_units, batch, c_in, c, s_in, s_up,
                          k_up, t_ps, t_valid, cs, t_tile, stages, device,
                          stream);
}

#ifdef MRF_CYCLES
// The cycle spans (CycleSpan order) of `device` into h, or (reset) set
// them to 0.
extern "C" int mrf_cycles(unsigned long long* h, int reset, int device) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  if (reset) {
    unsigned long long z[CY_SPANS] = {0};
    return (int)cudaMemcpyToSymbol(g_cycles, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(h, g_cycles, sizeof(g_cycles));
}
#endif
