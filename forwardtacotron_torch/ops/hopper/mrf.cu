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
//   - ups_mrf: the input tile ([TW / s_up + 2 in_halo + 1 rows, C_in] in
//     sample order, leaky applied) shares its bytes with src, ybuf and the
//     sum, which are dead while the upsample runs; u is computed once into
//     ubuf (one product per output phase of the stride) and copied into cur
//     at each branch's start. Any rate with s_in * s_up <= 4, any k_up: the
//     tile's halo, in_halo, is IN_HALO input rows or the farthest tap's
//     reach where that is more. Where the whole tile does not fit, it loads
//     in chunks of cw input channels (a multiple of KC) and the upsample's
//     f32 sum runs over the chunks: bf16 in the accumulators (per output
//     phase, each chunk's stages in turn, the tile reloaded between them),
//     f32 in ubuf (per chunk, every phase; the bias joins at the last
//     chunk), with one rounding after the last, as with the whole tile.
//   - The branches (weight pointers, kernel sizes and spans) are a table
//     in device memory (mrf.py ``branch_table``) read through the
//     read-only path, so a level takes any number of kernel sizes; the
//     parameter block keeps a copy of the first 32 kernel sizes and the
//     dilations (branch_krspan), and the biases are one tensor addressed
//     by arithmetic.
// The wide form (WIDE, C > 256: up to 16 CTAs of 64 or 128 channels, a
// non-portable cluster size past 8). A full-width source per CTA no longer
// fits (tw * C * elt bytes: 147,456 at C 512 in bf16 with the smallest
// window), so each CTA keeps only its own slices of cur, ybuf and ubuf, and
// every product streams its source from the cluster's CTAs in KC-channel
// chunks:
//   - bf16: wgmma reads only CTA-local shared memory, so each chunk is
//     copied into a ring of two chunk buffers (abuf) beside the weight
//     ring, over distributed shared memory (ld.shared::cluster, leaky
//     applied where the source is cur), then a proxy fence and the
//     consumers' barrier. The other route, the source through an
//     L2-resident scratch by TMA, would write every convolution's output
//     to device memory and fence it before any peer could load it; the
//     DSMEM copy moves the same bytes as the narrow form's gather, from
//     the peer's shared memory, with no global round trip. The weight
//     stages come chunk-major (mrf.py ``product_images``). With two chunk
//     buffers
//     one barrier a chunk suffices, and a warpgroup copies the next chunk
//     while the other may still compute on the last. At 128-channel slices
//     (wgmma N = 128) a consumer warpgroup holds at most two 64-row tiles
//     of accumulators, so the window is at most 256 rows.
//   - f32: the FMA threads read a peer's slice in place (generic loads of
//     ``mapa`` addresses), one peer after another along K.
//   - A branch's input is loaded by each CTA for its own slice only, so a
//     cluster barrier follows each branch's start (the producer warp takes
//     part in it as in every other).
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
// input rows of halo on each side of the ups_mrf tile, at least
constexpr int IN_HALO = 8;
// Every unit of a kernel size of at least 2 adds at least 2 samples to its
// branch's span, which the halo bounds: HALO / 2 units (mrf.py MAX_UNITS).
// A 1-tap convolution reads no neighbour, so its dilation never matters: a
// level whose kernel sizes are all 1 may have any number of units.
constexpr int MAX_UNITS = HALO / 2;
// CTAs per cluster: the narrow form (portable), the wide form
constexpr int MAX_CLUSTER = 8;
constexpr int WIDE_CLUSTER = 16;
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

// Shared memory of one CTA, byte offsets in carve order. Narrow: the ring
// (bf16), its mbarriers, a zero guard (bf16: a tile's rows shifted before
// the window read it), cur, ubuf (ups_mrf), src (bf16, and f32 clusters),
// ybuf, the f32 branch sum; the ups_mrf input tile starts at src and may
// reach past the sum. Wide: the ring, its mbarriers, ubuf, the guard, cur,
// abuf (bf16: two KC-channel chunks of the source), ybuf, the sum; the
// input tile starts at cur. The tile holds cw input channels. bf16 buffers
// are planar (no row padding), f32 rows padded by 16 bytes. mrf.py
// ``carve`` repeats this computation.
struct Carve {
  size_t ring, bars, guard, cur, ubuf, src, abuf, ybuf, sum, tile, total;
};

__host__ __device__ inline Carve carve(int elt, int c, int cs, int t_tile,
                                       int stages, bool ups, int cw,
                                       int in_rows, bool wide) {
  const bool mma = elt == 2;
  const int pad = mma ? 0 : 16 / elt;
  const int tw = t_tile + 2 * HALO;
  const size_t slice = al128((size_t)tw * (cs + pad) * elt);
  Carve v;
  v.ring = 0;
  v.bars = mma ? (size_t)stages * cs * KC * 2 : 0;
  if (wide) {
    v.ubuf = v.bars + al128(2 * MAX_STAGES * 8);
    v.guard = v.ubuf + (ups ? slice : 0);
    v.cur = v.guard + (mma ? GUARD : 0);
    v.abuf = v.src = v.cur + slice;
    v.ybuf = v.abuf + (mma ? 2 * al128((size_t)tw * KC * elt) : 0);
    v.tile = v.cur;
  } else {
    v.guard = v.bars + al128(2 * MAX_STAGES * 8);
    v.cur = v.guard + (mma ? GUARD : 0);
    v.ubuf = v.cur + slice;
    v.src = v.ubuf + (ups ? slice : 0);
    v.ybuf = v.src + (mma || cs < c ? al128((size_t)tw * (c + pad) * elt) : 0);
    v.abuf = v.ybuf;
    v.tile = v.src;
  }
  v.sum = v.ybuf + slice;
  v.total = v.sum + al128((size_t)t_tile * (cs + 1) * 4);
  if (ups) {
    const size_t tile_end = v.tile + al128((size_t)in_rows * (cw + pad) * elt);
    if (tile_end > v.total) v.total = tile_end;
  }
  return v;
}

// a branch's record in the table: w1, w2 (pointers) and its kernel size
// and span (the context it reads on each side) as kr | span << 16 (mrf.py
// ``branch_table``)
constexpr int REC = 3;

// the branches whose packed kernel size and span, and the dilations,
// travel in the launch's parameter block too (256 bytes of its 4 KB)
constexpr int PARAM_BRANCHES = 32;

struct Params {
  const long long* table;
  // every bias of the level, [n_br, 2, U, C] (b1 then b2 of each branch)
  const void* biases;
  // the table's first PARAM_BRANCHES kr | span << 16 and its dilations
  // (those of a kernel size of 2 or more: at most MAX_UNITS)
  int krspan[PARAM_BRANCHES];
  int dils[MAX_UNITS];
  int n_br;
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
  int c_in, cw, s_in, s_up, k_up, t_valid, in_halo, in_rows;
  Carve cv;
};

// The table's values: branch b's kernel size and span (packed) and its
// weights k (0 w1, 1 w2), read through the read-only path. A load from
// device memory on the path of each convolution stalls it (measured: 1-3%
// of v1's levels 2-3 with the kernel sizes and dilations loaded a step
// ahead, in lanes or registers), so the first PARAM_BRANCHES kernel sizes
// and the dilations also come in the launch's parameter block (the entry
// fills them from krs and dils), as before the table; the biases are one
// tensor, addressed by arithmetic.
__device__ __forceinline__ int branch_krspan(const Params& p, int b) {
  return b < PARAM_BRANCHES ? p.krspan[b]
                            : (int)__ldg(p.table + REC * b + 2);
}
__device__ __forceinline__ const void* branch_w(const Params& p, int b,
                                                int k) {
  return reinterpret_cast<const void*>(__ldg(p.table + REC * b + k));
}

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

// the generic address of the same shared-memory location in cluster CTA
// `rank` (plain loads through it read the peer's shared memory)
template <typename T>
__device__ __forceinline__ const T* peer_ptr(const T* p, int rank) {
  uint64_t r;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(r) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const T*>(r);
}

// generic-proxy writes to this CTA's shared memory ordered before the
// async proxy's reads (wgmma's operands)
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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
template <int NT, int CS, int MT>
__device__ __forceinline__ void mainloop(const Prod<bf16>& pr, Ring& ring,
                                         const int (&start)[MT],
                                         float (&acc)[MT][CS / 2]) {
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

// 64-row M tiles a consumer warpgroup holds at most at a slice of CS
// channels: three (CS / 2 accumulators each), two at CS 128
template <int CS>
struct Tiles {
  static constexpr int MT = CS > 64 ? 2 : MT_MAX;
};

// the main loop at this warpgroup's tile count, a template argument
template <int CS, int MT>
__device__ __forceinline__ void mainloop_tiles(int my_n,
                                               const Prod<bf16>& pr,
                                               Ring& ring,
                                               const int (&start)[MT],
                                               float (&acc)[MT][CS / 2]) {
  if constexpr (MT >= 3) {
    if (my_n >= 3) {
      mainloop<3, CS, MT>(pr, ring, start, acc);
      return;
    }
  }
  if (my_n == 2) {
    mainloop<2, CS, MT>(pr, ring, start, acc);
  } else if (my_n == 1) {
    mainloop<1, CS, MT>(pr, ring, start, acc);
  } else {
    mainloop<0, CS, MT>(pr, ring, start, acc);
  }
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
// type) rounded to bf16. GROUPED: K comes in `groups` groups of pr.k
// channels, each from the source src_of(g) returns (which loads it and
// meets the consumers' barrier), the accumulators running on across them.
template <int CS, bool GROUPED, typename B, typename Pre, typename Epi,
          typename Src>
__device__ void product_mma(const Prod<bf16>& pr, Ring& ring, const B* bias,
                            Pre pre, Epi epi, int groups, Src src_of) {
  constexpr int MT = Tiles<CS>::MT;
  const int tid = threadIdx.x, wg = tid >> 7, warp4 = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int n_mt = (pr.rows + 63) >> 6;
  const int my_n = (n_mt - wg + 1) / 2;     // this warpgroup's tiles, 0..MT
  int start[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    start[mt] = min(64 * (wg + 2 * mt), max(pr.rows - 64, 0));
  // this thread's bias pairs: channels nb * 8 + 2 * (lane & 3) + {0, 1}
  typename Pair<B>::type bv[CS / 8];
#pragma unroll
  for (int nb = 0; nb < CS / 8; ++nb)
    bv[nb] = bias_pair(bias + nb * 8 + 2 * (lane & 3));
  float acc[MT][CS / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < CS / 2; ++e) acc[mt][e] = 0.f;
  // a warpgroup without a tile still walks the ring
  if constexpr (GROUPED) {
    for (int g = 0; g < groups; ++g) {
      Prod<bf16> pg = pr;
      pg.src = src_of(g);
      mainloop_tiles<CS, MT>(my_n, pg, ring, start, acc);
    }
  } else {
    mainloop_tiles<CS, MT>(my_n, pr, ring, start, acc);
  }
  SPAN_START(t_epi);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
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

// Rows [r0, r1) of KC source channels into dst (KC / 8 planes of tw rows):
// the planes from plane0 of cluster CTA `peer`'s slice buffer at `buf` (a
// shared-memory address, the same in every CTA of the cluster), read
// through distributed shared memory in 16-byte pieces, leaky applied where
// asked; then the proxy fence (wgmma reads dst) and the consumers' barrier.
__device__ void copy_chunk(uint32_t buf, int peer, int plane0, bf16* dst,
                           int r0, int r1, int tw, bool act) {
  constexpr int NC = Cfg<bf16>::CONSUMERS;
  constexpr int BATCH = 4;   // remote loads in flight per thread
  const int rows = r1 - r0, n = rows * (KC / 8);
  for (int i0 = threadIdx.x; i0 < n; i0 += BATCH * NC) {
    uint4 v[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = min(i0 + k * NC, n - 1);
      const int pl = i / rows, row = r0 + i % rows;
      v[k] = ld_peer(buf + (uint32_t)(((plane0 + pl) * tw + row) * 16), peer);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int i = i0 + k * NC;
      if (i >= n) break;
      const int pl = i / rows, row = r0 + i % rows;
      if (act) {
        v[k].x = leaky2(v[k].x);
        v[k].y = leaky2(v[k].y);
        v[k].z = leaky2(v[k].z);
        v[k].w = leaky2(v[k].w);
      }
      *reinterpret_cast<uint4*>(dst + ((size_t)pl * tw + row) * 8) = v[k];
    }
  }
  fence_proxy_async_shared();
  asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory");
}

// f32 product on FMA: a thread owns 4 output channels x 8 rows. Tap j's
// weights start at w + j * tap_stride, output channel co's row at
// co * row_stride (co counted from the CTA's first channel). Source rows
// are clamped to [0, src_rows): only rows outside the output's dependency
// cone read past the window. WIDE: the source's channels lie in the
// cluster's CTAs, `cs` each, at the same offset as pr.src: read in place,
// one CTA after another along K. A null bias adds nothing.
template <bool WIDE, typename Pre, typename Epi>
__device__ void product_fma(const Prod<float>& pr, const float* __restrict__ w,
                            long tap_stride, long row_stride, int cs,
                            const float* bias, Pre pre, Epi epi) {
  constexpr int NC = Cfg<float>::CONSUMERS;
  const int cgs = cs / 4;
  const int n_units = cgs * ((pr.rows + 7) / 8);
  const int n_pe = WIDE ? pr.k / cs : 1, kk = WIDE ? cs : pr.k;
  for (int unit = threadIdx.x; unit < n_units; unit += NC) {
    const int co = (unit % cgs) * 4;
    const int i0 = (unit / cgs) * 8;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][r] = 0.f;
    for (int j = 0; j < pr.n_taps; ++j) {
      const int a = pr.a0 + i0 + pr.off0 + j * pr.dstep;
      for (int pe = 0; pe < n_pe; ++pe) {
        const float* base = WIDE ? peer_ptr(pr.src, pe) : pr.src;
        const float* wj = w + j * tap_stride + co * row_stride + pe * kk;
        const float* sp[8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          sp[r] = base + (size_t)min(max(a + r, 0), pr.src_rows - 1) * pr.ld;
        for (int ci = 0; ci < kk; ci += 4) {
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
    }
    const float2 zero = make_float2(0.f, 0.f);
    const float2 bv[2] = {bias ? bias_pair(bias + co) : zero,
                          bias ? bias_pair(bias + co + 2) : zero};
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
// product's, so the ring fills across boundaries), and in the wide form in
// the one after each branch's start.
template <bool UPS, bool WIDE>
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
  for (int b = 0; b < p.n_br; ++b) {
    const int kr = branch_krspan(p, b) & 0xffff;
    if (WIDE) boundary();
    for (int u = 0; u < 2 * p.n_units; ++u) {
      issue(kr, p.c);
      boundary();
    }
  }
  if (pending) cluster_wait();
}

__device__ __forceinline__ int floordiv(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// CHUNKED (bf16 ups_mrf): the input tile loads in chunks of input channels;
// without it the tile loads whole and the upsample keeps the products of
// the forms before the chunks, register for register (the chunks' loop
// holds the tile's addresses across the products, which spilled).
template <typename T, bool UPS, int CS, bool WIDE, bool CHUNKED = false>
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
  // narrow clusters gather the full-width source; the wide form streams it
  const bool gathers = !WIDE && p.n > 1;
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
  const size_t zero0 = cv.bars + al128(2 * MAX_STAGES * 8);
  for (size_t i = tid; i < (cv.total - zero0) / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(smem + zero0)[i] = make_uint4(0, 0, 0, 0);
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
      producer<UPS, WIDE>(p, smem_u32(smem + cv.ring), full, empty, rank);
      return;
    }
  }
  SPAN_START(t_kernel);
  Ring ring{smem_u32(smem + cv.ring), full, empty, p.stages, cs * KC * 2, 0};

  auto valid = [&](int row) {
    const int pos = pos0 + row;
    return pos >= 0 && pos < t_len;
  };
  // a convolution's product; in the wide form its source (cur or ybuf, the
  // same offset in every CTA of the cluster) comes from the cluster's CTAs
  auto run = [&](const Prod<T>& pr, const T* w, long tap_stride,
                 long row_stride, const auto* bias, auto pre, auto epi) {
    if constexpr (MMA) {
      if constexpr (WIDE) {
        bf16* abuf = reinterpret_cast<bf16*>(smem + cv.abuf);
        const size_t chunk = al128((size_t)tw * KC * 2) / 2;
        const uint32_t sa = smem_u32(pr.src);
        const int r0 = max(0, pr.a0 + pr.off0);
        const int r1 = min(tw, pr.a0 + pr.rows + pr.off0 +
                                   (pr.n_taps - 1) * pr.dstep);
        Prod<T> pa = pr;
        pa.ld = tw;
        pa.k = KC;
        product_mma<CS, true>(pa, ring, bias, pre, epi, pr.k / KC,
                              [&](int g) -> const bf16* {
          bf16* dst = abuf + (g & 1) * chunk;
          copy_chunk(sa, g * KC / cs, (g * KC % cs) / 8, dst, r0, r1, tw,
                     pr.leaky);
          return dst;
        });
      } else {
        product_mma<CS, false>(pr, ring, bias, pre, epi, 1,
                               [](int) -> const bf16* { return nullptr; });
      }
    } else {
      product_fma<WIDE>(pr, reinterpret_cast<const float*>(w), tap_stride,
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
    // leaky applied, 0 outside [0, s_in * t_valid); input channels in
    // chunks of cw (all of C_in where the whole tile fits)
    const int s = p.s_up, ci = p.c_in, cw = p.cw, n_g = ci / cw;
    const int ldi = MMA ? p.in_rows : cw + PAD;
    const int in0 = floordiv(pos0, s) - p.in_halo;
    T* tin = reinterpret_cast<T*>(smem + cv.tile);
    const T* x = static_cast<const T*>(p.x) + (size_t)b * p.s_in * ci * p.t;
    // chunk g of the tile; a thread takes VEC channels of a row:
    // independent loads, coalesced across the warp's rows, one 16-byte store
    auto load_tile = [&](int g) {
      const int n_in = cw / VEC * p.in_rows;
      for (int it = tid; it < n_in; it += NC) {
        const int ch = it / p.in_rows * VEC, row = it % p.in_rows;
        const int q = in0 + row;
        const int lane = floordiv(q, p.s_in), r_in = q - lane * p.s_in;
        const bool ok = q >= 0 && lane < p.t_valid;
        const T* xq = x + ((size_t)r_in * ci + g * cw + ch) * p.t + lane;
        float v[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = ok ? ld(xq + (size_t)k * p.t) : 0.f;
        st_vec(tin + at<T>(row, ch, ldi), v, true);
      }
    };
    if (n_g == 1) {
      load_tile(0);
      consumers_sync<T>();
    }
    // per output phase r of the stride: window rows o_r + s * i take taps
    // m_first + j * s from input rows (sample order) q_r + i + offset
    const int pad_up = p.k_up - 1 - (p.k_up - s) / 2;
    const float* ub = p.up_b + rank * cs;
    auto phase = [&](int r) {
      const int m_first = ((pad_up - r) % s + s) % s;
      const int o_r = ((r - pos0) % s + s) % s;
      Prod<T> pr;
      pr.src = tin;
      pr.ld = ldi;
      pr.src_rows = p.in_rows;
      pr.leaky = false;
      pr.k = cw;
      pr.n_taps = (p.k_up - m_first + s - 1) / s;
      pr.off0 = (r + m_first - pad_up) / s;    // exact
      pr.dstep = 1;
      pr.a0 = (pos0 + o_r - r) / s - in0;     // exact division
      pr.rows = (tw - o_r + s - 1) / s;
      pr.o0 = o_r;
      pr.ostride = s;
      return pr;
    };
    if constexpr (MMA) {
      for (int r = 0; r < s; ++r) {
        const Prod<T> pr = phase(r);
        auto epi = [&](int o, int col, P y, P) {
          *pair(ubuf, o, col, lds) = valid(o) ? y : zero;
        };
        if constexpr (CHUNKED) {
          // the tile's chunks in turn, the f32 sum in the accumulators
          product_mma<CS, true>(pr, ring, ub, no_pre, epi, n_g,
                                [&](int g) -> const bf16* {
            if (n_g > 1) {
              consumers_sync<T>();
              load_tile(g);
              fence_proxy_async_shared();
              consumers_sync<T>();
            }
            return tin;
          });
        } else {
          product_mma<CS, false>(pr, ring, ub, no_pre, epi, 1,
                                 [](int) -> const bf16* { return nullptr; });
        }
      }
    } else {
      // per chunk every phase, the f32 sum in ubuf; the bias and the mask
      // with the last chunk
      for (int g = 0; g < n_g; ++g) {
        if (n_g > 1) {
          if (g) consumers_sync<T>();
          load_tile(g);
          consumers_sync<T>();
        }
        const bool last_g = g == n_g - 1;
        for (int r = 0; r < s; ++r) {
          const Prod<T> pr = phase(r);
          const int m_first = ((pad_up - r) % s + s) % s;
          product_fma<false>(
              pr, static_cast<const float*>(p.up_w) +
                      ((size_t)m_first * c + rank * cs) * ci + g * cw,
              (long)s * c * ci, ci, cs, last_g ? ub : nullptr,
              [&](int o, int col) { return g ? *pair(ubuf, o, col, lds) : zero; },
              [&](int o, int col, P y, P old) {
                const P v = g ? p_add(old, y) : y;
                *pair(ubuf, o, col, lds) = !last_g || valid(o) ? v : zero;
              });
        }
      }
    }
    cluster_sync();
  }

  for (int br = 0; br < p.n_br; ++br) {
    const int krspan = branch_krspan(p, br);
    const int kr = krspan & 0xffff, span = krspan >> 16;
    SPAN_START(t_branch);
    // cur = the level's input over the window, and (bf16, narrow clusters)
    // src its activated copy, leaky(input)
    if constexpr (UPS) {
      for (int i = tid; i < (int)(al128((size_t)tw * (cs + PAD) * sizeof(T)) / 16); i += NC)
        reinterpret_cast<uint4*>(cur)[i] = reinterpret_cast<const uint4*>(ubuf)[i];
      if (!WIDE && (MMA || gathers)) gather(p, src, ubuf, 0, tw, lds, ldc, true);
    } else {
      // the rows this branch reads, VEC channels of a row per thread:
      // independent loads, coalesced across the warp's rows, 16-byte stores
      const int r_lo = HALO - span, rows = p.t_tile + 2 * span;
      const T* x = static_cast<const T*>(p.x) +
                   ((size_t)b * c + (WIDE ? rank * cs : 0)) * p.t;
      const int n_x = (gathers ? c : cs) / VEC * rows;
      for (int it = tid; it < n_x; it += NC) {
        const int ch = it / rows * VEC, row = r_lo + it % rows;
        const int pos = pos0 + row;
        const bool ok = pos >= 0 && pos < p.t;
        const T* xp = x + (size_t)ch * p.t + pos;
        float v[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = ok ? ld(xp + (size_t)k * p.t) : 0.f;
        if (!WIDE && (MMA || gathers)) st_vec(src + at<T>(row, ch, ldc), v, true);
        const int own = gathers ? ch - rank * cs : ch;
        if (own >= 0 && own < cs) st_vec(cur + at<T>(row, own, lds), v, false);
      }
    }
    // the wide form's peers read this CTA's cur
    if constexpr (WIDE) {
      cluster_sync();
    } else {
      consumers_sync<T>();
    }
    SPAN_END(CY_BRANCH_START, t_branch, tid == 0);
    // span still to come after each convolution of this branch
    int rest = span;
    for (int u = 0; u < p.n_units; ++u) {
      const int d = kr > 1 ? p.dils[u] : 1;
      const size_t wo = (size_t)u * c * kr * c;
      for (int half = 0; half < 2; ++half) {
        const bool first = half == 0;
        const int dil = first ? d : 1;
        rest -= (kr / 2) * dil;
        const bool last = !first && u == p.n_units - 1;
        const int lo = max(0, HALO - rest);
        const int hi = min(tw, HALO + p.t_tile + rest);
        // sources: bf16 reads the activated copy in src (the first
        // convolution's, or with narrow clusters either's); f32 reads cur
        // (leaky on load) or ybuf, or with narrow clusters src; the wide
        // form reads cur (leaky on the copy or load) or ybuf in every CTA
        const bool from_src = !WIDE && (gathers || (MMA && first));
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
        const B* bias = static_cast<const B*>(p.biases) +
                        ((size_t)(2 * br + (first ? 0 : 1)) * p.n_units + u) * c +
                        rank * cs;
        // (the f32 products read the weights through the table; bf16
        // streams them through the ring)
        const T* wgt = MMA ? nullptr
                           : static_cast<const T*>(branch_w(p, br, first ? 0 : 1)) +
                                 wo + (size_t)rank * cs * kr * c;
        if (first) {
          run(pr, wgt, c, (long)kr * c, bias, no_pre,
              [&](int o, int col, P y, P) {
                *pair(ybuf, o, col, lds) = valid(o) ? p_leaky(y) : zero;
              });
        } else {
          // one CTA per tile in bf16: the next unit's activated source is
          // written here, as the residual is
          const bool act = !WIDE && MMA && !gathers && !last;
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

// The branches into p; false on a shape the kernel does not take (the
// table in device memory holds the same kernel sizes and spans, mrf.py
// ``branch_table``).
bool set_branches(Params& p, const void* table, const void* biases,
                  const int* krs, int n_br, const int* dils, int n_units) {
  if (!table || !biases || n_br < 1 || n_units < 1) return false;
  for (int u = 0; u < n_units; ++u)
    if (dils[u] < 1) return false;
  for (int i = 0; i < n_br; ++i) {
    if (krs[i] < 1 || (krs[i] > 1 && n_units > MAX_UNITS)) return false;
    int span = 0;
    for (int u = 0; u < n_units; ++u) span += (krs[i] / 2) * (dils[u] + 1);
    if (span > HALO) return false;
  }
  p.table = static_cast<const long long*>(table);
  p.biases = biases;
  for (int i = 0; i < n_br && i < PARAM_BRANCHES; ++i) {
    int span = 0;
    for (int u = 0; u < n_units; ++u) span += (krs[i] / 2) * (dils[u] + 1);
    p.krspan[i] = krs[i] | span << 16;
  }
  for (int u = 0; u < n_units && u < MAX_UNITS; ++u) p.dils[u] = dils[u];
  p.n_br = n_br;
  p.n_units = n_units;
  return true;
}

// The plan's own checks: a channel slice the form takes (narrow: a power
// of two up to 256 channels in slices of 16-64, at most MAX_CLUSTER CTAs;
// wide: slices of 64 or 128, at most WIDE_CLUSTER CTAs, bf16 windows of at
// most two M tiles per warpgroup at 128), a window of at most MAX_TW rows,
// a ring of MIN_STAGES..MAX_STAGES stages (bf16) and a carve within the
// H100's shared memory per block.
template <typename T>
bool set_plan(Params& p, int c, int cs, int t_tile, int stages, bool ups,
              bool wide) {
  constexpr bool MMA = sizeof(T) == 2;
  const int tw = t_tile + 2 * HALO;
  if (t_tile < 16 || t_tile % 8 || tw > MAX_TW ||
      (MMA && (stages < MIN_STAGES || stages > MAX_STAGES)))
    return false;
  if (wide) {
    if ((cs != 64 && cs != 128) || c % cs || c / cs > WIDE_CLUSTER ||
        (MMA && cs > 64 && tw > 2 * 64 * 2))
      return false;
  } else if (c < 16 || c > 256 || (c & (c - 1)) || cs < 16 || cs > 64 ||
             c % cs || c / cs > MAX_CLUSTER) {
    return false;
  }
  p.c = c;
  p.cs = cs;
  p.n = c / cs;
  p.t_tile = t_tile;
  p.stages = MMA ? stages : 0;
  p.cv = carve(sizeof(T), c, cs, t_tile, p.stages, ups, p.cw, p.in_rows,
               wide);
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
  if (p.n > MAX_CLUSTER) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
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
int dispatch(const Params& p, bool wide, long tiles, int batch, int device,
             cudaStream_t stream) {
  constexpr int TH = Cfg<T>::THREADS;
  if constexpr (sizeof(T) == 2) {
    if (wide) {
      switch (p.cs) {
        case 64: return start(level_kernel<T, UPS, 64, true, UPS>, p, TH, tiles, batch, device, stream);
        case 128:
          // the tail's levels past 1,024 channels lie past the Pallas count
          if constexpr (!UPS)
            return start(level_kernel<T, UPS, 128, true>, p, TH, tiles, batch, device, stream);
          return (int)cudaErrorInvalidValue;
        default: return (int)cudaErrorInvalidValue;
      }
    }
    if (UPS && p.c_in > p.cw) {
      switch (p.cs) {
        case 16: return start(level_kernel<T, UPS, 16, false, UPS>, p, TH, tiles, batch, device, stream);
        case 32: return start(level_kernel<T, UPS, 32, false, UPS>, p, TH, tiles, batch, device, stream);
        case 64: return start(level_kernel<T, UPS, 64, false, UPS>, p, TH, tiles, batch, device, stream);
        default: return (int)cudaErrorInvalidValue;
      }
    }
    switch (p.cs) {
      case 16: return start(level_kernel<T, UPS, 16, false>, p, TH, tiles, batch, device, stream);
      case 32: return start(level_kernel<T, UPS, 32, false>, p, TH, tiles, batch, device, stream);
      case 64: return start(level_kernel<T, UPS, 64, false>, p, TH, tiles, batch, device, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    if (wide)
      return start(level_kernel<T, UPS, 0, true>, p, TH, tiles, batch, device, stream);
    return start(level_kernel<T, UPS, 0, false>, p, TH, tiles, batch, device, stream);
  }
}

template <typename T>
int launch(const void* x, void* out, const void* table, const void* biases,
           const void* packed, long long rank_elems, const int* krs, int n_br, const int* dils,
           int n_units, int batch, int c, int t, int cs, int t_tile,
           int stages, int wide, int device, cudaStream_t stream) {
  Params p = {};
  if (!set_branches(p, table, biases, krs, n_br, dils, n_units) ||
      !set_plan<T>(p, c, cs, t_tile, stages, false, wide) || batch < 1 ||
      batch > 65535 || t < 1 || (sizeof(T) == 2 && (!packed || rank_elems < 1)))
    return (int)cudaErrorInvalidValue;
  p.x = x;
  p.out = out;
  p.packed = static_cast<const bf16*>(packed);
  p.rank_elems = rank_elems;
  p.t = t;
  p.s_in = p.s_up = 1;
  return dispatch<T, false>(p, wide, (t + t_tile - 1) / t_tile, batch, device,
                            stream);
}

template <typename T>
int launch_ups(const void* x, void* out, const void* up_w, const float* up_b,
               const void* table, const void* biases, const void* packed,
               long long rank_elems,
               const int* krs, int n_br, const int* dils, int n_units,
               int batch, int c_in, int c, int s_in, int s_up, int k_up,
               int t_ps, int t_valid, int cs, int t_tile, int stages,
               int wide, int cw, int device, cudaStream_t stream) {
  Params p = {};
  const int s_out = s_in * s_up;
  // C_in and its tile chunk: a power of two below KC (whole), else
  // multiples of KC
  if (s_in < 1 || s_up < 2 || s_out > 4 || k_up < s_up || (k_up - s_up) % 2 ||
      c_in < 16 || (c_in < KC ? KC % c_in : c_in % KC) || cw < 16 ||
      c_in % cw || (cw < KC ? cw != c_in : cw % KC) || t_tile % s_out)
    return (int)cudaErrorInvalidValue;
  // the input rows the farthest tap reaches away from its output's own
  // input sample (ups_mrf.py tap_reach), held by the tile's halo
  const int pad_up = k_up - 1 - (k_up - s_up) / 2;
  const int reach = max((pad_up + s_up - 1) / s_up,
                        (s_up - 1 + k_up - 1 - pad_up) / s_up);
  p.c_in = c_in;
  p.cw = cw;
  p.s_in = s_in;
  p.s_up = s_up;
  p.k_up = k_up;
  p.in_halo = max(IN_HALO, reach);
  // the window's input rows (at least one 64-row tile) and in_halo + 1
  // more on each side
  p.in_rows =
      max((t_tile + 2 * HALO + s_up - 1) / s_up, 64) + 2 * p.in_halo + 1;
  if (!set_branches(p, table, biases, krs, n_br, dils, n_units) ||
      !set_plan<T>(p, c, cs, t_tile, stages, true, wide) || batch < 1 ||
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
  return dispatch<T, true>(p, wide, (samples + t_tile - 1) / t_tile, batch,
                           device, stream);
}

}  // namespace

// table: per kernel size the pointers of w1, w2 and kr | span << 16
// (mrf.py ``branch_table``), and biases: every bias of the level (mrf.py
// ``pack_biases``), both in device memory; krs and dils: the same
// on the host, checked before the launch. The f32 entries read the weights
// through the table ([U, C, kr*C], j-major im2col columns), the bf16
// entries from `packed` (mrf.py ``pack_weights``). wide: the wide form
// (mrf.py ``plan``).
extern "C" int mrf_f32(const void* x, void* out, const void* table,
                       const void* biases, const void* packed,
                       long long rank_elems,
                       const int* krs, int n_br, const int* dils, int n_units,
                       int batch, int c, int t, int cs, int t_tile,
                       int stages, int wide, int device,
                       cudaStream_t stream) {
  return launch<float>(x, out, table, biases, packed, rank_elems, krs, n_br,
                       dils, n_units, batch, c, t, cs, t_tile, stages, wide,
                       device, stream);
}

extern "C" int mrf_bf16(const void* x, void* out, const void* table,
                        const void* biases, const void* packed,
                        long long rank_elems,
                        const int* krs, int n_br, const int* dils,
                        int n_units, int batch, int c, int t, int cs,
                        int t_tile, int stages, int wide, int device,
                        cudaStream_t stream) {
  return launch<bf16>(x, out, table, biases, packed, rank_elems, krs, n_br,
                      dils, n_units, batch, c, t, cs, t_tile, stages, wide,
                      device, stream);
}

// cw: the input channels of a tile chunk (c_in where the tile loads whole)
extern "C" int ups_mrf_f32(const void* x, void* out, const void* up_w,
                           const float* up_b, const void* table,
                           const void* biases, const void* packed,
                           long long rank_elems,
                           const int* krs, int n_br, const int* dils,
                           int n_units, int batch, int c_in, int c, int s_in,
                           int s_up, int k_up, int t_ps, int t_valid, int cs,
                           int t_tile, int stages, int wide, int cw,
                           int device, cudaStream_t stream) {
  return launch_ups<float>(x, out, up_w, up_b, table, biases, packed,
                           rank_elems, krs, n_br, dils, n_units, batch, c_in,
                           c, s_in, s_up, k_up, t_ps, t_valid, cs, t_tile,
                           stages, wide, cw, device, stream);
}

extern "C" int ups_mrf_bf16(const void* x, void* out, const void* up_w,
                            const float* up_b, const void* table,
                            const void* biases, const void* packed,
                            long long rank_elems,
                            const int* krs, int n_br, const int* dils,
                            int n_units, int batch, int c_in, int c, int s_in,
                            int s_up, int k_up, int t_ps, int t_valid, int cs,
                            int t_tile, int stages, int wide, int cw,
                            int device, cudaStream_t stream) {
  return launch_ups<bf16>(x, out, up_w, up_b, table, biases, packed,
                          rank_elems, krs, n_br, dils, n_units, batch, c_in,
                          c, s_in, s_up, k_up, t_ps, t_valid, cs, t_tile,
                          stages, wide, cw, device, stream);
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
