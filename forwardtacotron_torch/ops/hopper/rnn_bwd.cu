// Reverse-time backward sweeps of the trainable bidirectional GRU and LSTM:
// dh (and dc) carried in float32 from t = T-1 down to 0, and the
// pre-activation gradients written as bf16 every step.
//
// Replaces forwardtacotron_tpu/ops/pallas/rnn_train.py:
//   _gru_core_bwd   (body _gru_bwd_kernel)   -> rnn_gru_bwd_*: dgx, dgh
//   _lstm_core_bwd  (body _lstm_bwd_kernel)  -> rnn_lstm_bwd_*: dgates
// The weight and input gradients (x^T dgates, h_prev^T dgates, dgates Wi^T)
// are plain products over the whole [T*2*B] axis outside this file, as the
// JAX package leaves them to XLA.
//
// Numerics as in the TPU kernels: the incoming dhs is bf16 (cast by the
// caller), gates recompute in float32 from bf16 products with float32
// accumulation (the GRU adds bi and bh apart from its products, the LSTM
// takes bi + bh summed in bf16), h_{-1} = c_{-1} = 0, dh and dc are carried
// in float32, and dh_{t-1} = [z * dh_t +] bf16(dgh_t) @ Wh^T with float32
// accumulation. The GRU's two outputs differ in the n gate: dgx_n = dgn,
// dgh_n = dgn * r.
//
// Layout: dhs, hs, cs [T, 2, B, H]; x [T, 2, B, I] (direction 1 flipped by
// the caller, as in the forward); weights [2, K, G], torch gate order (GRU
// r,z,n; LSTM i,f,g,o), G = NG*H; outputs [T, 2, B, G].
//
// Bound on an H100: per direction two products, the gate recompute
// [T*B, I+H] x [I+H, G] and the carry dgates_t @ Wh^T, [B, G] x [G, H] per
// step (the bf16 train step's bi-LSTM: 0.55 TFLOP, 0.42 ms at the bf16
// peak). At training batch the T sequential steps of the carry, not the
// operations, set the time: each step is a few microseconds of latency
// (an exchange of the step's dgates between the CTAs of a direction, and a
// short product), so the design keeps everything that does not depend on
// dh off that chain.
//
// Two launches per sweep:
//   1. bwd_gates_kernel: the gate recompute for all T steps at once, one
//      tensor-core GEMM per direction, since the gates depend only on saved
//      forward values (x_t, h_{t-1}, c_t, c_{t-1}), not on the carried dh.
//      wgmma m64n128k16 from shared memory, A (x_t, then h_{t-1} boxes of
//      [64 rows, 64], loaded by TMA from 4D maps, so one 64-row tile holds
//      64 / B steps of one direction, or 64 batch rows of one step; h_{-1}
//      is the map's zero fill at t = -1) and B (the weights packed by the
//      wrapper as [gate tile][gate][unit] columns, K-major, the GRU's n gate
//      as two columns n_x from x rows and n_h from h rows), both with the
//      128-byte swizzle, through a ring of stages fed by a producer warp;
//      three stages, so two CTAs share an SM and one's epilogue runs under
//      the other's products. Its epilogue applies the nonlinearities in float32 and stores, per
//      (t, d, b, unit), the incoming dhs and the coefficients that make the
//      step's dgates linear in dh_total (and dc):
//        GRU   dgr = dh A_r, dgz = dh A_z, dgn = dh A_n, dgh_n = dh A_nr,
//              carry z dh;  A_n = (1-z)(1-n^2), A_r = A_n hn r(1-r),
//              A_z = (h_prev-n) z(1-z), A_nr = A_n r
//        LSTM  dc_total = dh K + dc, (dgi, dgf, dgg) = dc_total (A_i, A_f,
//              A_g), dgo = dh A_o, dc' = dc_total F;  K = o(1-tc^2),
//              A_i = g i(1-i), A_f = c_prev f(1-f), A_g = i(1-g^2),
//              A_o = tc o(1-o), F = f, tc = tanh(c_t)
//      in float32, never rounded (the TPU kernel keeps its gates in f32),
//      as [T, 2, H/16, B, NK, 16]: one sweep CTA's block of a step is
//      contiguous.
//   2. bwd_sweep_kernel: the reverse walk. CTA (s, d, r) owns hidden units
//      [16 s, 16 s + 16) of direction d and keeps their rows of Wh ([16, G],
//      the K-major B operand of dh_{t-1} = dgates_t @ Wh[units]^T) in
//      shared memory for all T steps: 64 KB for the H=512 LSTM, which the
//      old design could not afford beside its recomputed gate slice. Per
//      step, warpgroup 0 forms its units' dgates from the coefficient block
//      (a bulk copy a producer warp issues a step ahead: it does not depend
//      on dh), dhs and the carried dh and dc, on registers laid out as the
//      dh product's accumulator fragment; writes them; and arrives at the
//      group's barrier (a counter in device memory, split: the consumers
//      arrive with red.release, the producers poll with ld.acquire). The
//      producers then load the step's [B, G] row block of dgates (GRU dgh)
//      from device memory, the output itself, by TMA (3D map: rows past B
//      read zero) into two rings of [rows, 64] stages, rows = min(B, 64)
//      rounded up to 8 (the wgmma tile's other rows read on into the next
//      stage and are never used, so a stage holds only the rows a box
//      loads and a training batch of 32 gets twice the stages in flight),
//      and the two consumer warpgroups each multiply half of the K chunks
//      by the resident Wh rows (wgmma m64n16k16); warpgroup 1 hands its
//      partial sum over through shared memory.
//      Why not a cluster exchange through distributed shared memory: the
//      LSTM's 32 CTAs per direction exceed a cluster, and for the GRU (8 or
//      16 CTAs a direction, one cluster) a sweep that gathered each step's
//      slices from its peers' shared memory at one cluster barrier per step
//      measured slower on the H100 than this one (PERF.md, section 6); nor 32
//      units per CTA for the LSTM (half the exchanged bytes, twice the
//      product per CTA): slower too. What a step costs is measured with
//      copies of this file built with -DRNN_BWD_SKIP_BARRIER (the producers
//      do not wait at the barrier) and -DRNN_BWD_SKIP_PRODUCTS (no
//      products): chip_smoke.py --kernel-parts. Their sums are wrong;
//      only their times are kept.
//      Batches of more than 64 rows walk their 64-row tiles one after
//      another (tile-major over the groups), so the carry stays in
//      registers; every B and T launches. The launch is cooperative (the
//      barrier needs every CTA resident) and refuses a grid that does not
//      fit; it does not hang.
// The launch plans come from the wrapper (rnn_train.py ``plan``, which
// needs no card); the entries recompute the carves and refuse a plan that
// does not fit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int KC = 64;                   // K depth of a stage: one 128-byte swizzle row
constexpr int U = 16;                    // hidden units of one sweep CTA
constexpr int TILE = 64;                 // rows of a wgmma tile
constexpr int STAGE = TILE * KC * 2;     // one [64, 64] bf16 box
constexpr int MIN_STAGES = 2;            // sweep ring stages per warpgroup
constexpr int MAX_STAGES = 16;
constexpr int COEF_SLOTS = 2;            // coefficient blocks in flight: the next loads a step ahead
constexpr int GATE_UNITS = 32;           // hidden units of one gate-product column tile
constexpr int GATE_N = 4 * GATE_UNITS;   // its columns: 4 gate blocks
constexpr int GATE_STAGE = 2 * STAGE + GATE_N * KC * 2;  // two A boxes and the B box
constexpr int GATE_MIN_STAGES = 2;
constexpr int GATE_MAX_STAGES = 3;       // two CTAs per SM: one's epilogue under the other's products
constexpr int GATE_THREADS = 2 * 128 + 32;   // two consumer warpgroups, a producer warp
constexpr int SWEEP_THREADS = 2 * 128 + 64;  // two consumer warpgroups, two producer warps

template <bool LSTM>
struct Cell {
  static constexpr int NG = LSTM ? 4 : 3;  // gates
  static constexpr int NK = LSTM ? 7 : 6;  // f32 values per (t, d, b, unit): dhs, coefficients
};

__host__ __device__ inline size_t align128(size_t n) { return (n + 127) & ~(size_t)127; }
__host__ __device__ inline int round64(int n) { return (n + 63) & ~63; }

// Shared memory of one gate-product CTA: its mbarriers (128 B), 1024 B of
// slack for the swizzle's alignment, `stages` stages. rnn_train.py ``plan``
// repeats this sum.
__host__ __device__ inline size_t gate_smem(int stages) {
  return 128 + 1024 + (size_t)stages * GATE_STAGE;
}

// Shared memory of one sweep CTA, in carve order: the Wh rows [16, G padded
// to 64] as core matrices, COEF_SLOTS coefficient blocks [rows, NK, 16] f32,
// warpgroup 1's partial sums [8][128] f32, the mbarriers, then two rings of
// `stages` stages of [rows, 64] bf16, 1024-byte aligned inside 1024 B of
// slack. `rows` is the box's: min(B, 64) rounded up to 8. A stage holds
// only the rows a box loads; the wgmma tile's other rows read on into the
// next stage (the tail slack after the last), and their sums are never
// used. rnn_train.py ``plan`` repeats this sum.
struct SweepCarve {
  size_t w, coef, part, bars, ring, total;
};

__host__ __device__ inline SweepCarve sweep_carve(int nk, int g, int rows, int stages) {
  SweepCarve c;
  c.w = 0;
  c.coef = align128((size_t)U * round64(g) * 2);
  c.part = c.coef + (size_t)COEF_SLOTS * rows * nk * U * 4;
  c.bars = c.part + 8 * 128 * 4;
  c.ring = c.bars + align128((4 * MAX_STAGES + 2 * COEF_SLOTS) * 8);
  c.total = c.ring + 1024 + ((size_t)2 * stages * rows + TILE - rows) * KC * 2;
  return c;
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (row, k) in K-major core matrices (8 rows x 16 B,
// 128 contiguous bytes each): k-neighbours 128 B apart, 8-row groups `sbo`
__device__ __forceinline__ uint32_t core_off(int row, int k, int sbo) {
  return (row >> 3) * sbo + (k >> 3) * 128 + (row & 7) * 16 + (k & 7) * 2;
}

// wgmma shared-memory descriptors: core matrices without swizzle (LBO =
// k-neighbour core matrices, SBO = 8-row groups, in 16-byte units), and a
// TMA box with the 128-byte swizzle (8 rows of 128 B = 1024 B per row group)
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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

// TMA boxes of 2D, 3D and 4D tensor maps into shared memory; completion
// counted in bytes on `bar`; coordinates outside the tensor read zero
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes global -> shared by the TMA unit, completion
// counted on `bar` (one arrival with the byte count)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// generic-proxy writes to global memory (the dgates) ordered before
// async-proxy reads (the TMA loads of the other CTAs)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// the group barrier's counter: an arrival that releases the CTA's writes
// (those its threads made before a bar.sync with this one), and a read
// that acquires the arrivals' writes
__device__ __forceinline__ void red_release(unsigned int* bar) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(bar) : "memory");
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* bar) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(bar) : "memory");
  return v;
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

// wgmma m64nNk16, bf16 x bf16 -> f32, A and B K-major in shared memory:
// D = A B + (acc ? D : 0); N = 2 x the accumulator's length
__device__ __forceinline__ void wgmma(float (&d)[8], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
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


// ------------------------------------------------------ the gate product

struct GateParams {
  CUtensorMap xmap;  // x as [I, B, 2, T] in boxes {64, bb, 1, tb}, 128-byte swizzle
  CUtensorMap hmap;  // hs as [H, B, 2, T], the same boxes
  CUtensorMap wmap;  // packed weights as [KP, 2 NC] in boxes {64, GATE_N}, 128-byte swizzle
  const bf16* hs;    // [T, 2, B, H]
  const bf16* cs;    // [T, 2, B, H] (LSTM)
  const bf16* dhs;   // [T, 2, B, H]
  const bf16* bx;    // [2, G]: GRU bi, LSTM bi + bh
  const bf16* bh;    // [2, G]: GRU bh (null for the LSTM)
  float* coef;       // [T, 2, H/U, B, NK, U]
  int T, B, I, H, NC, bb, tb, n_mtiles, n_ntiles, stages;
};

// tile mt of one direction: steps [t0, t0 + tb) x batch rows [b0, b0 + bb),
// row r of the tile = step t0 + r / bb, batch row b0 + r % bb
__device__ __forceinline__ void gate_tile(const GateParams& p, int mt, int& t0, int& b0) {
  const int nbb = (p.B + p.bb - 1) / p.bb;
  t0 = (mt / nbb) * p.tb;
  b0 = (mt % nbb) * p.bb;
}

template <bool LSTM>
__global__ void __launch_bounds__(GATE_THREADS, 2)
    bwd_gates_kernel(const __grid_constant__ GateParams p) {
  constexpr int NK = Cell<LSTM>::NK;
  // block -> (column tile nt, direction d, pair of row tiles mp): the
  // column tiles of one pair of row tiles run side by side, sharing A in L2
  long blk = blockIdx.x;
  const int nt = (int)(blk % p.n_ntiles);
  blk /= p.n_ntiles;
  const int d = (int)(blk & 1);
  const int mp = (int)(blk >> 1);
  const int tid = threadIdx.x;
  const int G = (LSTM ? 4 : 3) * p.H;
  const int nkx = round64(p.I) / KC, nkc = nkx + round64(p.H) / KC;

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full = smem_u32(smem), empty = full + 8 * GATE_MAX_STAGES;
  const uint32_t ring = (smem_u32(smem + 128) + 1023) & ~1023u;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(full + 8 * i, 1);   // the producer's arrive + the bytes
      mbar_init(empty + 8 * i, 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // the producer: per K chunk the two row tiles' x_t (then h_{t-1}) boxes
    // and the column tile's weight box
    if (tid != 256) return;
    const int a_bytes = 128 * p.bb * p.tb;
    for (int kc = 0; kc < nkc; ++kc) {
      const int slot = kc % p.stages;
      if (kc >= p.stages) mbar_wait(empty + 8 * slot, (kc / p.stages - 1) & 1);
      mbar_expect_tx(full + 8 * slot, 2 * a_bytes + GATE_N * KC * 2);
      const uint32_t st = ring + slot * GATE_STAGE;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        int t0, b0;
        gate_tile(p, 2 * mp + m, t0, b0);
        if (kc < nkx)
          tma_load_4d(st + m * STAGE, &p.xmap, kc * KC, b0, d, t0, full + 8 * slot);
        else  // h_{t-1}: the row above is step t0 - 1, zero at -1
          tma_load_4d(st + m * STAGE, &p.hmap, (kc - nkx) * KC, b0, d, t0 - 1, full + 8 * slot);
      }
      tma_load_2d(st + 2 * STAGE, &p.wmap, kc * KC, d * p.NC + nt * GATE_N, full + 8 * slot);
    }
    return;
  }

  // consumer warpgroup wg: row tile 2 mp + wg, all GATE_N columns
  const int wg = tid >> 7, warp4 = (tid >> 5) & 3, lane = tid & 31;
  float acc[GATE_N / 2];
  for (int kc = 0; kc < nkc; ++kc) {
    const int slot = kc % p.stages;
    mbar_wait(full + 8 * slot, (kc / p.stages) & 1);
    const uint32_t a0 = ring + slot * GATE_STAGE + wg * STAGE;
    const uint32_t b0 = ring + slot * GATE_STAGE + 2 * STAGE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks)
      wgmma(acc, desc_sw128(a0 + ks * 32), desc_sw128(b0 + ks * 32), kc + ks > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (kc > 0 && lane == 0) mbar_arrive(empty + 8 * ((kc - 1) % p.stages));
  }
  wgmma_wait<0>();

  // epilogue: the thread's fragment holds rows row0 and row0 + 8 and, per
  // 8-unit block jj of the tile's 32 units, units jj 8 + 2 (lane % 4) + e
  // of all four gate blocks: acc[16 g + 4 jj + 2 i + e]
  int t0, b0;
  gate_tile(p, 2 * mp + wg, t0, b0);
  const int S = p.H / U;
  const size_t plane = (size_t)2 * p.B * p.H;  // one step of a [T, 2, B, H] tensor
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp4 * 16 + (lane >> 2) + 8 * i;
    const int t = t0 + r / p.bb, b = b0 + r % p.bb;
    if (r >= p.bb * p.tb || t >= p.T || b >= p.B) continue;
    const size_t hrow = ((size_t)(t * 2 + d) * p.B + b) * p.H;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int unit = nt * GATE_UNITS + jj * 8 + 2 * (lane & 3);
      if (unit >= p.H) continue;
      const float2 dh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.dhs + hrow + unit));
      float2 prev = make_float2(0.f, 0.f);  // GRU h_{t-1}, LSTM c_{t-1}
      if (t > 0)
        prev = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            (LSTM ? p.cs : p.hs) + hrow - plane + unit));
      float2 ct = make_float2(0.f, 0.f);
      if (LSTM) ct = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p.cs + hrow + unit));
      float co[NK][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int a = 4 * jj + 2 * i + e, u = unit + e;
        const bf16* bx = p.bx + (size_t)d * G;
        co[0][e] = e ? dh.y : dh.x;
        const float pv = e ? prev.y : prev.x;
        if constexpr (LSTM) {
          const float gi = sigmoidf(acc[a] + __bfloat162float(bx[u]));
          const float gf = sigmoidf(acc[16 + a] + __bfloat162float(bx[p.H + u]));
          const float gg = tanhf(acc[32 + a] + __bfloat162float(bx[2 * p.H + u]));
          const float go = sigmoidf(acc[48 + a] + __bfloat162float(bx[3 * p.H + u]));
          const float tc = tanhf(e ? ct.y : ct.x);
          co[1][e] = go * (1.f - tc * tc);
          co[2][e] = gg * gi * (1.f - gi);
          co[3][e] = pv * gf * (1.f - gf);
          co[4][e] = gi * (1.f - gg * gg);
          co[5][e] = tc * go * (1.f - go);
          co[6][e] = gf;
        } else {
          const bf16* bh = p.bh + (size_t)d * G;
          const float rg = sigmoidf(acc[a] + __bfloat162float(bx[u]) + __bfloat162float(bh[u]));
          const float zg = sigmoidf(acc[16 + a] + __bfloat162float(bx[p.H + u]) +
                                    __bfloat162float(bh[p.H + u]));
          const float hn = acc[48 + a] + __bfloat162float(bh[2 * p.H + u]);
          const float ng = tanhf(acc[32 + a] + __bfloat162float(bx[2 * p.H + u]) + rg * hn);
          const float an = (1.f - zg) * (1.f - ng * ng);
          co[1][e] = an * hn * rg * (1.f - rg);
          co[2][e] = (pv - ng) * zg * (1.f - zg);
          co[3][e] = an;
          co[4][e] = an * rg;
          co[5][e] = zg;
        }
      }
      float* dst = p.coef + (((size_t)(t * 2 + d) * S + unit / U) * p.B + b) * NK * U + unit % U;
#pragma unroll
      for (int k = 0; k < NK; ++k)
        *reinterpret_cast<float2*>(dst + k * U) = make_float2(co[k][0], co[k][1]);
    }
  }
}

// ---------------------------------------------------------- the sweep

struct SweepParams {
  CUtensorMap emap;   // the exchanged gradient (GRU dgh, LSTM dgates) as [G, B, 2T] in
                      // boxes {64, box_rows, 1}, 128-byte swizzle
  const float* coef;  // [T, 2, H/U, B, NK, U]
  const bf16* wh;     // [2, H, G]
  bf16* dgx;          // [T, 2, B, G]: GRU dgx, LSTM dgates
  bf16* dgh;          // [T, 2, B, G]: GRU dgh (null for the LSTM)
  unsigned int* bar;  // [2, R] barrier counters, zero at launch
  int T, B, H, R, P, box_rows;
};

// Warpgroup 0's part of a sweep step: dgates_t of the CTA's units for the
// thread's pairs (rows row0 + 8 i, units 8 j + 2 (lane % 4) + e, as
// acc[4 j + 2 i + e] of the m64n16 product) from the coefficient block cf
// ([rows, NK, U] f32: dhs, then the coefficients), the carried dc and dh
// (GRU: z dh_total) and, where `prod`, the product of step t+1 (this
// warpgroup's acc plus warpgroup 1's part). Writes dgx (and dgh) rows b0 +
// row < B at `row_base` = (t * 2 + d) * B.
template <bool LSTM>
__device__ __forceinline__ void form_dgates(const float* cf, const float (&acc)[8],
                                            const float* part, bool prod, float (&carry)[8],
                                            float (&dc)[8], int b0, int B, size_t row_base, int H,
                                            int s, bf16* dgx, bf16* dgh) {
  constexpr int NG = Cell<LSTM>::NG, NK = Cell<LSTM>::NK;
  const int ltid = threadIdx.x & 127, lane = threadIdx.x & 31;
  const int row0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2), u0 = 2 * (lane & 3);
  const int G = NG * H;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i, b = b0 + row;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float gv[4][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int a = 4 * j + 2 * i + e;
        const float* c = cf + row * NK * U + 8 * j + u0 + e;
        const float sum = prod ? acc[a] + part[a * 128 + ltid] : 0.f;
        const float dh = c[0] + (carry[a] + sum);
        if constexpr (LSTM) {
          const float dct = dh * c[U] + dc[a];
          gv[0][e] = dct * c[2 * U];
          gv[1][e] = dct * c[3 * U];
          gv[2][e] = dct * c[4 * U];
          gv[3][e] = dh * c[5 * U];
          dc[a] = dct * c[6 * U];
        } else {
          gv[0][e] = dh * c[U];
          gv[1][e] = dh * c[2 * U];
          gv[2][e] = dh * c[3 * U];
          gv[3][e] = dh * c[4 * U];
          carry[a] = dh * c[5 * U];
        }
      }
      const size_t at = (row_base + b) * G + s * U + 8 * j + u0;
#pragma unroll
      for (int g = 0; g < NG; ++g)
        if (b < B)
          *reinterpret_cast<__nv_bfloat162*>(dgx + at + g * H) =
              __floats2bfloat162_rn(gv[g][0], gv[g][1]);
      if constexpr (!LSTM) {
#pragma unroll
        for (int g = 0; g < 3; ++g)  // dgh: r, z as dgx, n as dgn r
          if (b < B)
            *reinterpret_cast<__nv_bfloat162*>(dgh + at + g * H) =
                __floats2bfloat162_rn(gv[g == 2 ? 3 : g][0], gv[g == 2 ? 3 : g][1]);
      }
    }
  }
}

template <bool LSTM>
__global__ void __launch_bounds__(SWEEP_THREADS, 1)
    bwd_sweep_kernel(const __grid_constant__ SweepParams p) {
  constexpr int NG = Cell<LSTM>::NG, NK = Cell<LSTM>::NK;
  const int s = blockIdx.x, d = blockIdx.y, r = blockIdx.z;
  const int S = gridDim.x, R = p.R, P = p.P, T = p.T, B = p.B, H = p.H;
  const int G = NG * H, GP = round64(G);
  const int nch = GP / KC, nch0 = (nch + 1) / 2;  // K chunks; warpgroup 0 takes the first nch0
  const int tid = threadIdx.x;

  extern __shared__ __align__(128) unsigned char smem[];
  const int rows = p.box_rows;  // rows of a stage and a coefficient block
  const int stage = rows * KC * 2;
  const SweepCarve cv = sweep_carve(NK, G, rows, P);
  unsigned char* Ws = smem + cv.w;
  float* coefs = reinterpret_cast<float*>(smem + cv.coef);
  float* part = reinterpret_cast<float*>(smem + cv.part);
  const uint32_t full = smem_u32(smem + cv.bars), empty = full + 8 * 2 * MAX_STAGES;
  const uint32_t cfull = empty + 8 * 2 * MAX_STAGES, cempty = cfull + 8 * COEF_SLOTS;
  const uint32_t ring = (smem_u32(smem + cv.ring) + 1023) & ~1023u;
  const int sbo_w = GP * 16;
  const int SLOT = rows * NK * U;  // floats of one coefficient block

  // this CTA's rows of Wh, [U, GP] as core matrices (zero past G)
  for (int i = tid; i < U * (GP / 8); i += blockDim.x) {
    const int u = i / (GP / 8), k = (i - u * (GP / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (k < G) v = *reinterpret_cast<const uint4*>(p.wh + ((size_t)d * H + s * U + u) * G + k);
    *reinterpret_cast<uint4*>(Ws + core_off(u, k, sbo_w)) = v;
  }
  if (tid == 0) {
    for (int i = 0; i < 2 * P; ++i) {
      mbar_init(full + 8 * i, 1);   // the producer's arrive + the bytes
      mbar_init(empty + 8 * i, 4);  // one arrive per warp of the warpgroup
    }
    for (int i = 0; i < COEF_SLOTS; ++i) {
      mbar_init(cfull + 8 * i, 1);
      mbar_init(cempty + 8 * i, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // Ws for wgmma
  __syncthreads();

  unsigned int* bar = p.bar + d * R + r;
  const int n_tiles = (B + TILE - 1) / TILE;

  if (tid >= 256) {
    // producer warp w feeds consumer warpgroup w: its K chunks of each
    // step's exchanged row block, after the group's barrier; warp 0 also
    // loads the coefficient blocks, one step ahead (they do not depend on dh)
    const int w = (tid - 256) >> 5;
    if (tid & 31) return;
    const int q0 = w ? nch0 : 0, q1 = w ? nch : nch0;
    uint32_t gc = 0, gq = 0, n_bar = 0;
    auto load_coef = [&](int t, int b0, int n) {
      const uint32_t slot = gq % COEF_SLOTS;
      if (gq >= (uint32_t)COEF_SLOTS) mbar_wait(cempty + 8 * slot, (gq / COEF_SLOTS - 1) & 1);
      bulk_load(smem_u32(coefs + slot * SLOT),
                p.coef + (((size_t)(t * 2 + d) * S + s) * B + b0) * NK * U, n * NK * U * 4,
                cfull + 8 * slot);
      ++gq;
    };
    for (int tile = r; tile < n_tiles; tile += R) {
      const int b0 = tile * TILE, n = min(TILE, B - b0);
      if (w == 0) load_coef(T - 1, b0, n);
      for (int t = T - 1; t > 0; --t) {
        if (w == 0) load_coef(t - 1, b0, n);
        ++n_bar;
#ifndef RNN_BWD_SKIP_BARRIER  // diagnostic: the exchange without its wait (wrong sums)
        while (ld_acquire(bar) < n_bar * (unsigned)S) {
        }
#endif
        fence_proxy_async_global();
        for (int q = q0; q < q1; ++q, ++gc) {
          const uint32_t slot = w * P + gc % P;
          if (gc >= (uint32_t)P) mbar_wait(empty + 8 * slot, (gc / P - 1) & 1);
          mbar_expect_tx(full + 8 * slot, stage);
          tma_load_3d(ring + slot * stage, &p.emap, q * KC, b0, t * 2 + d, full + 8 * slot);
        }
      }
    }
    return;
  }

  // the consumer warpgroups: warpgroup 0 forms each step's dgates, both
  // multiply half of the K chunks
  const int wg = tid >> 7, lane = tid & 31, ltid = tid & 127;
  const int q0 = wg ? nch0 : 0, q1 = wg ? nch : nch0;
  uint32_t gc = 0, gq = 0;
  float acc[8], carry[8], dc[8];
  for (int tile = r; tile < n_tiles; tile += R) {
    const int b0 = tile * TILE;
#pragma unroll
    for (int a = 0; a < 8; ++a) carry[a] = dc[a] = 0.f;
    for (int t = T - 1; t >= 0; --t) {
      if (wg == 0) {
        // dgates_t of this CTA's units from dhs, the coefficients, the
        // carried dc and dh: z dh_total (GRU) + the product of step t+1
        const uint32_t slot = gq % COEF_SLOTS;
        mbar_wait(cfull + 8 * slot, (gq / COEF_SLOTS) & 1);
        form_dgates<LSTM>(coefs + slot * SLOT, acc, part, t < T - 1, carry, dc, b0, B,
                          (size_t)(t * 2 + d) * B, H, s, p.dgx, p.dgh);
        __syncwarp();
        if (lane == 0) mbar_arrive(cempty + 8 * slot);
        ++gq;
        if (t > 0) {  // dgates_t of this CTA's units are out: arrive at the group
          fence_proxy_async_global();
          asm volatile("bar.sync 2, 128;\n" ::: "memory");
          if (tid == 0) red_release(bar);
        }
      }
      if (t > 0) {
        // this warpgroup's K chunks of dgates_t @ Wh[units]^T
        if (q1 == q0) {
#pragma unroll
          for (int a = 0; a < 8; ++a) acc[a] = 0.f;
        }
        for (int q = q0; q < q1; ++q, ++gc) {
          const uint32_t slot = wg * P + gc % P;
          mbar_wait(full + 8 * slot, (gc / P) & 1);
          const uint32_t a0 = ring + slot * stage;
          const uint32_t w0 = smem_u32(Ws) + q * (KC / 8) * 128;
          wgmma_fence();
#ifndef RNN_BWD_SKIP_PRODUCTS  // diagnostic: the stages arrive and go, no products
#pragma unroll
          for (int ks = 0; ks < KC / 16; ++ks)
            wgmma(acc, desc_sw128(a0 + ks * 32), desc_plain(w0 + ks * 256, sbo_w), q > q0 || ks > 0);
#endif
          wgmma_commit();
          wgmma_wait<1>();
          if (q > q0 && lane == 0) mbar_arrive(empty + 8 * (wg * P + (gc - 1) % P));
        }
        wgmma_wait<0>();
        if (q1 > q0 && lane == 0) mbar_arrive(empty + 8 * (wg * P + (gc - 1) % P));
        if (wg == 1) {
#pragma unroll
          for (int a = 0; a < 8; ++a) part[a * 128 + ltid] = acc[a];
        }
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
      }
    }
  }
}


// ------------------------------------------------------------ launches

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a bf16 tensor map of `rank` dims (dims[0] contiguous; strides in bytes of
// dims 1.. ) in boxes `box`, with the 128-byte swizzle; outside the tensor
// reads zero
int make_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
             const cuuint64_t* strides, const cuuint32_t* box) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// [T, 2, B, W] as a 4D map [W, B, 2, T] in boxes {64, bb, 1, tb}
int step_map(CUtensorMap* map, const void* base, int T, int B, int W, int bb, int tb) {
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)B, 2, (cuuint64_t)T};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)B * W * 2,
                                 (cuuint64_t)2 * B * W * 2};
  const cuuint32_t box[4] = {KC, (cuuint32_t)bb, 1, (cuuint32_t)tb};
  return make_map(map, base, 4, dims, strides, box);
}

int device_limits(int device, int* n_sm, int* max_smem) {
  cudaError_t err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Checks the gate product's plan (stages, carve) and launches it: the tile
// shape follows from B (bb = min(B, 64) batch rows x tb = 64 / bb steps).
template <bool LSTM>
int launch_gates(GateParams& p, const void* x, const void* hs, const void* wpk, int stages,
                 int smem, int device, cudaStream_t stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  int n_sm = 0, max_smem = 0;
  int st = device_limits(device, &n_sm, &max_smem);
  if (st) return st;
  if (p.I % 16 || p.H % U || stages < GATE_MIN_STAGES || stages > GATE_MAX_STAGES ||
      (size_t)smem != gate_smem(stages) || smem > max_smem)
    return (int)cudaErrorInvalidValue;
  p.stages = stages;
  p.bb = p.B < TILE ? p.B : TILE;
  p.tb = TILE / p.bb;
  p.n_mtiles = (p.T + p.tb - 1) / p.tb * ((p.B + p.bb - 1) / p.bb);
  p.n_ntiles = (p.H + GATE_UNITS - 1) / GATE_UNITS;
  p.NC = p.n_ntiles * GATE_N;
  const int kp = round64(p.I) + round64(p.H);
  st = step_map(&p.xmap, x, p.T, p.B, p.I, p.bb, p.tb);
  if (st) return st;
  st = step_map(&p.hmap, hs, p.T, p.B, p.H, p.bb, p.tb);
  if (st) return st;
  const cuuint64_t wdims[2] = {(cuuint64_t)kp, (cuuint64_t)2 * p.NC};
  const cuuint64_t wstrides[1] = {(cuuint64_t)kp * 2};
  const cuuint32_t wbox[2] = {KC, GATE_N};
  st = make_map(&p.wmap, wpk, 2, wdims, wstrides, wbox);
  if (st) return st;
  auto kernel = bwd_gates_kernel<LSTM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)p.n_ntiles * 2 * ((p.n_mtiles + 1) / 2);
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, GATE_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Checks the sweep's plan against the device and launches it: the carve must
// equal sweep_carve of the plan and fit the opt-in limit, the grid (H/U, 2,
// groups) must be resident, one CTA per SM.
template <bool LSTM>
int launch_sweep(SweepParams& p, const void* exch, int stages, int groups, int smem, int device,
                 cudaStream_t stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  int n_sm = 0, max_smem = 0;
  int st = device_limits(device, &n_sm, &max_smem);
  if (st) return st;
  const int G = Cell<LSTM>::NG * p.H;
  const int n_tiles = (p.B + TILE - 1) / TILE;
  if (p.H % U || stages < MIN_STAGES || stages > MAX_STAGES || groups < 1 || groups > n_tiles)
    return (int)cudaErrorInvalidValue;
  // a batch of one tile loads only its rows, in multiples of 8
  p.box_rows = p.B < TILE ? (p.B + 7) / 8 * 8 : TILE;
  const size_t need = sweep_carve(Cell<LSTM>::NK, G, p.box_rows, stages).total;
  if ((size_t)smem != need || need > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  p.P = stages;
  p.R = groups;
  const cuuint64_t dims[3] = {(cuuint64_t)G, (cuuint64_t)p.B, (cuuint64_t)2 * p.T};
  const cuuint64_t strides[2] = {(cuuint64_t)G * 2, (cuuint64_t)p.B * G * 2};
  const cuuint32_t box[3] = {KC, (cuuint32_t)p.box_rows, 1};
  st = make_map(&p.emap, exch, 3, dims, strides, box);
  if (st) return st;
  auto kernel = bwd_sweep_kernel<LSTM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SWEEP_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const int S = p.H / U;
  if (per_sm < 1 || 2 * S * groups > per_sm * n_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  dim3 grid(S, 2, groups);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((void*)kernel, grid, dim3(SWEEP_THREADS), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns a cudaError_t (0 on success). Plans (stages, groups,
// smem) from rnn_train.py ``plan``; I and H multiples of 16.

// The gate product: coef [T, 2, H/16, B, 6, 16] f32 from x [T, 2, B, I],
// hs, dhs [T, 2, B, H], the packed weights wpk [2, NC, KP] and bi, bh.
extern "C" int rnn_gru_bwd_gates_bf16(const void* x, const void* hs, const void* dhs,
                                      const void* wpk, const void* bi, const void* bh, void* coef,
                                      int T, int B, int I, int H, int stages, int smem, int device,
                                      cudaStream_t stream) {
  GateParams p = {};
  p.hs = (const bf16*)hs, p.dhs = (const bf16*)dhs, p.bx = (const bf16*)bi, p.bh = (const bf16*)bh;
  p.coef = (float*)coef;
  p.T = T, p.B = B, p.I = I, p.H = H;
  return launch_gates<false>(p, x, hs, wpk, stages, smem, device, stream);
}

// The LSTM's: coef [T, 2, H/16, B, 7, 16] f32; b = bi + bh.
extern "C" int rnn_lstm_bwd_gates_bf16(const void* x, const void* hs, const void* cs,
                                       const void* dhs, const void* wpk, const void* b, void* coef,
                                       int T, int B, int I, int H, int stages, int smem,
                                       int device, cudaStream_t stream) {
  GateParams p = {};
  p.hs = (const bf16*)hs, p.cs = (const bf16*)cs, p.dhs = (const bf16*)dhs, p.bx = (const bf16*)b;
  p.coef = (float*)coef;
  p.T = T, p.B = B, p.I = I, p.H = H;
  return launch_gates<true>(p, x, hs, wpk, stages, smem, device, stream);
}

// The GRU's sweep: dgx, dgh [T, 2, B, 3H] from coef and wh; `bar` holds
// 2 * groups zeroed counters.
extern "C" int rnn_gru_bwd_sweep_bf16(const void* coef, const void* wh, void* dgx, void* dgh,
                                      unsigned int* bar, int T, int B, int H, int stages,
                                      int groups, int smem, int device, cudaStream_t stream) {
  SweepParams p = {};
  p.coef = (const float*)coef, p.wh = (const bf16*)wh, p.dgx = (bf16*)dgx, p.dgh = (bf16*)dgh;
  p.bar = bar, p.T = T, p.B = B, p.H = H;
  return launch_sweep<false>(p, dgh, stages, groups, smem, device, stream);
}

// The LSTM's: dgates [T, 2, B, 4H].
extern "C" int rnn_lstm_bwd_sweep_bf16(const void* coef, const void* wh, void* dgates,
                                       unsigned int* bar, int T, int B, int H, int stages,
                                       int groups, int smem, int device, cudaStream_t stream) {
  SweepParams p = {};
  p.coef = (const float*)coef, p.wh = (const bf16*)wh, p.dgx = (bf16*)dgates;
  p.bar = bar, p.T = T, p.B = B, p.H = H;
  return launch_sweep<true>(p, dgates, stages, groups, smem, device, stream);
}
