// Bidirectional recurrences of the bf16 serving and training paths, whole
// sequence in one launch: a GRU from a precomputed input projection, a GRU
// or LSTM with the input projection in the kernel, the LSTM that also
// stores every step's cell state, and an LSTM whose every step ends in the
// mel projection h_t @ W_mel.
//
// Replaces forwardtacotron_tpu/ops/pallas/rnn.py:
//   gru_from_xp_pallas  (body _gru_xp_kernel)    -> MODE_GRU_XP
//   bidir_rnn_pallas    (bodies _gru_kernel,
//                        _lstm_kernel)           -> MODE_GRU_X, MODE_LSTM_X
//   lstm_lr_mel_pallas  (body _lstm_mel_kernel)  -> MODE_LSTM_MEL
// and forwardtacotron_tpu/ops/pallas/rnn_train.py:
//   _lstm_fwd_call      (body _lstm_kernel_train) -> MODE_LSTM_TRAIN, the
//                        LSTM that also stores every step's bf16 cell state
//                        for the backward sweep (rnn_bwd.cu)
//   _gru_fwd_call       (body _gru_kernel)        -> MODE_GRU_X
// All five modes are instances of one kernel, rnn_step_kernel<MODE, UNIT,
// MCOLS>.
//
// Numerics as in the TPU kernels: products of bf16 values accumulate in f32
// on the tensor cores, nonlinearities run in f32, the carried h and c are
// stored as bf16 every step (the scratch dtype is the input dtype), the GRU
// adds bi and bh apart in f32 (n = tanh(gx_n + bi_n + r*(gh_n + bh_n))), the
// LSTM takes one bias (bi + bh summed in bf16 by the caller), and the mel
// stage multiplies the bf16 h by the bf16 W_mel with f32 accumulation and
// stores bf16.
//
// Layout: x [T, 2, B, I] (direction 1 already flipped by the caller), out
// [T, 2, B, H] (or [T, 2, B, M] for the mel stage), weights [2, K, G] with
// torch gate order (GRU r,z,n; LSTM i,f,g,o), G = NG*H.
//
// One schedule, weight-stationary and step-major: the weights of one
// direction (4 MB for the LSTM) do not fit one SM, so the hidden units are
// split across CTAs. CTA (s, d, r) owns `unit` units [unit s, unit s +
// unit) of direction d -- all gate columns of those units, so the cell
// update stays local -- and keeps their [I+H, N] weight slice in shared
// memory for all T steps. h_t goes through an L2-resident ping-pong
// buffer, and the H/unit CTAs of one (direction, batch group r) meet at a
// spin barrier before step t+1. All CTAs must be resident at once for that
// barrier, so the kernel launches cooperatively: the launch fails instead
// of hanging when the grid does not fit. Within step t a CTA walks ALL
// batch tiles of its group, then meets its group once: T barrier rounds
// per launch whatever B is.
//   - Products: wgmma m64nNk16, one consumer warpgroup per 64-row batch
//     tile, A (the staged activations, 128-byte swizzle) and B (the
//     resident weight slice, K-major core matrices) from shared memory,
//     the sums in registers. The slice is [I+H, N] with columns
//     [gate][unit], so a thread's fragment holds every gate of the same
//     (row, unit) pairs and the cell update runs on registers. The GRU's n
//     gate takes two column blocks, n_x (x rows only) and n_h (h rows
//     only), so one product keeps its halves apart; the LSTMs' columns are
//     i, f, g, o (one accumulator chain over x and h: the TPU kernels add
//     gx and gh apart in f32), and MODE_LSTM_MEL's N adds the CTA's
//     columns of W_mel (h rows only). MODE_GRU_XP has no x rows and no n_x
//     block: its slice is [H, 3 unit] (r, z, n_h), N = 3 unit. Every chunk
//     runs the same product: a branch around wgmma makes ptxas serialize
//     them all.
//   - Two consumer warpgroups take alternate tiles, so one's cell update
//     overlaps the other's products. The gates run in f32 to a few ulp, as
//     in the twins: the library's tanhf, and a sigmoid from expf without a
//     branch (sigmoid_nb).
//   - Staging: a producer warp per consumer warpgroup loads [rows, 64]
//     boxes of x_t and h_{t-1} with TMA into the warpgroup's ring of P
//     stages (full / empty mbarriers), P chunks ahead, while the
//     warpgroup keeps two chunks' products in flight behind the next. A
//     stage goes back to the producer only once the warpgroup has waited
//     for the chunk two after it, so P >= 3 (MIN_STAGES): with 2 the
//     producer and the warpgroup would wait for each other.
//     The barrier is split: the consumers arrive after their last tile of
//     step t; the producers load the x half of step t+1 at once and wait
//     only before the first h_t chunk, so the x products overlap the
//     barrier.
//   - MODE_GRU_XP (the multi-GRU of the serving call, the input
//     projection precomputed): per tile the producer loads gx_t as three
//     [rows, unit] boxes (the tile's r, z, n columns of this CTA's units)
//     into one of GX_SLOTS slots (gx full / empty mbarriers), the first
//     tile's ahead of the step barrier, since gx_t does not depend on h.
//     The epilogue adds gx_t to the f32 sums and bh as _gru_xp_kernel
//     does: r, z = sigmoid(gx + (gh + bh)), n = tanh(gx_n + r (gh_n +
//     bh_n)); at t = 0 h_{-1} = 0, so no product runs.
//   - Carried state: h through hbuf (written with st.global, read by TMA:
//     a proxy fence on each side). The LSTMs' c, rounded to bf16 every
//     step, goes to global memory and comes back the next step: each
//     thread reads only the (row, unit) pairs it wrote, so no barrier
//     guards it. MODE_LSTM_MEL and MODE_LSTM_X keep it in a [2, B, H]
//     buffer (2048 rows x 16 units do not fit beside the weights);
//     MODE_LSTM_TRAIN stores c_t into its output cout[t] and reads c_{t-1}
//     back from cout[t-1]. Where each consumer warpgroup owns at most one
//     tile for the whole launch (the train step's B 32, a request),
//     MODE_LSTM_X and MODE_LSTM_TRAIN carry c in registers instead.
//   - Mel stage (MODE_LSTM_MEL): step t stages h_{t-1} anyway, so its
//     product with the CTA's W_mel columns comes out of the same wgmma and
//     is stored as mel_{t-1}; one more pass after the last step stores
//     mel_{T-1}.
// Bound on an H100 at serving batch: the products (9 TFLOP per LSTM-mel
// call, ~9 ms at the bf16 peak; the multi-GRU at T 81, B 4096, H 512 1.04
// TFLOP, 1.06 ms, above the 0.81 ms of its 2.7 GB of gx in and h out) and
// the L2 re-reads (each CTA reads every activation row of its group each
// step: LSTM-mel 2048 rows x 2 KB = 4 MiB per CTA per step, ~128 GiB per
// launch; the multi-GRU 1024 rows x 1 KB = 1 MiB per CTA per step, 128 MiB
// a step over its 128 CTAs). The slices are the widest the
// carve allows (72 columns for LSTM-mel, 128 for the GRU at serving), so
// each staged byte feeds that many columns; measured, the producers wait
// for free stages, so L2 is not the wall: each warpgroup's chain of
// dependent products and its cell update are. At one tile (a request, the
// train step's B 32: the LSTM forward with cells does 0.28 TFLOP at T 928,
// 0.28 ms at the bf16 peak) the time is T times one step's latency: boxes
// of the batch's rows only, narrow slices (8 units: 2 x 64 CTAs at H 512)
// for more CTAs and a shorter step, the x half behind the barrier, the h
// half P chunks deep.
// What a step costs is measured with copies of this file built with
// -DRNN_SKIP_BARRIER (the producers do not wait at the step barrier) and
// -DRNN_SKIP_PRODUCTS (the stages arrive and go, no products), and
// -DRNN_C_FROM_MEMORY (the LSTMs' c always through memory):
// chip_smoke.py --kernel-parts. The first two give wrong sums; only their
// times are kept.
//
// The launch plan (unit, warpgroups, groups, ring stages, shared-memory
// carve) is computed by the caller (rnn.py ``plan``: at serving the
// multi-GRU takes 32 units, 16 CTAs per direction, 4 batch groups, a 96 KB
// weight slice, wgmma N = 96); the entries check it against step_carve
// and the device and refuse a plan that does not fit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum Mode {
  MODE_GRU_X = 0,
  MODE_LSTM_X = 1,
  MODE_GRU_XP = 2,
  MODE_LSTM_MEL = 3,
  MODE_LSTM_TRAIN = 4
};

__host__ __device__ constexpr int n_gates(int mode) {
  return (mode == MODE_LSTM_X || mode == MODE_LSTM_MEL || mode == MODE_LSTM_TRAIN) ? 4 : 3;
}

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) & ~(size_t)127;
}

// 1 / y for y in [1, 2]: the approximate reciprocal and one Newton step,
// within an ulp
__device__ __forceinline__ float rcp_1_2(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return fmaf(r, fmaf(-y, r, 1.f), r);
}

// The gates' sigmoid, as accurate as 1 / (1 + expf(-v)) (a few ulp:
// expf's 2 and the reciprocal's 1) for every v, but without a branch: the
// IEEE division's slow-path branch kept ptxas from interleaving a thread's
// (row, unit) pairs, so the cell update outlasted the other warpgroup's
// products.
// e = exp(-|v|) lies in (0, 1], so 1 + e needs no range check.
__device__ __forceinline__ float sigmoid_nb(float v) {
  const float e = expf(-fabsf(v));
  const float r = rcp_1_2(1.f + e);
  return v >= 0.f ? r : e * r;
}

constexpr int KC = 64;     // depth of one ring stage: one 128-byte swizzle row
constexpr int TILE = 64;   // batch rows of a tile: one consumer warpgroup's
constexpr int STAGE = TILE * KC * 2;
constexpr int MAX_STAGES = 8;  // per consumer warpgroup
constexpr int MIN_STAGES = 3;  // a chunk loading while two are held
constexpr int GX_SLOTS = 2;    // MODE_GRU_XP: gx slots per consumer warpgroup

struct StepParams {
  CUtensorMap xmap;  // x as [T*2*B rows, I], boxes of [box_rows, 64], 128-byte swizzle;
                     // MODE_GRU_XP: gx as [T*2*B rows, 3H], boxes of [box_rows, unit]
  CUtensorMap hmap;  // hbuf as [4*B rows, H], boxes of [box_rows, 64], 128-byte swizzle
  const bf16* wi;    // [2, I, G] (null for MODE_GRU_XP)
  const bf16* wh;    // [2, H, G]
  const bf16* bx;    // [2, G]: GRU bi, LSTM bi+bh (null for MODE_GRU_XP)
  const bf16* bh;    // [2, G]: GRU bh (null for the LSTM)
  const bf16* wm;    // [2, H, M] (MODE_LSTM_MEL)
  bf16* out;         // [T, 2, B, H], or [T, 2, B, M] for MODE_LSTM_MEL
  bf16* cout;        // [T, 2, B, H] cell states (MODE_LSTM_TRAIN)
  bf16* hbuf;        // [2 (parity), 2 (direction), B, H]
  bf16* cbuf;        // [2, B, H] carried c (MODE_LSTM_MEL, MODE_LSTM_X)
  unsigned int* bar;  // [2, R] barrier counters, zero at launch
  int T, B, I, H, M, R, P, wgs, box_rows;  // wgs: consumer warpgroups, 64 rows each
};

__host__ __device__ inline int round64(int n) { return (n + 63) & ~63; }

// Shared memory of one step-major CTA, in carve order: the weight slice
// [round64(I) + round64(H), ncols] as core matrices (ncols = 4*unit + mcols,
// or 3*unit for MODE_GRU_XP), the biases (f32, bx then bh, 4*unit each), the
// rings' full and empty mbarriers, for MODE_GRU_XP (gx) the gx slots'
// full and empty mbarriers (128 bytes) and `wgs` x GX_SLOTS slots of three
// [TILE, unit] bf16 boxes, then `wgs` rings of `stages` stages of [TILE, KC]
// bf16, 1024-byte aligned (the swizzle's period) inside 1024 bytes of
// slack. rnn.py ``plan`` repeats this sum.
struct StepCarve {
  size_t w, bias, bars, gx, ring, total;
};

__host__ __device__ inline size_t gx_slot_bytes(int unit) { return (size_t)3 * TILE * unit * 2; }

__host__ __device__ inline StepCarve step_carve(int I, int H, int unit, int ncols, bool gx,
                                                int wgs, int stages) {
  StepCarve c;
  c.w = 0;
  c.bias = align128((size_t)(round64(I) + round64(H)) * ncols * sizeof(bf16));
  c.bars = c.bias + align128(2 * 4 * unit * sizeof(float));
  c.gx = c.bars + align128(2 * 2 * MAX_STAGES * sizeof(uint64_t));
  c.ring = c.gx + (gx ? 128 + (size_t)wgs * GX_SLOTS * gx_slot_bytes(unit) : 0);
  c.total = c.ring + 1024 + (size_t)wgs * stages * STAGE;
  return c;
}

// byte offset of element (row, k) in K-major core matrices (8 rows x 16 B,
// 128 contiguous bytes each): k-neighbours 128 B apart, 8-row groups `sbo`
__device__ __forceinline__ uint32_t core_off(int row, int k, int sbo) {
  return (row >> 3) * sbo + (k >> 3) * 128 + (row & 7) * 16 + (k & 7) * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptors: the weight slice without swizzle (LBO
// = k-neighbour core matrices, SBO = 8-row groups, in 16-byte units), the
// staged activations as TMA writes them with the 128-byte swizzle (8 rows
// of 128 B = 1024 B per row group)
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

// one [box_rows, 64] box of a 2D tensor map into shared memory; completion
// counted in bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int col, int row,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// generic-proxy writes to global memory (h_t) ordered before async-proxy
// reads (the TMA loads of the next step)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
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
__device__ __forceinline__ void wgmma(float (&d)[12], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[24], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[48], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[16], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[36], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35}, %36, %37, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[40], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// bf16 pair from global memory, issued where it is written (volatile asm is
// not moved past the products), waited for at its first use
__device__ __forceinline__ __nv_bfloat162 ld_pair(const bf16* src) {
  unsigned v;
  asm volatile("ld.global.cg.b32 %0, [%1];\n" : "=r"(v) : "l"(src));
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

template <int MODE, int UNIT, int MCOLS>
__global__ void __launch_bounds__(2 * (128 + 32), 1)
    rnn_step_kernel(const __grid_constant__ StepParams p) {
  constexpr bool MEL = MODE == MODE_LSTM_MEL;
  constexpr bool XP = MODE == MODE_GRU_XP;
  constexpr bool TRAIN = MODE == MODE_LSTM_TRAIN;
  constexpr int NG = n_gates(MODE);
  constexpr bool LSTM = NG == 4;
  // GRU r z n_x n_h; GRU_XP r z n_h; LSTM i f g o (MODE_LSTM_MEL: then mel)
  constexpr int NCOLS = XP ? 3 * UNIT : 4 * UNIT + MCOLS;
  constexpr int UB = UNIT / 8;  // 8-unit blocks of one gate
  const int s = blockIdx.x, d = blockIdx.y, r = blockIdx.z;
  const int S = gridDim.x, R = p.R, P = p.P;
  const int I = p.I, H = p.H, G = NG * H, B = p.B, M = p.M;
  const int IP = round64(I), KP = IP + round64(H);
  const int n_cons = 128 * p.wgs;
  const int tid = threadIdx.x;

  extern __shared__ __align__(128) unsigned char smem[];
  const StepCarve cv = step_carve(I, H, UNIT, NCOLS, XP, p.wgs, P);
  unsigned char* Ws = smem + cv.w;
  float* bxs = reinterpret_cast<float*>(smem + cv.bias);  // [4 UNIT]
  float* bhs = bxs + 4 * UNIT;                            // [4 UNIT]
  // per consumer warpgroup w: a ring of P stages of one [64, 64] box at
  // ring + (w P + i) STAGE, with mbarriers full[w P + i], empty[w P + i];
  // MODE_GRU_XP: GX_SLOTS slots of gx_t's three [64, UNIT] gate boxes at
  // gxs + (w GX_SLOTS + i) gx_slot_bytes, mbarriers gx_full, gx_empty
  const uint32_t full = smem_u32(smem + cv.bars);
  const uint32_t empty = full + 8 * 2 * MAX_STAGES;
  const uint32_t gx_full = smem_u32(smem + cv.gx);
  const uint32_t gx_empty = gx_full + 8 * 2 * GX_SLOTS;
  unsigned char* gxs = smem + cv.gx + 128;
  const uint32_t ring = (smem_u32(smem + cv.ring) + 1023) & ~1023u;
  const int sbo_w = KP * 16;

  // the weight slice, [KP, NCOLS]: rows [0, I) from wi, [IP, IP + H) from
  // wh, zero elsewhere. GRU columns r, z (x and h rows), n_x (x rows only),
  // n_h (h rows only), so one product keeps the n gate's halves apart;
  // GRU_XP (no x rows) r, z, n_h; LSTM columns i, f, g, o, then this CTA's
  // MCOLS columns of W_mel (h rows only): the mel of h_{t-1} comes out of
  // the same product
  for (int i = tid; i < KP * NCOLS; i += blockDim.x) {
    const int k = i / NCOLS, n = i - k * NCOLS;
    const bool xrow = k < IP;
    const int kk = xrow ? k : k - IP;
    float v = 0.f;
    if (kk < (xrow ? I : H)) {
      const bf16* w = xrow ? p.wi + ((size_t)d * I + kk) * G : p.wh + ((size_t)d * H + kk) * G;
      const int g = n / UNIT, u = n % UNIT;
      if (XP) {
        v = __bfloat162float(w[g * H + s * UNIT + u]);
      } else if (n >= 4 * UNIT) {
        const int m = s * MCOLS + n - 4 * UNIT;
        if (!xrow && m < M) v = __bfloat162float(p.wm[((size_t)d * H + kk) * M + m]);
      } else if (LSTM || g < 2 || (g == 2) == xrow) {
        v = __bfloat162float(w[(LSTM ? g : min(g, 2)) * H + s * UNIT + u]);
      }
    }
    *reinterpret_cast<bf16*>(Ws + core_off(n, k, sbo_w)) = __float2bfloat16(v);
  }
  for (int j = tid; j < NG * UNIT; j += blockDim.x) {
    const int col = (j / UNIT) * H + s * UNIT + (j % UNIT);
    bxs[j] = XP ? 0.f : __bfloat162float(p.bx[(size_t)d * G + col]);
    bhs[j] = LSTM ? 0.f : __bfloat162float(p.bh[(size_t)d * G + col]);
  }
  if (tid == 0) {
    for (int i = 0; i < p.wgs * P; ++i) {
      mbar_init(full + 8 * i, 1);   // the producer's arrive + the bytes
      mbar_init(empty + 8 * i, 4);  // one arrive per warp of the warpgroup
    }
    if (XP)
      for (int i = 0; i < p.wgs * GX_SLOTS; ++i) {
        mbar_init(gx_full + 8 * i, 1);
        mbar_init(gx_empty + 8 * i, 4);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // Ws for wgmma
  __syncthreads();

  unsigned int* bar = p.bar + d * R + r;
  const int n_tiles = (B + TILE - 1) / TILE;
  const int my_tiles = (n_tiles - r + R - 1) / R;  // tiles r, r + R, ...
  const int nx = IP / KC, nh = round64(H) / KC;
  const int t_end = MEL ? p.T + 1 : p.T;  // MODE_LSTM_MEL: one more pass for mel_{T-1}

  if (tid >= n_cons) {
    // a producer warp per consumer warpgroup w: one lane loads every chunk
    // of the warpgroup's tiles (w, w + wgs, ...) into its ring, P stages
    // ahead of the products; per step and tile the x_t chunks (GRU_XP: the
    // tile's three gx_t boxes into a gx slot), then the h_{t-1} chunks, the
    // step's first waiting for the group's step t-1
    const int w = (tid - n_cons) >> 5;
    if (tid & 31) return;
    const int box_bytes = p.box_rows * KC * 2;
    uint32_t gc = 0, gq = 0;
    for (int t = 0; t < t_end; ++t) {
      const int nxs = t < p.T ? nx : 0, per = nxs + (t > 0 ? nh : 0);
      for (int j = w; j < my_tiles; j += p.wgs) {
        const int b0 = (r + j * R) * TILE;
        if (XP) {  // gx_t does not depend on h: loaded ahead of the barrier
          const uint32_t slot = w * GX_SLOTS + gq % GX_SLOTS;
          if (gq >= (uint32_t)GX_SLOTS) mbar_wait(gx_empty + 8 * slot, (gq / GX_SLOTS - 1) & 1);
          mbar_expect_tx(gx_full + 8 * slot, 3 * p.box_rows * UNIT * 2);
          const uint32_t dst = smem_u32(gxs + slot * gx_slot_bytes(UNIT));
#pragma unroll
          for (int g = 0; g < 3; ++g)
            tma_load(dst + g * TILE * UNIT * 2, &p.xmap, g * H + s * UNIT, (t * 2 + d) * B + b0,
                     gx_full + 8 * slot);
          ++gq;
        }
        for (int q = 0; q < per; ++q, ++gc) {
          const bool is_h = q >= nxs;
          if (is_h && j == w && q == nxs) {
#ifndef RNN_SKIP_BARRIER  // diagnostic: the h chunks without the wait (wrong sums)
            volatile unsigned int* vb = bar;
            while (*vb < (unsigned)t * S) {
            }
#endif
            __threadfence();
            fence_proxy_async_global();
          }
          const uint32_t slot = w * P + gc % P;
          if (gc >= (uint32_t)P) mbar_wait(empty + 8 * slot, (gc / P - 1) & 1);
          mbar_expect_tx(full + 8 * slot, box_bytes);
          if (is_h)
            tma_load(ring + slot * STAGE, &p.hmap, (q - nxs) * KC,
                     (((t - 1) & 1) * 2 + d) * B + b0, full + 8 * slot);
          else
            tma_load(ring + slot * STAGE, &p.xmap, q * KC, (t * 2 + d) * B + b0,
                     full + 8 * slot);
        }
      }
    }
    return;
  }

  // the consumer warpgroups, each on its own tiles (w, w + wgs, ...), so
  // one's cell update overlaps the other's products
  const int wg = tid >> 7, warp4 = (tid >> 5) & 3, lane = tid & 31;
  const size_t hplane = (size_t)B * H;  // one (parity, direction) plane of hbuf
  // the rows and unit pairs of this thread's accumulator fragments
  const int row0 = warp4 * 16 + (lane >> 2);  // and row0 + 8
  const int upair = 2 * (lane & 3);            // + 8 ub within a gate
  float acc[NCOLS / 2];
  __nv_bfloat162 prev[2][UB];  // GRU h_{t-1}, LSTM c_{t-1} of the thread's pairs
  // MODE_LSTM_X / MODE_LSTM_TRAIN with at most one tile per warpgroup: c
  // stays in prev from one step to the next
#ifdef RNN_C_FROM_MEMORY  // diagnostic: c through memory at every shape
  constexpr bool c_regs = false;
#else
  const bool c_regs = LSTM && !MEL && my_tiles <= p.wgs;
#endif
  uint32_t gc = 0, gq = 0;
  for (int t = 0; t < t_end; ++t) {
    const int nxs = t < p.T ? nx : 0, per = nxs + (t > 0 ? nh : 0);
    for (int j = wg; j < my_tiles; j += p.wgs) {
      const int b0 = (r + j * R) * TILE;
      if (t > 0 && t < p.T && !c_regs) {  // the carried state of this thread's pairs
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int b = min(b0 + row0 + 8 * i, B - 1);
#pragma unroll
          for (int ub = 0; ub < UB; ++ub) {
            const size_t at = (size_t)b * H + s * UNIT + ub * 8 + upair;
            prev[i][ub] = ld_pair(TRAIN  ? p.cout + ((size_t)(t - 1) * 2 + d) * hplane + at
                                  : LSTM ? p.cbuf + d * hplane + at
                                         : p.hbuf + (size_t)(((t - 1) & 1) * 2 + d) * hplane + at);
          }
        }
      }
      if (per == 0) {  // no product: GRU_XP (or I = 0) at t = 0, h_{-1} = 0
#pragma unroll
        for (int i = 0; i < NCOLS / 2; ++i) acc[i] = 0.f;
      }
      // products of the tile's chunks; the first starts the sums. Two
      // chunks' products stay in flight while the next one's are issued;
      // a chunk's stage goes back to the producer once they are done.
      for (int q = 0; q < per; ++q, ++gc) {
        const uint32_t slot = wg * P + gc % P;
        mbar_wait(full + 8 * slot, (gc / P) & 1);
        const int kw = q >= nxs ? IP + (q - nxs) * KC : q * KC;
        const uint32_t a0 = ring + slot * STAGE;
        const uint32_t w0 = smem_u32(Ws) + kw / 8 * 128;
        wgmma_fence();
#ifndef RNN_SKIP_PRODUCTS  // diagnostic: the stages arrive and go, no products
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks)
          wgmma(acc, desc_sw128(a0 + ks * 32), desc_plain(w0 + ks * 256, sbo_w), q + ks > 0);
#endif
        wgmma_commit();
        wgmma_wait<2>();
        if (gc > 1 && lane == 0) mbar_arrive(empty + 8 * (wg * P + (gc - 2) % P));
      }
      wgmma_wait<0>();

      // GRU_XP: this tile's gx_t boxes, [gate][row][unit]
      const bf16* gxt = nullptr;
      uint32_t gslot = 0;
      if (XP) {
        gslot = wg * GX_SLOTS + gq % GX_SLOTS;
        mbar_wait(gx_full + 8 * gslot, (gq / GX_SLOTS) & 1);
        gxt = reinterpret_cast<const bf16*>(gxs + gslot * gx_slot_bytes(UNIT));
        ++gq;
      }

      // cell update on the registers, mel_{t-1}
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = b0 + row0 + 8 * i;
        if (b >= B) continue;
        if (t < p.T) {
#pragma unroll
          for (int ub = 0; ub < UB; ++ub) {
            float hv[2], cn[2] = {0.f, 0.f};
            float2 gxv[3];
            if (XP)
#pragma unroll
              for (int g = 0; g < 3; ++g)
                gxv[g] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                    gxt + (g * TILE + row0 + 8 * i) * UNIT + ub * 8 + upair));
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int u = ub * 8 + upair + e;
              const int a = ub * 4 + i * 2 + e;  // + g * UB * 4 for gate g
              const float pv = t == 0 ? 0.f
                               : e ? __high2float(prev[i][ub]) : __low2float(prev[i][ub]);
              if constexpr (LSTM) {
                const float gi = sigmoid_nb(acc[a] + bxs[u]);
                const float gf = sigmoid_nb(acc[UB * 4 + a] + bxs[UNIT + u]);
                const float gg = tanhf(acc[2 * UB * 4 + a] + bxs[2 * UNIT + u]);
                const float go = sigmoid_nb(acc[3 * UB * 4 + a] + bxs[3 * UNIT + u]);
                cn[e] = gf * pv + gi * gg;
                hv[e] = go * tanhf(cn[e]);
              } else if constexpr (XP) {  // gx_t carries bi: gates as _gru_xp_kernel
                const float xr = e ? gxv[0].y : gxv[0].x;
                const float xz = e ? gxv[1].y : gxv[1].x;
                const float xn = e ? gxv[2].y : gxv[2].x;
                const float rg = sigmoid_nb(xr + (acc[a] + bhs[u]));
                const float zg = sigmoid_nb(xz + (acc[UB * 4 + a] + bhs[UNIT + u]));
                const float ng = tanhf(xn + rg * (acc[2 * UB * 4 + a] + bhs[2 * UNIT + u]));
                hv[e] = (1.f - zg) * ng + zg * pv;
              } else {
                const float rg = sigmoid_nb(acc[a] + bxs[u] + bhs[u]);
                const float zg = sigmoid_nb(acc[UB * 4 + a] + bxs[UNIT + u] + bhs[UNIT + u]);
                const float ng = tanhf(acc[2 * UB * 4 + a] + bxs[2 * UNIT + u] +
                                       rg * (acc[3 * UB * 4 + a] + bhs[2 * UNIT + u]));
                hv[e] = (1.f - zg) * ng + zg * pv;
              }
            }
            const size_t at = (size_t)b * H + s * UNIT + ub * 8 + upair;
            const __nv_bfloat162 hb = __floats2bfloat162_rn(hv[0], hv[1]);
            *reinterpret_cast<__nv_bfloat162*>(p.hbuf + (size_t)((t & 1) * 2 + d) * hplane + at) = hb;
            if (!MEL)
              *reinterpret_cast<__nv_bfloat162*>(p.out + ((size_t)t * 2 + d) * hplane + at) = hb;
            if (LSTM) {  // the carried c is stored as bf16
              const __nv_bfloat162 cb = __floats2bfloat162_rn(cn[0], cn[1]);
              if (TRAIN)
                *reinterpret_cast<__nv_bfloat162*>(p.cout + ((size_t)t * 2 + d) * hplane + at) = cb;
              else if (!c_regs)
                *reinterpret_cast<__nv_bfloat162*>(p.cbuf + d * hplane + at) = cb;
              prev[i][ub] = cb;
            }
          }
        }
        if (MEL && t > 0) {
#pragma unroll
          for (int jm = 0; jm < MCOLS / 8; ++jm) {  // columns m, m + 1 of mel_{t-1}
            const int m = s * MCOLS + jm * 8 + upair;
            const float* av = acc + (4 * UB + jm) * 4 + i * 2;
            bf16* dst = p.out + (((size_t)(t - 1) * 2 + d) * B + b) * M + m;
            if (m + 1 < M && !(M & 1)) {  // both in the row, 4-byte aligned
              *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(av[0], av[1]);
            } else {
              if (m < M) dst[0] = __float2bfloat16(av[0]);
              if (m + 1 < M) dst[1] = __float2bfloat16(av[1]);
            }
          }
        }
      }
      if (XP) {  // the gx slot goes back to the producer
        __syncwarp();
        if (lane == 0) mbar_arrive(gx_empty + 8 * gslot);
      }
    }
    if (t + 1 < t_end) {  // h_t of this CTA's units is out: arrive at the group
      fence_proxy_async_global();
      asm volatile("bar.sync 1, %0;\n" ::"r"(n_cons) : "memory");
      if (tid == 0) {
        __threadfence();
        atomicAdd(bar, 1u);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a 2D bf16 tensor map of [rows, cols] (row-major) in boxes of
// [box_rows, box_cols]: [box_rows, 64] with the 128-byte swizzle by
// default, unswizzled row-major boxes otherwise; outside the tensor reads
// zero
int make_map(CUtensorMap* map, const void* base, int cols, long long rows, int box_rows,
             int box_cols = KC) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
    if (err != cudaSuccess) return (int)err;
    if (q != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              box_cols == KC ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Checks a step-major plan against the device and launches it: the carve
// must equal step_carve of the plan and fit the opt-in limit, the grid
// (H/unit, 2, groups) of (128 + 32) wgs threads must be resident, one CTA
// per SM.
template <int MODE, int UNIT, int MCOLS>
int launch_step(StepParams& p, const void* x, int wgs, int smem, int device,
                cudaStream_t stream) {
  const DeviceGuard guard(device);
  cudaError_t err = guard.err;
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (p.B + TILE - 1) / TILE;
  if (p.H % UNIT || p.I % 16 || p.P < MIN_STAGES || p.P > MAX_STAGES || p.R < 1 ||
      p.R > n_tiles || (wgs != 1 && wgs != 2))
    return (int)cudaErrorInvalidValue;
  if (MODE == MODE_LSTM_MEL && (p.H / UNIT) * MCOLS < p.M) return (int)cudaErrorInvalidValue;
  constexpr bool XP = MODE == MODE_GRU_XP;
  constexpr int NCOLS = XP ? 3 * UNIT : 4 * UNIT + MCOLS;
  p.wgs = wgs;
  int max_smem = 0, n_sm = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const size_t need = step_carve(p.I, p.H, UNIT, NCOLS, XP, p.wgs, p.P).total;
  if ((size_t)smem != need || need > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  // a batch of one tile loads only its rows, in multiples of 8
  p.box_rows = p.B < TILE ? (p.B + 7) / 8 * 8 : TILE;
  // GRU_XP: gx [T*2*B rows, 3H] in one [box_rows, UNIT] box per gate; no
  // map where there are no x rows
  int st = XP       ? make_map(&p.xmap, x, 3 * p.H, (long long)p.T * 2 * p.B, p.box_rows, UNIT)
           : p.I > 0 ? make_map(&p.xmap, x, p.I, (long long)p.T * 2 * p.B, p.box_rows)
                     : 0;
  if (st) return st;
  st = make_map(&p.hmap, p.hbuf, p.H, 4LL * p.B, p.box_rows);
  if (st) return st;
  auto kernel = rnn_step_kernel<MODE, UNIT, MCOLS>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (128 + 32) * p.wgs;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  const int S = p.H / UNIT;
  if (per_sm < 1 || 2 * S * p.R > per_sm * n_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  dim3 grid(S, 2, p.R);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((void*)kernel, grid, dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns a cudaError_t (0 on success). `bar` must hold 2 * B
// zeroed counters; hbuf 2 * 2 * B * H bf16 values of scratch.

// Step-major GRU; unit (8, 16 or 32), warpgroups, groups, stages and smem
// from rnn.py plan.
extern "C" int rnn_gru_x_bf16(const void* x, const void* wi, const void* wh, const void* bi,
                              const void* bh, void* out, void* hbuf, unsigned int* bar, int T,
                              int B, int I, int H, int unit, int wgs, int groups, int stages,
                              int smem, int device, cudaStream_t stream) {
  StepParams p = {};
  p.wi = (const bf16*)wi, p.wh = (const bf16*)wh, p.bx = (const bf16*)bi, p.bh = (const bf16*)bh;
  p.out = (bf16*)out, p.hbuf = (bf16*)hbuf, p.bar = bar;
  p.T = T, p.B = B, p.I = I, p.H = H, p.R = groups, p.P = stages;
  if (unit == 32) return launch_step<MODE_GRU_X, 32, 0>(p, x, wgs, smem, device, stream);
  if (unit == 16) return launch_step<MODE_GRU_X, 16, 0>(p, x, wgs, smem, device, stream);
  if (unit == 8) return launch_step<MODE_GRU_X, 8, 0>(p, x, wgs, smem, device, stream);
  return (int)cudaErrorInvalidValue;
}

// Step-major GRU from the precomputed input projection xp [T, 2, B, 3H];
// unit (8, 16 or 32), warpgroups, groups, stages and smem from rnn.py plan.
extern "C" int rnn_gru_xp_bf16(const void* xp, const void* wh, const void* bh, void* out,
                               void* hbuf, unsigned int* bar, int T, int B, int H, int unit,
                               int wgs, int groups, int stages, int smem, int device,
                               cudaStream_t stream) {
  StepParams p = {};
  p.wh = (const bf16*)wh, p.bh = (const bf16*)bh;
  p.out = (bf16*)out, p.hbuf = (bf16*)hbuf, p.bar = bar;
  p.T = T, p.B = B, p.I = 0, p.H = H, p.R = groups, p.P = stages;
  if (unit == 32) return launch_step<MODE_GRU_XP, 32, 0>(p, xp, wgs, smem, device, stream);
  if (unit == 16) return launch_step<MODE_GRU_XP, 16, 0>(p, xp, wgs, smem, device, stream);
  if (unit == 8) return launch_step<MODE_GRU_XP, 8, 0>(p, xp, wgs, smem, device, stream);
  return (int)cudaErrorInvalidValue;
}

// Step-major LSTM + mel stage; cbuf: 2 * B * H bf16 values of scratch;
// unit 16, mcols (8 or 16), warpgroups, groups, stages and smem from rnn.py
// plan.
extern "C" int rnn_lstm_mel_bf16(const void* x, const void* wi, const void* wh, const void* b,
                                 const void* wm, void* out, void* hbuf, void* cbuf,
                                 unsigned int* bar, int T, int B, int I, int H, int M, int unit,
                                 int mcols, int wgs, int groups, int stages, int smem,
                                 int device, cudaStream_t stream) {
  StepParams p = {};
  p.wi = (const bf16*)wi, p.wh = (const bf16*)wh, p.bx = (const bf16*)b, p.wm = (const bf16*)wm;
  p.out = (bf16*)out, p.hbuf = (bf16*)hbuf, p.cbuf = (bf16*)cbuf, p.bar = bar;
  p.T = T, p.B = B, p.I = I, p.H = H, p.M = M, p.R = groups, p.P = stages;
  if (unit != 16) return (int)cudaErrorInvalidValue;
  if (mcols == 8) return launch_step<MODE_LSTM_MEL, 16, 8>(p, x, wgs, smem, device, stream);
  if (mcols == 16) return launch_step<MODE_LSTM_MEL, 16, 16>(p, x, wgs, smem, device, stream);
  return (int)cudaErrorInvalidValue;
}

// Step-major LSTM; cbuf: 2 * B * H bf16 values of scratch; unit (8, 16 or
// 32), warpgroups, groups, stages and smem from rnn.py plan.
extern "C" int rnn_lstm_x_bf16(const void* x, const void* wi, const void* wh, const void* b,
                               void* out, void* hbuf, void* cbuf, unsigned int* bar, int T, int B,
                               int I, int H, int unit, int wgs, int groups, int stages, int smem,
                               int device, cudaStream_t stream) {
  StepParams p = {};
  p.wi = (const bf16*)wi, p.wh = (const bf16*)wh, p.bx = (const bf16*)b;
  p.out = (bf16*)out, p.hbuf = (bf16*)hbuf, p.cbuf = (bf16*)cbuf, p.bar = bar;
  p.T = T, p.B = B, p.I = I, p.H = H, p.R = groups, p.P = stages;
  if (unit == 32) return launch_step<MODE_LSTM_X, 32, 0>(p, x, wgs, smem, device, stream);
  if (unit == 16) return launch_step<MODE_LSTM_X, 16, 0>(p, x, wgs, smem, device, stream);
  if (unit == 8) return launch_step<MODE_LSTM_X, 8, 0>(p, x, wgs, smem, device, stream);
  return (int)cudaErrorInvalidValue;
}

// Step-major LSTM that also writes the cell states cout [T, 2, B, H] (and
// carries c through them); unit (8, 16 or 32), warpgroups, groups, stages
// and smem from rnn.py plan.
extern "C" int rnn_lstm_train_bf16(const void* x, const void* wi, const void* wh, const void* b,
                                   void* out, void* cout, void* hbuf, unsigned int* bar, int T,
                                   int B, int I, int H, int unit, int wgs, int groups,
                                   int stages, int smem, int device, cudaStream_t stream) {
  StepParams p = {};
  p.wi = (const bf16*)wi, p.wh = (const bf16*)wh, p.bx = (const bf16*)b;
  p.out = (bf16*)out, p.cout = (bf16*)cout, p.hbuf = (bf16*)hbuf, p.bar = bar;
  p.T = T, p.B = B, p.I = I, p.H = H, p.R = groups, p.P = stages;
  if (unit == 32) return launch_step<MODE_LSTM_TRAIN, 32, 0>(p, x, wgs, smem, device, stream);
  if (unit == 16) return launch_step<MODE_LSTM_TRAIN, 16, 0>(p, x, wgs, smem, device, stream);
  if (unit == 8) return launch_step<MODE_LSTM_TRAIN, 8, 0>(p, x, wgs, smem, device, stream);
  return (int)cudaErrorInvalidValue;
}

// The SM count and the opt-in shared memory per block of `device`, for
// rnn.py plan where torch does not report them.
extern "C" int rnn_device_limits(int device, int* n_sm, int* smem_optin) {
  cudaError_t err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
