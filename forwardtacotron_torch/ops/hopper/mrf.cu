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
// the sequence (torch's zero padding at the true sequence ends).
//
// ups_mrf_* replaces mrf.py::ups_mrf_pallas (kernel body _ups_mrf_kernel):
// one level of the phase-stacked tail. x [B, s_in*C_in, T_ps] holds input
// sample s_in*t + r of channel c at row r*C_in + c, lane t; lanes at or past
// t_valid are padding. The level computes
//   u   = round(conv_transpose(leaky(x) * mask_in, stride s_up) + b_up)
//   out = the MRF above on u, written phase-stacked: [B, s_out*C, T_ps] with
//         s_out = s_in * s_up, 0 at padding lanes.
// The phase-stacked layout is the contract in device memory only: each CTA
// de-interleaves its input tile into sample order in shared memory, computes
// the upsample there (per output phase of the stride, the taps of that phase
// are [C, C_in] x [C_in, samples] products on consecutive input rows, so no
// zero is ever multiplied), and runs the MRF on sample-ordered rows with the
// machinery of mrf_*. The TPU kernel's per-(phase, tap) lane shifts exist
// because a TPU cannot interleave lanes cheaply; here the interleave is an
// address computation on the tile's load and on the output's store.
//
// Weights per branch: w1, w2 [U, C, kr*C] with j-major im2col columns
// (column j*C + c_in, as pack_conv_weight packs them), biases b1, b2 [U, C];
// ups_mrf_*: the upsampler as [k, C, C_in], taps reversed (as
// pack_up_weight packs it), its bias [C] float32.
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
// useful FLOPs per item (126 convolution taps for kr = 3, 7, 11 and U = 3):
// 63 * C FLOPs per byte of bf16 input and output (4,032 at C = 64), far
// above the 295 at which the bf16 tensor cores become the limit, and
// 31.5 * C in f32, far above the f32 FMA units' 20. The upsample adds
// 2 * C_in * C * k / s_up FLOPs per output sample (3% at HiFi-GAN v1's
// levels 2 and 3).
//
// Design. One CTA per (batch item, time tile of output samples). The tile's
// window of t_tile + 2 * HALO samples stays in shared memory through all 18
// convolutions, time-major ([t][c], rows padded by 16 bytes against bank
// conflicts), so no intermediate activation touches device memory: what the
// TPU kernel keeps in VMEM stays on chip here too. Blocks run in no order,
// so each recomputes its own halo; each convolution computes only the
// columns that later convolutions of its branch still read (the exact
// region widens by every later convolution's span), which trims the
// recomputation from 1.5x to about 1.2x at t_tile 256. Two buffers: `cur`
// (the branch's running residual) and `ybuf` (leaky(y) * mask of the unit's
// first convolution); the first convolution applies leaky to `cur` as it
// loads it, so the activated copy never exists. Both buffers hold 0 at
// positions outside [0, T) and carry 32 zero rows above and below the
// window, so the inner loop reads shifted rows without bounds checks. Each
// convolution is kr shifted [C, C] x [C, cols] products:
//   bf16: tensor cores, mma.sync m16n8k16 with f32 accumulation; a warp owns
//         16 output channels x up to 96 samples; each tap's [C, C] weight
//         block is copied to shared memory (cp.async, double-buffered, one
//         barrier per tap), so the inner loop reads only shared memory;
//   f32:  FMA; a thread owns 4 output channels x 8 samples, weights as
//         float4 through the read-only cache, activations as float4.
// ups_mrf_*: at each branch's start `cur` is the upsample's output over the
// whole window, recomputed from the input tile (about 14% more work than
// keeping u, which has no room beside the buffers). The input tile, [TW /
// s_up + 16, C_in] in sample order with 8 rows of halo on each side, lives
// in ybuf's buffer, which is dead until the branch's first convolution; the
// upsampler's taps pass through the weight stage like a convolution's.
// Shared memory (C = 64): bf16, t_tile 256: 2 x 448 x 72 x 2 B + a 64 x 257
// f32 branch sum + 2 x 64 x 72 x 2 B of weights = 213,248 B (ups_mrf at
// C_in 128: two staged [64, 136] taps, 229,632 B); f32, t_tile 128:
// 2 x 320 x 68 x 4 + 64 x 129 x 4 = 207,104 B; one CTA of 16 warps per SM.
// C is at most 64 and C_in at most 128, both multiples of 16 (the wrappers
// pad with zero channels). A simple first kernel: TMA, wgmma and more
// resident warps are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HALO = 64;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BRANCHES = 4;
constexpr int MAX_UNITS = 4;
constexpr int MAX_C = 64;
constexpr int MAX_C_IN = 128;
constexpr int MAX_K_UP = 16;
// input rows of halo on each side of the upsampler's tile: more than the
// largest input offset of a tap, (k_up - s_up) / (2 * s_up) + 1
constexpr int IN_HALO = 8;

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
  int c;
  int t;        // mrf: sequence length; ups_mrf: lanes T_ps
  int yreg;     // elements of ybuf's buffer (ups_mrf: it also holds the tile)
  // ups_mrf only
  const void* up_w;    // [k_up, C, C_in]
  const float* up_b;   // [C]
  int c_in, s_in, s_up, k_up, t_valid;
};

template <typename T> struct Tile;
template <> struct Tile<bf16> {
  static constexpr int T_TILE = 256;
  static constexpr int PAD = 8;   // elements: 16 bytes
};
template <> struct Tile<float> {
  static constexpr int T_TILE = 128;
  static constexpr int PAD = 4;   // elements: 16 bytes
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

// a convolution's f32 product plus its bias, before the store rounds it: a
// bias in bf16 follows the product's own rounding, an f32 bias joins the f32
// product (in f32 the two orders agree)
__device__ __forceinline__ float bias_add(float v, const float* b) {
  return v + *b;
}
__device__ __forceinline__ float bias_add(float v, const bf16* b) {
  return rnd<bf16>(v) + ld(b);
}

// leaky(v) = max(v, s * v), slope and product in T
template <typename T>
__device__ __forceinline__ float leaky(float v) {
  const float s = rnd<T>(0.1f);
  return fmaxf(v, rnd<T>(s * v));
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The window's activations: rows are samples, row r at sequence position
// pos0 + r. Buffers carry PAD_ROWS zero rows above and below the window, so a
// convolution's shifted reads never leave them, and hold 0 at positions
// outside [0, T): the mask is applied where a value is written.
constexpr int PAD_ROWS = 32;   // > the largest tap shift, (11 / 2) * 5 = 25

struct Window {
  int ld;     // row stride in elements
  int pos0;   // sequence position of row 0
  int t;      // sequence length
  __device__ __forceinline__ bool valid(int row) const {
    const int p = pos0 + row;
    return p >= 0 && p < t;
  }
};

// Epilogue of one output element (channel m, window row col) of a
// convolution with f32 product `v`: the first convolution of a unit writes
// leaky(y) * mask into ybuf, the second writes (cur + y) * mask into cur.
template <typename T, typename B>
__device__ __forceinline__ void epilogue(float v, int m, int col, bool first,
                                         const B* bias, T* ybuf, T* cur,
                                         const Window& w) {
  const float y = rnd<T>(bias_add(v, bias + m));
  const int i = col * w.ld + m;
  const bool ok = w.valid(col);
  if (first) {
    st(ybuf + i, ok ? leaky<T>(y) : 0.f);
  } else {
    st(cur + i, ok ? ld(cur + i) + y : 0.f);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// A [rows, cols] weight block (row stride ld_src in device memory, cols a
// multiple of 8) into shared memory, row stride cols + 8, one 16-byte copy
// per thread and step.
__device__ __forceinline__ void stage_block(bf16* dst, const bf16* src,
                                            int rows, int cols, int ld_src) {
  const int pieces = cols / 8;
  for (int i = threadIdx.x; i < rows * pieces; i += THREADS) {
    const int m = i / pieces, q = i - m * pieces;
    cp_async16(dst + m * (cols + 8) + q * 8, src + (long)m * ld_src + q * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

constexpr int MAX_NT = 12;   // n-tiles of 8 samples a warp owns, at most

// How warps split a [C, 8 * total] output: warp w owns the 16 output
// channels of m-block w % (C/16) and one of WARPS / (C/16) contiguous runs
// of n-tiles.
struct WarpTile {
  int m0, nt0, my_nt;
  __device__ WarpTile(int c, int total) {
    const int warp = threadIdx.x >> 5;
    const int mbs = c / 16;
    const int chunks = WARPS / mbs;
    const int per = (total + chunks - 1) / chunks;   // <= 48 / 4 = MAX_NT
    const int chunk = warp / mbs;
    m0 = (warp % mbs) * 16;
    nt0 = chunk * per;
    my_nt = chunk < chunks ? max(0, min(per, total - nt0)) : 0;
  }
};

// One convolution over output rows [lo, hi) (multiples of 8) on the tensor
// cores. src is cur (first: leaky applied on load) or ybuf. The taps'
// weight blocks pass through a double-buffered shared-memory stage, one
// barrier per tap.
template <typename B>
__device__ void conv_mma(const bf16* __restrict__ wgt, const B* bias,
                         int kr, int dil, bool first, const bf16* src,
                         bf16* ybuf, bf16* cur, bf16* wstage, int lo, int hi,
                         int c, const Window& w) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ldw = kr * c;
  const int lds = c + 8;
  const WarpTile wt(c, (hi - lo) / 8);
  const int m0 = wt.m0, my_nt = wt.my_nt;
  const int col0 = lo + wt.nt0 * 8;
  const __nv_bfloat162 s2 = __float2bfloat162_rn(0.1f);
  float acc[MAX_NT][4];
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;

  stage_block(wstage, wgt, c, c, ldw);
  for (int j = 0; j < kr; ++j) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // tap j staged; every warp is done with tap j - 1
    if (j + 1 < kr)
      stage_block(wstage + ((j + 1) & 1) * c * lds, wgt + (j + 1) * c, c, c,
                  ldw);
    const bf16* ws = wstage + (j & 1) * c * lds + (m0 + g) * lds + 2 * tg;
    const bf16* sp = src + (col0 + g + (j - kr / 2) * dil) * w.ld + 2 * tg;
    for (int k0 = 0; k0 < c; k0 += 16) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(ws + k0);
      a[1] = *reinterpret_cast<const uint32_t*>(ws + 8 * lds + k0);
      a[2] = *reinterpret_cast<const uint32_t*>(ws + k0 + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(ws + 8 * lds + k0 + 8);
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt) {
        if (nt >= my_nt) break;
        const bf16* p = sp + nt * 8 * w.ld + k0;
        __nv_bfloat162 v0 = *reinterpret_cast<const __nv_bfloat162*>(p);
        __nv_bfloat162 v1 = *reinterpret_cast<const __nv_bfloat162*>(p + 8);
        if (first) {
          v0 = __hmax2(v0, __hmul2(v0, s2));
          v1 = __hmax2(v1, __hmul2(v1, s2));
        }
        mma_16816(acc[nt], a, *reinterpret_cast<uint32_t*>(&v0),
                  *reinterpret_cast<uint32_t*>(&v1));
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt) {
    if (nt >= my_nt) break;
    const int col = col0 + nt * 8 + 2 * tg;
    epilogue(acc[nt][0], m0 + g, col, first, bias, ybuf, cur, w);
    epilogue(acc[nt][1], m0 + g, col + 1, first, bias, ybuf, cur, w);
    epilogue(acc[nt][2], m0 + g + 8, col, first, bias, ybuf, cur, w);
    epilogue(acc[nt][3], m0 + g + 8, col + 1, first, bias, ybuf, cur, w);
  }
}

// The same convolution in f32 FMAs: a thread owns 4 output channels x 8
// window rows; weights as float4 through the read-only cache.
__device__ void conv_fma(const float* __restrict__ wgt, const float* bias,
                         int kr, int dil, bool first, const float* src,
                         float* ybuf, float* cur, int lo, int hi, int c,
                         const Window& w) {
  const int ldw = kr * c;
  const int cgs = c / 4;
  const int n_units = cgs * ((hi - lo) / 8);
  for (int unit = threadIdx.x; unit < n_units; unit += THREADS) {
    const int co = (unit % cgs) * 4;
    const int t0 = lo + (unit / cgs) * 8;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][r] = 0.f;
    for (int j = 0; j < kr; ++j) {
      const float* wj = wgt + (long)co * ldw + j * c;
      const float* sj = src + (t0 + (j - kr / 2) * dil) * w.ld;
      for (int ci = 0; ci < c; ci += 4) {
        float4 wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[i] = __ldg(reinterpret_cast<const float4*>(wj + (long)i * ldw + ci));
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          float4 v = *reinterpret_cast<const float4*>(sj + r * w.ld + ci);
          if (first) {
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
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 8; ++r)
        epilogue(acc[i][r], co + i, t0 + r, first, bias, ybuf, cur, w);
  }
}

// Shared memory of both kernels: cur's buffer [ROWS, ld], ybuf's buffer of
// p.yreg elements, the f32 branch sum [C, t_tile + 1] and (bf16) the weight
// stage.
template <typename T>
struct Smem {
  static constexpr int T_TILE = Tile<T>::T_TILE;
  static constexpr int TW = T_TILE + 2 * HALO;
  static constexpr int ROWS = TW + 2 * PAD_ROWS;
  static constexpr int ACC_LD = T_TILE + 1;
  T* base;
  T* cur;
  T* yreg;
  T* ybuf;
  float* acc;
  bf16* wstage;
  __device__ Smem(void* smem, const Params& p, int ld) {
    base = static_cast<T*>(smem);
    cur = base + PAD_ROWS * ld;
    yreg = base + ROWS * ld;
    ybuf = yreg + PAD_ROWS * ld;
    acc = reinterpret_cast<float*>(yreg + p.yreg);
    wstage = reinterpret_cast<bf16*>(acc + p.c * ACC_LD);
  }
  // both buffers start at 0: the pad rows stay 0, and rows a convolution
  // leaves unwritten are read only for columns outside the output's
  // dependency cone
  __device__ void zero(const Params& p, int row_ld) {
    for (int i = threadIdx.x; i < ROWS * row_ld + p.yreg; i += THREADS)
      st(base + i, 0.f);
    __syncthreads();
  }
  // acc[c][t] (+)= cur over the tile's own rows
  __device__ void accumulate(int br, int c, int row_ld) {
    for (int i = threadIdx.x; i < c * T_TILE; i += THREADS) {
      const int r = i / c, ch = i - r * c;
      const float v = ld(cur + (HALO + r) * row_ld + ch);
      float* a = acc + ch * ACC_LD + r;
      *a = br == 0 ? v : *a + v;
    }
    __syncthreads();
  }
};

// One branch's units on the window held in `cur`, leaving the branch's
// result in cur. B is the biases' type.
template <typename T, typename B>
__device__ void run_branch(const Branch& bp, const Params& p, T* cur,
                           T* ybuf, bf16* wstage, const Window& w) {
  constexpr int T_TILE = Tile<T>::T_TILE;
  constexpr int TW = T_TILE + 2 * HALO;
  const int kr = bp.kr, c = p.c;
  // span still to come after each convolution of this branch
  int rest = 0;
  for (int u = 0; u < p.n_units; ++u) rest += (kr / 2) * (p.dils[u] + 1);
  for (int u = 0; u < p.n_units; ++u) {
    const int d = p.dils[u];
    const size_t wo = (size_t)u * c * kr * c;
    for (int half = 0; half < 2; ++half) {
      const bool first = half == 0;
      rest -= (kr / 2) * (first ? d : 1);
      // output rows of the exact region, widened to multiples of 8
      const int lo = max(0, ((HALO - rest) / 8) * 8);
      const int hi = min(TW, ((HALO + T_TILE + rest + 7) / 8) * 8);
      const T* wgt = static_cast<const T*>(first ? bp.w1 : bp.w2) + wo;
      const B* bias = static_cast<const B*>(first ? bp.b1 : bp.b2) + u * c;
      const T* src = first ? cur : ybuf;
      if constexpr (sizeof(T) == 2) {
        conv_mma(wgt, bias, kr, first ? d : 1, first, src, ybuf, cur, wstage,
                 lo, hi, c, w);
      } else {
        conv_fma(wgt, bias, kr, first ? d : 1, first, src, ybuf, cur, lo, hi,
                 c, w);
      }
      __syncthreads();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) mrf_kernel(Params p) {
  typedef Smem<T> S;
  extern __shared__ float4 smem4[];
  const int c = p.c;
  Window w;
  w.ld = c + Tile<T>::PAD;
  w.t = p.t;
  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * S::T_TILE;
  w.pos0 = tile0 - HALO;
  S sm(smem4, p, w.ld);
  const T* x = static_cast<const T*>(p.x) + (long)b * c * p.t;
  T* out = static_cast<T*>(p.out) + (long)b * c * p.t;
  const int tid = threadIdx.x;

  sm.zero(p, w.ld);
  for (int br = 0; br < p.n_br; ++br) {
    // cur = x over the window, zero outside the sequence (coalesced in t)
    for (int i = tid; i < c * S::TW; i += THREADS) {
      const int ch = i / S::TW, row = i - ch * S::TW;
      const int pos = w.pos0 + row;
      sm.cur[row * w.ld + ch] =
          (pos >= 0 && pos < p.t) ? x[(long)ch * p.t + pos] : T(0.f);
    }
    __syncthreads();
    run_branch<T, T>(p.br[br], p, sm.cur, sm.ybuf, sm.wstage, w);
    sm.accumulate(br, c, w.ld);
  }

  const float nb = (float)p.n_br;
  for (int i = tid; i < c * S::T_TILE; i += THREADS) {
    const int ch = i / S::T_TILE, r = i - ch * S::T_TILE;
    const int pos = tile0 + r;
    if (pos < p.t) st(out + (long)ch * p.t + pos, sm.acc[ch * S::ACC_LD + r] / nb);
  }
}

// ---------------------------------------------- upsample + MRF (ups_mrf_*)

// The input tile in sample order: row r holds input sample in_pos0 + r,
// leaky applied, 0 outside [0, s_in * t_valid). Read lane-contiguous per
// (channel, phase) row of x.
template <typename T>
__device__ void load_input_tile(const Params& p, T* tile, int ld_in,
                                int in_pos0, int in_rows, int b) {
  const int n_t = in_rows / p.s_in;        // in_rows is a multiple of s_in
  const int t_lo = in_pos0 / p.s_in;       // exact: in_pos0 is too
  const T* x = static_cast<const T*>(p.x) + (long)b * p.s_in * p.c_in * p.t;
  for (int i = threadIdx.x; i < p.c_in * in_rows; i += THREADS) {
    const int ch = i / in_rows;
    const int rem = i - ch * in_rows;
    const int r_in = rem / n_t, tt = rem - r_in * n_t;
    const int t = t_lo + tt;
    const float v = (t >= 0 && t < p.t_valid)
        ? leaky<T>(ld(x + ((long)r_in * p.c_in + ch) * p.t + t)) : 0.f;
    st(tile + (p.s_in * tt + r_in) * ld_in + ch, v);
  }
}

// The upsampler's taps of output phase r_up: tap m feeds window rows
// o = s_up * q + r_up from input rows q + d_m (+ IN_HALO in the tile).
struct UpPhase {
  int m_first, n_taps, pad_up;
  __device__ UpPhase(const Params& p, int r_up) {
    pad_up = p.k_up - 1 - (p.k_up - p.s_up) / 2;
    m_first = ((pad_up - r_up) % p.s_up + p.s_up) % p.s_up;
    n_taps = (p.k_up - m_first + p.s_up - 1) / p.s_up;
  }
  __device__ int tap(int j, const Params& p) const { return m_first + j * p.s_up; }
  __device__ int offset(int m, int r_up, const Params& p) const {
    return (r_up + m - pad_up) / p.s_up;   // exact
  }
};

// u over window rows s_up * q + r_up, q in [0, nq), into cur: per tap,
// [C, C_in] x [C_in, 8-sample tiles] on the tensor cores; then
// u = round(acc + b_up), 0 outside the sequence.
__device__ void ups_mma(const Params& p, int r_up, const bf16* tile,
                        int ld_in, bf16* cur, bf16* wstage, int nq,
                        const Window& w) {
  const int c = p.c, c_in = p.c_in;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int lds = c_in + 8;
  const bf16* wt = static_cast<const bf16*>(p.up_w);
  const UpPhase ph(p, r_up);
  const WarpTile wtl(c, nq / 8);
  const int m0 = wtl.m0, my_nt = wtl.my_nt;
  const int q0 = wtl.nt0 * 8;
  float acc[MAX_NT][4];
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;

  stage_block(wstage, wt + (long)ph.tap(0, p) * c * c_in, c, c_in, c_in);
  for (int j = 0; j < ph.n_taps; ++j) {
    const int m = ph.tap(j, p);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // tap j staged; every warp is done with tap j - 1
    if (j + 1 < ph.n_taps)
      stage_block(wstage + ((j + 1) & 1) * c * lds,
                  wt + (long)ph.tap(j + 1, p) * c * c_in, c, c_in, c_in);
    const bf16* ws = wstage + (j & 1) * c * lds + (m0 + g) * lds + 2 * tg;
    const bf16* sp =
        tile + (q0 + g + ph.offset(m, r_up, p) + IN_HALO) * ld_in + 2 * tg;
    for (int k0 = 0; k0 < c_in; k0 += 16) {
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(ws + k0);
      a[1] = *reinterpret_cast<const uint32_t*>(ws + 8 * lds + k0);
      a[2] = *reinterpret_cast<const uint32_t*>(ws + k0 + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(ws + 8 * lds + k0 + 8);
#pragma unroll
      for (int nt = 0; nt < MAX_NT; ++nt) {
        if (nt >= my_nt) break;
        const bf16* bp = sp + nt * 8 * ld_in + k0;
        mma_16816(acc[nt], a, *reinterpret_cast<const uint32_t*>(bp),
                  *reinterpret_cast<const uint32_t*>(bp + 8));
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt) {
    if (nt >= my_nt) break;
    const int q = q0 + nt * 8 + 2 * tg;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = m0 + g + (e >> 1) * 8;
      const int o = p.s_up * (q + (e & 1)) + r_up;
      st(cur + o * w.ld + ch, w.valid(o) ? acc[nt][e] + p.up_b[ch] : 0.f);
    }
  }
}

// The same upsample phase in f32 FMAs: a thread owns 4 output channels x 8
// rows of the phase.
__device__ void ups_fma(const Params& p, int r_up, const float* tile,
                        int ld_in, float* cur, int nq, const Window& w) {
  const int c = p.c, c_in = p.c_in;
  const float* wt = static_cast<const float*>(p.up_w);
  const UpPhase ph(p, r_up);
  const int cgs = c / 4;
  const int n_units = cgs * (nq / 8);
  for (int unit = threadIdx.x; unit < n_units; unit += THREADS) {
    const int co = (unit % cgs) * 4;
    const int q0 = (unit / cgs) * 8;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 8; ++r) acc[i][r] = 0.f;
    for (int j = 0; j < ph.n_taps; ++j) {
      const int m = ph.tap(j, p);
      const float* wj = wt + ((long)m * c + co) * c_in;
      const float* sj = tile + (q0 + ph.offset(m, r_up, p) + IN_HALO) * ld_in;
      for (int ci = 0; ci < c_in; ci += 4) {
        float4 wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          wv[i] = __ldg(reinterpret_cast<const float4*>(wj + (long)i * c_in + ci));
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(sj + r * ld_in + ci);
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
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int o = p.s_up * (q0 + r) + r_up;
        cur[o * w.ld + co + i] = w.valid(o) ? acc[i][r] + p.up_b[co + i] : 0.f;
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) ups_mrf_kernel(Params p) {
  typedef Smem<T> S;
  extern __shared__ float4 smem4[];
  const int c = p.c;
  const int s_out = p.s_in * p.s_up;
  Window w;
  w.ld = c + Tile<T>::PAD;
  w.t = s_out * p.t_valid;            // valid output samples
  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * S::T_TILE;
  w.pos0 = tile0 - HALO;
  S sm(smem4, p, w.ld);
  const int ld_in = p.c_in + Tile<T>::PAD;
  const int nq = S::TW / p.s_up;       // window rows of each output phase
  const int in_rows = nq + 2 * IN_HALO;
  const int in_pos0 = w.pos0 / p.s_up - IN_HALO;   // pos0 % s_up == 0
  T* tile = sm.yreg;
  const int tid = threadIdx.x;

  sm.zero(p, w.ld);
  for (int br = 0; br < p.n_br; ++br) {
    load_input_tile(p, tile, ld_in, in_pos0, in_rows, b);
    __syncthreads();
    for (int r_up = 0; r_up < p.s_up; ++r_up) {
      if constexpr (sizeof(T) == 2) {
        ups_mma(p, r_up, tile, ld_in, sm.cur, sm.wstage, nq, w);
      } else {
        ups_fma(p, r_up, tile, ld_in, sm.cur, nq, w);
      }
      __syncthreads();
    }
    run_branch<T, float>(p.br[br], p, sm.cur, sm.ybuf, sm.wstage, w);
    sm.accumulate(br, c, w.ld);
  }

  // out[b, r*C + c, t] holds output sample s_out*t + r: lane-contiguous
  // stores per (channel, phase) row, 0 at padding lanes
  const float nb = (float)p.n_br;
  const int tpp = S::T_TILE / s_out;
  const int lane0 = tile0 / s_out;
  T* out = static_cast<T*>(p.out) + (long)b * s_out * c * p.t;
  for (int i = tid; i < c * S::T_TILE; i += THREADS) {
    const int ch = i / S::T_TILE, rem = i - ch * S::T_TILE;
    const int r = rem / tpp, tt = rem - r * tpp;
    const int lane = lane0 + tt;
    if (lane < p.t)
      st(out + ((long)r * c + ch) * p.t + lane,
         lane < p.t_valid ? sm.acc[ch * S::ACC_LD + s_out * tt + r] / nb : 0.f);
  }
}

// The branches' weights and spans into p; false on a shape the kernels do
// not take.
bool set_branches(Params& p, const void* const* wb, const int* krs, int n_br,
                  const int* dils, int n_units) {
  if (n_br < 1 || n_br > MAX_BRANCHES || n_units < 1 || n_units > MAX_UNITS)
    return false;
  for (int i = 0; i < n_br; ++i) {
    int span = 0;
    for (int u = 0; u < n_units; ++u) span += (krs[i] / 2) * (dils[u] + 1);
    if (krs[i] < 1 || krs[i] % 2 == 0 || span > HALO) return false;
    p.br[i] = Branch{wb[4 * i], wb[4 * i + 1], wb[4 * i + 2], wb[4 * i + 3],
                     krs[i]};
  }
  for (int u = 0; u < n_units; ++u) p.dils[u] = dils[u];
  p.n_br = n_br;
  p.n_units = n_units;
  return true;
}

// Dynamic shared memory of a CTA: cur's and ybuf's buffers, the f32 branch
// sum and (bf16) the double-buffered weight stage, sized for the widest
// block staged (a [C, C] tap or an upsampler's [C, C_in] tap).
template <typename T>
size_t smem_bytes(const Params& p, int stage_cols) {
  return ((size_t)Smem<T>::ROWS * (p.c + Tile<T>::PAD) + p.yreg) * sizeof(T) +
         (size_t)p.c * Smem<T>::ACC_LD * sizeof(float) +
         (sizeof(T) == 2 ? 2 * (size_t)p.c * (stage_cols + 8) * sizeof(bf16)
                         : 0);
}

template <typename K>
int start(K kernel, const Params& p, size_t smem, int tiles, int batch,
          int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(tiles, batch), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* out, const void* const* wb, const int* krs,
           int n_br, const int* dils, int n_units, int batch, int c, int t,
           int device, cudaStream_t stream) {
  Params p = {};
  if (!set_branches(p, wb, krs, n_br, dils, n_units) || c < 16 ||
      c > MAX_C || c % 16 || batch < 1 || batch > 65535 || t < 1)
    return (int)cudaErrorInvalidValue;
  p.x = x;
  p.out = out;
  p.c = c;
  p.t = t;
  p.yreg = Smem<T>::ROWS * (c + Tile<T>::PAD);
  constexpr int T_TILE = Tile<T>::T_TILE;
  return start(mrf_kernel<T>, p, smem_bytes<T>(p, c),
               (t + T_TILE - 1) / T_TILE, batch, device, stream);
}

template <typename T>
int launch_ups(const void* x, void* out, const void* up_w, const float* up_b,
               const void* const* wb, const int* krs, int n_br,
               const int* dils, int n_units, int batch, int c_in, int c,
               int s_in, int s_up, int k_up, int t_ps, int t_valid,
               int device, cudaStream_t stream) {
  Params p = {};
  const bool rates = (s_up == 2 || s_up == 4) &&
                     (s_in == 1 || s_in == 2 || s_in == 4) && s_in * s_up <= 4;
  if (!set_branches(p, wb, krs, n_br, dils, n_units) || !rates || c < 16 ||
      c > MAX_C || c % 16 || c_in < 16 || c_in > MAX_C_IN || c_in % 16 ||
      k_up < s_up || (k_up - s_up) % 2 || k_up > MAX_K_UP || batch < 1 ||
      batch > 65535 || t_ps < 1 || t_valid < 0 || t_valid > t_ps)
    return (int)cudaErrorInvalidValue;
  p.x = x;
  p.out = out;
  p.c = c;
  p.t = t_ps;
  p.up_w = up_w;
  p.up_b = up_b;
  p.c_in = c_in;
  p.s_in = s_in;
  p.s_up = s_up;
  p.k_up = k_up;
  p.t_valid = t_valid;
  constexpr int T_TILE = Tile<T>::T_TILE;
  const int in_rows = Smem<T>::TW / s_up + 2 * IN_HALO;
  const int window = Smem<T>::ROWS * (c + Tile<T>::PAD);
  const int tile = in_rows * (c_in + Tile<T>::PAD);
  p.yreg = window > tile ? window : tile;
  const long samples = (long)s_in * s_up * t_ps;
  return start(ups_mrf_kernel<T>, p, smem_bytes<T>(p, c > c_in ? c : c_in),
               (int)((samples + T_TILE - 1) / T_TILE), batch, device, stream);
}

}  // namespace

extern "C" int mrf_f32(const void* x, void* out, const void* const* wb,
                       const int* krs, int n_br, const int* dils, int n_units,
                       int batch, int c, int t, int device,
                       cudaStream_t stream) {
  return launch<float>(x, out, wb, krs, n_br, dils, n_units, batch, c, t,
                       device, stream);
}

extern "C" int mrf_bf16(const void* x, void* out, const void* const* wb,
                        const int* krs, int n_br, const int* dils,
                        int n_units, int batch, int c, int t, int device,
                        cudaStream_t stream) {
  return launch<bf16>(x, out, wb, krs, n_br, dils, n_units, batch, c, t,
                      device, stream);
}

extern "C" int ups_mrf_f32(const void* x, void* out, const void* up_w,
                           const float* up_b, const void* const* wb,
                           const int* krs, int n_br, const int* dils,
                           int n_units, int batch, int c_in, int c, int s_in,
                           int s_up, int k_up, int t_ps, int t_valid,
                           int device, cudaStream_t stream) {
  return launch_ups<float>(x, out, up_w, up_b, wb, krs, n_br, dils, n_units,
                           batch, c_in, c, s_in, s_up, k_up, t_ps, t_valid,
                           device, stream);
}

extern "C" int ups_mrf_bf16(const void* x, void* out, const void* up_w,
                            const float* up_b, const void* const* wb,
                            const int* krs, int n_br, const int* dils,
                            int n_units, int batch, int c_in, int c, int s_in,
                            int s_up, int k_up, int t_ps, int t_valid,
                            int device, cudaStream_t stream) {
  return launch_ups<bf16>(x, out, up_w, up_b, wb, krs, n_br, dils, n_units,
                          batch, c_in, c, s_in, s_up, k_up, t_ps, t_valid,
                          device, stream);
}
