// One whole HiFi-GAN MRF level (multi-receptive-field fusion), in f32 or bf16.
//
// Replaces forwardtacotron_tpu/ops/pallas/mrf.py::mrf_pallas (kernel body
// _mrf_kernel). On channels-major x [B, C, T], per kernel size kr:
//   cur = x
//   for each dilation d:  y   = conv(kr, d)(leaky(cur) * mask) (+ b1)
//                         cur = cur + conv(kr, 1)(leaky(y) * mask) (+ b2)
//   acc += cur                                   (float32)
// out = round(acc / n_branches) * mask
// with mask = 1 at positions in [0, T): every convolution sees zeros outside
// the sequence (torch's zero padding at the true sequence ends).
//
// Weights per branch: w1, w2 [U, C, kr*C] with j-major im2col columns
// (column j*C + c_in, as pack_conv_weight packs them), biases b1, b2 [U, C].
//
// Rounding points, in the activation's type T: leaky = max(v, round(s * v))
// with s = 0.1 in T; each convolution's f32 product, then its bias added;
// cur + y2. The branch sum is f32 and divided (not multiplied) by the count.
//
// Bound on an H100: operations. One level is 2 * C^2 * (2 * U * sum(kr)) * T
// useful FLOPs per item (126 convolution taps for kr = 3, 7, 11 and U = 3):
// 63 * C FLOPs per byte of bf16 input and output (4,032 at C = 64), far
// above the 295 at which the bf16 tensor cores become the limit, and
// 31.5 * C in f32, far above the f32 FMA units' 20.
//
// Design. One CTA per (batch item, time tile). The tile's window of
// t_tile + 2 * HALO samples stays in shared memory through all 18
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
// Shared memory (C = 64): bf16, t_tile 256: 2 x 448 x 72 x 2 B + a 64 x 257
// f32 branch sum + 2 x 64 x 72 x 2 B of weights = 213,248 B; f32, t_tile
// 128: 2 x 320 x 68 x 4 + 64 x 129 x 4 = 207,104 B; one CTA of 16 warps per
// SM. C is at most 64 and a multiple of 16 (the wrapper pads C = 8 mod 16
// with zero channels). A simple first kernel: TMA, wgmma and more resident
// warps are later work.

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
  int t;
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
template <typename T>
__device__ __forceinline__ void epilogue(float v, int m, int col, bool first,
                                         const T* bias, T* ybuf, T* cur,
                                         const Window& w) {
  const float y = rnd<T>(rnd<T>(v) + ld(bias + m));
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

// One tap's [C, C] weight block (columns j*C .. j*C + C of the packed rows)
// into shared memory, row stride C + 8, one 16-byte copy per thread and step.
__device__ __forceinline__ void stage_tap(bf16* dst, const bf16* wgt, int j,
                                          int c, int ldw) {
  const int pieces = c / 8;
  for (int i = threadIdx.x; i < c * pieces; i += THREADS) {
    const int m = i / pieces, q = i - m * pieces;
    cp_async16(dst + m * (c + 8) + q * 8, wgt + (long)m * ldw + j * c + q * 8);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

constexpr int MAX_NT = 12;   // n-tiles of 8 samples a warp owns, at most

// One convolution over output rows [lo, hi) (multiples of 8) on the tensor
// cores. src is cur (first: leaky applied on load) or ybuf. Warp w owns the
// 16 output channels of m-block w % (C/16) and one of WARPS / (C/16)
// contiguous runs of n-tiles; the taps' weight blocks pass through a
// double-buffered shared-memory stage, one barrier per tap.
__device__ void conv_mma(const bf16* __restrict__ wgt, const bf16* bias,
                         int kr, int dil, bool first, const bf16* src,
                         bf16* ybuf, bf16* cur, bf16* wstage, int lo, int hi,
                         int c, const Window& w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int ldw = kr * c;
  const int lds = c + 8;
  const int mbs = c / 16;
  const int chunks = WARPS / mbs;
  const int total = (hi - lo) / 8;
  const int per = (total + chunks - 1) / chunks;   // <= 48 / 4 = MAX_NT
  const int m0 = (warp % mbs) * 16;
  const int chunk = warp / mbs;
  const int nt0 = chunk * per;
  const int my_nt = chunk < chunks ? max(0, min(per, total - nt0)) : 0;
  const int col0 = lo + nt0 * 8;
  const __nv_bfloat162 s2 = __float2bfloat162_rn(0.1f);
  float acc[MAX_NT][4];
#pragma unroll
  for (int nt = 0; nt < MAX_NT; ++nt)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;

  stage_tap(wstage, wgt, 0, c, ldw);
  for (int j = 0; j < kr; ++j) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();   // tap j staged; every warp is done with tap j - 1
    if (j + 1 < kr) stage_tap(wstage + ((j + 1) & 1) * c * lds, wgt, j + 1, c, ldw);
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

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) mrf_kernel(Params p) {
  constexpr int T_TILE = Tile<T>::T_TILE;
  constexpr int TW = T_TILE + 2 * HALO;
  constexpr int ROWS = TW + 2 * PAD_ROWS;
  extern __shared__ float4 smem4[];
  const int c = p.c;
  Window w;
  w.ld = c + Tile<T>::PAD;
  w.t = p.t;
  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * T_TILE;
  w.pos0 = tile0 - HALO;
  T* cur = reinterpret_cast<T*>(smem4) + PAD_ROWS * w.ld;
  T* ybuf = cur + ROWS * w.ld;
  float* acc = reinterpret_cast<float*>(ybuf + (ROWS - PAD_ROWS) * w.ld);
  constexpr int ACC_LD = T_TILE + 1;
  bf16* wstage = reinterpret_cast<bf16*>(acc + c * ACC_LD);
  const T* x = static_cast<const T*>(p.x) + (long)b * c * p.t;
  T* out = static_cast<T*>(p.out) + (long)b * c * p.t;
  const int tid = threadIdx.x;

  // both buffers start at 0: the pad rows stay 0, and rows a convolution
  // leaves unwritten are read only for columns outside the output's
  // dependency cone
  for (int i = tid; i < 2 * ROWS * w.ld; i += THREADS)
    st(reinterpret_cast<T*>(smem4) + i, 0.f);

  for (int br = 0; br < p.n_br; ++br) {
    const Branch& bp = p.br[br];
    const int kr = bp.kr;
    // cur = x over the window, zero outside the sequence (coalesced in t)
    for (int i = tid; i < c * TW; i += THREADS) {
      const int ch = i / TW, row = i - ch * TW;
      const int pos = w.pos0 + row;
      cur[row * w.ld + ch] =
          (pos >= 0 && pos < p.t) ? x[(long)ch * p.t + pos] : T(0.f);
    }
    __syncthreads();
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
        const T* bias = static_cast<const T*>(first ? bp.b1 : bp.b2) + u * c;
        const T* src = first ? cur : ybuf;
        if constexpr (sizeof(T) == 2) {
          conv_mma(wgt, bias, kr, first ? d : 1, first, src, ybuf, cur,
                   wstage, lo, hi, c, w);
        } else {
          conv_fma(wgt, bias, kr, first ? d : 1, first, src, ybuf, cur, lo,
                   hi, c, w);
        }
        __syncthreads();
      }
    }
    // acc[c][t] (+)= cur over the tile's own rows
    for (int i = tid; i < c * T_TILE; i += THREADS) {
      const int r = i / c, ch = i - r * c;
      const float v = ld(cur + (HALO + r) * w.ld + ch);
      float* a = acc + ch * ACC_LD + r;
      *a = br == 0 ? v : *a + v;
    }
    __syncthreads();
  }

  const float nb = (float)p.n_br;
  for (int i = tid; i < c * T_TILE; i += THREADS) {
    const int ch = i / T_TILE, r = i - ch * T_TILE;
    const int pos = tile0 + r;
    if (pos < p.t) st(out + (long)ch * p.t + pos, acc[ch * ACC_LD + r] / nb);
  }
}

template <typename T>
int launch(const void* x, void* out, const void* const* wb, const int* krs,
           int n_br, const int* dils, int n_units, int batch, int c, int t,
           int device, cudaStream_t stream) {
  if (n_br < 1 || n_br > MAX_BRANCHES || n_units < 1 || n_units > MAX_UNITS ||
      c < 16 || c > MAX_C || c % 16 || batch < 1 || batch > 65535 || t < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  for (int i = 0; i < n_br; ++i) {
    int span = 0;
    for (int u = 0; u < n_units; ++u) span += (krs[i] / 2) * (dils[u] + 1);
    if (krs[i] < 1 || krs[i] % 2 == 0 || span > HALO)
      return (int)cudaErrorInvalidValue;
    p.br[i] = Branch{wb[4 * i], wb[4 * i + 1], wb[4 * i + 2], wb[4 * i + 3],
                     krs[i]};
  }
  for (int u = 0; u < n_units; ++u) p.dils[u] = dils[u];
  p.n_br = n_br;
  p.n_units = n_units;
  p.x = x;
  p.out = out;
  p.c = c;
  p.t = t;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int T_TILE = Tile<T>::T_TILE;
  // two padded activation buffers, the f32 branch sum and (bf16) the
  // double-buffered weight stage
  const size_t smem =
      2 * (size_t)(T_TILE + 2 * HALO + 2 * PAD_ROWS) * (c + Tile<T>::PAD) *
          sizeof(T) +
      (size_t)c * (T_TILE + 1) * sizeof(float) +
      (sizeof(T) == 2 ? 2 * (size_t)c * (c + 8) * sizeof(bf16) : 0);
  err = cudaFuncSetAttribute(mrf_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t + T_TILE - 1) / T_TILE, batch);
  mrf_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
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
