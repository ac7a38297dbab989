// Reverse-time backward sweeps of the trainable bidirectional GRU and LSTM:
// dh (and dc) carried in float32 from t = T-1 down to 0, the gates
// recomputed from x_t and the saved h_{t-1} (and c_t, c_{t-1}), and the
// pre-activation gradients written as bf16 every step.
//
// Replaces forwardtacotron_tpu/ops/pallas/rnn_train.py:
//   _gru_core_bwd   (body _gru_bwd_kernel)   -> rnn_gru_bwd_bf16: dgx, dgh
//   _lstm_core_bwd  (body _lstm_bwd_kernel)  -> rnn_lstm_bwd_bf16: dgates
// The weight and input gradients (x^T dgates, h_prev^T dgates, dgates Wi^T)
// are plain products over the whole [T*2*B] axis outside this kernel, as the
// JAX package leaves them to XLA.
//
// Numerics as in the TPU kernels: the incoming dhs is bf16 (cast by the
// caller), gates recompute in float32 from bf16 products with float32
// accumulation (the GRU adds bi and bh apart, the LSTM takes bi + bh summed
// in bf16), h_{-1} = c_{-1} = 0, dh and dc are carried in float32, and
// dh_{t-1} = [z * dh_t +] bf16(dgh_t) @ Wh^T with float32 accumulation.
// The GRU's two outputs differ in the n gate: dgx_n = dgn, dgh_n = dgn * r.
//
// Layout: dhs, hs, cs [T, 2, B, H]; x [T, 2, B, I] (direction 1 flipped by
// the caller, as in the forward); weights [2, K, G], torch gate order (GRU
// r,z,n; LSTM i,f,g,o), G = NG*H; outputs [T, 2, B, G].
//
// Bound on an H100: each step is two small tensor-core products per
// direction ([B, I+H] x [I+H, G] to recompute the gates and [B, G] x [G, H]
// for dh_{t-1}); at training batch the T sequential steps, not the
// operations, set the time. Design: as the forward (rnn.cu), CTA (s, d, r)
// owns hidden units [16 s, 16 s + 16) of direction d and keeps the [I+H,
// NG*16] weight columns of those units in shared memory for all T steps.
// Each step it stages x_t and h_{t-1} of its batch tile with cp.async,
// recomputes its gates on the tensor cores (wmma 16x16x16), forms its
// dgates, writes them, and meets the other H/16 CTAs of its (direction,
// batch group) at a grid barrier: dh_{t-1} of its 16 units needs the
// dgates of all G columns, which the others have just written (to the
// output itself, through L2). It then stages that [BB, G] row block into
// the shared memory that held x_t and h_{t-1} and multiplies it by its 16
// rows of Wh, read from L2 as the tensor cores' B operand, the K axis split
// over the warps. Shared memory is the constraint: the H=512 LSTM's weight
// columns take 144 KB and the staged dgates 64 KB of the 227 KB, so the
// staging buffers share one region and the Wh rows stay in L2. The launch
// is cooperative (the barrier needs every CTA resident) and refuses a grid
// that does not fit. A simple design: wgmma, TMA and clusters are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int U = 16;  // hidden units per CTA

struct Params {
  const bf16* dhs;  // [T, 2, B, H]
  const bf16* hs;   // [T, 2, B, H]
  const bf16* cs;   // [T, 2, B, H] (LSTM)
  const bf16* x;    // [T, 2, B, I]
  const bf16* wi;   // [2, I, G]
  const bf16* wh;   // [2, H, G]
  const bf16* bx;   // [2, G]: GRU bi, LSTM bi + bh
  const bf16* bh;   // [2, G]: GRU bh (null for the LSTM)
  bf16* dgx;        // [T, 2, B, G]: GRU dgx, LSTM dgates
  bf16* dgh;        // [T, 2, B, G]: GRU dgh (null for the LSTM)
  unsigned int* bar;  // [2, R] barrier counters, zero at launch
  int T, B, I, H, BB, R;
};

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) & ~(size_t)127;
}

// Shared memory of one CTA, in carve order. `stage` holds [x_t | h_{t-1}]
// for the gate products, then the exchanged dgates for the dh product;
// `acc` holds the gate accumulators, then the dh product's partial sums.
struct Carve {
  size_t w, stage, acc, dh, dc, bias, total;
};

__host__ __device__ inline Carve carve(bool lstm, int I, int H, int BB) {
  const int ng = lstm ? 4 : 3, nc = ng * U, ka = I + H, g = ng * H;
  const size_t stage_elems = (size_t)BB * ((ka > g ? ka : g) + 8);
  const size_t acc_bytes = (size_t)BB * nc * sizeof(float) * (lstm ? 1 : 2);
  const size_t part_bytes = (size_t)NWARPS * 256 * sizeof(float);
  Carve c;
  c.w = 0;
  c.stage = c.w + align128((size_t)ka * (nc + 8) * sizeof(bf16));
  c.acc = c.stage + align128(stage_elems * sizeof(bf16));
  c.dh = c.acc + align128(acc_bytes > part_bytes ? acc_bytes : part_bytes);
  c.dc = c.dh + align128((size_t)BB * U * sizeof(float));
  c.bias = c.dc + (lstm ? align128((size_t)BB * U * sizeof(float)) : 0);
  c.total = c.bias + align128(2 * nc * sizeof(float));
  return c;
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// 16-byte global -> shared copy through L2 only (.cg): the dgates written
// by other SMs before the barrier are seen
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Barrier of the S CTAs of one (direction, group): a counter that only
// grows; the n-th barrier waits for n * S arrivals.
__device__ __forceinline__ void group_sync(unsigned int* bar, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    volatile unsigned int* vb = bar;
    while (*vb < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

template <bool LSTM>
__global__ void __launch_bounds__(THREADS) rnn_bwd_kernel(Params p) {
  constexpr int NG = LSTM ? 4 : 3;
  constexpr int NC = NG * U;
  const int s = blockIdx.x, d = blockIdx.y, r = blockIdx.z;
  const int S = gridDim.x;
  const int I = p.I, H = p.H, G = NG * H, B = p.B, BB = p.BB;
  const int KA = I + H, lda = KA + 8, ldd = G + 8, ldw = NC + 8;
  const int tid = threadIdx.x, warp = tid / 32;

  extern __shared__ __align__(128) unsigned char smem[];
  const Carve cv = carve(LSTM, I, H, BB);
  bf16* Ws = reinterpret_cast<bf16*>(smem + cv.w);         // [KA][ldw]
  bf16* As = reinterpret_cast<bf16*>(smem + cv.stage);     // [BB][lda]
  bf16* Ds = As;                                           // [BB][ldd]
  float* acc_h = reinterpret_cast<float*>(smem + cv.acc);  // [BB][NC]
  float* acc_x = acc_h + BB * NC;                          // [BB][NC] (GRU)
  float* part = acc_h;                                     // [NWARPS][16][16]
  float* dh = reinterpret_cast<float*>(smem + cv.dh);      // [BB][U]
  float* dc = reinterpret_cast<float*>(smem + cv.dc);      // [BB][U] (LSTM)
  float* bxs = reinterpret_cast<float*>(smem + cv.bias);   // [NC]
  float* bhs = bxs + NC;                                   // [NC]

  // this CTA's weight columns: column j = g*U + u <- global g*H + s*U + u
  for (int i = tid; i < KA * NC; i += THREADS) {
    const int k = i / NC, j = i - k * NC;
    const int col = (j / U) * H + s * U + (j % U);
    Ws[k * ldw + j] = k < I ? p.wi[((size_t)d * I + k) * G + col]
                            : p.wh[((size_t)d * H + (k - I)) * G + col];
  }
  for (int j = tid; j < NC; j += THREADS) {
    const int col = (j / U) * H + s * U + (j % U);
    bxs[j] = __bfloat162float(p.bx[(size_t)d * G + col]);
    bhs[j] = p.bh ? __bfloat162float(p.bh[(size_t)d * G + col]) : 0.f;
  }

  unsigned int* bar = p.bar + d * p.R + r;
  unsigned int n_bar = 0;
  const int n_tiles = (B + BB - 1) / BB;
  const int rb_n = BB / 16;
  bf16* exch = LSTM ? p.dgx : p.dgh;  // the dgates dh_{t-1} is made from
  // this CTA's 16 rows of Wh as a column-major [G, 16] B operand
  const bf16* wh_rows = p.wh + ((size_t)d * H + s * U) * G;

  // copy `width` bf16 values of row b from src (rows of `stride`) into dst
  // row `row`, or zeros past the batch
  auto stage_rows = [&](bf16* dst, int ld, int width, int b0, auto src_of) {
    const int chunks = width / 8;
    for (int i = tid; i < BB * chunks; i += THREADS) {
      const int row = i / chunks, k = (i - row * chunks) * 8;
      const bf16* src = src_of(b0 + row, k);
      bf16* to = dst + row * ld + k;
      if (src)
        cp_async16(to, src);
      else
        *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
    }
    cp_async_wait_all();
  };

  for (int tile = r; tile < n_tiles; tile += p.R) {
    const int b0 = tile * BB;
    for (int i = tid; i < BB * U; i += THREADS) {
      dh[i] = 0.f;
      if (LSTM) dc[i] = 0.f;
    }
    for (int t = p.T - 1; t >= 0; --t) {
      // x_t (k < I) and h_{t-1} (k >= I, zero at t = 0)
      stage_rows(As, lda, KA, b0, [&](int b, int k) -> const bf16* {
        if (b >= B) return nullptr;
        if (k < I) return p.x + (((size_t)t * 2 + d) * B + b) * I + k;
        if (t == 0) return nullptr;
        return p.hs + (((size_t)(t - 1) * 2 + d) * B + b) * H + (k - I);
      });
      __syncthreads();

      // gate products: part 0 = h (GRU) or all of K (LSTM) into acc_h,
      // part 1 = x into acc_x (GRU)
      const int n_items = rb_n * NG * (LSTM ? 1 : 2);
      for (int item = warp; item < n_items; item += NWARPS) {
        const int part_i = item / (rb_n * NG), rem = item - part_i * rb_n * NG;
        const int rb = rem / NG, cb = rem - rb * NG;
        const int k0 = part_i == 1 ? 0 : (LSTM ? 0 : I);
        const int k1 = part_i == 1 ? I : KA;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int k = k0; k < k1; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, As + rb * 16 * lda + k, lda);
          wmma::load_matrix_sync(fb, Ws + k * ldw + cb * 16, ldw);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        float* dst = (part_i == 1 ? acc_x : acc_h) + rb * 16 * NC + cb * 16;
        wmma::store_matrix_sync(dst, acc, NC, wmma::mem_row_major);
      }
      __syncthreads();

      // dgates of this CTA's units; dh (and dc) carry what the next step
      // needs besides the dh product
      for (int i = tid; i < BB * U; i += THREADS) {
        const int row = i / U, u = i - row * U, b = b0 + row, unit = s * U + u;
        if (b >= B) {
          dh[i] = 0.f;
          if (LSTM) dc[i] = 0.f;
          continue;
        }
        const size_t hrow = (((size_t)t * 2 + d) * B + b) * H;
        const size_t grow = (((size_t)t * 2 + d) * B + b) * G;
        const float dh_total = __bfloat162float(p.dhs[hrow + unit]) + dh[i];
        const float* ah = acc_h + row * NC;
        if (!LSTM) {
          const float* ax = acc_x + row * NC;
          const float xr = ax[u] + bxs[u];
          const float xz = ax[U + u] + bxs[U + u];
          const float xn = ax[2 * U + u] + bxs[2 * U + u];
          const float hr = ah[u] + bhs[u];
          const float hz = ah[U + u] + bhs[U + u];
          const float hn = ah[2 * U + u] + bhs[2 * U + u];
          const float rg = sigmoidf(xr + hr), zg = sigmoidf(xz + hz);
          const float ng = tanhf(xn + rg * hn);
          const float h_prev = __bfloat162float(As[row * lda + I + unit]);
          const float dz = dh_total * (h_prev - ng);
          const float dn = dh_total * (1.f - zg);
          const float dgn = dn * (1.f - ng * ng);
          const float dr = dgn * hn;
          const float dgr = dr * rg * (1.f - rg);
          const float dgz = dz * zg * (1.f - zg);
          p.dgx[grow + unit] = __float2bfloat16(dgr);
          p.dgx[grow + H + unit] = __float2bfloat16(dgz);
          p.dgx[grow + 2 * H + unit] = __float2bfloat16(dgn);
          p.dgh[grow + unit] = __float2bfloat16(dgr);
          p.dgh[grow + H + unit] = __float2bfloat16(dgz);
          p.dgh[grow + 2 * H + unit] = __float2bfloat16(dgn * rg);
          dh[i] = dh_total * zg;
        } else {
          const float gi = sigmoidf(ah[u] + bxs[u]);
          const float gf = sigmoidf(ah[U + u] + bxs[U + u]);
          const float gg = tanhf(ah[2 * U + u] + bxs[2 * U + u]);
          const float go = sigmoidf(ah[3 * U + u] + bxs[3 * U + u]);
          const float c_t = __bfloat162float(p.cs[hrow + unit]);
          const float c_prev =
              t > 0 ? __bfloat162float(p.cs[hrow - (size_t)2 * B * H + unit]) : 0.f;
          const float tc = tanhf(c_t);
          const float d_o = dh_total * tc;
          const float dc_total = dh_total * go * (1.f - tc * tc) + dc[i];
          const float dgi = dc_total * gg * gi * (1.f - gi);
          const float dgf = dc_total * c_prev * gf * (1.f - gf);
          const float dgg = dc_total * gi * (1.f - gg * gg);
          const float dgo = d_o * go * (1.f - go);
          p.dgx[grow + unit] = __float2bfloat16(dgi);
          p.dgx[grow + H + unit] = __float2bfloat16(dgf);
          p.dgx[grow + 2 * H + unit] = __float2bfloat16(dgg);
          p.dgx[grow + 3 * H + unit] = __float2bfloat16(dgo);
          dc[i] = dc_total * gf;
          dh[i] = 0.f;
        }
      }
      // every CTA of the group has written its columns of step t
      ++n_bar;
      group_sync(bar, n_bar * S);

      // dh_{t-1} += bf16(dgates_t) @ Wh[units]^T: the [BB, G] row block
      // staged where x_t and h_{t-1} were, the K axis split over the warps
      stage_rows(Ds, ldd, G, b0, [&](int b, int k) -> const bf16* {
        if (b >= B) return nullptr;
        return exch + (((size_t)t * 2 + d) * B + b) * G + k;
      });
      __syncthreads();
      const int k_split = NWARPS / rb_n;
      {
        const int rb = warp % rb_n, kp = warp / rb_n;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kc = kp; kc < G / 16; kc += k_split) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fa, Ds + rb * 16 * ldd + kc * 16, ldd);
          wmma::load_matrix_sync(fb, wh_rows + kc * 16, G);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(part + warp * 256, acc, 16, wmma::mem_row_major);
      }
      __syncthreads();
      for (int i = tid; i < BB * U; i += THREADS) {
        const int row = i / U, u = i - row * U, rb = row / 16;
        float sum = 0.f;
        for (int kp = 0; kp < k_split; ++kp)
          sum += part[(kp * rb_n + rb) * 256 + (row % 16) * 16 + u];
        dh[i] += sum;
      }
      __syncthreads();
    }
  }
}

template <bool LSTM>
int launch(Params p, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int S = p.H / U;
  const int n_tiles_16 = (p.B + 15) / 16;
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  // the largest batch tile (16, 32 or 64 rows) that fits shared memory and
  // the batch
  int bb = 0;
  for (int cand = 64; cand >= 16; cand /= 2) {
    if (cand > 16 * n_tiles_16 && cand > 16) continue;
    if (carve(LSTM, p.I, p.H, cand).total <= (size_t)max_smem) {
      bb = cand;
      break;
    }
  }
  if (bb == 0) return (int)cudaErrorInvalidValue;
  p.BB = bb;
  const size_t smem = carve(LSTM, p.I, p.H, bb).total;
  err = cudaFuncSetAttribute(rnn_bwd_kernel<LSTM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rnn_bwd_kernel<LSTM>, THREADS,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (p.B + bb - 1) / bb;
  int groups = per_sm * n_sm / (2 * S);
  if (groups < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  p.R = groups < n_tiles ? groups : n_tiles;
  dim3 grid(S, 2, p.R);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((void*)rnn_bwd_kernel<LSTM>, grid, dim3(THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns a cudaError_t (0 on success). `bar` must hold 2 * B
// zeroed counters. I and H are multiples of 16.
extern "C" int rnn_gru_bwd_bf16(const void* dhs, const void* hs, const void* x, const void* wi,
                                const void* wh, const void* bi, const void* bh, void* dgx,
                                void* dgh, unsigned int* bar, int T, int B, int I, int H,
                                int device, cudaStream_t stream) {
  Params p{(const bf16*)dhs, (const bf16*)hs, nullptr, (const bf16*)x, (const bf16*)wi,
           (const bf16*)wh, (const bf16*)bi, (const bf16*)bh, (bf16*)dgx, (bf16*)dgh, bar,
           T, B, I, H, 0, 0};
  return launch<false>(p, device, stream);
}

extern "C" int rnn_lstm_bwd_bf16(const void* dhs, const void* hs, const void* cs, const void* x,
                                 const void* wi, const void* wh, const void* b, void* dgates,
                                 unsigned int* bar, int T, int B, int I, int H, int device,
                                 cudaStream_t stream) {
  Params p{(const bf16*)dhs, (const bf16*)hs, (const bf16*)cs, (const bf16*)x, (const bf16*)wi,
           (const bf16*)wh, (const bf16*)b, nullptr, (bf16*)dgates, nullptr, bar,
           T, B, I, H, 0, 0};
  return launch<true>(p, device, stream);
}
