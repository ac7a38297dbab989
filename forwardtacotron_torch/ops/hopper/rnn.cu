// Bidirectional recurrences of the bf16 serving path, whole sequence in one
// launch: a GRU from a precomputed input projection, a GRU or LSTM with the
// input projection in the kernel, and an LSTM whose every step ends in the
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
// Bound on an H100: at serving batch the per-step products ([B, I+H] x
// [I+H, G] per direction) are tensor-core operations; at batch 1 the T steps
// are sequential and the time is T times the latency of one step. Design:
// the TPU kernel keeps all weights in 16 MB of VMEM and walks time as its
// sequential grid axis. Here the weights of one direction (4 MB for the
// LSTM) do not fit one SM, so the hidden units are split across CTAs:
// CTA (s, d, r) owns units [16 s, 16 s + 16) of direction d -- all NG gate
// columns of those units, so the cell update stays local -- and keeps their
// [I+H, NG*16] weight slice in shared memory for all T steps. Each step it
// stages x_t and h_{t-1} of its batch tile (BB rows) in shared memory with
// cp.async, multiplies on the tensor cores (wmma 16x16x16 bf16, f32
// accumulation), updates its units and publishes h_t to an L2-resident
// ping-pong buffer;
// the H/16 CTAs of one (direction, batch-tile group) then meet at a barrier
// before step t+1. All CTAs must be resident at once for that barrier, so
// the kernel is launched cooperatively (the launch fails instead of hanging
// when the grid does not fit). A group r walks the batch tiles r, r+R, ...
// in turn. The mel stage of step t runs at step t+1, on the h_t that step
// stages anyway: each CTA computes M/S of the mel columns.
// A simple design: wgmma, TMA and clusters are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int U = 16;  // hidden units per CTA: one wmma column block per gate

enum Mode {
  MODE_GRU_X = 0,
  MODE_LSTM_X = 1,
  MODE_GRU_XP = 2,
  MODE_LSTM_MEL = 3,
  MODE_LSTM_TRAIN = 4
};

struct Params {
  const bf16* x;    // [T, 2, B, I], or gx [T, 2, B, 3H] for MODE_GRU_XP
  const bf16* wi;   // [2, I, G] (null for MODE_GRU_XP)
  const bf16* wh;   // [2, H, G]
  const bf16* bx;   // [2, G]: GRU bi, LSTM bi+bh (null for MODE_GRU_XP)
  const bf16* bh;   // [2, G]: GRU bh (null for the LSTM)
  const bf16* wm;   // [2, H, M] (MODE_LSTM_MEL)
  bf16* out;        // [T, 2, B, H], or [T, 2, B, M] for MODE_LSTM_MEL
  bf16* cout;       // [T, 2, B, H] cell states (MODE_LSTM_TRAIN)
  bf16* hbuf;       // [2 (parity), 2 (direction), B, H]
  unsigned int* bar;  // [2, R] barrier counters, zero at launch
  int T, B, I, H, M, BB, R;
};

__host__ __device__ constexpr int n_gates(int mode) {
  return (mode == MODE_LSTM_X || mode == MODE_LSTM_MEL || mode == MODE_LSTM_TRAIN) ? 4 : 3;
}

__host__ __device__ inline size_t align128(size_t n) {
  return (n + 127) & ~(size_t)127;
}

// Shared memory of one CTA, in carve order.
struct Carve {
  size_t w, a, acc_h, acc_x, c, wm, bias, total;
};

__host__ __device__ inline Carve carve(int mode, int I, int H, int M, int S,
                                       int BB) {
  const int ng = n_gates(mode);
  const int nc = ng * U;
  const int ka = (mode == MODE_GRU_XP ? 0 : I) + H;
  const int mpc = mode == MODE_LSTM_MEL ? (M + S - 1) / S : 0;
  Carve c;
  c.w = 0;
  c.a = c.w + align128((size_t)ka * (nc + 8) * sizeof(bf16));
  c.acc_h = c.a + align128((size_t)BB * (ka + 8) * sizeof(bf16));
  c.acc_x = c.acc_h + align128((size_t)BB * nc * sizeof(float));
  c.c = c.acc_x + (mode == MODE_GRU_X ? align128((size_t)BB * nc * sizeof(float)) : 0);
  c.wm = c.c + (ng == 4 ? align128((size_t)BB * U * sizeof(float)) : 0);
  c.bias = c.wm + align128((size_t)H * mpc * sizeof(bf16));
  c.total = c.bias + align128(2 * nc * sizeof(float));
  return c;
}

__device__ __forceinline__ float sigmoidf(float v) { return 1.f / (1.f + expf(-v)); }

// 16-byte global -> shared copy that does not wait for its data; .cg reads
// through L2 only, so h written by other SMs before the barrier is seen
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
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

template <int MODE>
__global__ void __launch_bounds__(THREADS) rnn_kernel(Params p) {
  constexpr int NG = n_gates(MODE);
  constexpr int NC = NG * U;
  constexpr bool HAS_X = MODE != MODE_GRU_XP;
  constexpr bool SPLIT = MODE == MODE_GRU_X;  // x and h products kept apart
  const int s = blockIdx.x, d = blockIdx.y, r = blockIdx.z;
  const int S = gridDim.x;
  const int I = HAS_X ? p.I : 0, H = p.H, G = NG * H, B = p.B, BB = p.BB;
  const int KA = I + H, lda = KA + 8, ldw = NC + 8;
  const int mpc = MODE == MODE_LSTM_MEL ? (p.M + S - 1) / S : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ __align__(128) unsigned char smem[];
  const Carve cv = carve(MODE, p.I, H, p.M, S, BB);
  bf16* Ws = reinterpret_cast<bf16*>(smem + cv.w);        // [KA][ldw]
  bf16* As = reinterpret_cast<bf16*>(smem + cv.a);        // [BB][lda]
  float* acc_h = reinterpret_cast<float*>(smem + cv.acc_h);  // [BB][NC]
  float* acc_x = reinterpret_cast<float*>(smem + cv.acc_x);  // [BB][NC]
  float* cs = reinterpret_cast<float*>(smem + cv.c);      // [BB][U]
  bf16* Wms = reinterpret_cast<bf16*>(smem + cv.wm);      // [H][mpc]
  float* bxs = reinterpret_cast<float*>(smem + cv.bias);  // [NC]
  float* bhs = bxs + NC;                                  // [NC]

  // this CTA's weight slice: column j = g*U + u <- global column g*H + s*U + u
  for (int i = tid; i < KA * NC; i += THREADS) {
    const int k = i / NC, j = i - k * NC;
    const int col = (j / U) * H + s * U + (j % U);
    Ws[k * ldw + j] = k < I ? p.wi[((size_t)d * I + k) * G + col]
                            : p.wh[((size_t)d * H + (k - I)) * G + col];
  }
  for (int j = tid; j < NC; j += THREADS) {
    const int col = (j / U) * H + s * U + (j % U);
    bxs[j] = HAS_X ? __bfloat162float(p.bx[(size_t)d * G + col]) : 0.f;
    bhs[j] = p.bh ? __bfloat162float(p.bh[(size_t)d * G + col]) : 0.f;
  }
  if (MODE == MODE_LSTM_MEL) {
    for (int i = tid; i < H * mpc; i += THREADS) {
      const int k = i / mpc, q = i - k * mpc, m = s + q * S;
      Wms[i] = m < p.M ? p.wm[((size_t)d * H + k) * p.M + m] : __float2bfloat16(0.f);
    }
  }

  unsigned int* bar = p.bar + d * p.R + r;
  unsigned int n_bar = 0;
  const int n_tiles = (B + BB - 1) / BB;
  const size_t hplane = (size_t)B * H;  // one (parity, direction) plane of hbuf

  // stage x_t (k < I) and h_{t-1} (k >= I, zero at t = 0) of the tile's rows:
  // every copy of the thread is issued before it waits, so a step pays one
  // memory round trip, not one per copy; h comes from other SMs through L2
  auto stage = [&](int t, int b0, bool with_x) {
    const int chunks = KA / 8;
    for (int i = tid; i < BB * chunks; i += THREADS) {
      const int row = i / chunks, k = (i - row * chunks) * 8, b = b0 + row;
      const bf16* src = nullptr;
      if (b < B) {
        if (k < I) {
          if (with_x) src = p.x + (((size_t)t * 2 + d) * B + b) * I + k;
        } else if (t > 0) {
          src = p.hbuf + (size_t)(((t - 1) & 1) * 2 + d) * hplane + (size_t)b * H + (k - I);
        }
      }
      bf16* dst = As + row * lda + k;
      if (src)
        cp_async16(dst, src);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    cp_async_wait_all();
  };

  // mel columns of step tt from the staged h (As[:, I:]), one warp per output
  auto mel_stage = [&](int tt, int b0) {
    for (int item = warp; item < BB * mpc; item += NWARPS) {
      const int row = item / mpc, q = item - row * mpc, m = s + q * S, b = b0 + row;
      if (m >= p.M || b >= B) continue;
      float acc = 0.f;
      for (int k = lane; k < H; k += 32)
        acc += __bfloat162float(As[row * lda + I + k]) * __bfloat162float(Wms[k * mpc + q]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0)
        p.out[(((size_t)tt * 2 + d) * B + b) * p.M + m] = __float2bfloat16(acc);
    }
  };

  for (int tile = r; tile < n_tiles; tile += p.R) {
    const int b0 = tile * BB;
    if (NG == 4)
      for (int i = tid; i < BB * U; i += THREADS) cs[i] = 0.f;
    for (int t = 0; t < p.T; ++t) {
      stage(t, b0, true);
      __syncthreads();
      if (MODE == MODE_LSTM_MEL && t > 0) mel_stage(t - 1, b0);

      // gate products on the tensor cores: part 0 = h (or all of K for the
      // LSTM) into acc_h, part 1 = x into acc_x (GRU with input projection)
      const int rb_n = BB / 16;
      const int n_items = rb_n * NG * (SPLIT ? 2 : 1);
      for (int item = warp; item < n_items; item += NWARPS) {
        const int part = item / (rb_n * NG), rem = item - part * rb_n * NG;
        const int rb = rem / NG, cb = rem - rb * NG;
        const int k0 = part == 1 ? 0 : (SPLIT ? I : 0);
        const int k1 = part == 1 ? I : KA;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int k = k0; k < k1; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, As + rb * 16 * lda + k, lda);
          wmma::load_matrix_sync(fb, Ws + k * ldw + cb * 16, ldw);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        float* dst = (part == 1 ? acc_x : acc_h) + rb * 16 * NC + cb * 16;
        wmma::store_matrix_sync(dst, acc, NC, wmma::mem_row_major);
      }
      __syncthreads();

      // cell update of this CTA's units
      bf16* hout = p.hbuf + (size_t)((t & 1) * 2 + d) * hplane;
      for (int i = tid; i < BB * U; i += THREADS) {
        const int row = i / U, u = i - row * U, b = b0 + row, unit = s * U + u;
        const float* ah = acc_h + row * NC;
        float h_new, c_new = 0.f;
        if (NG == 3) {
          float xr, xz, xn;
          if (MODE == MODE_GRU_XP) {
            if (b >= B) continue;
            const bf16* gx = p.x + (((size_t)t * 2 + d) * B + b) * G;
            xr = __bfloat162float(gx[unit]);
            xz = __bfloat162float(gx[H + unit]);
            xn = __bfloat162float(gx[2 * H + unit]);
          } else {
            const float* ax = acc_x + row * NC;
            xr = ax[u] + bxs[u];
            xz = ax[U + u] + bxs[U + u];
            xn = ax[2 * U + u] + bxs[2 * U + u];
          }
          const float hr = ah[u] + bhs[u];
          const float hz = ah[U + u] + bhs[U + u];
          const float hn = ah[2 * U + u] + bhs[2 * U + u];
          const float rg = sigmoidf(xr + hr), zg = sigmoidf(xz + hz);
          const float ng = tanhf(xn + rg * hn);
          const float h_prev = __bfloat162float(As[row * lda + I + unit]);
          h_new = (1.f - zg) * ng + zg * h_prev;
        } else {
          const float gi = sigmoidf(ah[u] + bxs[u]);
          const float gf = sigmoidf(ah[U + u] + bxs[U + u]);
          const float gg = tanhf(ah[2 * U + u] + bxs[2 * U + u]);
          const float go = sigmoidf(ah[3 * U + u] + bxs[3 * U + u]);
          c_new = gf * cs[i] + gi * gg;
          cs[i] = round_bf16(c_new);  // the carried c is stored as bf16
          h_new = go * tanhf(c_new);
        }
        if (b >= B) continue;
        const bf16 hb = __float2bfloat16(h_new);
        hout[(size_t)b * H + unit] = hb;
        if (MODE != MODE_LSTM_MEL)
          p.out[(((size_t)t * 2 + d) * B + b) * H + unit] = hb;
        if (MODE == MODE_LSTM_TRAIN)
          p.cout[(((size_t)t * 2 + d) * B + b) * H + unit] = __float2bfloat16(c_new);
      }
      ++n_bar;
      group_sync(bar, n_bar * S);
    }
    if (MODE == MODE_LSTM_MEL) {  // the last step's mel columns
      stage(p.T, b0, false);
      __syncthreads();
      mel_stage(p.T - 1, b0);
      __syncthreads();
    }
  }
}

template <int MODE>
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
  // the largest batch tile that fits shared memory and the batch
  int bb = 0;
  for (int cand = 64; cand >= 16; cand /= 2) {
    if (cand > 16 * n_tiles_16 && cand > 16) continue;
    if (carve(MODE, p.I, p.H, p.M, S, cand).total <= (size_t)max_smem) {
      bb = cand;
      break;
    }
  }
  if (bb == 0) return (int)cudaErrorInvalidValue;
  p.BB = bb;
  const size_t smem = carve(MODE, p.I, p.H, p.M, S, bb).total;
  err = cudaFuncSetAttribute(rnn_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rnn_kernel<MODE>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (p.B + bb - 1) / bb;
  int groups = per_sm * n_sm / (2 * S);
  if (groups < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  p.R = groups < n_tiles ? groups : n_tiles;
  dim3 grid(S, 2, p.R);
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((void*)rnn_kernel<MODE>, grid, dim3(THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns a cudaError_t (0 on success). `bar` must hold 2 * B
// zeroed counters; hbuf 2 * 2 * B * H bf16 values of scratch.
extern "C" int rnn_gru_x_bf16(const void* x, const void* wi, const void* wh, const void* bi,
                              const void* bh, void* out, void* hbuf, unsigned int* bar, int T,
                              int B, int I, int H, int device, cudaStream_t stream) {
  Params p{(const bf16*)x, (const bf16*)wi, (const bf16*)wh, (const bf16*)bi, (const bf16*)bh,
           nullptr, (bf16*)out, nullptr, (bf16*)hbuf, bar, T, B, I, H, 0, 0, 0};
  return launch<MODE_GRU_X>(p, device, stream);
}

extern "C" int rnn_lstm_x_bf16(const void* x, const void* wi, const void* wh, const void* b,
                               void* out, void* hbuf, unsigned int* bar, int T, int B, int I,
                               int H, int device, cudaStream_t stream) {
  Params p{(const bf16*)x, (const bf16*)wi, (const bf16*)wh, (const bf16*)b, nullptr, nullptr,
           (bf16*)out, nullptr, (bf16*)hbuf, bar, T, B, I, H, 0, 0, 0};
  return launch<MODE_LSTM_X>(p, device, stream);
}

extern "C" int rnn_gru_xp_bf16(const void* xp, const void* wh, const void* bh, void* out,
                               void* hbuf, unsigned int* bar, int T, int B, int H, int device,
                               cudaStream_t stream) {
  Params p{(const bf16*)xp, nullptr, (const bf16*)wh, nullptr, (const bf16*)bh, nullptr,
           (bf16*)out, nullptr, (bf16*)hbuf, bar, T, B, 0, H, 0, 0, 0};
  return launch<MODE_GRU_XP>(p, device, stream);
}

extern "C" int rnn_lstm_mel_bf16(const void* x, const void* wi, const void* wh, const void* b,
                                 const void* wm, void* out, void* hbuf, unsigned int* bar, int T,
                                 int B, int I, int H, int M, int device, cudaStream_t stream) {
  Params p{(const bf16*)x, (const bf16*)wi, (const bf16*)wh, (const bf16*)b, nullptr,
           (const bf16*)wm, (bf16*)out, nullptr, (bf16*)hbuf, bar, T, B, I, H, M, 0, 0};
  return launch<MODE_LSTM_MEL>(p, device, stream);
}

// MODE_LSTM_X that also writes the cell states cout [T, 2, B, H].
extern "C" int rnn_lstm_train_bf16(const void* x, const void* wi, const void* wh, const void* b,
                                   void* out, void* cout, void* hbuf, unsigned int* bar, int T,
                                   int B, int I, int H, int device, cudaStream_t stream) {
  Params p{(const bf16*)x, (const bf16*)wi, (const bf16*)wh, (const bf16*)b, nullptr, nullptr,
           (bf16*)out, (bf16*)cout, (bf16*)hbuf, bar, T, B, I, H, 0, 0, 0};
  return launch<MODE_LSTM_TRAIN>(p, device, stream);
}
