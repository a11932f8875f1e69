// The parity K1/K2 of the main path as two launches each, for Hopper
// (sm_90a), exposed through a plain C ABI and loaded with ctypes by
// helen_tpu_torch/ops/gru_window_smem.py:
//   bigru_window_proj_in1 / _in2: the input projection of both directions
//       over all T * B rows of a window, xp = x W_ih + b_ih, into a
//       (2, T, B, 3H) fp32 scratch; x is the uint8 image read in place
//       (K1) or the previous layer's halves [xa | xb] (K2);
//   bigru_window_rec_smem: the recurrence over that scratch, one block per
//       (ROWS batch rows, direction), with the direction's W_hh held in
//       shared memory for all T steps.
// Together they replace the same Pallas bodies as K1/K2
// (helen_tpu/ops/gru_pallas.py:426 _kernel_inproj1, :474 _kernel_inproj2,
// and helen_tpu/ops/gru_pallas_train.py:259 _fwd_kernel_ip) and compute the
// same function bit for bit as bigru_window_kernel (gru_window.cu), which
// keeps the shapes whose W_hh does not fit a block (H > 136 at 8 rows) and
// the fast tier.
//
// Why they are bit-equal to bigru_window_kernel: every sum is taken in the
// same order. Each projection output is one fmaf chain from 0.0 over
// k = 0, 1, ..., D - 1 in order (K2: over all 2H inputs of [xa | xb] in one
// chain), then + b_ih: what fma_chain and `xr + bias.ir` in gru_step do.
// No split-k, no tensor cores; the zero padding of the last k stage adds
// fmaf(0, 0, acc) = acc. Each h W_hh sum is one fmaf chain over k in order
// from shared memory, and the gates come from the same gru_gates
// (gru_window_common.cuh). Threads split a unit's batch rows, never k.
//
// What bounds them on this card (B=512, T=100, H=128): the projection does
// 7.1 GFLOP (K1, D=90) or 20.1 GFLOP (K2, D=256) of fp32 FMA and writes the
// 157 MB scratch: bound by operations at the 67 TFLOP/s fp32 peak, 0.11 /
// 0.30 ms. The recurrence does 10.1 GFLOP and reads the scratch: bound by
// operations, 0.15 ms, but its T steps run one after another, each a small
// B x 3H x H product spread over 128 blocks; per step and block the W_hh
// reads from shared memory and the FMAs take about the same issue slots.
//
// What the design does about it:
//   * the projection leaves the serial loop: a tiled fp32 product (128 x
//     128 outputs per block of 256 threads, 8 x 8 per thread, k in stages of
//     8 staged in shared memory, double-buffered through registers), grid
//     (row tiles, column tiles, direction);
//   * the recurrence reads no weight from device memory after its start:
//     the block copies its direction's W_hh (196,608 bytes at H=128) into
//     shared memory once with cp.async; h is double-buffered beside it (one
//     __syncthreads() per step), read four k at a time as one float4
//     broadcast; the next step's xp is loaded into registers before the
//     current step's chain;
//   * ROWS (8, 4, 2 or 1 batch rows per block) is the fewest rows whose
//     grid of 2 * ceil(B / ROWS) blocks fits the H100's 132 SMs in one wave
//     (one block per SM: the shared memory), 8 when none does: 8 at B=512
//     (128 blocks), 4 at B=256 (128 blocks); at 2 rows and more two threads
//     share a hidden unit, ROWS / 2 rows each (8 warps at H=128).
//     ops/gru_window_smem.py rec_block_rows states the same rule.
// The scratch costs 2 x 157 MB of device traffic at B=512 (0.09 ms at 3.35
// TB/s), which the design trades for a projection out of the serial chain.

#include "gru_window_common.cuh"

namespace {

constexpr int PJ_BM = 128;          // projection rows (t, b) per block
constexpr int PJ_BN = 128;          // projection columns of 3H per block
constexpr int PJ_BK = 8;            // k per shared-memory stage
constexpr int PJ_THREADS = 256;     // 16 x 16 threads, 8 x 8 outputs each
constexpr int PJ_APAD = PJ_BM + 4;  // row stride of the transposed x stage
constexpr int REC_SPLIT = 2;        // threads per hidden unit at >= 2 rows
constexpr int REC_MAX_THREADS = 320;  // the recurrence's launch bound

// h's row stride in shared memory: H rounded up to 4 floats, for float4 reads
__host__ __device__ inline int rec_hp(int H) { return (H + 3) / 4 * 4; }

// The recurrence block's dynamic shared memory: h double-buffered, then W_hh.
inline size_t rec_smem(int H, int rows) {
  return sizeof(float) * (2 * (size_t)rows * rec_hp(H) + 3 * (size_t)H * H);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// The projection pass
// ---------------------------------------------------------------------------

// Element k of input row `base` (the image offset of (b, start + t), or
// K2's row m = t * B + b times H); 0 past D
template <bool PAIR>
__device__ __forceinline__ float proj_x(const WindowIn& in, long long base, int k, int D,
                                        int H) {
  if (k >= D) return 0.0f;
  if (PAIR) return k < H ? __ldg(in.xa + base + k) : __ldg(in.xb + base + (k - H));
  return (float)__ldg(in.img + base + k);
}

template <bool PAIR>
__global__ void __launch_bounds__(PJ_THREADS, 2)
window_proj_kernel(WindowIn in, int D, const float* __restrict__ w_f,
                   const float* __restrict__ w_b, const float* __restrict__ b_f,
                   const float* __restrict__ b_b, float* __restrict__ xp, int T, int B,
                   int H) {
  const int dir = blockIdx.z;
  const float* __restrict__ w = dir ? w_b : w_f;
  const float* __restrict__ bias = dir ? b_b : b_f;
  const int N = 3 * H, M = T * B;
  const int m0 = blockIdx.x * PJ_BM, n0 = blockIdx.y * PJ_BN;
  const int tid = threadIdx.x;

  __shared__ __align__(16) float As[2][PJ_BK][PJ_APAD];  // x stage, transposed
  __shared__ __align__(16) float Bs[2][PJ_BK][PJ_BN];    // W_ih stage

  // each thread loads x rows ar + 32 i at k = ak, and W_ih rows bk + 2 i at
  // column bn, of every stage
  const int ak = tid % PJ_BK, ar = tid / PJ_BK;
  const int bn = tid % PJ_BN, bk = tid / PJ_BN;
  long long abase[4];
  bool aok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ar + 32 * i;
    aok[i] = m < M;
    const int t = aok[i] ? m / B : 0;
    const int b = aok[i] ? m - t * B : 0;
    abase[i] = PAIR ? (long long)m * H : (long long)b * in.sb + (long long)(in.start + t) * in.sl;
  }
  const bool bok = n0 + bn < N;
  float av[4], bv[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = aok[i] ? proj_x<PAIR>(in, abase[i], k0 + ak, D, H) : 0.0f;
      const int k = k0 + bk + 2 * i;
      bv[i] = (bok && k < D) ? __ldg(w + (size_t)k * N + n0 + bn) : 0.0f;
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[s][ak][ar + 32 * i] = av[i];
      Bs[s][bk + 2 * i][bn] = bv[i];
    }
  };

  // thread (tx, ty) owns rows ty*4 + {0..3}, 64 + ty*4 + {0..3} and columns
  // tx*4 + {0..3}, 64 + tx*4 + {0..3} of the block's tile
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int stages = (D + PJ_BK - 1) / PJ_BK;
  load(0);
  store(0);
  __syncthreads();
  for (int ks = 0; ks < stages; ++ks) {
    const int s = ks & 1;
    if (ks + 1 < stages) load((ks + 1) * PJ_BK);
#pragma unroll
    for (int kk = 0; kk < PJ_BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[s][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[s][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float v[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
      }
    }
    if (ks + 1 < stages) store(s ^ 1);
    __syncthreads();
  }

  // xp = acc + b_ih, one rounding, as gru_step's `xr + bias.ir`
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (m >= M) continue;
    float* row = xp + ((size_t)dir * M + m) * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + half * 64 + tx * 4;
      const int c = half * 4;
      if ((N & 3) == 0) {
        if (n < N) {
          *reinterpret_cast<float4*>(row + n) = make_float4(
              acc[i][c] + __ldg(bias + n), acc[i][c + 1] + __ldg(bias + n + 1),
              acc[i][c + 2] + __ldg(bias + n + 2), acc[i][c + 3] + __ldg(bias + n + 3));
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (n + q < N) row[n + q] = acc[i][c + q] + __ldg(bias + n + q);
        }
      }
    }
  }
}

template <bool PAIR>
int launch_proj(const WindowIn& in, int D, const float* w_f, const float* b_f,
                const float* w_b, const float* b_b, float* xp, int T, int B, int H,
                void* stream) {
  if (H < 1 || D < 1 || T < 1 || B < 1 || (long long)T * B > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid((T * B + PJ_BM - 1) / PJ_BM, (3 * H + PJ_BN - 1) / PJ_BN, 2);
  window_proj_kernel<PAIR><<<grid, PJ_THREADS, 0, (cudaStream_t)stream>>>(
      in, D, w_f, w_b, b_f, b_b, xp, T, B, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The recurrence with W_hh in shared memory
// ---------------------------------------------------------------------------

template <int ROWS>
__global__ void __launch_bounds__(REC_MAX_THREADS)
window_rec_kernel(const float* __restrict__ xp, const float* __restrict__ h0_f,
                  const float* __restrict__ h0_b, const float* __restrict__ wh_f,
                  const float* __restrict__ wh_b, const float* __restrict__ bh_f,
                  const float* __restrict__ bh_b, float* __restrict__ out_f,
                  float* __restrict__ out_b, float* __restrict__ hn_f,
                  float* __restrict__ hn_b, int T, int B, int H) {
  constexpr int SPLIT = ROWS >= 2 ? REC_SPLIT : 1;
  constexpr int RPT = ROWS / SPLIT;  // batch rows per thread
  const int dir = blockIdx.y;
  const float* __restrict__ w = dir ? wh_b : wh_f;
  const float* __restrict__ bh = dir ? bh_b : bh_f;
  const float* __restrict__ h0 = dir ? h0_b : h0_f;
  float* __restrict__ out = dir ? out_b : out_f;
  float* __restrict__ hn = dir ? hn_b : hn_f;
  const int H3 = 3 * H, HP = rec_hp(H);
  const int tid = threadIdx.x, nthreads = blockDim.x;  // blockDim.x == SPLIT * H
  const int j = tid % H;                // hidden unit
  const int g = tid / H;                // row group: rows g * RPT .. + RPT - 1
  const int b0 = blockIdx.x * ROWS + g * RPT;

  extern __shared__ __align__(16) float smem[];
  float* hbuf = smem;                // [2][ROWS][HP] the state
  float* ws = smem + 2 * ROWS * HP;  // [H][3H] W_hh, 16-byte aligned

  // W_hh into shared memory, once for all T steps
  const int nw = H * H3;
  if ((reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    const int n4 = nw / 4;
    for (int i = tid; i < n4; i += nthreads) cp_async16(ws + 4 * i, w + 4 * i);
    for (int i = 4 * n4 + tid; i < nw; i += nthreads) cp_async4(ws + i, w + i);
  } else {
    for (int i = tid; i < nw; i += nthreads) cp_async4(ws + i, w + i);
  }

  const CellBias bias{0.0f, 0.0f, 0.0f, bh[j], bh[H + j], bh[2 * H + j]};
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + i;
    hbuf[(g * RPT + i) * HP + j] = (b < B) ? h0[(size_t)b * H + j] : 0.0f;
  }
  // xp of one step for the thread's rows: xp + b_ih as gru_step forms it
  const float* __restrict__ xpd = xp + (size_t)dir * T * B * H3;
  float nr[RPT], nz[RPT], nn[RPT];
  auto load_xp = [&](int t) {
    const int tt = dir ? T - 1 - t : t;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int b = b0 + i;
      nr[i] = nz[i] = nn[i] = 0.0f;
      if (b < B) {
        const float* p = xpd + ((size_t)tt * B + b) * H3 + j;
        nr[i] = __ldg(p);
        nz[i] = __ldg(p + H);
        nn[i] = __ldg(p + 2 * H);
      }
    }
  };
  load_xp(0);
  cp_async_wait_all();
  __syncthreads();

  float hlast[RPT];
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const int tt = dir ? T - 1 - t : t;
    float xr[RPT], xz[RPT], xn[RPT], hr[RPT], hz[RPT], hq[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      xr[i] = nr[i];
      xz[i] = nz[i];
      xn[i] = nn[i];
      hr[i] = hz[i] = hq[i] = 0.0f;
    }
    if (t + 1 < T) load_xp(t + 1);
    // h W_hh: one fmaf chain per (row, gate) over k in order, as fma_chain
    const float* hc = hbuf + (cur * ROWS + g * RPT) * HP;
    int k = 0;
#pragma unroll 2
    for (; k + 4 <= H; k += 4) {
      float4 hv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) hv[i] = *reinterpret_cast<const float4*>(hc + i * HP + k);
      const float* wk = ws + k * H3 + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float wr = wk[q * H3], wz = wk[q * H3 + H], wn = wk[q * H3 + 2 * H];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float hk = lane(hv[i], q);
          hr[i] = fmaf(hk, wr, hr[i]);
          hz[i] = fmaf(hk, wz, hz[i]);
          hq[i] = fmaf(hk, wn, hq[i]);
        }
      }
    }
    for (; k < H; ++k) {
      const float* wk = ws + k * H3 + j;
      const float wr = wk[0], wz = wk[H], wn = wk[2 * H];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float hk = hc[i * HP + k];
        hr[i] = fmaf(hk, wr, hr[i]);
        hz[i] = fmaf(hk, wz, hz[i]);
        hq[i] = fmaf(hk, wn, hq[i]);
      }
    }
    float* hx = hbuf + ((cur ^ 1) * ROWS + g * RPT) * HP;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float h = gru_gates<false>(xr[i], xz[i], xn[i], hr[i], hz[i], hq[i], bias,
                                       hc[i * HP + j]);
      hx[i * HP + j] = h;
      hlast[i] = h;
      const int b = b0 + i;
      if (b < B) out[((size_t)tt * B + b) * H + j] = h;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + i;
    if (b < B) hn[(size_t)b * H + j] = hlast[i];
  }
}

template <int ROWS>
int launch_rec(const float* xp, const float* h0_f, const float* h0_b, const float* wh_f,
               const float* bh_f, const float* wh_b, const float* bh_b, float* out_f,
               float* out_b, float* hn_f, float* hn_b, int T, int B, int H, void* stream) {
  const int threads = (ROWS >= 2 ? REC_SPLIT : 1) * H;
  if (threads > REC_MAX_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = rec_smem(H, ROWS);
  if (int e = allow_smem(window_rec_kernel<ROWS>, smem)) return e;
  dim3 grid((B + ROWS - 1) / ROWS, 2);
  window_rec_kernel<ROWS><<<grid, threads, smem, (cudaStream_t)stream>>>(
      xp, h0_f, h0_b, wh_f, wh_b, bh_f, bh_b, out_f, out_b, hn_f, hn_b, T, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the recurrence block's dynamic shared memory at hidden size H and `rows`
// batch rows (ops/gru_window_smem.py rec_smem_bytes mirrors it)
long long bigru_window_rec_smem_bytes(int H, int rows) { return (long long)rec_smem(H, rows); }

int bigru_window_rec_max_threads() { return REC_MAX_THREADS; }

// K1's projection: image (B, L, D) uint8 with element strides (sb, sl),
// window columns [start, start + T); xp (2, T, B, 3H) fp32.
int bigru_window_proj_in1(const uint8_t* img, long long sb, long long sl, int start, int D,
                          const float* wi_f, const float* bi_f, const float* wi_b,
                          const float* bi_b, float* xp, int T, int B, int H, void* stream) {
  WindowIn in{img, sb, sl, start, nullptr, nullptr};
  return launch_proj<false>(in, D, wi_f, bi_f, wi_b, bi_b, xp, T, B, H, stream);
}

// K2's projection: xa, xb (T, B, H) fp32, W_ih (2H, 3H): rows [0, H) take
// xa, [H, 2H) xb; xp (2, T, B, 3H) fp32.
int bigru_window_proj_in2(const float* xa, const float* xb, const float* wi_f,
                          const float* bi_f, const float* wi_b, const float* bi_b, float* xp,
                          int T, int B, int H, void* stream) {
  WindowIn in{nullptr, 0, 0, 0, xa, xb};
  return launch_proj<true>(in, 2 * H, wi_f, bi_f, wi_b, bi_b, xp, T, B, H, stream);
}

// The recurrence over xp (2, T, B, 3H) from h0_f/h0_b (B, H), W_hh (H, 3H),
// b_hh (3H,) per direction, `rows` (1, 2, 4 or 8) batch rows per block;
// outputs out_f/out_b (T, B, H), hn_f/hn_b (B, H), f32.
int bigru_window_rec_smem(const float* xp, const float* h0_f, const float* h0_b,
                          const float* wh_f, const float* bh_f, const float* wh_b,
                          const float* bh_b, float* out_f, float* out_b, float* hn_f,
                          float* hn_b, int T, int B, int H, int rows, void* stream) {
  if (H < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1:
      return launch_rec<1>(xp, h0_f, h0_b, wh_f, bh_f, wh_b, bh_b, out_f, out_b, hn_f, hn_b,
                           T, B, H, stream);
    case 2:
      return launch_rec<2>(xp, h0_f, h0_b, wh_f, bh_f, wh_b, bh_b, out_f, out_b, hn_f, hn_b,
                           T, B, H, stream);
    case 4:
      return launch_rec<4>(xp, h0_f, h0_b, wh_f, bh_f, wh_b, bh_b, out_f, out_b, hn_f, hn_b,
                           T, B, H, stream);
    case 8:
      return launch_rec<8>(xp, h0_f, h0_b, wh_f, bh_f, wh_b, bh_b, out_f, out_b, hn_f, hn_b,
                           T, B, H, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
