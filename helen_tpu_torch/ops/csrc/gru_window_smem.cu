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

#include "gru_window_smem.cuh"

namespace {

// The recurrence block's dynamic shared memory: h double-buffered, then W_hh.
inline size_t rec_smem(int H, int rows) {
  return sizeof(float) * (2 * (size_t)rows * round4(H) + 3 * (size_t)H * H);
}

// ---------------------------------------------------------------------------
// The projection pass: the tile product (gru_window_smem.cuh) of the window's
// input rows and W_ih, + b_ih
// ---------------------------------------------------------------------------

int check_proj(int D, int T, int B, int H) {
  if (H < 1 || D < 1 || T < 1 || B < 1 || (long long)T * B > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
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
  const int H3 = 3 * H, HP = round4(H);
  const int tid = threadIdx.x, nthreads = blockDim.x;  // blockDim.x == SPLIT * H
  const int j = tid % H;                // hidden unit
  const int g = tid / H;                // row group: rows g * RPT .. + RPT - 1
  const int b0 = blockIdx.x * ROWS + g * RPT;

  extern __shared__ __align__(16) float smem[];
  float* hbuf = smem;                // [2][ROWS][HP] the state
  float* ws = smem + 2 * ROWS * HP;  // [H][3H] W_hh, 16-byte aligned

  // W_hh into shared memory, once for all T steps
  stage_async(ws, w, H * H3, tid, nthreads);

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
  if (int e = check_proj(D, T, B, H)) return e;
  const ImageRows src{WindowIn{img, sb, sl, start, nullptr, nullptr}, D, B};
  return launch_tile_product<true>(src, T * B, D, 3 * H, wi_f, wi_b, bi_f, bi_b, xp,
                                   stream);
}

// K2's projection: xa, xb (T, B, H) fp32, W_ih (2H, 3H): rows [0, H) take
// xa, [H, 2H) xb; xp (2, T, B, 3H) fp32.
int bigru_window_proj_in2(const float* xa, const float* xb, const float* wi_f,
                          const float* bi_f, const float* wi_b, const float* bi_b, float* xp,
                          int T, int B, int H, void* stream) {
  if (int e = check_proj(2 * H, T, B, H)) return e;
  const PairRows src{xa, xb, H};
  return launch_tile_product<true>(src, T * B, 2 * H, 3 * H, wi_f, wi_b, bi_f, bi_b, xp,
                                   stream);
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
