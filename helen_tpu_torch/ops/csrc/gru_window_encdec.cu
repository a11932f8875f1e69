// The fused encoder+decoder window kernel for Hopper (sm_90a), exposed
// through a plain C ABI and loaded with ctypes by
// helen_tpu_torch/ops/gru_window_encdec.py.
//
// Replaces the Pallas TPU kernel _kernel_fused_encdec
// (helen_tpu/ops/gru_pallas.py:756, called at :961 by fused_transducer_window):
//   transducer_window_encdec (K5) <- fast=False, transducer_window_encdec_fast
//   (K5f) <- fast=True. One transducer window of a model with one encoder
//   and one decoder bi-GRU layer in one launch: the encoder layer reads the
//   window straight from the (B, L, F) uint8 image at column `start` (K1's
//   function), the decoder layer reads the encoder's two output halves (K2's
//   function) from shared memory, where the encoder left them; they never go
//   to device memory. The decoder's h0 is the encoder's final state, and its
//   outputs and final states are the kernel's.
//
// What bounds it on this card. At B=512, T=100, H=128, F=90 one launch does
// 47.3 GFLOP of fp32 FMA (K1's 17.1 plus K2's 30.2) and must move about 60 MB
// (the image window, the weights, h0, the decoder's outputs), so it is bound
// by operations: 0.71 ms at the 67 TFLOP/s fp32 peak (the fast tier 0.048 ms
// at the 989 TFLOP/s bf16 rate). It saves the 105 MB that K1 writes and K2
// reads back between them (the stack boundary); K1/K2 do not wait on memory,
// so what that buys is the question the kernel answers.
//
// The design (simple and exact first):
//   * one block per BT batch rows holds BOTH directions: 2H threads, thread
//     j < H is unit j of the forward direction, j >= H unit j - H of the
//     backward one. The decoder of each direction reads both encoder
//     directions' outputs at mirrored times (forward at step s reads time s,
//     backward time T-1-s; gru_pallas.py:835-846), so both encoder directions
//     must finish before either decoder direction begins: one __syncthreads()
//     per step orders that inside a block. K1's layout (a block per
//     direction, grid y) does not carry over: blocks run in no order.
//   * the boundary eo[2][T][BT][H] sits in dynamic shared memory, each
//     direction's outputs at their original time positions (:821-824); the
//     decoder's x W_ih chain reads it in place. h is double-buffered per
//     direction as in K1; the encoder's input rows as well.
//   * the per-step cell is gru_step (gru_window_common.cuh), the one K1/K2
//     run, so K5 does their FMAs in their order and equals K1 -> K2 bit for
//     bit (K5f equals K1f -> K2f in their one-launch design, design "chain";
//     their two-launch design sums on the tensor cores, within 1e-3).
//   * BT is chosen per launch by the caller (encdec_block_rows in the Python
//     module): the most rows of 4, 2, 1 whose block fits the card's opt-in
//     shared memory (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232,448 bytes
//     on the H100) and its thread limit: 2H <= 1024 threads at BT <= 2, which
//     keeps 64 registers per thread, 2H <= 512 at BT = 4 (128 registers for
//     its 24 accumulators). At T=100, H=128 that is BT=2 (211,776 bytes:
//     2 x 100 KiB of boundary per row) and 256 blocks at B=512, one per SM,
//     in two waves; each weight load serves BT rows where K1's serves 8.
//   * the fast tier stores the boundary already rounded to bf16, where K2f
//     rounds its input halves (gru_window.cu's load_rows): the rounding is
//     deterministic, so this is exact and halves the boundary; BT=4 fits at
//     T=100, H=128 (226,944 bytes, 128 blocks).
// This is K5's "onepass" design. Where the chain's own recurrence takes the
// shape (H <= 128 in both tiers: the flagship), K5 runs as a cluster of two
// CTAs per group of batch rows instead (encdec_cluster_kernel in
// gru_window_smem.cu, encdec_cluster_fast_kernel in gru_window_fast.cu;
// ops/gru_window_encdec.py encdec_design); this kernel keeps the other
// shapes that fit one block (the golden h160 fixture among them).

#include <type_traits>

#include "gru_window_common.cuh"

namespace {

constexpr int ENCDEC_MAX_ROWS = 4;

// the most threads (2H) a block of `rows` batch rows takes
inline int encdec_max_threads(int rows) { return rows >= 4 ? MAX_H : 2 * MAX_H; }


// dynamic shared memory of one block: h [2 dirs][2 bufs][rows][H] (and its
// bf16 operand copy in the fast tier), the encoder's input rows [2][2][rows][D],
// the boundary [2][T][rows][H] (fp32, or bf16 in the fast tier)
inline size_t encdec_smem(int H, int rows, int D, int T, bool fast) {
  return sizeof(float) * 4 * (size_t)rows * ((size_t)H * (fast ? 2 : 1) + D) +
         (size_t)2 * T * rows * H * (fast ? sizeof(__nv_bfloat16) : sizeof(float));
}

// a boundary element: fp32 as it is, or rounded to bf16 (nearest even)
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int ROWS, bool FAST>
__global__ void __launch_bounds__(ROWS >= 4 ? MAX_H : 2 * MAX_H)
transducer_window_encdec_kernel(
    WindowIn in, int D, const float* __restrict__ h0_f, const float* __restrict__ h0_b,
    DirParams<typename std::conditional<FAST, __nv_bfloat16, float>::type> ef,
    DirParams<typename std::conditional<FAST, __nv_bfloat16, float>::type> eb,
    DirParams<typename std::conditional<FAST, __nv_bfloat16, float>::type> df,
    DirParams<typename std::conditional<FAST, __nv_bfloat16, float>::type> db,
    float* __restrict__ out_f, float* __restrict__ out_b, float* __restrict__ hn_f,
    float* __restrict__ hn_b, int T, int B, int H) {
  // the boundary's element: fp32, or the fast tier's bf16-rounded copy
  using E = typename std::conditional<FAST, __nv_bfloat16, float>::type;
  // k steps per unrolled iteration of the FMA chains: K1/K2's CHAIN_UNROLL in
  // the fast tier; 2 in the parity tier, where 4 takes K5 from 12.8 to 16.5
  // ms on the H100 at 2 rows per block (PERF.md, PR 5). The sums' order, and
  // so every bit of the result, is the same at any unroll.
  constexpr int UNROLL = FAST ? CHAIN_UNROLL : 2;
  const int dir = threadIdx.x >= H;  // blockDim.x == 2H
  const int j = threadIdx.x - dir * H;
  const int b0 = blockIdx.x * ROWS;

  extern __shared__ float smem[];
  const int hsz = 2 * ROWS * H;  // one direction's [2][ROWS][H]
  float* hbuf = smem + dir * hsz;
  // the operand copy of h: bf16-rounded (fast), or the state itself
  float* hop = FAST ? smem + 2 * hsz + dir * hsz : hbuf;
  float* xbuf = smem + (FAST ? 4 : 2) * hsz + dir * 2 * ROWS * D;  // [2][ROWS][D]
  E* eo = reinterpret_cast<E*>(smem + (FAST ? 4 : 2) * hsz + 4 * ROWS * D);
  const size_t plane = (size_t)ROWS * H;  // one time step of one direction

  // ---- the encoder layer: K1's function, outputs to the boundary ----
  const float* __restrict__ h0 = dir ? h0_b : h0_f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = b0 + r;
    const float h = (b < B) ? h0[(size_t)b * H + j] : 0.0f;
    hbuf[r * H + j] = h;
    if (FAST) hop[r * H + j] = bf16_rn(h);
  }
  load_rows<false, FAST, ROWS>(in, dir ? T - 1 : 0, b0, B, D, H, xbuf, j, H);
  __syncthreads();

  const auto pe = dir ? eb : ef;
  CellBias bias = load_bias(pe, H, j);
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const float* xc = xbuf + cur * ROWS * D;
    const int tt = dir ? T - 1 - t : t;
    float hnew[ROWS];
    gru_step<ROWS, FAST, UNROLL>(pe, bias, H, j, xc, D, xc, 0, D, hbuf + cur * ROWS * H,
                                 hop + cur * ROWS * H, hbuf + (cur ^ 1) * ROWS * H,
                                 hop + (cur ^ 1) * ROWS * H, hnew);
    // at the original time position (the backward direction computes
    // time T-1-t at step t)
    E* e = eo + ((size_t)dir * T + tt) * plane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) put(e + r * H + j, hnew[r]);
    if (t + 1 < T) {
      load_rows<false, FAST, ROWS>(in, dir ? T - 2 - t : t + 1, b0, B, D, H,
                                   xbuf + (cur ^ 1) * ROWS * D, j, H);
    }
    __syncthreads();  // the last one also orders every boundary write before the decoder
  }

  // ---- the decoder layer: K2's function on the boundary; its h0 is the
  // encoder's final state, already in this direction's buffer T & 1 ----
  const auto pd = dir ? db : df;
  bias = load_bias(pd, H, j);
  float* __restrict__ out = dir ? out_b : out_f;
  for (int s = 0; s < T; ++s) {
    const int cur = (T + s) & 1;
    const int tt = dir ? T - 1 - s : s;
    // the row [encoder forward | encoder backward] at time tt: W_ih rows
    // [0, H) take the first, [H, 2H) the second, as K2's [xa | xb]
    float hnew[ROWS];
    gru_step<ROWS, FAST, UNROLL>(pd, bias, H, j, eo + (size_t)tt * plane, H,
                                 eo + ((size_t)T + tt) * plane, H, H, hbuf + cur * ROWS * H,
                                 hop + cur * ROWS * H, hbuf + (cur ^ 1) * ROWS * H,
                                 hop + (cur ^ 1) * ROWS * H, hnew);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int b = b0 + r;
      if (b < B) out[((size_t)tt * B + b) * H + j] = hnew[r];
    }
    __syncthreads();
  }
  // the decoder's final state: buffer (2T) & 1 = 0 after its last step
  float* __restrict__ hn = dir ? hn_b : hn_f;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int b = b0 + r;
    if (b < B) hn[(size_t)b * H + j] = hbuf[r * H + j];
  }
}

template <int ROWS, bool FAST, typename W>
int launch_rows(const WindowIn& in, int D, const float* h0_f, const float* h0_b,
                DirParams<W> ef, DirParams<W> eb, DirParams<W> df, DirParams<W> db,
                float* out_f, float* out_b, float* hn_f, float* hn_b, int T, int B, int H,
                size_t smem, void* stream) {
  if (int e = allow_smem(transducer_window_encdec_kernel<ROWS, FAST>, smem)) return e;
  const dim3 grid((B + ROWS - 1) / ROWS);
  transducer_window_encdec_kernel<ROWS, FAST><<<grid, 2 * H, smem, (cudaStream_t)stream>>>(
      in, D, h0_f, h0_b, ef, eb, df, db, out_f, out_b, hn_f, hn_b, T, B, H);
  return (int)cudaGetLastError();
}

template <bool FAST, typename W>
int launch(const WindowIn& in, int D, const float* h0_f, const float* h0_b,
           DirParams<W> ef, DirParams<W> eb, DirParams<W> df, DirParams<W> db,
           float* out_f, float* out_b, float* hn_f, float* hn_b, int T, int B, int H,
           int rows, void* stream) {
  if (H < 1 || D < 1 || T < 1 || B < 1 || rows < 1 || rows > ENCDEC_MAX_ROWS ||
      2 * H > encdec_max_threads(rows)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = encdec_smem(H, rows, D, T, FAST);
  switch (rows) {
    case 1:
      return launch_rows<1, FAST>(in, D, h0_f, h0_b, ef, eb, df, db, out_f, out_b, hn_f,
                                  hn_b, T, B, H, smem, stream);
    case 2:
      return launch_rows<2, FAST>(in, D, h0_f, h0_b, ef, eb, df, db, out_f, out_b, hn_f,
                                  hn_b, T, B, H, smem, stream);
    case 4:
      return launch_rows<4, FAST>(in, D, h0_f, h0_b, ef, eb, df, db, out_f, out_b, hn_f,
                                  hn_b, T, B, H, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// the current device's opt-in shared memory per block, in bytes
int gru_window_smem_optin() {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return max_smem;
}

long long transducer_window_encdec_smem(int H, int rows, int D, int T, int fast) {
  return (long long)encdec_smem(H, rows, D, T, fast != 0);
}

int transducer_window_encdec_max_threads(int rows) { return encdec_max_threads(rows); }

// K5: image (B, L, D) uint8 with element strides (sb, sl), window columns
// [start, start + T); the encoder's W_ih (D, 3H) and the decoder's (2H, 3H),
// each layer's W_hh (H, 3H), b_ih, b_hh (3H,), all fp32, per direction;
// `rows` batch rows per block (1, 2 or 4). Outputs: the decoder's out_f /
// out_b (T, B, H) and hn_f / hn_b (B, H), fp32.
int transducer_window_encdec(const uint8_t* img, long long sb, long long sl, int start,
                             int D, const float* h0_f, const float* h0_b,
                             const float* ewi_f, const float* ewh_f, const float* ebi_f,
                             const float* ebh_f, const float* ewi_b, const float* ewh_b,
                             const float* ebi_b, const float* ebh_b, const float* dwi_f,
                             const float* dwh_f, const float* dbi_f, const float* dbh_f,
                             const float* dwi_b, const float* dwh_b, const float* dbi_b,
                             const float* dbh_b, float* out_f, float* out_b, float* hn_f,
                             float* hn_b, int T, int B, int H, int rows, void* stream) {
  WindowIn in{img, sb, sl, start, nullptr, nullptr};
  return launch<false>(in, D, h0_f, h0_b, DirParams<float>{ewi_f, ewh_f, ebi_f, ebh_f},
                       DirParams<float>{ewi_b, ewh_b, ebi_b, ebh_b},
                       DirParams<float>{dwi_f, dwh_f, dbi_f, dbh_f},
                       DirParams<float>{dwi_b, dwh_b, dbi_b, dbh_b}, out_f, out_b, hn_f,
                       hn_b, T, B, H, rows, stream);
}

// K5f: K5's arguments with bf16 W_ih, W_hh (biases fp32); outputs fp32.
int transducer_window_encdec_fast(
    const uint8_t* img, long long sb, long long sl, int start, int D, const float* h0_f,
    const float* h0_b, const __nv_bfloat16* ewi_f, const __nv_bfloat16* ewh_f,
    const float* ebi_f, const float* ebh_f, const __nv_bfloat16* ewi_b,
    const __nv_bfloat16* ewh_b, const float* ebi_b, const float* ebh_b,
    const __nv_bfloat16* dwi_f, const __nv_bfloat16* dwh_f, const float* dbi_f,
    const float* dbh_f, const __nv_bfloat16* dwi_b, const __nv_bfloat16* dwh_b,
    const float* dbi_b, const float* dbh_b, float* out_f, float* out_b, float* hn_f,
    float* hn_b, int T, int B, int H, int rows, void* stream) {
  WindowIn in{img, sb, sl, start, nullptr, nullptr};
  using BF = __nv_bfloat16;
  return launch<true>(in, D, h0_f, h0_b, DirParams<BF>{ewi_f, ewh_f, ebi_f, ebh_f},
                      DirParams<BF>{ewi_b, ewh_b, ebi_b, ebh_b},
                      DirParams<BF>{dwi_f, dwh_f, dbi_f, dbh_f},
                      DirParams<BF>{dwi_b, dwh_b, dbi_b, dbh_b}, out_f, out_b, hn_f, hn_b,
                      T, B, H, rows, stream);
}

}  // extern "C"
