// Bi-GRU window over a pre-projected input stream (K3) for Hopper (sm_90a),
// exposed through a plain C ABI and loaded with ctypes by
// helen_tpu_torch/ops/gru_window_xp.py.
//
// Replaces two Pallas TPU kernels that compute the same function, the
// recurrence of one bi-GRU layer over one window whose input projection
// xp = x W_ih + b_ih was computed outside as one large matrix product:
//   _kernel     (helen_tpu/ops/gru_pallas.py:231, pallas_call :398): the
//               inference form, bf16x3 products on the TPU;
//   _fwd_kernel (helen_tpu/ops/gru_pallas_train.py:119, pallas_call :457):
//               the training forward, DEFAULT precision on the TPU.
// Here both are true fp32 FMAs, so one kernel serves both. Per direction it
// runs the GRU cell of gru_window_common.cuh with xp read from the stream
// (b_hh stays inside the reset product); the final state is the h after the
// last step (for the backward direction: after time 0).
//
// This is the route of the wide models (H > MAX_H = 512, at every width whose
// state fits one block's shared memory at one row): past 512 hidden units a block no longer holds one thread per unit,
// and W_ih and W_hh of both directions (75 MB at H=1024, D=2048) no longer
// fit the 50 MB L2, while W_hh alone (25 MB) does. The projection goes to
// one GEMM (torch.matmul, outside any kernel, as helen_tpu leaves it to
// XLA) and only the recurrence stays here.
//
// What bounds it on this card. One launch at B=512, T=100, H=1024 does
// 2 * T * B * H * 3H * 2 = 644 GFLOP of fp32 FMA and must move 1.68 GB
// (xp in, out): 9.6 ms at the 67 TFLOP/s fp32 peak against 0.5 ms at
// 3.35 TB/s, so it is bound by operations. The recurrence serialises the T
// steps, and as written every block re-reads its direction's W_hh (12.6 MB)
// from L2 at every step, reusing each weight R times: L2 traffic, not the
// FMAs, sets its time (PERF.md has the measurement).
//
// This is the "chain" design. Where W_hh spread over the card's SMs fits
// their shared memory (every width of the xp route on the H100), the grid
// design of gru_window_xp_grid.cu runs instead (ops/gru_window_xp.py
// xp_fwd_design): the same sums in the same order and the same gate lines
// (gru_gates), so K3's two designs give the same bits.
//
// The design, simple and exact first:
//   * grid (ceil(B / R), 2): one block per R batch rows and direction, the
//     T loop inside the block; the ragged batch edge is masked. R, the rows
//     per block, is 8, 4, 2 or 1: the largest whose state fits the card's
//     opt-in shared memory (ops/gru_window_xp.py chain_rows; 8 up to
//     H=3,632 in parity, 1,816 in the fast tier, on the H100). Each row's
//     sums run in the same order at every R, so R does not change a bit.
//   * XP_THREADS threads per block, each looping over its hidden units j,
//     j + blockDim.x, ... (two at H=1024): 3 x R gate sums in registers per
//     unit, each weight read once per block, step and unit and reused R
//     times; weights stay in device memory and are read through L2/L1.
//   * h (R x H) double-buffered in shared memory (64 KB at H=1024, R=8):
//     step t reads buffer t&1 and writes (t+1)&1, one __syncthreads() per
//     step.
//   * true fp32 FMAs on the CUDA cores, no fast-math. Tensor cores (3xTF32
//     wgmma), weights split across a cluster's shared memory and more blocks
//     per direction are later work.
//
// The fast tier (FAST = true; bigru_window_xp_fast, K3f) replaces _kernel
// run with fast=True, as bigru_apply_fused (gru_pallas.py:1080-1091) feeds
// it: xp = bf16(x W_ih + b_ih) streamed as bf16, W_hh in bf16, one bf16
// pass for h W_hh with fp32 accumulation and fp32 gates (_gru_gates with
// w_lo None, :190-192). Here: xp and W_hh read as bf16 and widened in
// registers (exact), the operand copy of h rounded to bf16 in a second
// shared buffer (64 KB at H=1024 beside the fp32 state's 64 KB), fp32 FMAs,
// fp32 gates, z * h on the fp32 state, fp32 outputs. Its projection is a
// float32 GEMM outside (ops/gru_window_xp.py window_xp_fast). Bound on this
// card at B=512, T=100, H=1024, counted at the bf16 tensor-core rate
// (989 TFLOP/s): 644 GFLOP against about 1.06 GB (bf16 xp in, fp32 out),
// 0.65 ms, by operations. As written it runs on the CUDA cores' fp32 rate
// and the L2 re-reads of W_hh (half K3's bytes); bf16 wgmma tiles are later
// work.

#include <type_traits>

#include "gru_window_common.cuh"

namespace {

// one direction's streams and weights: fp32 xp and W_hh for the parity
// tier, bf16 for the fast one (X)
template <typename X>
struct DirXp {
  const X* xp;        // (T, B, 3H): x W_ih + b_ih
  const float* h0;    // (B, H)
  const X* w_hh;      // (H, 3H)
  const float* b_hh;  // (3H,)
  float* out;         // (T, B, H)
  float* hn;          // (B, H)
};

template <bool FAST, int R>
__global__ void __launch_bounds__(XP_THREADS)
xp_window_kernel(DirXp<typename std::conditional<FAST, __nv_bfloat16, float>::type> pf,
                 DirXp<typename std::conditional<FAST, __nv_bfloat16, float>::type> pb,
                 int T, int B, int H) {
  const int dir = blockIdx.y;
  const auto p = dir ? pb : pf;
  const int b0 = blockIdx.x * R;
  const int H3 = 3 * H;

  extern __shared__ float hbuf[];  // [2][R][H] the fp32 state
  // [2][R][H] the operand copy of h: bf16-rounded (fast), or the state
  float* hop = FAST ? hbuf + 2 * R * H : hbuf;
  for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
    const int r = idx / H, b = b0 + r;
    const float h = (b < B) ? p.h0[(size_t)b * H + (idx - r * H)] : 0.0f;
    hbuf[idx] = h;
    if (FAST) hop[idx] = bf16_rn(h);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hc = hbuf + (t & 1) * R * H;
    const float* ho = hop + (t & 1) * R * H;
    float* hx = hbuf + ((t & 1) ^ 1) * R * H;
    float* hox = hop + ((t & 1) ^ 1) * R * H;
    const int tt = dir ? T - 1 - t : t;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float hr[R], hz[R], hq[R];
#pragma unroll
      for (int r = 0; r < R; ++r) hr[r] = hz[r] = hq[r] = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const auto* w = p.w_hh + (size_t)k * H3;
        const float wr = ldg_f(w + j), wz = ldg_f(w + H + j), wn = ldg_f(w + 2 * H + j);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hv = ho[r * H + k];
          hr[r] = fmaf(hv, wr, hr[r]);
          hz[r] = fmaf(hv, wz, hz[r]);
          hq[r] = fmaf(hv, wn, hq[r]);
        }
      }
      const CellBias bias{0.0f, 0.0f, 0.0f, p.b_hh[j], p.b_hh[H + j], p.b_hh[2 * H + j]};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        float xr = 0.0f, xz = 0.0f, xn = 0.0f;
        if (b < B) {
          const auto* x = p.xp + ((size_t)tt * B + b) * H3;
          xr = to_f(x[j]);
          xz = to_f(x[H + j]);
          xn = to_f(x[2 * H + j]);
        }
        const float hnew =
            gru_gates<FAST>(xr, xz, xn, hr[r], hz[r], hq[r], bias, hc[r * H + j]);
        hx[r * H + j] = hnew;
        if (FAST) hox[r * H + j] = bf16_rn(hnew);
        if (b < B) p.out[((size_t)tt * B + b) * H + j] = hnew;
      }
    }
    __syncthreads();
  }
  const float* hfin = hbuf + (T & 1) * R * H;  // h after the last step
  for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
    const int r = idx / H, b = b0 + r;
    if (b < B) p.hn[(size_t)b * H + (idx - r * H)] = hfin[idx];
  }
}

// the chain's dynamic shared memory at hidden size H and R rows per block:
// the fp32 state's two buffers, and in the fast tier the operand copy's
size_t xp_chain_smem(int H, int R, bool fast) {
  return sizeof(float) * 2 * (size_t)R * H * (fast ? 2 : 1);
}

template <bool FAST, int R, typename X>
int launch_xp_rows(DirXp<X> pf, DirXp<X> pb, int T, int B, int H, void* stream) {
  const size_t smem = xp_chain_smem(H, R, FAST);
  if (int e = allow_smem(xp_window_kernel<FAST, R>, smem)) return e;
  dim3 grid((B + R - 1) / R, 2);
  xp_window_kernel<FAST, R><<<grid, xp_threads(H), smem, (cudaStream_t)stream>>>(pf, pb, T,
                                                                               B, H);
  return (int)cudaGetLastError();
}

template <bool FAST, typename X>
int launch_xp(DirXp<X> pf, DirXp<X> pb, int T, int B, int H, int rows, void* stream) {
  if (H < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 8: return launch_xp_rows<FAST, 8>(pf, pb, T, B, H, stream);
    case 4: return launch_xp_rows<FAST, 4>(pf, pb, T, B, H, stream);
    case 2: return launch_xp_rows<FAST, 2>(pf, pb, T, B, H, stream);
    case 1: return launch_xp_rows<FAST, 1>(pf, pb, T, B, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// the chain's dynamic shared memory at hidden size H and `rows` rows per
// block, in the parity tier (fast = 0) or the fast one (ops/gru_window_xp.py
// chain_smem_bytes mirrors it)
long long bigru_window_xp_chain_smem_bytes(int H, int rows, int fast) {
  return (long long)xp_chain_smem(H, rows, fast != 0);
}

// K3: xp_f, xp_b (T, B, 3H) f32 (x W_ih + b_ih per direction), h0 (B, H),
// W_hh (H, 3H), b_hh (3H,) per direction. Outputs out_f/out_b (T, B, H) in
// original time order, hn_f/hn_b (B, H). `rows`: batch rows per block, 8, 4,
// 2 or 1.
int bigru_window_xp(const float* xp_f, const float* xp_b, const float* h0_f,
                    const float* h0_b, const float* wh_f, const float* bh_f,
                    const float* wh_b, const float* bh_b, float* out_f,
                    float* out_b, float* hn_f, float* hn_b, int T, int B, int H,
                    int rows, void* stream) {
  return launch_xp<false>(DirXp<float>{xp_f, h0_f, wh_f, bh_f, out_f, hn_f},
                          DirXp<float>{xp_b, h0_b, wh_b, bh_b, out_b, hn_b}, T, B, H,
                          rows, stream);
}

// K3f: K3's arguments with bf16 xp streams and bf16 W_hh (b_hh, h0 and the
// outputs fp32).
int bigru_window_xp_fast(const __nv_bfloat16* xp_f, const __nv_bfloat16* xp_b,
                         const float* h0_f, const float* h0_b,
                         const __nv_bfloat16* wh_f, const float* bh_f,
                         const __nv_bfloat16* wh_b, const float* bh_b, float* out_f,
                         float* out_b, float* hn_f, float* hn_b, int T, int B, int H,
                         int rows, void* stream) {
  return launch_xp<true>(DirXp<__nv_bfloat16>{xp_f, h0_f, wh_f, bh_f, out_f, hn_f},
                         DirXp<__nv_bfloat16>{xp_b, h0_b, wh_b, bh_b, out_b, hn_b}, T,
                         B, H, rows, stream);
}

}  // extern "C"
