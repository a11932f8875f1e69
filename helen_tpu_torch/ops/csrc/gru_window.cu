// Bi-GRU window kernels for Hopper (sm_90a), exposed through a plain C ABI
// and loaded with ctypes by helen_tpu_torch/ops/gru_window.py.
//
// Replaces the two Pallas TPU kernels of helen_tpu's consensus path:
//   bigru_window_in1 <- _kernel_inproj1 (helen_tpu/ops/gru_pallas.py:426):
//       one bi-GRU layer over one window, read straight from the (B, L, F)
//       uint8 pileup image at column `start`;
//   bigru_window_in2 <- _kernel_inproj2 (helen_tpu/ops/gru_pallas.py:474):
//       the same layer over the previous layer's (out_f, out_b) halves, with
//       no concat (decoder layers and every stacked layer >= 1).
// Both compute, per direction, the GRU cell of gru_window_common.cuh, one
// step at a time through its gru_step, which the fused encoder+decoder
// kernel (gru_window_encdec.cu) shares; the final state is the h after the
// last step (for the backward direction: after time 0).
//
// What bounds it on this card. One launch at B=512, T=100, H=128 does
// 17.1 GFLOP (K1, D=90) or 30.2 GFLOP (K2, D=256) of fp32 FMA and must move
// only 59 / 107 MB, so it is bound by operations: 0.26 / 0.45 ms at the
// 67 TFLOP/s fp32 peak. The recurrence serialises the T steps, so the work
// per step is small (B x 3H x (D + H) FMAs) and must spread over many SMs.
// As written it runs at about a tenth of that bound (PERF.md): every block
// re-reads its direction's weights from L2 at every step and reuses each
// weight only BT times.
//
// What this design does about it (simple and exact first):
//   * grid (ceil(B / BT), 2): one block per BT batch rows and direction —
//     the directions are independent, so they run in separate blocks, and
//     the T loop runs inside the block (blocks run in no order on Hopper;
//     the TPU's sequential (B/Bt, T) grid does not carry over). At B=512
//     that is 128 blocks for 132 SMs. The ragged batch edge is masked.
//   * one thread per hidden unit j, which keeps 6 x BT fp32 accumulators
//     (the r, z, n gates of the x and h products for its BT rows) in
//     registers; each weight element is read once per block and step and
//     reused BT times. Weights (135-384 KiB per layer and direction in fp32)
//     stay in device memory and are read through L2/L1 — they do not fit a
//     block's shared memory beside the rest.
//   * the block's h (BT x H) and input rows (BT x D) live in shared memory,
//     double-buffered: step t reads buffer t&1 and writes buffer (t+1)&1,
//     so one __syncthreads() per step separates every read of h[t-1] from
//     the write of h[t].
//   * true fp32 FMA on the CUDA cores: the parity tier's counterpart of the
//     TPU's bf16x3 hi/lo product (no Veltkamp split: that exists only
//     because the TPU's matrix unit lacks an fp32 pass). uint8 inputs are
//     exact in fp32. No fast-math: expf/tanhf keep full precision.
//   * H is a runtime value up to MAX_H (the threads of one block; the
//     launch bound keeps 128 registers per thread). D=90 is not padded.
// Tensor cores (3xTF32 wgmma), TMA and weights split across a cluster's
// shared memory are later work.
//
// The fast tier (FAST = true; bigru_window_in1_fast / _in2_fast, K1f / K2f)
// replaces the same two Pallas bodies run with fast=True: one bf16 pass for
// each product with fp32 accumulation (_proj_passes and _gru_gates with
// w_lo None, gru_pallas.py:220-221 and :190-192). Here that is the same
// kernel with bf16 weights widened in registers (exact) and fp32 FMAs on the
// CUDA cores: a product of two bf16 values is exact in fp32, so this is the
// TPU's single-pass bf16 product up to the order of the sums. K2f rounds the
// previous layer's fp32 halves to bf16 as it stages them (K1f's uint8 image
// is exact in bf16), and a second shared buffer holds the bf16-rounded
// operand copy of h; the gates, z * h and every output stay fp32.
// Bound on this card, counted at the bf16 tensor-core rate (989 TFLOP/s)
// with bf16 weights: K1f 17.1 GFLOP and 59 MB, K2f 30.2 GFLOP and 107 MB at
// B=512, T=100, H=128, both about 0.02-0.03 ms and bound by bytes. As
// written they are bound by the same L2 weight re-reads as K1/K2, at half
// the bytes per weight, and by the CUDA cores' fp32 rate. Up to H=160 the
// fast tier's main path runs instead as a projection pass and a recurrence
// on bf16 tensor cores (gru_window_fast.cu); this kernel keeps the wider
// shapes and design "chain", and its gru_step is the one K5f shares.

#include <type_traits>

#include "gru_window_common.cuh"

namespace {

template <bool PAIR, bool FAST>
__global__ void __launch_bounds__(MAX_H)
bigru_window_kernel(WindowIn in, int D, const float* __restrict__ h0_f,
                    const float* __restrict__ h0_b,
                    DirParams<typename std::conditional<FAST, __nv_bfloat16, float>::type> pf,
                    DirParams<typename std::conditional<FAST, __nv_bfloat16, float>::type> pb,
                    float* __restrict__ out_f, float* __restrict__ out_b,
                    float* __restrict__ hn_f, float* __restrict__ hn_b,
                    int T, int B, int H) {
  const int dir = blockIdx.y;
  const auto p = dir ? pb : pf;
  const float* __restrict__ h0 = dir ? h0_b : h0_f;
  float* __restrict__ out = dir ? out_b : out_f;
  float* __restrict__ hn = dir ? hn_b : hn_f;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;  // hidden unit; blockDim.x == H

  extern __shared__ float smem[];
  float* hbuf = smem;               // [2][BT][H] the fp32 state
  float* xbuf = smem + 2 * BT * H;  // [2][BT][D]
  // [2][BT][H] the operand copy of h: bf16-rounded (fast), or the state
  float* hop = FAST ? xbuf + 2 * BT * D : hbuf;

#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const int b = b0 + r;
    const float h = (b < B) ? h0[(size_t)b * H + j] : 0.0f;
    hbuf[r * H + j] = h;
    if (FAST) hop[r * H + j] = bf16_rn(h);
  }
  load_rows<PAIR, FAST, BT>(in, dir ? T - 1 : 0, b0, B, D, H, xbuf, j, H);
  __syncthreads();

  const CellBias bias = load_bias(p, H, j);
  float hlast[BT];

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const float* xc = xbuf + cur * BT * D;
    const int tt = dir ? T - 1 - t : t;
    // x W_ih over the D inputs of this step, then h W_hh (the fast tier:
    // bf16(h) W_hh), then the gates
    float hnew[BT];
    gru_step<BT, FAST, CHAIN_UNROLL>(p, bias, H, j, xc, D, xc, 0, D, hbuf + cur * BT * H,
                       hop + cur * BT * H, hbuf + (cur ^ 1) * BT * H,
                       hop + (cur ^ 1) * BT * H, hnew);
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      hlast[r] = hnew[r];
      const int b = b0 + r;
      if (b < B) out[((size_t)tt * B + b) * H + j] = hnew[r];
    }
    if (t + 1 < T) {
      load_rows<PAIR, FAST, BT>(in, dir ? T - 2 - t : t + 1, b0, B, D, H,
                                xbuf + (cur ^ 1) * BT * D, j, H);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const int b = b0 + r;
    if (b < B) hn[(size_t)b * H + j] = hlast[r];
  }
}

template <bool PAIR, bool FAST, typename W>
int launch(const WindowIn& in, int D, const float* h0_f, const float* h0_b,
           DirParams<W> pf, DirParams<W> pb, float* out_f, float* out_b,
           float* hn_f, float* hn_b, int T, int B, int H, void* stream) {
  if (H < 1 || H > MAX_H || D < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * BT * ((size_t)H * (FAST ? 2 : 1) + D);
  if (int e = allow_smem(bigru_window_kernel<PAIR, FAST>, smem)) return e;
  dim3 grid((B + BT - 1) / BT, 2);
  bigru_window_kernel<PAIR, FAST><<<grid, H, smem, (cudaStream_t)stream>>>(
      in, D, h0_f, h0_b, pf, pb, out_f, out_b, hn_f, hn_b, T, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gru_window_max_h() { return MAX_H; }

int gru_window_block_rows() { return BT; }

const char* gru_window_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1: image (B, L, D) uint8 with element strides (sb, sl), window columns
// [start, start + T). Outputs out_f/out_b (T, B, H), hn_f/hn_b (B, H), f32.
int bigru_window_in1(const uint8_t* img, long long sb, long long sl, int start,
                     int D, const float* h0_f, const float* h0_b,
                     const float* wi_f, const float* wh_f, const float* bi_f,
                     const float* bh_f, const float* wi_b, const float* wh_b,
                     const float* bi_b, const float* bh_b, float* out_f,
                     float* out_b, float* hn_f, float* hn_b, int T, int B,
                     int H, void* stream) {
  WindowIn in{img, sb, sl, start, nullptr, nullptr};
  return launch<false, false>(in, D, h0_f, h0_b,
                              DirParams<float>{wi_f, wh_f, bi_f, bh_f},
                              DirParams<float>{wi_b, wh_b, bi_b, bh_b}, out_f, out_b,
                              hn_f, hn_b, T, B, H, stream);
}

// K2: xa, xb (T, B, H) f32, W_ih (2H, 3H): rows [0, H) take xa, [H, 2H) xb.
int bigru_window_in2(const float* xa, const float* xb, const float* h0_f,
                     const float* h0_b, const float* wi_f, const float* wh_f,
                     const float* bi_f, const float* bh_f, const float* wi_b,
                     const float* wh_b, const float* bi_b, const float* bh_b,
                     float* out_f, float* out_b, float* hn_f, float* hn_b,
                     int T, int B, int H, void* stream) {
  WindowIn in{nullptr, 0, 0, 0, xa, xb};
  return launch<true, false>(in, 2 * H, h0_f, h0_b,
                             DirParams<float>{wi_f, wh_f, bi_f, bh_f},
                             DirParams<float>{wi_b, wh_b, bi_b, bh_b}, out_f, out_b,
                             hn_f, hn_b, T, B, H, stream);
}

// K1f: K1's arguments with bf16 W_ih, W_hh (biases fp32); outputs fp32.
int bigru_window_in1_fast(const uint8_t* img, long long sb, long long sl, int start,
                          int D, const float* h0_f, const float* h0_b,
                          const __nv_bfloat16* wi_f, const __nv_bfloat16* wh_f,
                          const float* bi_f, const float* bh_f,
                          const __nv_bfloat16* wi_b, const __nv_bfloat16* wh_b,
                          const float* bi_b, const float* bh_b, float* out_f,
                          float* out_b, float* hn_f, float* hn_b, int T, int B,
                          int H, void* stream) {
  WindowIn in{img, sb, sl, start, nullptr, nullptr};
  return launch<false, true>(in, D, h0_f, h0_b,
                             DirParams<__nv_bfloat16>{wi_f, wh_f, bi_f, bh_f},
                             DirParams<__nv_bfloat16>{wi_b, wh_b, bi_b, bh_b}, out_f,
                             out_b, hn_f, hn_b, T, B, H, stream);
}

// K2f: K2's arguments with bf16 W_ih, W_hh; the fp32 halves are rounded to
// bf16 in the kernel.
int bigru_window_in2_fast(const float* xa, const float* xb, const float* h0_f,
                          const float* h0_b, const __nv_bfloat16* wi_f,
                          const __nv_bfloat16* wh_f, const float* bi_f,
                          const float* bh_f, const __nv_bfloat16* wi_b,
                          const __nv_bfloat16* wh_b, const float* bi_b,
                          const float* bh_b, float* out_f, float* out_b, float* hn_f,
                          float* hn_b, int T, int B, int H, void* stream) {
  WindowIn in{nullptr, 0, 0, 0, xa, xb};
  return launch<true, true>(in, 2 * H, h0_f, h0_b,
                            DirParams<__nv_bfloat16>{wi_f, wh_f, bi_f, bh_f},
                            DirParams<__nv_bfloat16>{wi_b, wh_b, bi_b, bh_b}, out_f,
                            out_b, hn_f, hn_b, T, B, H, stream);
}

}  // extern "C"
