// Bi-GRU window BACKWARD for Hopper (sm_90a), exposed through a plain C ABI
// and loaded with ctypes by helen_tpu_torch/ops/gru_window_bwd.py.
//
// Replaces the Pallas TPU kernel of helen_tpu's training path:
//   _bwd_kernel_ip (helen_tpu/ops/gru_pallas_train.py:321, pallas_call :612):
//   the backward of one bi-GRU layer over one window with the input
//   projection in-kernel. Its forward (_fwd_kernel_ip, :259) computes what
//   the window kernels K1/K2 (gru_window.cu) compute, so those serve as the
//   training forward unchanged: the backward saves nothing beyond the
//   forward's outputs and recomputes the gates from x and h_prev.
//
// Per direction (gates [r, z, n], b_hh inside the reset product), at each
// step of the unwind (the forward direction unwinds t = T-1 .. 0, the
// backward direction t = 0 .. T-1):
//   h_prev = out[t-1] (fwd) / out[t+1] (bwd), or h0 at the window boundary
//   xp = x W_ih + b_ih,  hp = h_prev W_hh + b_hh,  r, z, n as in the forward
//   dh = dout[t] + dh_carry                      (dh_carry starts at dh_final)
//   dz = dh (h_prev - n),  da = dh (1 - z)(1 - n^2),  dr = da hp_n
//   drpre = dr r (1 - r),  dzpre = dz z (1 - z)
//   dxp = [drpre | dzpre | da],  dhp = [drpre | dzpre | da r]
//   dh_carry' = dh z + dhp W_hh^T,   dx[t] = dxp W_ih^T (K2-kind layers only)
// and over all rows n = (t, b) of the window:
//   dW_ih = sum x^T dxp, db_ih = sum dxp, dW_hh = sum h_prev^T dhp, db_hh = sum dhp.
//
// Two passes, because Hopper's blocks run in no order and the TPU kernel's
// sequential-grid accumulation of dW/db in VMEM does not carry over:
//   pass 1 (bwd_rec_kernel, the "chain" design; where W_hh^T fits one
//     block's shared memory, the flagship's H=128 included, pass 1 runs as
//     gru_window_bwd_smem.cu's three kernels instead, bit for bit the same,
//     by the fixed shape rule of ops/gru_window_bwd.py bwd_design): the
//     recurrence. Grid (ceil(B / BT), 2), one
//     block per BT batch rows and direction, one thread per hidden unit, the
//     T loop inside the block. h_prev and the step's input rows, dxp and the
//     n block of dhp live in shared memory; dh_carry lives in registers (each
//     thread owns its unit's rows). It streams dxp (T, B, 3H) and dhp_n
//     (T, B, H) per direction to scratch the wrapper allocates, writes dh0,
//     and, for K2-kind layers, dx per direction (the wrapper adds the two,
//     as helen_tpu's wrapper does at gru_pallas_train.py:658). Layer 0 reads
//     the uint8 image in place at column `start`, as K1 does; it has no dx.
//   pass 2: the weight cotangents over the N = T * B rows, the split
//     design of gru_window_wgrad.cu (slices of N on 3xTF32 tensor cores,
//     the slices added in a fixed order). No float atomics: the same inputs
//     give bit-identical gradients.
//
// FLOPs per launch and direction: pass 1 2*B*T*3H*(2D + 2H) (the gate
// recompute x W_ih and h W_hh, the carry dhp W_hh^T, and dx; without dx
// 2*B*T*3H*(D + 2H)); pass 2 2*B*T*3H*(D + H) (plus the bias rows).
// At the flagship training shapes (B=256, T=100, H=128) both passes and
// directions do 22.2 GFLOP for layer 0 (D=90, no dx) and 45.3 GFLOP for the
// decoder (D=256, with dx), while the function's own inputs and outputs are
// 30-110 MB: the bound is operations on the fp32 CUDA cores, 0.33 / 0.68 ms
// at the H100 SXM's published 67 TFLOP/s fp32 peak (700 W). The dxp/dhp_n
// scratch between the passes (105 MB written and read again) is the
// design's own traffic on top of that.
// What the design does about it: pass 1 is the K1/K2 recurrence layout
// (weights read through L2/L1, 6 x BT gate sums in registers, each weight
// reused BT times per read); pass 2 reuses each loaded element 32 times from
// shared memory. Both are simple and exact first: true fp32 FMAs, no
// fast-math, no tensor cores.
//
// H is a runtime value up to MAX_H = 512 (threads of a pass-1 block; the
// launch bound holds a thread to 128 registers).

#include "gru_window_common.cuh"

namespace {

struct DirW {
  const float* w_ih;   // (D, 3H)
  const float* w_hh;   // (H, 3H)
  const float* w_ihT;  // (3H, D)
  const float* w_hhT;  // (3H, H)
  const float* b_ih;   // (3H,)
  const float* b_hh;   // (3H,)
};

template <bool PAIR>
__global__ void __launch_bounds__(MAX_H)
bwd_rec_kernel(WindowIn in, int D, const float* __restrict__ h0_f,
               const float* __restrict__ h0_b, const float* __restrict__ out_f,
               const float* __restrict__ out_b, const float* __restrict__ dout_f,
               const float* __restrict__ dout_b, const float* __restrict__ dhf,
               const float* __restrict__ dhb, DirW pf, DirW pb,
               float* __restrict__ dxp_all, float* __restrict__ dhpn_all,
               float* __restrict__ dx_f, float* __restrict__ dx_b,
               float* __restrict__ dh0_f, float* __restrict__ dh0_b, int T,
               int B, int H) {
  const int dir = blockIdx.y;
  const DirW p = dir ? pb : pf;
  const float* __restrict__ h0 = dir ? h0_b : h0_f;
  const float* __restrict__ out = dir ? out_b : out_f;
  const float* __restrict__ dout = dir ? dout_b : dout_f;
  const float* __restrict__ dh_final = dir ? dhb : dhf;
  float* __restrict__ dx = dir ? dx_b : dx_f;  // nullptr: no dx (layer 0)
  float* __restrict__ dh0 = dir ? dh0_b : dh0_f;
  const int H3 = 3 * H;
  float* __restrict__ dxp_g = dxp_all + (size_t)dir * T * B * H3;
  float* __restrict__ dhpn_g = dhpn_all + (size_t)dir * T * B * H;
  const int b0 = blockIdx.x * BT;
  const int j = threadIdx.x;  // hidden unit; blockDim.x == H

  extern __shared__ float smem[];
  float* xs = smem;           // [BT][D]  input rows of the step
  float* hs = xs + BT * D;    // [BT][H]  h_prev rows of the step
  float* gx = hs + BT * H;    // [BT][3H] dxp of the step
  float* gn = gx + BT * H3;   // [BT][H]  n block of dhp (da r)

  const float bir = p.b_ih[j], biz = p.b_ih[H + j], bin = p.b_ih[2 * H + j];
  const CellBias bias{bir, biz, bin, p.b_hh[j], p.b_hh[H + j], p.b_hh[2 * H + j]};
  float dhc[BT];  // dh_carry of unit j, for the block's BT rows
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const int b = b0 + r;
    dhc[r] = (b < B) ? dh_final[(size_t)b * H + j] : 0.0f;
  }

  for (int s = 0; s < T; ++s) {
    const int tt = dir ? s : T - 1 - s;
    for (int idx = threadIdx.x; idx < BT * D; idx += blockDim.x) {
      const int r = idx / D, k = idx - (idx / D) * D, b = b0 + r;
      xs[idx] = (b < B) ? x_at<PAIR>(in, tt, b, k, B, H) : 0.0f;
    }
    for (int idx = threadIdx.x; idx < BT * H; idx += blockDim.x) {
      const int r = idx / H, k = idx - (idx / H) * H, b = b0 + r;
      hs[idx] = (b < B) ? hprev_at(out, h0, dir, tt, b, k, T, B, H) : 0.0f;
    }
    __syncthreads();

    // recompute the gates: the forward kernels' arithmetic
    float xr[BT], xz[BT], xn[BT], hr[BT], hz[BT], hq[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      xr[r] = xz[r] = xn[r] = 0.0f;
      hr[r] = hz[r] = hq[r] = 0.0f;
    }
#pragma unroll 2
    for (int k = 0; k < D; ++k) {
      const float* w = p.w_ih + (size_t)k * H3;
      const float wr = __ldg(w + j), wz = __ldg(w + H + j), wn = __ldg(w + 2 * H + j);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float xv = xs[r * D + k];
        xr[r] = fmaf(xv, wr, xr[r]);
        xz[r] = fmaf(xv, wz, xz[r]);
        xn[r] = fmaf(xv, wn, xn[r]);
      }
    }
#pragma unroll 2
    for (int k = 0; k < H; ++k) {
      const float* w = p.w_hh + (size_t)k * H3;
      const float wr = __ldg(w + j), wz = __ldg(w + H + j), wn = __ldg(w + 2 * H + j);
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float hv = hs[r * H + k];
        hr[r] = fmaf(hv, wr, hr[r]);
        hz[r] = fmaf(hv, wz, hz[r]);
        hq[r] = fmaf(hv, wn, hq[r]);
      }
    }
    float dhz[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const int b = b0 + r;
      const float dh = ((b < B) ? dout[((size_t)tt * B + b) * H + j] : 0.0f) + dhc[r];
      const CellGrad c = gru_cell_bwd(xr[r] + bir, xz[r] + biz, xn[r] + bin, hr[r], hz[r],
                                      hq[r], bias, hs[r * H + j], dh);
      gx[r * H3 + j] = c.drpre;
      gx[r * H3 + H + j] = c.dzpre;
      gx[r * H3 + 2 * H + j] = c.da;
      gn[r * H + j] = c.dn;
      dhz[r] = c.dhz;
      if (b < B) {
        float* g = dxp_g + ((size_t)tt * B + b) * H3;
        g[j] = c.drpre;
        g[H + j] = c.dzpre;
        g[2 * H + j] = c.da;
        dhpn_g[((size_t)tt * B + b) * H + j] = c.dn;
      }
    }
    __syncthreads();

    // dh_carry' = dh z + dhp W_hh^T, dhp = [dxp_r | dxp_z | dn]
    float acc[BT];
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[r] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < 2 * H; ++k) {
      const float w = __ldg(p.w_hhT + (size_t)k * H + j);
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = fmaf(gx[r * H3 + k], w, acc[r]);
    }
#pragma unroll 2
    for (int k = 0; k < H; ++k) {
      const float w = __ldg(p.w_hhT + (size_t)(2 * H + k) * H + j);
#pragma unroll
      for (int r = 0; r < BT; ++r) acc[r] = fmaf(gn[r * H + k], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < BT; ++r) dhc[r] = __fadd_rn(dhz[r], acc[r]);  // never fused

    // dx[t] = dxp W_ih^T, one input feature per thread and pass
    if (dx != nullptr) {
      for (int d = j; d < D; d += blockDim.x) {
        float a[BT];
#pragma unroll
        for (int r = 0; r < BT; ++r) a[r] = 0.0f;
#pragma unroll 2
        for (int k = 0; k < H3; ++k) {
          const float w = __ldg(p.w_ihT + (size_t)k * D + d);
#pragma unroll
          for (int r = 0; r < BT; ++r) a[r] = fmaf(gx[r * H3 + k], w, a[r]);
        }
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const int b = b0 + r;
          if (b < B) dx[((size_t)tt * B + b) * D + d] = a[r];
        }
      }
    }
    __syncthreads();  // xs, hs, gx, gn are rewritten by the next step
  }
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    const int b = b0 + r;
    if (b < B) dh0[(size_t)b * H + j] = dhc[r];
  }
}

int check_geometry(int D, int T, int B, int H) {
  if (H < 1 || H > MAX_H || D < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  return 0;
}

template <bool PAIR>
int launch_rec(const WindowIn& in, int D, const float* h0_f, const float* h0_b,
               const float* out_f, const float* out_b, const float* dout_f,
               const float* dout_b, const float* dhf, const float* dhb, DirW pf,
               DirW pb, float* dxp, float* dhpn, float* dx_f, float* dx_b,
               float* dh0_f, float* dh0_b, int T, int B, int H, void* stream) {
  if (int e = check_geometry(D, T, B, H)) return e;
  const size_t smem = sizeof(float) * BT * ((size_t)D + 5 * (size_t)H);
  if (int e = allow_smem(bwd_rec_kernel<PAIR>, smem)) return e;
  dim3 grid((B + BT - 1) / BT, 2);
  bwd_rec_kernel<PAIR><<<grid, H, smem, (cudaStream_t)stream>>>(
      in, D, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dhf, dhb, pf, pb, dxp,
      dhpn, dx_f, dx_b, dh0_f, dh0_b, T, B, H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gru_window_bwd_max_h() { return MAX_H; }

// Pass 1. Layer 0 when img != nullptr (image (B, L, D) uint8, strides sb, sl,
// window columns [start, start + T)), else the K2 kind: xa, xb (T, B, H),
// D = 2H. dxp (2, T, B, 3H) and dhpn (2, T, B, H) are scratch for pass 2;
// dx_f/dx_b (T, B, D) may be null (no dx).
int bigru_window_bwd_rec(const uint8_t* img, long long sb, long long sl, int start,
                         const float* xa, const float* xb, int D,
                         const float* h0_f, const float* h0_b, const float* out_f,
                         const float* out_b, const float* dout_f,
                         const float* dout_b, const float* dhf, const float* dhb,
                         const float* wi_f, const float* wh_f, const float* wiT_f,
                         const float* whT_f, const float* bi_f, const float* bh_f,
                         const float* wi_b, const float* wh_b, const float* wiT_b,
                         const float* whT_b, const float* bi_b, const float* bh_b,
                         float* dxp, float* dhpn, float* dx_f, float* dx_b,
                         float* dh0_f, float* dh0_b, int T, int B, int H,
                         void* stream) {
  const WindowIn in{img, sb, sl, start, xa, xb};
  const DirW pf{wi_f, wh_f, wiT_f, whT_f, bi_f, bh_f};
  const DirW pb{wi_b, wh_b, wiT_b, whT_b, bi_b, bh_b};
  if (img != nullptr) {
    return launch_rec<false>(in, D, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dhf,
                             dhb, pf, pb, dxp, dhpn, dx_f, dx_b, dh0_f, dh0_b, T,
                             B, H, stream);
  }
  if (D != 2 * H) return (int)cudaErrorInvalidValue;
  return launch_rec<true>(in, D, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dhf,
                          dhb, pf, pb, dxp, dhpn, dx_f, dx_b, dh0_f, dh0_b, T, B,
                          H, stream);
}

}  // extern "C"
