// What the bi-GRU window kernels (gru_window*.cu) share: their limits, the
// gate nonlinearity, the forward cell step of the in-projection kernels and
// of the fused encoder+decoder kernel, and the readers of a layer's input and
// of h_prev.
//
// Every kernel computes, per direction, the torch nn.GRU cell with gates
// [r, z, n] and b_hh INSIDE the reset product:
//   xp = x W_ih + b_ih,  hp = h W_hh + b_hh
//   r = sigmoid(xp_r + hp_r), z = sigmoid(xp_z + hp_z)
//   n = tanh(xp_n + r * hp_n),  h' = (1 - z) n + z h
// The forward direction reads time t at step t, the backward direction time
// T-1-t, and each writes its output at the time it read.
//
// The fast tier's forward kernels (FAST = true) read bf16 weights (and K3f a
// bf16 xp stream) and round their input rows and the operand copy of h to
// bf16, round-to-nearest-even; every product of two bf16 values is exact in
// fp32 and summed there, and the gates and the carried h stay fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 8;            // batch rows per recurrence block
// k steps per unrolled iteration of the in-projection kernels' FMA chains
// (fma_chain): 4 takes K1, K2, K1f and K2f 10-21% under 2 on the H100, where
// ptxas stopped issuing K1f's next weight loads before its FMAs (PERF.md, PR 5)
constexpr int CHAIN_UNROLL = 4;
constexpr int MAX_H = 512;       // in-projection kernels: one thread per hidden unit
constexpr int XP_THREADS = 512;  // xp-stream kernels: threads per block

struct WindowIn {
  // layer 0: uint8 image (B, L, D), element strides (sb, sl), unit feature
  // stride; time t of the window is image column start + t
  const uint8_t* img;
  long long sb, sl;
  int start;
  // later layers: the previous layer's halves (T, B, H); row = [xa | xb]
  const float* xa;
  const float* xb;
};

// the output buffers of one direction's [dW_ih; db_ih] and [dW_hh; db_hh]
struct DirG {
  float* w_ih;  // (D, 3H)
  float* w_hh;  // (H, 3H)
  float* b_ih;  // (3H,)
  float* b_hh;  // (3H,)
};

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// A weight or stream element as fp32: through the read-only cache, widening
// a bf16 one (exact).
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// The n gate tanh(xn + r * hn) and the blend (1 - z) n + z h. The fast tier
// rounds each product and each sum on its own (no fused multiply-add), as
// the plain version's separate torch ops do, so that on the card kernel and
// plain version round h to bf16 alike (models/gru.py); the parity tier lets
// nvcc fuse them.
template <bool FAST>
__device__ __forceinline__ float gate_n(float xn, float r, float hn) {
  return FAST ? tanhf(__fadd_rn(xn, __fmul_rn(r, hn))) : tanhf(xn + r * hn);
}

template <bool FAST>
__device__ __forceinline__ float blend(float z, float n, float h) {
  return FAST ? __fadd_rn(__fmul_rn(1.0f - z, n), __fmul_rn(z, h))
              : (1.0f - z) * n + z * h;
}

// v rounded to bf16 (nearest even), held in fp32: the fast tier's operand
// copy of an fp32 value
__device__ __forceinline__ float bf16_rn(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x rounded to the nearest TF32 value, ties away from zero: half a TF32 ulp
// added to the magnitude's bits, then the 13 bits TF32 drops cleared. It is
// cvt.rna.tf32.f32 for every finite x that does not round past the largest
// float (two integer operations, where ptxas expands the cvt into about six).
// The 3xTF32 products (gru_window_wgrad.cu, gru_window_proj.cu) split with it.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, each TF32 rounded to nearest (ties away), lo the rest of a
__device__ __forceinline__ void split_tf32(float a, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// The forward cell step of the in-projection kernels (K1/K2 and their fast
// twins, gru_window.cu; K5, gru_window_encdec.cu): one direction, ROWS batch
// rows, one thread per hidden unit j. Every kernel that calls it does the
// same FMAs in the same k order, so K5 equals K1 -> K2 bit for bit.
// ---------------------------------------------------------------------------

// one direction's weights: fp32 for the parity tier, bf16 for the fast one
template <typename W>
struct DirParams {
  const W* w_ih;       // (D, 3H)
  const W* w_hh;       // (H, 3H)
  const float* b_ih;   // (3H,)
  const float* b_hh;   // (3H,)
};

// unit j's six bias values, held in registers across the steps
struct CellBias {
  float ir, iz, in, hr, hz, hn;
};

template <typename W>
__device__ __forceinline__ CellBias load_bias(const DirParams<W>& p, int H, int j) {
  return {p.b_ih[j], p.b_ih[H + j], p.b_ih[2 * H + j],
          p.b_hh[j], p.b_hh[H + j], p.b_hh[2 * H + j]};
}

// a[r] += x[r * ldx + k] * W[k, g * H + j] for the gates g = r, z, n, one FMA
// chain per (row, gate) over k = 0, 1, ..., d - 1 in order; x in shared memory
// (fp32, or K5f's bf16 boundary), W in device memory through the read-only
// cache. UNROLL changes the schedule only, never the order of the sums.
template <int ROWS, int UNROLL, typename X, typename W>
__device__ __forceinline__ void fma_chain(const X* x, int ldx, int d, const W* w, int H,
                                          int j, float (&ar)[ROWS], float (&az)[ROWS],
                                          float (&an)[ROWS]) {
  const int H3 = 3 * H;
#pragma unroll (UNROLL)
  for (int k = 0; k < d; ++k) {
    const W* wk = w + (size_t)k * H3;
    const float wr = ldg_f(wk + j), wz = ldg_f(wk + H + j), wn = ldg_f(wk + 2 * H + j);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float xv = to_f(x[r * ldx + k]);
      ar[r] = fmaf(xv, wr, ar[r]);
      az[r] = fmaf(xv, wz, az[r]);
      an[r] = fmaf(xv, wn, an[r]);
    }
  }
}

// The gates of one row and its h' = (1 - z) n + z h, from the input
// projections with b_ih added (xr, xz, xn), the sums of h W_hh without b_hh
// (hr, hz, hq) and the fp32 state hc. gru_step, the W_hh-in-shared-memory
// recurrence (gru_window_smem.cu) and both designs of the xp-stream window
// (gru_window_xp.cu, gru_window_xp_grid.cu) take their gates from here, so
// each pair of designs rounds alike.
template <bool FAST>
__device__ __forceinline__ float gru_gates(float xr, float xz, float xn, float hr, float hz,
                                           float hq, const CellBias& bias, float hc) {
  const float rg = sigmoidf_(xr + (hr + bias.hr));
  const float zg = sigmoidf_(xz + (hz + bias.hz));
  const float ng = gate_n<FAST>(xn, rg, hq + bias.hn);
  return blend<FAST>(zg, ng, hc);
}

// The backward of one row's cell step (parity tier): the gates recomputed as
// gru_gates forms them, from xp with b_ih added (xr, xz, xn), the sums of
// h_prev W_hh without b_hh (hr, hz, hq) and h_prev itself (hp), then the
// cotangents for dh = dout + dh_carry:
//   dz = dh (h_prev - n),  da = dh (1 - z)(1 - n^2),  dr = da hp_n
//   dxp = [drpre | dzpre | da],  dhp = [drpre | dzpre | dn = da r]
// and dh z, the carry's own term. The one-launch backward (gru_window_bwd.cu)
// and the recurrence with W_hh^T in shared memory (gru_window_bwd_smem.cu)
// both take their cotangents from here, so the two designs round alike.
struct CellGrad {
  float drpre, dzpre, da, dn, dhz;
};

__device__ __forceinline__ CellGrad gru_cell_bwd(float xr, float xz, float xn, float hr,
                                                 float hz, float hq, const CellBias& bias,
                                                 float hp, float dh) {
  const float rg = sigmoidf_(xr + (hr + bias.hr));
  const float zg = sigmoidf_(xz + (hz + bias.hz));
  const float hpn = hq + bias.hn;
  const float ng = tanhf(xn + rg * hpn);
  const float dz = dh * (hp - ng);
  const float da = dh * (1.0f - zg) * (1.0f - ng * ng);
  const float dr = da * hpn;
  return {dr * rg * (1.0f - rg), dz * zg * (1.0f - zg), da, da * rg, dh * zg};
}

// One step: xp = [x0 | x1] W_ih (x0's d0 inputs take W_ih rows [0, d0), x1's
// d1 inputs the rows after; both with row stride ldx), hp = ho W_hh over the
// operand copy of h (the state itself in the parity tier, its bf16 rounding
// in the fast tier), the gates, and h' = (1 - z) n + z h from the fp32 state
// hc. Writes h' to hx (and its bf16 copy to hox in the fast tier) and
// returns it in hnew. The caller separates the steps with __syncthreads().
template <int ROWS, bool FAST, int UNROLL, typename W, typename X>
__device__ __forceinline__ void gru_step(const DirParams<W>& p, const CellBias& bias, int H,
                                         int j, const X* x0, int d0, const X* x1, int d1,
                                         int ldx, const float* hc, const float* ho, float* hx,
                                         float* hox, float (&hnew)[ROWS]) {
  float xr[ROWS], xz[ROWS], xn[ROWS], hr[ROWS], hz[ROWS], hq[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    xr[r] = xz[r] = xn[r] = 0.0f;
    hr[r] = hz[r] = hq[r] = 0.0f;
  }
  fma_chain<ROWS, UNROLL>(x0, ldx, d0, p.w_ih, H, j, xr, xz, xn);
  if (d1 > 0) {
    fma_chain<ROWS, UNROLL>(x1, ldx, d1, p.w_ih + (size_t)d0 * 3 * H, H, j, xr, xz, xn);
  }
  fma_chain<ROWS, UNROLL>(ho, H, H, p.w_hh, H, j, hr, hz, hq);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    hnew[r] = gru_gates<FAST>(xr[r] + bias.ir, xz[r] + bias.iz, xn[r] + bias.in, hr[r],
                              hz[r], hq[r], bias, hc[r * H + j]);
    hx[r * H + j] = hnew[r];
    if (FAST) hox[r * H + j] = bf16_rn(hnew[r]);
  }
}

// The input rows of one step into shared memory dst[ROWS][D], loaded by the
// threads tid = 0 .. nthreads-1: a layer-0 window of the uint8 image, or
// (PAIR) the previous layer's halves [xa | xb], which the fast tier rounds
// to bf16 here (uint8 is exact). Rows past B are zeros.
template <bool PAIR, bool FAST, int ROWS>
__device__ __forceinline__ void load_rows(const WindowIn& in, int tt, int b0, int B, int D,
                                          int H, float* dst, int tid, int nthreads) {
  for (int idx = tid; idx < ROWS * D; idx += nthreads) {
    const int r = idx / D;
    const int k = idx - r * D;
    const int b = b0 + r;
    float v = 0.0f;
    if (b < B) {
      if (PAIR) {
        v = (k < H) ? in.xa[((size_t)tt * B + b) * H + k]
                    : in.xb[((size_t)tt * B + b) * H + (k - H)];
        if (FAST) v = bf16_rn(v);
      } else {
        v = (float)in.img[(size_t)b * in.sb + (size_t)(in.start + tt) * in.sl + k];
      }
    }
    dst[idx] = v;
  }
}

template <bool PAIR>
__device__ __forceinline__ float x_at(const WindowIn& in, int tt, int b, int k,
                                      int B, int H) {
  if (PAIR) {
    return (k < H) ? in.xa[((size_t)tt * B + b) * H + k]
                   : in.xb[((size_t)tt * B + b) * H + (k - H)];
  }
  return (float)in.img[(size_t)b * in.sb + (size_t)(in.start + tt) * in.sl + k];
}

// h_prev of direction `dir` at window time tt: the forward output stream
// shifted by one step (out[tt-1] forward, out[tt+1] backward), or h0 at the
// window boundary
__device__ __forceinline__ float hprev_at(const float* out, const float* h0,
                                          int dir, int tt, int b, int k, int T,
                                          int B, int H) {
  const int tp = dir ? tt + 1 : tt - 1;
  return (tp >= 0 && tp < T) ? out[((size_t)tp * B + b) * H + k]
                             : h0[(size_t)b * H + k];
}

// xp-stream kernels: a block of XP_THREADS (fewer for a small H) loops over
// its hidden units j = threadIdx.x, threadIdx.x + blockDim.x, ...
inline int xp_threads(int H) {
  const int warps = (H + 31) / 32;
  return warps * 32 < XP_THREADS ? warps * 32 : XP_THREADS;
}

// Raise a kernel's dynamic shared memory limit past the default 48 KB, or
// refuse a size the card does not have.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  }
  return 0;
}

}  // namespace
