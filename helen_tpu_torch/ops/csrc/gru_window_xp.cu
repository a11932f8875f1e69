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
// This is the route of the wide models (H > MAX_H = 512, up to XP_MAX_H =
// 1024): past 512 hidden units a block no longer holds one thread per unit,
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
// from L2 at every step, reusing each weight BT times: L2 traffic, not the
// FMAs, sets its time (PERF.md has the measurement).
//
// The design, simple and exact first:
//   * grid (ceil(B / BT), 2): one block per BT batch rows and direction, the
//     T loop inside the block; the ragged batch edge is masked.
//   * XP_THREADS threads per block, each looping over its hidden units j,
//     j + blockDim.x, ... (two at H=1024): 3 x BT gate sums in registers per
//     unit, each weight read once per block, step and unit and reused BT
//     times; weights stay in device memory and are read through L2/L1.
//   * h (BT x H) double-buffered in shared memory (64 KB at H=1024): step t
//     reads buffer t&1 and writes (t+1)&1, one __syncthreads() per step.
//   * true fp32 FMAs on the CUDA cores, no fast-math. Tensor cores (3xTF32
//     wgmma), weights split across a cluster's shared memory and more blocks
//     per direction are later work.

#include "gru_window_common.cuh"

namespace {

struct DirXp {
  const float* xp;    // (T, B, 3H): x W_ih + b_ih
  const float* h0;    // (B, H)
  const float* w_hh;  // (H, 3H)
  const float* b_hh;  // (3H,)
  float* out;         // (T, B, H)
  float* hn;          // (B, H)
};

__global__ void __launch_bounds__(XP_THREADS)
xp_window_kernel(DirXp pf, DirXp pb, int T, int B, int H) {
  const int dir = blockIdx.y;
  const DirXp p = dir ? pb : pf;
  const int b0 = blockIdx.x * BT;
  const int H3 = 3 * H;

  extern __shared__ float hbuf[];  // [2][BT][H]
  for (int idx = threadIdx.x; idx < BT * H; idx += blockDim.x) {
    const int r = idx / H, b = b0 + r;
    hbuf[idx] = (b < B) ? p.h0[(size_t)b * H + (idx - r * H)] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* hc = hbuf + (t & 1) * BT * H;
    float* hx = hbuf + ((t & 1) ^ 1) * BT * H;
    const int tt = dir ? T - 1 - t : t;
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float hr[BT], hz[BT], hq[BT];
#pragma unroll
      for (int r = 0; r < BT; ++r) hr[r] = hz[r] = hq[r] = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float* w = p.w_hh + (size_t)k * H3;
        const float wr = __ldg(w + j), wz = __ldg(w + H + j), wn = __ldg(w + 2 * H + j);
#pragma unroll
        for (int r = 0; r < BT; ++r) {
          const float hv = hc[r * H + k];
          hr[r] = fmaf(hv, wr, hr[r]);
          hz[r] = fmaf(hv, wz, hz[r]);
          hq[r] = fmaf(hv, wn, hq[r]);
        }
      }
      const float bhr = p.b_hh[j], bhz = p.b_hh[H + j], bhn = p.b_hh[2 * H + j];
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const int b = b0 + r;
        float xr = 0.0f, xz = 0.0f, xn = 0.0f;
        if (b < B) {
          const float* x = p.xp + ((size_t)tt * B + b) * H3;
          xr = x[j];
          xz = x[H + j];
          xn = x[2 * H + j];
        }
        const float rg = sigmoidf_(xr + (hr[r] + bhr));
        const float zg = sigmoidf_(xz + (hz[r] + bhz));
        const float ng = tanhf(xn + rg * (hq[r] + bhn));
        const float hnew = (1.0f - zg) * ng + zg * hc[r * H + j];
        hx[r * H + j] = hnew;
        if (b < B) p.out[((size_t)tt * B + b) * H + j] = hnew;
      }
    }
    __syncthreads();
  }
  const float* hfin = hbuf + (T & 1) * BT * H;  // h after the last step
  for (int idx = threadIdx.x; idx < BT * H; idx += blockDim.x) {
    const int r = idx / H, b = b0 + r;
    if (b < B) p.hn[(size_t)b * H + (idx - r * H)] = hfin[idx];
  }
}

}  // namespace

extern "C" {

int gru_window_xp_max_h() { return XP_MAX_H; }

// K3: xp_f, xp_b (T, B, 3H) f32 (x W_ih + b_ih per direction), h0 (B, H),
// W_hh (H, 3H), b_hh (3H,) per direction. Outputs out_f/out_b (T, B, H) in
// original time order, hn_f/hn_b (B, H).
int bigru_window_xp(const float* xp_f, const float* xp_b, const float* h0_f,
                    const float* h0_b, const float* wh_f, const float* bh_f,
                    const float* wh_b, const float* bh_b, float* out_f,
                    float* out_b, float* hn_f, float* hn_b, int T, int B, int H,
                    void* stream) {
  if (H < 1 || H > XP_MAX_H || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 2 * BT * (size_t)H;
  if (int e = allow_smem(xp_window_kernel, smem)) return e;
  const DirXp pf{xp_f, h0_f, wh_f, bh_f, out_f, hn_f};
  const DirXp pb{xp_b, h0_b, wh_b, bh_b, out_b, hn_b};
  dim3 grid((B + BT - 1) / BT, 2);
  xp_window_kernel<<<grid, xp_threads(H), smem, (cudaStream_t)stream>>>(pf, pb, T, B,
                                                                       H);
  return (int)cudaGetLastError();
}

}  // extern "C"
