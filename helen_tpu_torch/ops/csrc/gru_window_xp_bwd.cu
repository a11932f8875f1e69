// Bi-GRU window BACKWARD over a pre-projected input stream (K4) for Hopper
// (sm_90a), exposed through a plain C ABI and loaded with ctypes by
// helen_tpu_torch/ops/gru_window_xp_bwd.py.
//
// Replaces the Pallas TPU kernel
//   _bwd_kernel (helen_tpu/ops/gru_pallas_train.py:166, pallas_call :507):
//   the backward of the xp-stream training window (forward: K3,
//   gru_window_xp.cu). It returns dxp (T, B, 3H) per direction instead of
//   dx: the projection xp = x W_ih + b_ih and its cotangents dx, dW_ih, db_ih
//   stay in torch autograd around the two kernels, as they stay in XLA
//   around helen_tpu's custom VJP (_window_core, :698). It saves nothing
//   beyond the forward's xp and outputs and recomputes the gates.
//
// Per direction, at each step of the unwind (the forward direction unwinds
// t = T-1 .. 0, the backward direction t = 0 .. T-1), gru_pallas_train.py's
// equations (:51-62):
//   h_prev = out[t-1] (fwd) / out[t+1] (bwd), or h0 at the window boundary
//   hp = h_prev W_hh + b_hh,  r, z, n from xp[t] and hp as in the forward
//   dh = dout[t] + dh_carry                      (dh_carry starts at dh_final)
//   dz = dh (h_prev - n),  da = dh (1 - z)(1 - n^2),  dr = da hp_n
//   drpre = dr r (1 - r),  dzpre = dz z (1 - z)
//   dxp = [drpre | dzpre | da],  dhp = [drpre | dzpre | da r]
//   dh_carry' = dh z + dhp W_hh^T
// and over all rows n = (t, b): dW_hh = sum h_prev^T dhp, db_hh = sum dhp.
//
// Two passes, as in the in-projection backward (gru_window_bwd.cu), since
// Hopper's blocks run in no order and the TPU kernel's accumulation of dW/db
// across its sequential grid does not carry over:
//   pass 1 (xp_bwd_rec_kernel): the recurrence. Grid (ceil(B / R), 2), one
//     block per R batch rows and direction, XP_THREADS threads each looping
//     over its hidden units, the T loop inside the block. The step's h_prev
//     rows, its dhp rows and the dh carry live in shared memory (5 R H
//     floats: 160 KB at H=1024, R=8; each thread reads and writes only its
//     own units' carry). R is 8, 4, 2 or 1, the largest that fits the card's
//     opt-in shared memory (ops/gru_window_xp_bwd.py bwd_chain_rows; 8 up
//     to H=1,452 on the H100); each row's sums run in the same order at
//     every R, so R does not change a bit. It
//     writes dxp (an output) and the n block of dhp (scratch) per direction,
//     and dh0.
//   pass 2: the [dW_hh; db_hh] half of the weight-cotangent reduction over
//     those streams, the split design of gru_window_wgrad.cu. No float
//     atomics: two launches are bit-identical.
//
// Shapes whose W_hh slices fit the card's SMs take the grid design instead
// (gru_window_xp_bwd_grid.cu: the gate pass, then a grid-wide recurrence with
// W_hh in the SMs' shared memory; ops/gru_window_xp_bwd.py xp_bwd_design):
// it takes its cotangents from the same gru_cell_bwd and sums in the same
// order, so the two give the same bits.
//
// What bounds it on this card. At the wide training shapes (B=64, T=100,
// H=1024) pass 1 does 2 dirs x (2 T B H 3H for the gate recompute + the same
// for the carry) = 161 GFLOP and pass 2 2 x 2 T B (H + 1) 3H = 81 GFLOP,
// against 0.3-0.5 GB of inputs and outputs each: operations bound them, at
// 2.4 and 1.2 ms at the 67 TFLOP/s fp32 peak. At B=64 pass 1 has only 16
// blocks for 132 SMs, and every block re-reads W_hh and W_hh^T (25 MB) from
// L2 at every step: it runs far from that bound (PERF.md). Simple and exact
// first: true fp32 FMAs, no fast-math, no tensor cores.

#include "gru_window_common.cuh"

namespace {

struct DirXpBwd {
  const float* xp;        // (T, B, 3H): x W_ih + b_ih
  const float* h0;        // (B, H)
  const float* out;       // (T, B, H): the forward's output stream
  const float* dout;      // (T, B, H)
  const float* dh_final;  // (B, H): cotangent of the final state
  const float* w_hh;      // (H, 3H)
  const float* w_hhT;     // (3H, H)
  const float* b_hh;      // (3H,)
  float* dxp;             // (T, B, 3H)
  float* dhpn;            // (T, B, H): the n block of dhp, for pass 2
  float* dh0;             // (B, H)
};

template <int R>
__global__ void __launch_bounds__(XP_THREADS)
xp_bwd_rec_kernel(DirXpBwd pf, DirXpBwd pb, int T, int B, int H) {
  const int dir = blockIdx.y;
  const DirXpBwd p = dir ? pb : pf;
  const int b0 = blockIdx.x * R;
  const int H3 = 3 * H;

  extern __shared__ float smem[];
  float* hs = smem;             // [R][H]  h_prev rows of the step
  float* gh = hs + R * H;      // [R][3H] dhp rows of the step
  float* dhc = gh + R * H3;    // [R][H]  dh carry

  for (int j = threadIdx.x; j < H; j += blockDim.x) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r;
      dhc[r * H + j] = (b < B) ? p.dh_final[(size_t)b * H + j] : 0.0f;
    }
  }

  for (int s = 0; s < T; ++s) {
    const int tt = dir ? s : T - 1 - s;
    for (int idx = threadIdx.x; idx < R * H; idx += blockDim.x) {
      const int r = idx / H, k = idx - r * H, b = b0 + r;
      hs[idx] = (b < B) ? hprev_at(p.out, p.h0, dir, tt, b, k, T, B, H) : 0.0f;
    }
    // hs is complete, and every read of the previous step's gh is done
    __syncthreads();

    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      // recompute the gates: the forward kernel's arithmetic
      float hr[R], hz[R], hq[R];
#pragma unroll
      for (int r = 0; r < R; ++r) hr[r] = hz[r] = hq[r] = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H; ++k) {
        const float* w = p.w_hh + (size_t)k * H3;
        const float wr = __ldg(w + j), wz = __ldg(w + H + j), wn = __ldg(w + 2 * H + j);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float hv = hs[r * H + k];
          hr[r] = fmaf(hv, wr, hr[r]);
          hz[r] = fmaf(hv, wz, hz[r]);
          hq[r] = fmaf(hv, wn, hq[r]);
        }
      }
      const CellBias bias{0.0f, 0.0f, 0.0f, p.b_hh[j], p.b_hh[H + j], p.b_hh[2 * H + j]};
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int b = b0 + r;
        const size_t row = (size_t)tt * B + b;
        float xr = 0.0f, xz = 0.0f, xn = 0.0f, dout = 0.0f;
        if (b < B) {
          const float* x = p.xp + row * H3;
          xr = x[j];
          xz = x[H + j];
          xn = x[2 * H + j];
          dout = p.dout[row * H + j];
        }
        // the cotangent lines the grid design (gru_window_xp_bwd_grid.cu)
        // shares, so that the two designs round alike
        const CellGrad c = gru_cell_bwd(xr, xz, xn, hr[r], hz[r], hq[r], bias, hs[r * H + j],
                                        dout + dhc[r * H + j]);
        gh[r * H3 + j] = c.drpre;
        gh[r * H3 + H + j] = c.dzpre;
        gh[r * H3 + 2 * H + j] = c.dn;
        dhc[r * H + j] = c.dhz;
        if (b < B) {
          float* g = p.dxp + row * H3;
          g[j] = c.drpre;
          g[H + j] = c.dzpre;
          g[2 * H + j] = c.da;
          p.dhpn[row * H + j] = c.dn;
        }
      }
    }
    __syncthreads();  // gh is complete

    // dh_carry' = dh z + dhp W_hh^T
    for (int j = threadIdx.x; j < H; j += blockDim.x) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 8
      for (int k = 0; k < H3; ++k) {
        const float w = __ldg(p.w_hhT + (size_t)k * H + j);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(gh[r * H3 + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) dhc[r * H + j] = __fadd_rn(dhc[r * H + j], acc[r]);
    }
    // no barrier here: the next step writes only hs before its barrier, and
    // hs is not read after the one above
  }
  for (int j = threadIdx.x; j < H; j += blockDim.x) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int b = b0 + r;
      if (b < B) p.dh0[(size_t)b * H + j] = dhc[r * H + j];
    }
  }
}

int check_xp_geometry(int T, int B, int H) {
  if (H < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  return 0;
}

// pass 1's dynamic shared memory at hidden size H and R rows per block
size_t xp_bwd_chain_smem(int H, int R) { return sizeof(float) * 5 * (size_t)R * H; }

template <int R>
int launch_bwd_rows(const DirXpBwd& pf, const DirXpBwd& pb, int T, int B, int H,
                    void* stream) {
  const size_t smem = xp_bwd_chain_smem(H, R);
  if (int e = allow_smem(xp_bwd_rec_kernel<R>, smem)) return e;
  dim3 grid((B + R - 1) / R, 2);
  xp_bwd_rec_kernel<R><<<grid, xp_threads(H), smem, (cudaStream_t)stream>>>(pf, pb, T, B,
                                                                           H);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// pass 1's dynamic shared memory at hidden size H and `rows` rows per block
// (ops/gru_window_xp_bwd.py bwd_chain_smem_bytes mirrors it)
long long bigru_window_xp_bwd_chain_smem_bytes(int H, int rows) {
  return (long long)xp_bwd_chain_smem(H, rows);
}

// Pass 1: xp_f/xp_b (T, B, 3H), the forward's out_f/out_b (T, B, H), h0,
// the cotangents dout (T, B, H) and dh (B, H) of the final state, W_hh,
// W_hh^T and b_hh per direction. Writes dxp (2, T, B, 3H) (an output:
// [0] forward, [1] backward direction), dhpn (2, T, B, H) (scratch for
// pass 2) and dh0_f/dh0_b (B, H). `rows`: batch rows per block, 8, 4, 2 or 1.
int bigru_window_xp_bwd_rec(const float* xp_f, const float* xp_b, const float* h0_f,
                            const float* h0_b, const float* out_f, const float* out_b,
                            const float* dout_f, const float* dout_b, const float* dhf,
                            const float* dhb, const float* wh_f, const float* whT_f,
                            const float* bh_f, const float* wh_b, const float* whT_b,
                            const float* bh_b, float* dxp, float* dhpn, float* dh0_f,
                            float* dh0_b, int T, int B, int H, int rows, void* stream) {
  if (int e = check_xp_geometry(T, B, H)) return e;
  const size_t n3 = (size_t)T * B * 3 * H, n1 = (size_t)T * B * H;
  const DirXpBwd pf{xp_f, h0_f, out_f, dout_f, dhf, wh_f, whT_f, bh_f,
                    dxp, dhpn, dh0_f};
  const DirXpBwd pb{xp_b, h0_b, out_b, dout_b, dhb, wh_b, whT_b, bh_b,
                    dxp + n3, dhpn + n1, dh0_b};
  switch (rows) {
    case 8: return launch_bwd_rows<8>(pf, pb, T, B, H, stream);
    case 4: return launch_bwd_rows<4>(pf, pb, T, B, H, stream);
    case 2: return launch_bwd_rows<2>(pf, pb, T, B, H, stream);
    case 1: return launch_bwd_rows<1>(pf, pb, T, B, H, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
