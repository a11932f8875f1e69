// Pass 1 of the in-projection backward (bwd_rec) as a parallel gate pass, a
// recurrence with W_hh^T in shared memory and a dx product pass, for Hopper
// (sm_90a), exposed through a plain C ABI and loaded with ctypes by
// helen_tpu_torch/ops/gru_window_bwd_smem.py. Per layer-window:
//   the gate pass, over all T * B rows of the window, both directions:
//     xp = x W_ih + b_ih: bigru_window_proj_in1 / _in2 (gru_window_smem.cu);
//     hp = h_prev W_hh:   bigru_window_bwd_hp (here), h_prev the forward
//       output stream shifted one step (out[t-1] forward, out[t+1]
//       backward), h0 at the window boundary; no b_hh;
//   bigru_window_bwd_rec_smem: the recurrence, one block per (ROWS batch
//     rows, direction), the direction's W_hh^T (3H x H) in shared memory for
//     all T steps; writes dxp (2, T, B, 3H), dhp_n (2, T, B, H) for pass 2
//     (gru_window_wgrad.cu) and dh0;
//   bigru_window_bwd_dx (K2-kind layers): dx_dir = dxp_dir W_ih^T over all
//     T * B rows per direction, into (2, T, B, D); the wrapper adds the two.
// Together they replace pass 1 of _bwd_kernel_ip
// (helen_tpu/ops/gru_pallas_train.py:321, pallas_call :612) and compute it
// bit for bit as bwd_rec_kernel (gru_window_bwd.cu), which keeps the shapes
// whose W_hh^T does not fit a block (H > 131 at 8 rows).
//
// Why they are bit-equal to bwd_rec_kernel: every sum is taken in the same
// order. xp is one fmaf chain over k in order, then + b_ih (as bwd_rec_kernel's
// `xr + bir`); hp one chain over k in order without the bias (its `hr`, to
// which the gate lines add b_hh); the cotangents come from the same
// gru_cell_bwd (gru_window_common.cuh); the carry dh z + dhp W_hh^T is one
// chain over the 3H entries of [drpre | dzpre | dn] in order, then + dh z;
// dx one chain over the 3H entries of dxp in order. The tile product
// (gru_window_smem.cuh) never splits k. Threads split a unit's batch rows,
// never k.
//
// What bounds them on this card (B=256, T=100, H=128, per layer-window):
// the gate pass does 2 x 25,600 x 384 x (D + H) x 2 FLOP (8.9 GFLOP at
// D=90, 15.1 at D=256) and writes 157 MB of scratch; the recurrence 5.0
// GFLOP of carry products, one step after another: per step and block a
// small rows x 3H x H product out of shared memory, with a read of W_hh^T
// per 2 or 4 FMAs; dx 10.1 GFLOP at D=256. All bound by operations at the
// 67 TFLOP/s fp32 peak; the recurrence, in practice, by its serial steps.
//
// What the design does about it: only the carry product depends on the
// previous step, so it alone stays in the serial loop. The gate recompute
// and dx, two thirds of the old kernel's FLOPs, run as tiled products over
// the whole window (132 SMs busy, not 64 blocks). The recurrence reads no
// weight from device memory after its start; its per-step inputs (xp, hp,
// h_prev, dout: 8 values per row) are loaded into registers a step ahead;
// dhp is double-buffered in shared memory (one __syncthreads() per step)
// and read four entries at a time as a float4 broadcast. ROWS comes from the
// forward recurrence's rule (ops/gru_window_smem.py rec_block_rows: 4 at
// B=256, 8 at B=512; one wave of 128 blocks).

#include "gru_window_smem.cuh"

namespace {

// one direction's inputs and outputs of the recurrence
struct BwdDir {
  const float* h0;        // (B, H)
  const float* out;       // (T, B, H) the forward's outputs
  const float* dout;      // (T, B, H)
  const float* dh_final;  // (B, H)
  const float* w_hhT;     // (3H, H)
  const float* b_hh;      // (3H,)
  float* dh0;             // (B, H)
};

// The recurrence block's dynamic shared memory: dhp double-buffered (rows of
// 3H rounded up to 4 floats), then W_hh^T.
inline size_t bwd_rec_smem(int H, int rows) {
  return sizeof(float) * (2 * (size_t)rows * round4(3 * H) + 3 * (size_t)H * H);
}

template <int ROWS>
__global__ void __launch_bounds__(REC_MAX_THREADS)
bwd_rec_smem_kernel(const float* __restrict__ xp, const float* __restrict__ hp, BwdDir pf,
                    BwdDir pb, float* __restrict__ dxp_all, float* __restrict__ dhpn_all,
                    int T, int B, int H) {
  constexpr int SPLIT = ROWS >= 2 ? REC_SPLIT : 1;
  constexpr int RPT = ROWS / SPLIT;  // batch rows per thread
  const int dir = blockIdx.y;
  const BwdDir p = dir ? pb : pf;
  const int H3 = 3 * H, GP = round4(H3);
  const int tid = threadIdx.x, nthreads = blockDim.x;  // blockDim.x == SPLIT * H
  const int j = tid % H;                // hidden unit
  const int g = tid / H;                // row group: rows g * RPT .. + RPT - 1
  const int b0 = blockIdx.x * ROWS + g * RPT;

  extern __shared__ __align__(16) float smem[];
  float* gbuf = smem;                // [2][ROWS][GP] dhp of the step
  float* ws = smem + 2 * ROWS * GP;  // [3H][H] W_hh^T, 16-byte aligned

  // W_hh^T into shared memory, once for all T steps
  stage_async(ws, p.w_hhT, H3 * H, tid, nthreads);

  const CellBias bias{0.0f, 0.0f, 0.0f, p.b_hh[j], p.b_hh[H + j], p.b_hh[2 * H + j]};
  const size_t dstride = (size_t)T * B * H3;
  const float* __restrict__ xpd = xp + (size_t)dir * dstride;
  const float* __restrict__ hpd = hp + (size_t)dir * dstride;
  float* __restrict__ dxp = dxp_all + (size_t)dir * dstride;
  float* __restrict__ dhpn = dhpn_all + (size_t)dir * T * B * H;

  float dhc[RPT];  // dh_carry of unit j for the thread's rows
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + i;
    dhc[i] = (b < B) ? p.dh_final[(size_t)b * H + j] : 0.0f;
  }
  // one step's inputs for the thread's rows: xp (b_ih added), h_prev W_hh
  // (without b_hh), h_prev and dout; zeros past B
  float nxr[RPT], nxz[RPT], nxn[RPT], nhr[RPT], nhz[RPT], nhq[RPT], nhp[RPT], ndo[RPT];
  auto load = [&](int s) {
    const int tt = dir ? s : T - 1 - s;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int b = b0 + i;
      nxr[i] = nxz[i] = nxn[i] = nhr[i] = nhz[i] = nhq[i] = nhp[i] = ndo[i] = 0.0f;
      if (b < B) {
        const size_t row = (size_t)tt * B + b;
        const float* x = xpd + row * H3 + j;
        const float* h = hpd + row * H3 + j;
        nxr[i] = __ldg(x);
        nxz[i] = __ldg(x + H);
        nxn[i] = __ldg(x + 2 * H);
        nhr[i] = __ldg(h);
        nhz[i] = __ldg(h + H);
        nhq[i] = __ldg(h + 2 * H);
        nhp[i] = hprev_at(p.out, p.h0, dir, tt, b, j, T, B, H);
        ndo[i] = __ldg(p.dout + row * H + j);
      }
    }
  };
  load(0);
  cp_async_wait_all();
  __syncthreads();

  // the forward direction unwinds t = T-1 .. 0, the backward t = 0 .. T-1
  for (int s = 0; s < T; ++s) {
    const int tt = dir ? s : T - 1 - s;
    float xr[RPT], xz[RPT], xn[RPT], hr[RPT], hz[RPT], hq[RPT], hv[RPT], dv[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      xr[i] = nxr[i];
      xz[i] = nxz[i];
      xn[i] = nxn[i];
      hr[i] = nhr[i];
      hz[i] = nhz[i];
      hq[i] = nhq[i];
      hv[i] = nhp[i];
      dv[i] = ndo[i];
    }
    if (s + 1 < T) load(s + 1);
    float* gb = gbuf + ((s & 1) * ROWS + g * RPT) * GP;
    float dhz[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const CellGrad c = gru_cell_bwd(xr[i], xz[i], xn[i], hr[i], hz[i], hq[i], bias, hv[i],
                                      dv[i] + dhc[i]);
      gb[i * GP + j] = c.drpre;
      gb[i * GP + H + j] = c.dzpre;
      gb[i * GP + 2 * H + j] = c.dn;
      dhz[i] = c.dhz;
      const int b = b0 + i;
      if (b < B) {
        const size_t row = (size_t)tt * B + b;
        float* d = dxp + row * H3;
        d[j] = c.drpre;
        d[H + j] = c.dzpre;
        d[2 * H + j] = c.da;
        dhpn[row * H + j] = c.dn;
      }
    }
    __syncthreads();

    // dh_carry' = dh z + dhp W_hh^T: one fmaf chain per row over the 3H
    // entries of dhp = [drpre | dzpre | dn] in order
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.0f;
    int k = 0;
#pragma unroll 2
    for (; k + 4 <= H3; k += 4) {
      float4 gv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) gv[i] = *reinterpret_cast<const float4*>(gb + i * GP + k);
      const float* wk = ws + k * H + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float w = wk[q * H];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] = fmaf(lane(gv[i], q), w, acc[i]);
      }
    }
    for (; k < H3; ++k) {
      const float w = ws[k * H + j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] = fmaf(gb[i * GP + k], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) dhc[i] = __fadd_rn(dhz[i], acc[i]);  // never fused
    // gbuf[s & 1] is written again at step s + 2, after every thread has
    // passed step s + 1's __syncthreads(), so after these reads
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + i;
    if (b < B) p.dh0[(size_t)b * H + j] = dhc[i];
  }
}

template <int ROWS>
int launch_rec(const float* xp, const float* hp, const BwdDir& pf, const BwdDir& pb,
               float* dxp, float* dhpn, int T, int B, int H, void* stream) {
  const int threads = (ROWS >= 2 ? REC_SPLIT : 1) * H;
  if (threads > REC_MAX_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_rec_smem(H, ROWS);
  if (int e = allow_smem(bwd_rec_smem_kernel<ROWS>, smem)) return e;
  dim3 grid((B + ROWS - 1) / ROWS, 2);
  bwd_rec_smem_kernel<ROWS><<<grid, threads, smem, (cudaStream_t)stream>>>(
      xp, hp, pf, pb, dxp, dhpn, T, B, H);
  return (int)cudaGetLastError();
}

int check_window(int T, int B, int H) {
  if (H < 1 || T < 1 || B < 1 || (long long)T * B > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// the recurrence block's dynamic shared memory at hidden size H and `rows`
// batch rows (ops/gru_window_bwd_smem.py bwd_rec_smem_bytes mirrors it)
long long bigru_window_bwd_rec_smem_bytes(int H, int rows) {
  return (long long)bwd_rec_smem(H, rows);
}

// hp (2, T, B, 3H) = h_prev W_hh per direction, without b_hh; out_f/out_b
// (T, B, H) the forward's outputs, h0_f/h0_b (B, H), W_hh (H, 3H).
int bigru_window_bwd_hp(const float* h0_f, const float* h0_b, const float* out_f,
                        const float* out_b, const float* wh_f, const float* wh_b, float* hp,
                        int T, int B, int H, void* stream) {
  if (int e = check_window(T, B, H)) return e;
  const HprevRows src{out_f, out_b, h0_f, h0_b, T, B, H};
  return launch_tile_product<false>(src, T * B, H, 3 * H, wh_f, wh_b, nullptr, nullptr, hp,
                                    stream);
}

// The recurrence over xp and hp (2, T, B, 3H); per direction h0, out,
// dout, dh_final, W_hh^T (3H, H), b_hh; writes dxp (2, T, B, 3H), dhpn
// (2, T, B, H) and dh0_f/dh0_b (B, H); `rows` (1, 2, 4 or 8) batch rows per
// block.
int bigru_window_bwd_rec_smem(const float* xp, const float* hp, const float* h0_f,
                              const float* h0_b, const float* out_f, const float* out_b,
                              const float* dout_f, const float* dout_b, const float* dhf,
                              const float* dhb, const float* whT_f, const float* whT_b,
                              const float* bh_f, const float* bh_b, float* dxp, float* dhpn,
                              float* dh0_f, float* dh0_b, int T, int B, int H, int rows,
                              void* stream) {
  if (int e = check_window(T, B, H)) return e;
  const BwdDir pf{h0_f, out_f, dout_f, dhf, whT_f, bh_f, dh0_f};
  const BwdDir pb{h0_b, out_b, dout_b, dhb, whT_b, bh_b, dh0_b};
  switch (rows) {
    case 1:
      return launch_rec<1>(xp, hp, pf, pb, dxp, dhpn, T, B, H, stream);
    case 2:
      return launch_rec<2>(xp, hp, pf, pb, dxp, dhpn, T, B, H, stream);
    case 4:
      return launch_rec<4>(xp, hp, pf, pb, dxp, dhpn, T, B, H, stream);
    case 8:
      return launch_rec<8>(xp, hp, pf, pb, dxp, dhpn, T, B, H, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// dx (2, T, B, D) = dxp W_ih^T per direction: dxp (2, T, B, 3H), W_ih^T
// (3H, D) per direction.
int bigru_window_bwd_dx(const float* dxp, const float* wiT_f, const float* wiT_b, float* dx,
                        int T, int B, int H, int D, void* stream) {
  if (int e = check_window(T, B, H)) return e;
  if (D < 1) return (int)cudaErrorInvalidValue;
  const DenseRows src{dxp, T * B, 3 * H};
  return launch_tile_product<false>(src, T * B, 3 * H, D, wiT_f, wiT_b, nullptr, nullptr, dx,
                                    stream);
}

}  // extern "C"
