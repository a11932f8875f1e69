// Pass 1 of the xp-stream backward (K4) as a grid-wide recurrence with
// W_hh spread over the SMs' shared memory, for Hopper (sm_90a), exposed
// through a plain C ABI and loaded with ctypes by
// helen_tpu_torch/ops/gru_window_xp_bwd_grid.py. Per layer-window:
//   the gate pass, bigru_window_bwd_hp (gru_window_bwd_smem.cu, unchanged):
//     hp (2, T, B, 3H) = h_prev W_hh per direction, without b_hh, over all
//     T * B rows of the window;
//   bigru_window_xp_bwd_rec_grid (here): the recurrence, one persistent
//     grid of 2 C blocks, C per direction, one per SM, all co-resident
//     (a cooperative launch); block c of a direction holds the W_hh rows of
//     its U hidden units [c U, (c + 1) U) in shared memory for all T steps;
//     writes dxp (2, T, B, 3H), dhp_n (2, T, B, H) for pass 2
//     (gru_window_wgrad.cu) and dh0.
// Together they replace pass 1 of _bwd_kernel
// (helen_tpu/ops/gru_pallas_train.py:166, pallas_call :507) and compute it
// bit for bit as xp_bwd_rec_kernel (gru_window_xp_bwd.cu), which keeps the
// shapes whose W_hh slices do not fit the card's SMs.
//
// Each step s (time tt: t = T-1 .. 0 forward, 0 .. T-1 backward):
//   a. gates: each block, for every batch row b and own unit j, takes the
//      cotangent lines of gru_cell_bwd (gru_window_common.cuh) from xp[tt],
//      hp[tt] + b_hh, h_prev and dh = dout[tt] + carry, and writes
//      dxp[tt, b, {j, H + j, 2H + j}] and dhp_n[tt, b, j]; dh z goes into
//      dh0, which holds the carry during the launch (each block reads and
//      writes only its own units' columns). dxp's r and z blocks and dhp_n
//      are the step's dhp = [drpre | dzpre | dn], written once per time row:
//      the exchange needs no buffer of its own.
//   b. one barrier per direction: each block releases its writes
//      (__threadfence, then an atomic arrival on its direction's counter, a
//      zeroed buffer the wrapper passes per launch) and waits with acquire
//      loads until all C blocks have arrived. A wait past GRID_SPIN_NS traps,
//      so a fault fails the launch instead of hanging the card.
//   c. carry: dh_carry'[b, i] = __fadd_rn(dh z, acc), acc the fmaf chain
//      over k = 0 .. 3H-1 in order of dhp[tt, b, k] W_hh[i, k]: the dhp rows
//      (written by other blocks in this launch, so read through L2 only,
//      cp.async.cg) stream through a double buffer of k-chunks in shared
//      memory; each thread holds GRID_RPT rows of one unit in registers, so
//      a float4 of W_hh feeds 16 FMAs and one of dhp 4.
//
// Why it is bit-equal to xp_bwd_rec_kernel: hp is one fmaf chain from 0.0
// over k in order (the tile product never splits k), as the old kernel's
// hr/hz/hq; both kernels take their cotangents from gru_cell_bwd; the carry
// is one chain over the 3H entries of dhp in order (zero padding past 3H
// adds fmaf(0, w, acc) = acc), finished by __fadd_rn(dh z, acc) in both.
//
// What bounds it on this card (B=64, T=100, H=1024, per launch): 2 T B 3H H
// x 2 = 80.5 GFLOP of carry products, 1.2 ms at the 67 TFLOP/s fp32 peak,
// one step after another; each block reads the step's B x 3H dhp rows from
// L2 (786 KB a step, about 10 GB a launch over 128 blocks). What the design
// does about it: the gate recompute, half of the old kernel's FLOPs, runs
// as the parallel tile product; the recurrence reads no weight from device
// memory after its start, and 128 SMs share the carry product instead of 16
// blocks. Simple and exact first: true fp32 FMAs, no tensor cores.
//
// The shape of a block was measured (helen_tpu_torch/obs/grid_variants.py,
// H100 SXM, B=64, H=1024): 256 threads of 4 rows x 1 unit took the
// recurrence from 9.5 ms at 128 threads of 4 x 2 to 7.7, and 64-k chunks in
// two stages to 7.1 (32 in three: 7.7; 16 in six: 8.8). With one warp per
// scheduler nothing hid the shared-memory latency; each chunk costs a
// __syncthreads.

#include "gru_window_grid.cuh"

namespace {

constexpr int GRID_RPT = 4;          // batch rows per thread, strided by the row groups
constexpr int GRID_UPT = 1;          // hidden units per thread, strided by the unit groups
constexpr int GRID_ROW_GROUPS = 16;  // the most row groups: a row block of 64 rows
constexpr int GRID_ROWS = GRID_RPT * GRID_ROW_GROUPS;
constexpr int GRID_KC = 64;          // k per ring stage of the carry product
constexpr int GRID_KS = GRID_KC + 4; // a stage's row stride: rows 4 banks apart
constexpr int GRID_STAGES = 2;       // chunk ch + 1 lands while chunk ch is summed
constexpr int GRID_MAX_UNITS = 16;   // units per block: at most 16 unit groups
constexpr int GRID_MAX_THREADS = GRID_MAX_UNITS / GRID_UPT * GRID_ROW_GROUPS;

// W_hh row stride in shared memory: 3H rounded up to 32 floats, plus 4, so
// the rows of neighbouring units start 4 banks apart
__host__ __device__ inline int grid_wstride(int H) { return (3 * H + 31) / 32 * 32 + 4; }

// W_hh rows the block holds: U rounded up to whole unit groups (the rows
// past U are zeros, read by the threads whose second unit does not exist)
__host__ __device__ inline int grid_wrows(int U) {
  return (U + GRID_UPT - 1) / GRID_UPT * GRID_UPT;
}

// the block's dynamic shared memory: its W_hh rows, then the dhp ring
inline size_t grid_smem(int H, int U) {
  return sizeof(float) * ((size_t)grid_wrows(U) * grid_wstride(H) +
                          (size_t)GRID_STAGES * GRID_ROWS * GRID_KS);
}

inline int grid_threads(int U, int B) {
  const int ug = (U + GRID_UPT - 1) / GRID_UPT;
  const int rg = (B + GRID_RPT - 1) / GRID_RPT;
  return ug * (rg < GRID_ROW_GROUPS ? rg : GRID_ROW_GROUPS);
}

// one direction's inputs and outputs of the recurrence
struct GridDir {
  const float* xp;        // (T, B, 3H): x W_ih + b_ih
  const float* h0;        // (B, H)
  const float* out;       // (T, B, H): the forward's outputs
  const float* dout;      // (T, B, H)
  const float* dh_final;  // (B, H)
  const float* w_hh;      // (H, 3H)
  const float* b_hh;      // (3H,)
  float* dh0;             // (B, H): the carry during the launch, dh0 at its end
};

__global__ void __launch_bounds__(GRID_MAX_THREADS, 1)
xp_bwd_rec_grid_kernel(GridDir pf, GridDir pb, const float* __restrict__ hp,
                       float* __restrict__ dxp_all, float* __restrict__ dhpn_all,
                       unsigned* arrive, int T, int B, int H, int U, int C) {
  const int dir = blockIdx.x >= C;
  const int c = blockIdx.x - dir * C;
  const GridDir io = dir ? pb : pf;
  const int H3 = 3 * H, WS = grid_wstride(H);
  const int u0 = c * U;
  const int Uc = min(U, H - u0);  // the last block of a direction may own fewer
  const int UG = (U + GRID_UPT - 1) / GRID_UPT;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int RG = nthreads / UG;  // row groups: the host's grid_threads
  const int RB = RG * GRID_RPT;  // rows per row block
  const int ug = tid % UG, rg = tid / UG;

  extern __shared__ __align__(16) float smem[];
  const int UW = grid_wrows(U);
  float* ws = smem;               // [UW][WS] the block's W_hh rows
  float* ring = smem + UW * WS;   // [GRID_STAGES][GRID_ROWS][GRID_KS] dhp chunks

  // the block's W_hh rows into shared memory, once for all T steps; zeros
  // past 3H (the carry chain's padding reads them) and in rows past Uc
  for (int u = 0; u < Uc; ++u) {
    stage_async(ws + u * WS, io.w_hh + (size_t)(u0 + u) * H3, H3, tid, nthreads);
  }
  for (int u = 0; u < UW; ++u) {
    for (int k = (u < Uc ? H3 : 0) + tid; k < WS; k += nthreads) ws[u * WS + k] = 0.0f;
  }

  // the thread's units j = u0 + ug + q UG and their biases
  int jg[GRID_UPT];
  bool uok[GRID_UPT];
  CellBias bias[GRID_UPT];
#pragma unroll
  for (int q = 0; q < GRID_UPT; ++q) {
    const int jl = ug + q * UG;
    uok[q] = jl < Uc;
    jg[q] = u0 + (uok[q] ? jl : 0);
    bias[q] = CellBias{0.0f, 0.0f, 0.0f, io.b_hh[jg[q]], io.b_hh[H + jg[q]],
                       io.b_hh[2 * H + jg[q]]};
  }
  // the carry starts at dh_final; the thread's rows are r0 + rg + p RG
  for (int r0 = 0; r0 < B; r0 += RB) {
#pragma unroll
    for (int p = 0; p < GRID_RPT; ++p) {
      const int b = r0 + rg + p * RG;
#pragma unroll
      for (int q = 0; q < GRID_UPT; ++q) {
        if (b < B && uok[q]) {
          io.dh0[(size_t)b * H + jg[q]] = io.dh_final[(size_t)b * H + jg[q]];
        }
      }
    }
  }

  const size_t dstride = (size_t)T * B * H3;
  const float* __restrict__ hpd = hp + (size_t)dir * dstride;
  float* __restrict__ dxp = dxp_all + (size_t)dir * dstride;
  float* __restrict__ dhpn = dhpn_all + (size_t)dir * T * B * H;
  unsigned* ctr = arrive + dir * GRID_CTR_STRIDE;
  const bool vec = (H & 3) == 0;  // dhp rows 16-byte aligned: cp.async.cg
  const int nch = (H3 + GRID_KC - 1) / GRID_KC;
  cp_async_wait_all();
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int tt = dir ? s : T - 1 - s;

    // a. the gates of the thread's (row, unit) pairs: every input loaded
    // first, then the cotangent lines
    for (int r0 = 0; r0 < B; r0 += RB) {
      float xr[GRID_RPT][GRID_UPT], xz[GRID_RPT][GRID_UPT], xn[GRID_RPT][GRID_UPT];
      float hr[GRID_RPT][GRID_UPT], hz[GRID_RPT][GRID_UPT], hq[GRID_RPT][GRID_UPT];
      float hv[GRID_RPT][GRID_UPT], dh[GRID_RPT][GRID_UPT];
#pragma unroll
      for (int p = 0; p < GRID_RPT; ++p) {
        const int b = r0 + rg + p * RG;
#pragma unroll
        for (int q = 0; q < GRID_UPT; ++q) {
          xr[p][q] = xz[p][q] = xn[p][q] = hr[p][q] = hz[p][q] = hq[p][q] = 0.0f;
          hv[p][q] = dh[p][q] = 0.0f;
          if (b < B && uok[q]) {
            const int j = jg[q];
            const size_t row = (size_t)tt * B + b;
            const float* x = io.xp + row * H3 + j;
            const float* h = hpd + row * H3 + j;
            xr[p][q] = __ldg(x);
            xz[p][q] = __ldg(x + H);
            xn[p][q] = __ldg(x + 2 * H);
            hr[p][q] = __ldg(h);
            hz[p][q] = __ldg(h + H);
            hq[p][q] = __ldg(h + 2 * H);
            hv[p][q] = hprev_at(io.out, io.h0, dir, tt, b, j, T, B, H);
            dh[p][q] = __ldg(io.dout + row * H + j) + io.dh0[(size_t)b * H + j];
          }
        }
      }
#pragma unroll
      for (int p = 0; p < GRID_RPT; ++p) {
        const int b = r0 + rg + p * RG;
#pragma unroll
        for (int q = 0; q < GRID_UPT; ++q) {
          if (b < B && uok[q]) {
            const int j = jg[q];
            const size_t row = (size_t)tt * B + b;
            const CellGrad g = gru_cell_bwd(xr[p][q], xz[p][q], xn[p][q], hr[p][q], hz[p][q],
                                            hq[p][q], bias[q], hv[p][q], dh[p][q]);
            float* d = dxp + row * H3 + j;
            d[0] = g.drpre;
            d[H] = g.dzpre;
            d[2 * H] = g.da;
            dhpn[row * H + j] = g.dn;
            io.dh0[(size_t)b * H + j] = g.dhz;
          }
        }
      }
    }

    // b. every block of the direction has written its units of dhp[tt]
    grid_barrier(ctr, (unsigned)C * (unsigned)(s + 1));

    // c. the carry product over dhp[tt] = [dxp_r | dxp_z | dhp_n]
    const float* gx = dxp + (size_t)tt * B * H3;
    const float* gn = dhpn + (size_t)tt * B * H;
    for (int r0 = 0; r0 < B; r0 += RB) {
      // stage `ch` of the ring: rows [r0, r0 + RB) x k [ch KC, (ch + 1) KC),
      // zeros past B and past 3H; one commit group per stage, empty past the
      // last, so that wait_group counts stages
      auto fill = [&](int ch) {
        if (ch < nch) {
          float* st = ring + (ch % GRID_STAGES) * GRID_ROWS * GRID_KS;
          const int k0 = ch * GRID_KC;
          for (int idx = tid; idx < RB * (GRID_KC / 4); idx += nthreads) {
            const int lr = idx / (GRID_KC / 4);
            const int kk = 4 * (idx - lr * (GRID_KC / 4));
            const int b = r0 + lr, k = k0 + kk;
            float* dst = st + lr * GRID_KS + kk;
            if (b < B && k < H3 && vec) {
              cp_async16(dst, k < 2 * H ? gx + (size_t)b * H3 + k
                                        : gn + (size_t)b * H + (k - 2 * H));
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int ke = k + e;
                dst[e] = (b < B && ke < H3)
                             ? __ldcg(ke < 2 * H ? gx + (size_t)b * H3 + ke
                                                 : gn + (size_t)b * H + (ke - 2 * H))
                             : 0.0f;
              }
            }
          }
        }
        cp_async_commit();
      };
      float acc[GRID_RPT][GRID_UPT];
#pragma unroll
      for (int p = 0; p < GRID_RPT; ++p) {
#pragma unroll
        for (int q = 0; q < GRID_UPT; ++q) acc[p][q] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < GRID_STAGES - 1; ++i) fill(i);
      for (int ch = 0; ch < nch; ++ch) {
        cp_async_wait_group<GRID_STAGES - 2>();
        // stage ch is in; every thread is done with stage ch - 1, whose
        // buffer the next fill overwrites
        __syncthreads();
        fill(ch + GRID_STAGES - 1);
        const float* st = ring + (ch % GRID_STAGES) * GRID_ROWS * GRID_KS + rg * GRID_KS;
        const float* wk = ws + ug * WS + ch * GRID_KC;
#pragma unroll
        for (int kk = 0; kk < GRID_KC; kk += 4) {
          float4 dv[GRID_RPT], wv[GRID_UPT];
#pragma unroll
          for (int p = 0; p < GRID_RPT; ++p) {
            dv[p] = *reinterpret_cast<const float4*>(st + p * RG * GRID_KS + kk);
          }
#pragma unroll
          for (int q = 0; q < GRID_UPT; ++q) {
            wv[q] = *reinterpret_cast<const float4*>(wk + q * UG * WS + kk);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int p = 0; p < GRID_RPT; ++p) {
#pragma unroll
              for (int q = 0; q < GRID_UPT; ++q) {
                acc[p][q] = fmaf(lane(dv[p], e), lane(wv[q], e), acc[p][q]);
              }
            }
          }
        }
      }
      // the ring is refilled by the next row block and the next step
      __syncthreads();
#pragma unroll
      for (int p = 0; p < GRID_RPT; ++p) {
        const int b = r0 + rg + p * RG;
#pragma unroll
        for (int q = 0; q < GRID_UPT; ++q) {
          if (b < B && uok[q]) {
            float* dc = io.dh0 + (size_t)b * H + jg[q];
            *dc = __fadd_rn(*dc, acc[p][q]);  // dh z + dhp W_hh^T, never fused
          }
        }
      }
    }
  }
}

int check_grid(int T, int B, int H, int U) {
  if (H < 1 || T < 1 || B < 1 || (long long)T * B > (1LL << 30) || U < 1 ||
      U > GRID_MAX_UNITS) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// the block's dynamic shared memory at hidden size H and U units per block
// (ops/gru_window_xp_bwd_grid.py grid_smem_bytes mirrors it)
long long bigru_window_xp_bwd_grid_smem_bytes(int H, int U) {
  return (long long)grid_smem(H, U);
}

// the current device's streaming multiprocessors
int gru_window_sm_count() { return device_sm_count(); }

// The recurrence: xp_f/xp_b (T, B, 3H) with b_ih added, hp (2, T, B, 3H) =
// h_prev W_hh without b_hh (bigru_window_bwd_hp); per direction h0, the
// forward's out, dout (T, B, H), dh_final (B, H), W_hh (H, 3H), b_hh (3H,);
// writes dxp (2, T, B, 3H), dhpn (2, T, B, H) and dh0_f/dh0_b (B, H).
// `arrive`: 2 * 32 zeroed uint32, the directions' barrier counters. U units
// per block, ceil(H / U) blocks per direction, all co-resident: a grid the
// card cannot hold at once is refused (cudaErrorCooperativeLaunchTooLarge).
int bigru_window_xp_bwd_rec_grid(const float* xp_f, const float* xp_b, const float* hp,
                                 const float* h0_f, const float* h0_b, const float* out_f,
                                 const float* out_b, const float* dout_f,
                                 const float* dout_b, const float* dhf, const float* dhb,
                                 const float* wh_f, const float* bh_f, const float* wh_b,
                                 const float* bh_b, float* dxp, float* dhpn, float* dh0_f,
                                 float* dh0_b, unsigned* arrive, int T, int B, int H, int U,
                                 void* stream) {
  if (int e = check_grid(T, B, H, U)) return e;
  int C = (H + U - 1) / U;
  GridDir pf{xp_f, h0_f, out_f, dout_f, dhf, wh_f, bh_f, dh0_f};
  GridDir pb{xp_b, h0_b, out_b, dout_b, dhb, wh_b, bh_b, dh0_b};
  void* args[] = {&pf, &pb, &hp, &dxp, &dhpn, &arrive, &T, &B, &H, &U, &C};
  return launch_cooperative(xp_bwd_rec_grid_kernel, 2 * C, grid_threads(U, B),
                            grid_smem(H, U), args, stream);
}

}  // extern "C"
