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
//      dh0, which holds the carry during the launch (each thread reads and
//      writes only its own (row, unit) pairs' entries). dxp's r and z blocks
//      and dhp_n are the step's dhp = [drpre | dzpre | dn], written once per
//      time row: the exchange needs no buffer of its own.
//   b. one barrier per direction: each block releases its writes
//      (__threadfence, then an atomic arrival on its direction's counter, a
//      zeroed buffer the wrapper passes per launch) and waits with acquire
//      loads until all C blocks have arrived. A wait past GRID_SPIN_NS traps,
//      so a fault fails the launch instead of hanging the card.
//   c. carry: dh_carry'[b, i] = __fadd_rn(dh z, acc), acc the fmaf chain
//      over k = 0 .. 3H-1 in order of dhp[tt, b, k] W_hh[i, k]. The dhp rows
//      were written by other blocks in this launch, so they are read through
//      L2 only (cp.async.cg, __ldcg).
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
// memory after its start, and 128 SMs share the carry product. True fp32
// FMAs, no tensor cores.
//
// The carry product is register-tiled: each thread holds RPT rows x 2 units
// of sums, in blocks of 256 threads, two warps an SM quarter (grid_tile in
// ops/gru_window_xp_bwd_grid.py, a rule of B passed to the entry as `rpt`:
// 2 rows where 64 rows hold the batch, else 4). Per 4 k it loads a float4 of
// dhp for each of its rows and one of W_hh for each of its units: 4 loads
// feed 16 FMAs at 2 rows, 6 feed 32 at 4, against the one-unit tile's 5 for
// 16. A warp is 8 unit groups x 4 row groups and it alone reads those rows,
// so it fills their ring chunks itself, through cp.async.cg (8 lanes a row:
// each row's 128 bytes of a chunk in one request), and meets only its own
// lanes at a chunk (__syncwarp): no block-wide barrier inside a step's
// product, and each warp keeps S - 1 of its chunks in flight while it sums
// one. The ring's float4 are swizzled (swz), so that the fill's writes and
// the product's reads are free of bank conflicts. The gates of a step use
// the same (row, unit) pairs as its carry, so the thread that adds a pair's
// carry product wrote its dh z; the next step's gate inputs of the first row
// block are loaded into registers while the product runs.

#include "gru_window_grid.cuh"

namespace {

constexpr int BG_UG = 8;             // unit groups: a warp is 8 unit groups x 4 row groups
constexpr int BG_UPT = 2;            // unit slots per thread, BG_UG apart
constexpr int BG_RGW = 32 / BG_UG;   // row groups per warp
constexpr int BG_MAX_UNITS = 16;     // units per block: BG_UG x BG_UPT
constexpr int BG_RG = 32;            // row groups: 256 threads, two warps an SM quarter
constexpr int BG_KC = 16;            // k per chunk; twice that at row blocks of at most 64 rows
constexpr int BG_RING = 8192;        // floats of dhp in the ring: 32 KB
static_assert(BG_MAX_UNITS == BG_UG * BG_UPT, "a block's units fill its unit slots");

// W_hh row stride in shared memory: 3H rounded up to 32 floats, plus 4, so
// the rows of neighbouring units start 4 banks apart
__host__ __device__ inline int grid_wstride(int H) { return (3 * H + 31) / 32 * 32 + 4; }

// the block's dynamic shared memory: its U W_hh rows, then the dhp ring; the
// same at every tile
inline size_t grid_smem(int H, int U) {
  return sizeof(float) * ((size_t)U * grid_wstride(H) + BG_RING);
}

// A chunk of a warp's ring holds its row slots' NF float4 of dhp, float4 f
// of slot s at s NF + (f ^ swz(s, NF)): the 8 float4 a fill writes at once
// (8 of one row, or 4 of two) and the 4 row slots a product load reads (a +
// 4 p, a < 4) fall in distinct groups of 4 banks.
__host__ __device__ constexpr int swz(int s, int nf) { return s * nf / 8 % nf; }

// a thread's row slots a + 4 p share the part of their swizzle that is not
// its own: swz(a + 4 p) = swz(4 p) ^ swz(a), for every a < 4 and p < rpt
__host__ __device__ constexpr bool swz_splits(int nf, int rpt) {
  for (int p = 0; p < rpt; ++p) {
    for (int a = 0; a < 4; ++a) {
      if (swz(a + 4 * p, nf) != (swz(4 * p, nf) ^ swz(a, nf))) return false;
    }
  }
  return true;
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

// RPT: the tile's rows per thread, in 8 RG threads (RG = BG_RG row groups).
// A row block holds SR = RG RPT rows; the thread (ug, rg) = (tid % 8, tid /
// 8) holds the unit slots ug + 8 q, q < 2, and the rows r0 + rg + p RG, p <
// RPT, of each row block, in the gates and in the carry. A warp's
// ring holds S chunks of its WR = 4 RPT rows x KC k (KC = 32 at 64-row
// blocks, else 16), S = BG_RING / (SR KC) at most 16. The next 4 k's
// fragments are loaded while the FMAs of these run, across chunk boundaries
// too; a chunk's stage is refilled as soon as its last fragments are loaded.
template <int RPT>
__global__ void __launch_bounds__(BG_UG * BG_RG, 1)
xp_bwd_rec_grid_kernel(GridDir pf, GridDir pb, const float* __restrict__ hp,
                       float* __restrict__ dxp_all, float* __restrict__ dhpn_all,
                       unsigned* arrive, int T, int B, int H, int U, int C) {
  constexpr int UG = BG_UG, UPT = BG_UPT, RG = BG_RG;
  constexpr int SR = RG * RPT;                // rows per row block
  constexpr int WR = BG_RGW * RPT;            // rows per warp: its ring's row slots
  constexpr int KC = SR <= 64 ? 2 * BG_KC : BG_KC;
  constexpr int NF = KC / 4;                  // float4 of dhp per row and chunk
  constexpr int CH = WR * KC;                 // floats of a warp's chunk
  constexpr int S = BG_RING / (SR * KC) < 16 ? BG_RING / (SR * KC) : 16;  // the ring's chunks
  constexpr int NSLOT = WR * NF / 32;         // a lane's float4 of a fill
  static_assert(S >= 3, "the ring keeps a chunk in flight beyond the next");
  static_assert(NF % 2 == 0, "a chunk's first fragments land in buffer 0");
  static_assert(32 % NF == 0 && NSLOT * 32 == WR * NF, "a lane fills whole float4 of rows");
  static_assert(swz_splits(NF, RPT), "a thread's row slots share its swizzle");
  static_assert(RG % BG_RGW == 0, "whole warps");
  const int dir = blockIdx.x >= C;
  const int c = blockIdx.x - dir * C;
  const GridDir io = dir ? pb : pf;
  const int H2 = 2 * H, H3 = 3 * H, WS = grid_wstride(H);
  const int u0 = c * U;
  const int Uc = min(U, H - u0);  // the last block of a direction may own fewer
  const int tid = threadIdx.x, nthreads = UG * RG;
  const int ug = tid % UG, rg = tid / UG;
  const int ln = tid % 32, warp = tid / 32, a = ln / UG;  // the lane; rg = 4 warp + a

  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                            // [U][WS] the block's W_hh rows
  float* wring = smem + U * WS + warp * S * CH;  // [S][CH] the warp's dhp chunks (swz)

  // the block's W_hh rows into shared memory, once for all T steps; zeros
  // past 3H (the carry chain's padding reads them) and in rows past Uc
  for (int u = 0; u < Uc; ++u) {
    stage_async(ws + u * WS, io.w_hh + (size_t)(u0 + u) * H3, H3, tid, nthreads);
  }
  for (int u = 0; u < U; ++u) {
    for (int k = (u < Uc ? H3 : 0) + tid; k < WS; k += nthreads) ws[u * WS + k] = 0.0f;
  }

  // the thread's units j = u0 + ug + 8 q, their biases and W_hh rows (a unit
  // slot past U reads row 0: its sums are never written)
  int jg[UPT];
  bool uok[UPT];
  CellBias bias[UPT];
  const float* wq[UPT];
#pragma unroll
  for (int q = 0; q < UPT; ++q) {
    const int u = ug + q * UG;
    uok[q] = u < Uc;
    jg[q] = u0 + (uok[q] ? u : 0);
    bias[q] = CellBias{0.0f, 0.0f, 0.0f, io.b_hh[jg[q]], io.b_hh[H + jg[q]],
                       io.b_hh[2 * H + jg[q]]};
    wq[q] = ws + (u < U ? u : 0) * WS;
  }
  // the carry starts at dh_final
  for (int r0 = 0; r0 < B; r0 += SR) {
#pragma unroll
    for (int p = 0; p < RPT; ++p) {
      const int b = r0 + rg + p * RG;
#pragma unroll
      for (int q = 0; q < UPT; ++q) {
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
  const int nch = (H3 + KC - 1) / KC;
  const int nchunks = (B + SR - 1) / SR * nch;  // a step's chunks, row block by row block
  // the lane's fill slots: float4 fk / 4 = l % NF of row slots l / NF + n
  // 32 / NF, slot a' + 4 p' being row 4 warp + a' + p' RG of a row block,
  // at foff[n] in a chunk; ob[g]: float4 g ^ swz(4 p) of the thread's row
  // slot a + 4 p lies at ob[g] + 16 p NF
  const int fk = 4 * (ln % NF);
  int frow[NSLOT], foff[NSLOT], ob[NF];
#pragma unroll
  for (int n = 0; n < NSLOT; ++n) {
    const int sl = ln / NF + n * (32 / NF);
    frow[n] = warp * BG_RGW + sl % BG_RGW + sl / BG_RGW * RG;
    foff[n] = 4 * (sl * NF + (ln % NF ^ swz(sl, NF)));
  }
#pragma unroll
  for (int g = 0; g < NF; ++g) ob[g] = 4 * (a * NF + (g ^ swz(a, NF)));
  cp_async_wait_all();
  __syncthreads();

  // the gate inputs of the thread's pairs in a row block at time t: xp's r,
  // z, n, hp's r, z, n, h_prev, dout
  float gi[RPT][UPT][8];
  auto gate_in = [&](int r0, int t) {
#pragma unroll
    for (int p = 0; p < RPT; ++p) {
      const int b = r0 + rg + p * RG;
#pragma unroll
      for (int q = 0; q < UPT; ++q) {
#pragma unroll
        for (int v = 0; v < 8; ++v) gi[p][q][v] = 0.0f;
        if (b < B && uok[q]) {
          const int j = jg[q];
          const size_t row = (size_t)t * B + b;
          const float* x = io.xp + row * H3 + j;
          const float* h = hpd + row * H3 + j;
          gi[p][q][0] = __ldg(x);
          gi[p][q][1] = __ldg(x + H);
          gi[p][q][2] = __ldg(x + 2 * H);
          gi[p][q][3] = __ldg(h);
          gi[p][q][4] = __ldg(h + H);
          gi[p][q][5] = __ldg(h + 2 * H);
          gi[p][q][6] = hprev_at(io.out, io.h0, dir, t, b, j, T, B, H);
          gi[p][q][7] = __ldg(io.dout + row * H + j);
        }
      }
    }
  };
  bool pre = false;  // the first row block's gate inputs are loaded ahead
  for (int s = 0; s < T; ++s) {
    const int tt = dir ? s : T - 1 - s;

    // a. the gates of the thread's (row, unit) pairs: every input loaded
    // first (the first row block's during the step before), then the
    // cotangent lines
    for (int r0 = 0; r0 < B; r0 += SR) {
      if (r0 > 0 || !pre) gate_in(r0, tt);
#pragma unroll
      for (int p = 0; p < RPT; ++p) {
        const int b = r0 + rg + p * RG;
#pragma unroll
        for (int q = 0; q < UPT; ++q) {
          if (b < B && uok[q]) {
            const int j = jg[q];
            const size_t row = (size_t)tt * B + b;
            const float dh = gi[p][q][7] + io.dh0[(size_t)b * H + j];
            const CellGrad g = gru_cell_bwd(gi[p][q][0], gi[p][q][1], gi[p][q][2], gi[p][q][3],
                                            gi[p][q][4], gi[p][q][5], bias[q], gi[p][q][6], dh);
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

    // b. every block of the direction has written its units of dhp[tt]; the
    // barrier's __syncthreads also ends every warp's reads of its ring
    grid_barrier(ctr, (unsigned)C * (unsigned)(s + 1));

    // c. the carry product over dhp[tt] = [dxp_r | dxp_z | dhp_n]. The fills,
    // in chunk order, each into the warp's next stage: the lane's rows of a
    // row block x k [fk0 + fk, fk0 + fk + 4), zeros past 3H (a row past B is
    // left as it is: it feeds only sums that are never written); one commit
    // group per chunk, empty past the last, so that wait_group counts chunks.
    // The lane's source rows are set once per row block.
    const float* gx = dxp + (size_t)tt * B * H3;
    const float* gn = dhpn + (size_t)tt * B * H;
    int fi = 0, fk0 = 0, fr0 = 0;
    unsigned fval = 0;
    const float *fx[NSLOT], *fn[NSLOT];
    auto fill_rows = [&]() {
      fval = 0;
#pragma unroll
      for (int n = 0; n < NSLOT; ++n) {
        const int b = fr0 + frow[n];
        const bool in = b < B;
        fval |= (unsigned)in << n;
        fx[n] = gx + (size_t)(in ? b : 0) * H3;
        fn[n] = gn + (size_t)(in ? b : 0) * H;
      }
    };
    auto fill = [&](int stage) {
      if (fi < nchunks) {
        float* st = wring + stage * CH;
        const int k = fk0 + fk;
#pragma unroll
        for (int n = 0; n < NSLOT; ++n) {
          if (fval >> n & 1) {
            if (vec && k < H3) {
              cp_async16(st + foff[n], k < H2 ? fx[n] + k : fn[n] + (k - H2));
            } else {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int ke = k + e;
                st[foff[n] + e] =
                    ke < H3 ? __ldcg(ke < H2 ? fx[n] + ke : fn[n] + (ke - H2)) : 0.0f;
              }
            }
          }
        }
        fk0 += KC;
        ++fi;
        if (fk0 == nch * KC) {
          fk0 = 0;
          fr0 += SR;
          fill_rows();
        }
      }
      cp_async_commit();
    };
    float acc[RPT][UPT];
    float dv[2][RPT][4], wv[2][UPT][4];
    // the fragments of 4 k: dhp of the thread's rows, float4 f of the chunk
    // at `st` (row slot a + 4 p), its units' W_hh at k
    auto load = [&](int buf, const float* st, int f, int k) {
#pragma unroll
      for (int p = 0; p < RPT; ++p) {
        const float4 v =
            *reinterpret_cast<const float4*>(st + ob[f ^ swz(4 * p, NF)] + 16 * p * NF);
        dv[buf][p][0] = v.x, dv[buf][p][1] = v.y, dv[buf][p][2] = v.z, dv[buf][p][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < UPT; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(wq[q] + k);
        wv[buf][q][0] = v.x, wv[buf][q][1] = v.y, wv[buf][q][2] = v.z, wv[buf][q][3] = v.w;
      }
    };
    fill_rows();
#pragma unroll
    for (int i = 0; i < S; ++i) fill(i);
    // the next step's first row block's gate inputs, in flight through the
    // product
    pre = s + 1 < T;
    if (pre) gate_in(0, dir ? tt + 1 : tt - 1);
    cp_async_wait_group<S - 1>();
    __syncwarp();
    load(0, wring, 0, 0);
    for (int r0 = 0, cs = 0; r0 < B; r0 += SR) {
#pragma unroll
      for (int p = 0; p < RPT; ++p) {
#pragma unroll
        for (int q = 0; q < UPT; ++q) acc[p][q] = 0.0f;
      }
      for (int ch = 0; ch < nch; ++ch) {
        const float* st = wring + cs * CH;
        const int k0 = ch * KC;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          // the next fragments: this chunk's, else the next chunk's first
          // (past the step's last chunk they are loaded and not used)
          if (f + 1 < NF) {
            load((f + 1) & 1, st, f + 1, k0 + 4 * (f + 1));
          } else {
            // every fragment of this chunk is in registers: the next chunk
            // is in, from every lane, and this chunk's stage takes the chunk
            // S ahead, so that S - 1 chunks are in flight while one is summed
            cp_async_wait_group<S - 2>();
            __syncwarp();
            fill(cs);
            cs = cs + 1 == S ? 0 : cs + 1;
            load((f + 1) & 1, wring + cs * CH, 0, ch + 1 == nch ? 0 : k0 + KC);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int p = 0; p < RPT; ++p) {
#pragma unroll
              for (int q = 0; q < UPT; ++q) {
                acc[p][q] = fmaf(dv[f & 1][p][e], wv[f & 1][q][e], acc[p][q]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < RPT; ++p) {
        const int b = r0 + rg + p * RG;
#pragma unroll
        for (int q = 0; q < UPT; ++q) {
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
      U > BG_MAX_UNITS) {
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
// `rpt`: the tile's rows per thread (ops/gru_window_xp_bwd_grid.py
// grid_tile, a rule of B); a tile with no instance here is refused
// (cudaErrorInvalidValue).
int bigru_window_xp_bwd_rec_grid(const float* xp_f, const float* xp_b, const float* hp,
                                 const float* h0_f, const float* h0_b, const float* out_f,
                                 const float* out_b, const float* dout_f,
                                 const float* dout_b, const float* dhf, const float* dhb,
                                 const float* wh_f, const float* bh_f, const float* wh_b,
                                 const float* bh_b, float* dxp, float* dhpn, float* dh0_f,
                                 float* dh0_b, unsigned* arrive, int T, int B, int H, int U,
                                 int rpt, void* stream) {
  if (int e = check_grid(T, B, H, U)) return e;
  int C = (H + U - 1) / U;
  GridDir pf{xp_f, h0_f, out_f, dout_f, dhf, wh_f, bh_f, dh0_f};
  GridDir pb{xp_b, h0_b, out_b, dout_b, dhb, wh_b, bh_b, dh0_b};
  void* args[] = {&pf, &pb, &hp, &dxp, &dhpn, &arrive, &T, &B, &H, &U, &C};
  const size_t smem = grid_smem(H, U);
  switch (rpt) {
    case 2: return launch_cooperative(xp_bwd_rec_grid_kernel<2>, 2 * C, BG_UG * BG_RG, smem,
                                      args, stream);
    case 4: return launch_cooperative(xp_bwd_rec_grid_kernel<4>, 2 * C, BG_UG * BG_RG, smem,
                                      args, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
