// The xp-stream bi-GRU window (K3, and K3f in the fast tier) as a grid-wide
// recurrence with W_hh spread over the SMs' shared memory, for Hopper
// (sm_90a), exposed through a plain C ABI and loaded with ctypes by
// helen_tpu_torch/ops/gru_window_xp_grid.py.
//
// Replaces, as xp_window_kernel (gru_window_xp.cu) does, two Pallas TPU
// kernels that compute the same function, the recurrence of one bi-GRU
// layer over one window whose input projection xp = x W_ih + b_ih was
// computed outside:
//   _kernel     (helen_tpu/ops/gru_pallas.py:231, pallas_call :398), in both
//               tiers (fast=True through bigru_apply_fused, :1080-1091);
//   _fwd_kernel (helen_tpu/ops/gru_pallas_train.py:119, pallas_call :457).
// xp_window_kernel keeps the shapes whose W_hh slices do not fit the card's
// SMs (ops/gru_window_xp.py xp_fwd_design, a rule of the shape, the tier and
// the card).
//
// The grid: one persistent cooperative launch of 2 C blocks, C = ceil(H / U)
// per direction, one block per SM, all co-resident. Block c of a direction
// owns the hidden units [c U, (c + 1) U) and stages the 3U columns of W_hh
// for them (W_hh[:, j], W_hh[:, H + j], W_hh[:, 2H + j]) into shared memory
// once, by cp.async, for all T steps: after that no weight is read from
// device memory. The block loops over row blocks of the batch, so all SMs
// work at any B. Each step s (time tt = s forward, T-1-s backward):
//   1. h_prev streams through a ring of k-chunks in shared memory. Its rows
//      were written by other blocks in this launch, so they are read through
//      L2 only (cp.async.cg, __ldcg).
//   2. the step product hr, hz, hq = h_prev W_hh[:, {j, H + j, 2H + j}] for
//      the block's (row, unit) pairs;
//   3. the gates (gru_gates, gru_window_common.cuh, as xp_window_kernel),
//      out[tt, b, j] and, after the last step, hn;
//   4. one barrier per direction (gru_window_grid.cuh).
//
// K3, the parity tier (xp_grid_kernel): h_prev is out's row tt -/+ 1 (h0 at
// step 0): out is written once per time row anyway, so the exchange needs no
// buffer of its own. Each of the three sums is one fmaf chain from 0.0 over
// k = 0 .. H-1 in order, as xp_window_kernel's; zero padding past H adds
// fmaf(0, w, acc) = acc; the gates are the same gru_gates lines. So the two
// designs give the same bits. The step product is register-tiled, an
// SGEMM's outer product: each thread holds RPT rows x 2 units x 3 gates of
// sums, RPT = 8 (48 sums) above B=128, else 4 (grid_tile in
// ops/gru_window_xp_grid.py), in blocks of 256 threads (128 at B <= 64).
// Per 4 k it loads a float4 of h for each of its rows and its 24 weights,
// k-major, as 4 float4 and 4 float2: at 8 rows 16 loads (56 words) feed 192
// FMAs, 3.4 FMAs a word, twice the one-unit tile's 1.7. A warp is 8 unit
// groups x 4 row groups and it alone reads those rows, so it fills their
// ring chunks itself and meets only its own lanes at a chunk (__syncwarp):
// no block-wide barrier inside a step.
//
// K3f, the fast tier (xp_grid_fast_kernel<NU>): the operand is h rounded to
// bf16, as xp_window_kernel's bf16 copy, exchanged through a bf16 ping-pong
// scratch (2 dirs, 2, B, H) that the wrapper allocates: step s writes buffer
// s & 1 and reads buffer (s - 1) & 1, which no block overwrites before every
// block has passed the barrier after step s. The step product runs on the
// tensor cores, mma.sync.m16n8k16 with bf16 operands and fp32 sums: A is the
// bf16 h chunk (ldmatrix from the ring), B the block's W_hh slice stored as
// [n][k] with its columns gate-major, n = g U8 + u (U rounded up to U8, a
// multiple of 8, with zero columns), so the lane that holds a C-fragment
// element for (row, u) in gate r's tile holds z and n for the same (row, u)
// in the tiles NU and 2 NU further on: the gates need no shuffle. Products
// of bf16 values are exact in fp32; only the order of the fp32 sums differs
// from xp_window_kernel's chain, so K3f's two designs agree to FAST_TOL, not
// to the bit.
//
// What bounds it on this card (B=512, T=100, H=1024, per launch): 644.2
// GFLOP of step products, 9.6 ms at the 67 TFLOP/s fp32 peak for K3 (9.9
// on the 128 SMs the grid uses), 0.65 ms at the 989 TFLOP/s dense bf16 peak
// for K3f, one step after another; each block reads the step's whole h_prev
// from L2 (2 MB fp32 for K3, 1 MB bf16 for K3f, 128 blocks), while W_hh
// stays on chip. K3: what fits at H=1024, U=16 is the k-major W slice
// (196,608 of the 232,448 opt-in bytes) and a 32 KB ring of h: 4 chunks of
// 256 rows x 8 k at 8 rows a thread (256 threads, two warps per SM quarter:
// one alone leaves the FMA pipe idle between its loads), 8 of 64 rows x 16
// k at B=64 (4 rows a thread, 128 threads). The 8-row tile's 48 sums and two sets of fragments
// fill the register file (246 of 255); the gate inputs are prefetched to L2
// and loaded after the product. A chunk's work outside its FMAs (the wait,
// the warp's meeting, the fill's cp.async) is kept to a few instructions:
// with one or two warps per SM quarter, each is an FMA issue slot lost.
// PERF.md has the measurement.

#include "gru_window_grid.cuh"
#include "gru_window_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// K3: fp32 FMA chains in k order
// ---------------------------------------------------------------------------

constexpr int XG_UG = 8;            // unit groups: a warp is 8 unit groups x 4 row groups
constexpr int XG_UPT = 2;           // units per thread, XG_UG apart
constexpr int XG_RGW = 32 / XG_UG;  // row groups per warp
constexpr int XG_MAX_UNITS = 16;    // units per block: XG_UG x XG_UPT
constexpr int XG_MAX_THREADS = 256;  // 8 unit groups x at most 32 row groups
constexpr int XG_KC = 8;            // k per chunk: one 32-byte sector of each row; twice
                                    // that at row blocks of at most 64 rows
constexpr int XG_RING = 8192;       // floats of h in the ring: 32 KB
constexpr int XG_WK = 3 * XG_MAX_UNITS;  // a k-major W row: 8 unit groups x 2 units x 3 gates
static_assert(XG_MAX_UNITS == XG_UG * XG_UPT, "a block's units fill its unit groups");
static_assert(XG_KC % 4 == 0, "a chunk holds whole float4 of h");

// W_hh's rows staged: H rounded up to whole chunks of either size
__host__ __device__ inline int xg_krows(int H) {
  return (H + 2 * XG_KC - 1) / (2 * XG_KC) * (2 * XG_KC);
}

// the block's dynamic shared memory: its W_hh slice, k-major, 3 x 16
// columns (zeros past the block's units) of xg_krows(H) rows, then the h
// ring; the same at every U and every tile
inline size_t xg_smem(int H) {
  return sizeof(float) * ((size_t)XG_WK * xg_krows(H) + XG_RING);
}

// the row groups of the tile of `rpt` rows per thread at batch B: 32 (a row
// block of 256 rows at 8 rows a thread, 128 at 4), or 16 at 4 rows a thread
// where 64 rows hold the batch
inline int xg_row_groups(int B, int rpt) { return rpt == 4 && B <= 64 ? 16 : 32; }

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// 4 floats of shared memory into registers, one vector load
__device__ __forceinline__ void ld_frag4(float (&d)[4], const float* s) {
  const float4 v = *reinterpret_cast<const float4*>(s);
  d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
}

// a thread's 6 weights of one k from a k-major W row: its first 4 at 4 ug,
// the other 2 at 32 + 2 ug (xg_wcol), one float4 and one float2
__device__ __forceinline__ void ld_w6(float (&d)[6], const float* row, int ug) {
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * ug);
  const float2 b = *reinterpret_cast<const float2*>(row + 4 * XG_UG + 2 * ug);
  d[0] = a.x, d[1] = a.y, d[2] = a.z, d[3] = a.w, d[4] = b.x, d[5] = b.y;
}

// the place in a k-major W row of weight j = 3 q + g (unit ug + 8 q, gate g)
// of unit group ug
__host__ __device__ inline int xg_wcol(int ug, int j) {
  return j < 4 ? 4 * ug + j : 4 * XG_UG + 2 * ug + j - 4;
}

// one direction's streams and weights: fp32 (K3) or bf16 (K3f) xp and W_hh
template <typename X>
struct GridXp {
  const X* xp;        // (T, B, 3H): x W_ih + b_ih
  const float* h0;    // (B, H)
  const X* w_hh;      // (H, 3H)
  const float* b_hh;  // (3H,)
  float* out;         // (T, B, H)
  float* hn;          // (B, H)
  __nv_bfloat16* hx;  // K3f: (2, B, H), the bf16 copies of h, ping-pong
};

// one weight into shared memory: fp32 by cp.async (waited for with
// cp_async_wait_all), bf16 (2 bytes, under cp.async's 4) by a load and a store
__device__ __forceinline__ void stage_one(float* d, const float* w) { cp_async4(d, w); }
__device__ __forceinline__ void stage_one(__nv_bfloat16* d, const __nv_bfloat16* w) {
  *d = __ldg(w);
}
__device__ __forceinline__ void set_zero(float* d) { *d = 0.0f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16* d) { *d = __float2bfloat16_rn(0.0f); }

// the block's W_hh columns, gate-major: dst[(g UP + u) ld + k] =
// W_hh[k, g H + u0 + u] for u < Uc, k < H, and zeros up to UP units and ld
// rows; consecutive threads read consecutive units (one row of W_hh)
template <typename X>
__device__ __forceinline__ void stage_columns(X* dst, const X* w, int H, int u0, int Uc,
                                              int UP, int ld, int tid, int nthreads) {
  const int H3 = 3 * H;
  for (int idx = tid; idx < 3 * H * UP; idx += nthreads) {
    const int u = idx % UP, gk = idx / UP;
    const int g = gk / H, k = gk - g * H;
    X* d = dst + (size_t)(g * UP + u) * ld + k;
    if (u < Uc) {
      stage_one(d, w + (size_t)k * H3 + g * H + u0 + u);
    } else {
      set_zero(d);
    }
  }
  for (int idx = tid; idx < 3 * UP * (ld - H); idx += nthreads) {
    const int n = idx / (ld - H);
    set_zero(dst + (size_t)n * ld + H + (idx - n * (ld - H)));
  }
}

// K3's W_hh slice, k-major: dst[k XG_WK + xg_wcol(ug, 3 q + g)] = W_hh[k, g H
// + u0 + ug + 8 q] for the block's units (u < Uc) and k < H, zeros up to HK
// rows and 16 units; by cp.async (waited for with cp_async_wait_all)
__device__ __forceinline__ void stage_kmajor(float* dst, const float* w, int H, int HK, int u0,
                                             int Uc, int tid, int nthreads) {
  for (int idx = tid; idx < HK * XG_WK; idx += nthreads) {
    const int k = idx / XG_WK, ug = idx % XG_UG, j = idx / XG_UG % 6;
    const int u = ug + XG_UG * (j / 3);
    float* d = dst + k * XG_WK + xg_wcol(ug, j);
    if (k < H && u < Uc) {
      cp_async4(d, w + (size_t)k * 3 * H + (j % 3) * H + u0 + u);
    } else {
      *d = 0.0f;
    }
  }
}

// RPT: the tile's rows per thread (8 or 4; grid_tile picks by B); RG:
// its row groups (xg_row_groups), 8 RG threads. A ring stage holds a row
// block, SR = RG RPT rows, of KC = 8 k (16 at 64 rows or fewer), and the
// ring S = XG_RING / (SR KC) chunks, at most 16. The thread (ug, rg) = (tid
// % 8, tid / 8) holds the units u0 + ug + 8 q, q < 2, and the rows r0 + rg +
// p RG, p < RPT, of each row block: RPT x 6 sums. A warp holds 4 row groups,
// and it alone reads their rows: it fills them into the ring itself and
// meets only its own lanes (__syncwarp) at each chunk, never the block, so
// the warps run apart and the ring keeps S - 2 chunks in flight for each.
// Per 4 k a thread loads a float4 of each of its rows and, from the k-major
// W (staged once a launch, so its layout costs nothing), its 6 weights of
// each k as a float4 and a float2. The next 4 k's fragments are loaded while
// the FMAs of these run, across chunk boundaries too.
template <int RPT, int RG>
__global__ void __launch_bounds__(XG_UG * RG, 1)
xp_grid_kernel(GridXp<float> pf, GridXp<float> pb, unsigned* arrive, int T, int B, int H,
               int U, int C) {
  constexpr int UG = XG_UG, UPT = XG_UPT, WK = XG_WK;
  constexpr int SR = RG * RPT, RB = SR;       // rows per stage and per row block
  constexpr int KC = SR <= 64 ? 2 * XG_KC : XG_KC;
  constexpr int NF = KC / 4;                  // float4 of h per row and chunk
  constexpr int S = XG_RING / (SR * KC) < 16 ? XG_RING / (SR * KC) : 16;  // the ring's chunks
  static_assert(S >= 3, "the ring keeps a chunk in flight beyond the next");
  static_assert(NF % 2 == 0, "a chunk's first fragments land in buffer 0");
  static_assert(RG % XG_RGW == 0 && UG * RG <= XG_MAX_THREADS, "whole warps, at most 256");
  constexpr int NSLOT = (XG_RGW * RPT * NF + 31) / 32;  // a lane's float4 of a fill
  const int dir = blockIdx.x >= C;
  const int c = blockIdx.x - dir * C;
  const GridXp<float> io = dir ? pb : pf;
  const int H3 = 3 * H, HK = xg_krows(H);
  const int u0 = c * U;
  const int Uc = min(U, H - u0);  // the last block of a direction may own fewer
  const int tid = threadIdx.x, nthreads = UG * RG;
  const int ug = tid % UG, rg = tid / UG;
  const int lane = tid % 32, rg0 = tid / 32 * XG_RGW;  // the warp's first row group

  extern __shared__ __align__(16) float smem[];
  float* ws = smem;              // [HK][WK] the block's W_hh slice, k-major
  float* ring = smem + HK * WK;  // [S][SR][KC] h_prev chunks
  stage_kmajor(ws, io.w_hh, H, HK, u0, Uc, tid, nthreads);

  bool uok[UPT];
  int jq[UPT];
  CellBias bias[UPT];
#pragma unroll
  for (int q = 0; q < UPT; ++q) {
    const int u = ug + q * UG;
    uok[q] = u < Uc;
    jq[q] = u0 + (uok[q] ? u : 0);
    bias[q] = CellBias{0.0f, 0.0f, 0.0f, io.b_hh[jq[q]], io.b_hh[H + jq[q]],
                       io.b_hh[2 * H + jq[q]]};
  }
  // the lane's float4 of each fill of its warp's rows rg0 + a + p RG (a < 4,
  // p < RPT) x KC: float4 number j = lane + 32 n is row slot j / NF = a + 4 p
  // at k offset fk = 4 (j % NF), stage offset foff[n]; -1 past RPT rows
  int frow[NSLOT], foff[NSLOT];
  const int fk = 4 * (lane % NF);
#pragma unroll
  for (int n = 0; n < NSLOT; ++n) {
    const int rp = (lane + 32 * n) / NF;
    const int a = rp % XG_RGW, p = rp / XG_RGW;
    frow[n] = p < RPT ? rg0 + a + p * RG : -1;
    foff[n] = frow[n] * KC + fk;
  }
  unsigned* ctr = arrive + dir * GRID_CTR_STRIDE;
  const bool vec = (H & 3) == 0;  // h rows 16-byte aligned: cp.async.cg
  const int nch = (H + KC - 1) / KC;
  const int nchunks = (B + RB - 1) / RB * nch;  // a step's chunks, row block by row block
  cp_async_wait_all();
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int tt = dir ? T - 1 - s : s;
    const float* hprev = s == 0 ? io.h0 : io.out + (size_t)(dir ? tt + 1 : tt - 1) * B * H;
    // the fills, in chunk order, each into the next stage: the warp's rows
    // [fr0, fr0 + RB) of a row block x k [fk0, fk0 + KC), zeros past H (rows
    // past B are left as they are: they feed only sums that are never
    // written); one commit group per chunk, empty past the last, so that
    // wait_group counts chunks. Each slot's source row and whether it lies
    // in the batch are set once per row block.
    int fi = 0, fk0 = 0, fr0 = 0, fs = 0;
    int fsrc[NSLOT];  // the slots' offsets in h_prev (B H <= 2^30)
    unsigned fval = 0;
    auto fill_rows = [&]() {
      fval = 0;
#pragma unroll
      for (int n = 0; n < NSLOT; ++n) {
        const bool in = frow[n] >= 0 && fr0 + frow[n] < B;
        fval |= (unsigned)in << n;
        fsrc[n] = (in ? fr0 + frow[n] : 0) * H + fk;
      }
    };
    auto fill = [&]() {
      if (fi < nchunks) {
        float* st = ring + fs * SR * KC;
        if (vec && fk0 + KC <= H) {
#pragma unroll
          for (int n = 0; n < NSLOT; ++n) {
            if (fval >> n & 1) cp_async16(st + foff[n], hprev + fsrc[n] + fk0);
          }
        } else {
#pragma unroll
          for (int n = 0; n < NSLOT; ++n) {
            if (fval >> n & 1) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                st[foff[n] + e] = fk0 + fk + e < H ? __ldcg(hprev + fsrc[n] + fk0 + e) : 0.0f;
              }
            }
          }
        }
        fk0 += KC;
        fs = fs + 1 == S ? 0 : fs + 1;
        ++fi;
        if (fk0 == nch * KC) {
          fk0 = 0;
          fr0 += RB;
          fill_rows();
        }
      }
      cp_async_commit();
    };
    float acc[RPT][UPT][3], hv[2][RPT][4], wv[2][4][6];
    // the fragments of 4 k: h of the thread's rows at `st`, its weights of
    // the 4 rows of W from `wk`
    auto load = [&](int buf, const float* st, const float* wk) {
#pragma unroll
      for (int p = 0; p < RPT; ++p) ld_frag4(hv[buf][p], st + p * RG * KC);
#pragma unroll
      for (int e = 0; e < 4; ++e) ld_w6(wv[buf][e], wk + e * WK, ug);
    };
    fill_rows();
#pragma unroll
    for (int i = 0; i < S - 1; ++i) fill();
    cp_async_wait_group<S - 2>();
    __syncwarp();
    load(0, ring + rg * KC, ws);
    for (int r0 = 0, cs = 0; r0 < B; r0 += RB) {
#pragma unroll
      for (int p = 0; p < RPT; ++p) {
#pragma unroll
        for (int q = 0; q < UPT; ++q) acc[p][q][0] = acc[p][q][1] = acc[p][q][2] = 0.0f;
        // the block's 16 units of a gate lie in one 64-byte run of xp
        const int b = r0 + rg + p * RG;
        if (ug == 0 && b < B) {
#pragma unroll
          for (int g = 0; g < 3; ++g) prefetch_l2(io.xp + ((size_t)tt * B + b) * H3 + g * H + u0);
        }
      }
      for (int ch = 0; ch < nch; ++ch) {
        cp_async_wait_group<S - 3>();
        // the next chunk is in, from every lane; every lane is done with the
        // chunk before this one, whose stage the next fill overwrites
        __syncwarp();
        fill();
        const int cn = cs + 1 == S ? 0 : cs + 1;
        const float* st = ring + cs * SR * KC + rg * KC;
        const float* wk = ws + ch * KC * WK;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          // the next fragments: this chunk's, else the next chunk's first
          // (past the step's last chunk they are loaded and not used)
          if (f + 1 < NF) {
            load((f + 1) & 1, st + (f + 1) * 4, wk + (f + 1) * 4 * WK);
          } else {
            load((f + 1) & 1, ring + cn * SR * KC + rg * KC,
                 ws + (ch + 1 == nch ? 0 : (ch + 1) * KC) * WK);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
#pragma unroll
            for (int p = 0; p < RPT; ++p) {
#pragma unroll
              for (int j = 0; j < 6; ++j) {
                float& a = acc[p][j / 3][j % 3];
                a = fmaf(hv[f & 1][p][e], wv[f & 1][e][j], a);
              }
            }
          }
        }
        cs = cn;
      }
      // the gates: every input loaded before the first is used
      float gx[RPT][UPT][3], gh[RPT][UPT];
#pragma unroll
      for (int p = 0; p < RPT; ++p) {
        const int b = r0 + rg + p * RG;
#pragma unroll
        for (int q = 0; q < UPT; ++q) {
          gx[p][q][0] = gx[p][q][1] = gx[p][q][2] = gh[p][q] = 0.0f;
          if (b < B && uok[q]) {
            const float* x = io.xp + ((size_t)tt * B + b) * H3 + jq[q];
            gx[p][q][0] = __ldg(x);
            gx[p][q][1] = __ldg(x + H);
            gx[p][q][2] = __ldg(x + 2 * H);
            gh[p][q] = __ldcg(hprev + (size_t)b * H + jq[q]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < RPT; ++p) {
        const int b = r0 + rg + p * RG;
#pragma unroll
        for (int q = 0; q < UPT; ++q) {
          if (b < B && uok[q]) {
            const size_t row = (size_t)tt * B + b;
            const float hnew = gru_gates<false>(gx[p][q][0], gx[p][q][1], gx[p][q][2],
                                                acc[p][q][0], acc[p][q][1], acc[p][q][2],
                                                bias[q], gh[p][q]);
            io.out[row * H + jq[q]] = hnew;
            if (s == T - 1) io.hn[(size_t)b * H + jq[q]] = hnew;
          }
        }
      }
    }
    // every block of the direction has written its units of out[tt]; the
    // barrier's first __syncthreads also frees the ring for the next step
    if (s + 1 < T) grid_barrier(ctr, (unsigned)C * (unsigned)(s + 1));
  }
}

// ---------------------------------------------------------------------------
// K3f: bf16 mma.sync with fp32 sums
// ---------------------------------------------------------------------------

constexpr int XF_WARPS = 8;
constexpr int XF_MT = 2;                        // m16 tiles per warp
constexpr int XF_ROWS = XF_WARPS * XF_MT * 16;  // rows per row block
constexpr int XF_KC = 64;                       // k per ring stage
constexpr int XF_KS = XF_KC + 8;                // a stage's row stride (bf16): 4 banks apart
constexpr int XF_STAGES = 2;
constexpr int XF_MAX_UNITS = 24;                // NU <= 3 tiles of 8 units
constexpr int XF_FILL_ROWS = XF_WARPS * 32 / (XF_KC / 8);  // rows one pass of a fill covers

// W column stride in shared memory (bf16): H rounded up to whole chunks
// (a multiple of 128 bytes), plus 8, so that ldmatrix's 8 rows fall 4 banks apart
__host__ __device__ inline int xf_wstride(int H) { return (H + XF_KC - 1) / XF_KC * XF_KC + 8; }

__host__ __device__ inline int xf_units8(int U) { return (U + 7) / 8 * 8; }

// the block's dynamic shared memory: its W_hh slice (bf16), then the ring
inline size_t xf_smem(int H, int U) {
  return sizeof(__nv_bfloat16) * ((size_t)3 * xf_units8(U) * xf_wstride(H) +
                                  (size_t)XF_STAGES * XF_ROWS * XF_KS);
}

__device__ __forceinline__ __nv_bfloat16 ldcg_bf16(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// NU: the block's units in tiles of 8 (U8 = 8 NU); 3 NU n-tiles, gate-major
template <int NU>
__global__ void __launch_bounds__(XF_WARPS * 32, 1)
xp_grid_fast_kernel(GridXp<__nv_bfloat16> pf, GridXp<__nv_bfloat16> pb, unsigned* arrive,
                    int T, int B, int H, int U, int C) {
  constexpr int U8 = 8 * NU, NT = 3 * NU;
  const int dir = blockIdx.x >= C;
  const int c = blockIdx.x - dir * C;
  const GridXp<__nv_bfloat16> io = dir ? pb : pf;
  const int H3 = 3 * H, WS = xf_wstride(H);
  const int u0 = c * U;
  const int Uc = min(U, H - u0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, ln = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [3 U8][WS]: n, k
  __nv_bfloat16* ring = ws + 3 * U8 * WS;  // [XF_STAGES][XF_ROWS][XF_KS] bf16 h_prev chunks
  stage_columns(ws, io.w_hh, H, u0, Uc, U8, WS, tid, nthreads);

  // the lane's units of each 8-unit tile: u = 8 t + 2 (lane % 4) + {0, 1}
  CellBias bias[NU][2];
#pragma unroll
  for (int t = 0; t < NU; ++t) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int u = 8 * t + 2 * (ln % 4) + q;
      const int jb = u0 + (u < Uc ? u : 0);
      bias[t][q] = CellBias{0.0f, 0.0f, 0.0f, io.b_hh[jb], io.b_hh[H + jb], io.b_hh[2 * H + jb]};
    }
  }
  unsigned* ctr = arrive + dir * GRID_CTR_STRIDE;
  const bool vec = (H & 7) == 0;  // bf16 h rows 16-byte aligned: cp.async.cg
  const int nch = (H + XF_KC - 1) / XF_KC;
  // the thread's 16 bytes of every stage: k offset kq of rows lq + i XF_FILL_ROWS
  const int kq = 8 * (tid % (XF_KC / 8)), lq = tid / (XF_KC / 8);
  cp_async_wait_all();
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int tt = dir ? T - 1 - s : s;
    // the fp32 state (the blend's h) and the bf16 operand of the step
    const float* hprev = s == 0 ? io.h0 : io.out + (size_t)(dir ? tt + 1 : tt - 1) * B * H;
    const __nv_bfloat16* hsrc = io.hx + (size_t)((s + 1) & 1) * B * H;
    __nv_bfloat16* hdst = io.hx + (size_t)(s & 1) * B * H;
    for (int r0 = 0; r0 < B; r0 += XF_ROWS) {
      // stage `ch`: rows [r0, min(r0 + XF_ROWS, B)) x k [ch KC, (ch + 1) KC)
      // of the bf16 h_prev (h0 rounded here at step 0), zeros past H (rows
      // past B feed only sums that are never written)
      const int nr = min(XF_ROWS, B - r0);
      auto fill = [&](int ch) {
        if (ch < nch) {
          const int k = ch * XF_KC + kq;
          __nv_bfloat16* st = ring + (ch % XF_STAGES) * XF_ROWS * XF_KS + lq * XF_KS + kq;
          const size_t row0 = (size_t)(r0 + lq) * H + k;
#pragma unroll
          for (int i = 0; i < XF_ROWS / XF_FILL_ROWS; ++i) {
            if (lq + i * XF_FILL_ROWS < nr) {
              __nv_bfloat16* dst = st + i * XF_FILL_ROWS * XF_KS;
              const size_t at = row0 + (size_t)i * XF_FILL_ROWS * H;
              if (s > 0 && k < H && vec) {
                cp_async16_cg(dst, hsrc + at);
              } else {
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                  float v = 0.0f;
                  if (k + e < H) {
                    v = s == 0 ? bf16_rn(__ldg(io.h0 + at + e))
                               : __bfloat162float(ldcg_bf16(hsrc + at + e));
                  }
                  dst[e] = __float2bfloat16_rn(v);
                }
              }
            }
          }
        }
        cp_async_commit();
      };
      float acc[XF_MT][NT][4];
#pragma unroll
      for (int m = 0; m < XF_MT; ++m) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
        }
      }
      // a warp whose rows all lie past B skips the products
      const bool active = r0 + warp * XF_MT * 16 < B;
#pragma unroll
      for (int i = 0; i < XF_STAGES - 1; ++i) fill(i);
      for (int ch = 0; ch < nch; ++ch) {
        cp_async_wait_group<XF_STAGES - 2>();
        __syncthreads();
        fill(ch + XF_STAGES - 1);
        if (active) {
          const __nv_bfloat16* st = ring + (ch % XF_STAGES) * XF_ROWS * XF_KS;
          const __nv_bfloat16* wk = ws + ch * XF_KC;
#pragma unroll
          for (int kk = 0; kk < XF_KC; kk += 16) {
            // A: rows m0 + lane % 16, k kk + 8 (lane / 16): the fragment's
            // a0..a3 = (g, k 0-7), (g + 8, k 0-7), (g, k 8-15), (g + 8, k 8-15)
            unsigned a[XF_MT][4];
#pragma unroll
            for (int m = 0; m < XF_MT; ++m) {
              ldmatrix_x4(a[m], st + ((warp * XF_MT + m) * 16 + ln % 16) * XF_KS + kk +
                                    8 * (ln / 16));
            }
            // B: n-tile n's rows n 8 + lane % 8 of the [n][k] slice, k 0-7
            // then 8-15; two n-tiles per x4
            unsigned bf[NT][2];
#pragma unroll
            for (int n = 0; n + 1 < NT; n += 2) {
              unsigned r[4];
              ldmatrix_x4(r, wk + (size_t)((n + ln / 16) * 8 + ln % 8) * WS + kk +
                                 8 * ((ln / 8) % 2));
              bf[n][0] = r[0];
              bf[n][1] = r[1];
              bf[n + 1][0] = r[2];
              bf[n + 1][1] = r[3];
            }
            if (NT % 2) {
              unsigned r[2];
              ldmatrix_x2(r, wk + (size_t)((NT - 1) * 8 + ln % 8) * WS + kk +
                                 8 * ((ln / 8) % 2));
              bf[NT - 1][0] = r[0];
              bf[NT - 1][1] = r[1];
            }
#pragma unroll
            for (int m = 0; m < XF_MT; ++m) {
#pragma unroll
              for (int n = 0; n < NT; ++n) mma_bf16(acc[m][n], a[m], bf[n]);
            }
          }
        }
      }
      __syncthreads();
      // the gates: the lane's c0, c1 at row g = lane / 4, units 2 (lane % 4)
      // + {0, 1} of each tile, c2, c3 at row g + 8; r, z, n in tiles t,
      // NU + t, 2 NU + t. Every input is loaded before the first store, so
      // that the loads are in flight together.
      float gx[XF_MT][NU][4][3], gh[XF_MT][NU][4];
#pragma unroll
      for (int m = 0; m < XF_MT; ++m) {
#pragma unroll
        for (int t = 0; t < NU; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = r0 + (warp * XF_MT + m) * 16 + ln / 4 + 8 * (e / 2);
            const int u = 8 * t + 2 * (ln % 4) + (e % 2);
            gx[m][t][e][0] = gx[m][t][e][1] = gx[m][t][e][2] = gh[m][t][e] = 0.0f;
            if (b < B && u < Uc) {
              const __nv_bfloat16* x = io.xp + ((size_t)tt * B + b) * H3 + u0 + u;
              gx[m][t][e][0] = ldg_f(x);
              gx[m][t][e][1] = ldg_f(x + H);
              gx[m][t][e][2] = ldg_f(x + 2 * H);
              gh[m][t][e] = __ldcg(hprev + (size_t)b * H + u0 + u);
            }
          }
        }
      }
#pragma unroll
      for (int m = 0; m < XF_MT; ++m) {
#pragma unroll
        for (int t = 0; t < NU; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int b = r0 + (warp * XF_MT + m) * 16 + ln / 4 + 8 * (e / 2);
            const int u = 8 * t + 2 * (ln % 4) + (e % 2);
            if (b < B && u < Uc) {
              const int jj = u0 + u;
              const float hnew = gru_gates<true>(
                  gx[m][t][e][0], gx[m][t][e][1], gx[m][t][e][2], acc[m][t][e],
                  acc[m][NU + t][e], acc[m][2 * NU + t][e], bias[t][e % 2], gh[m][t][e]);
              io.out[((size_t)tt * B + b) * H + jj] = hnew;
              hdst[(size_t)b * H + jj] = __float2bfloat16_rn(hnew);
              if (s == T - 1) io.hn[(size_t)b * H + jj] = hnew;
            }
          }
        }
      }
    }
    if (s + 1 < T) grid_barrier(ctr, (unsigned)C * (unsigned)(s + 1));
  }
}

int check_grid(int T, int B, int H, int U, int max_units) {
  if (H < 1 || T < 1 || B < 1 || (long long)T * B > (1LL << 30) || U < 1 ||
      U > max_units) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" {

// the block's dynamic shared memory at hidden size H and U units per block,
// in the parity tier (fast = 0) or the fast one (ops/gru_window_xp_grid.py
// grid_smem_bytes mirrors it)
long long bigru_window_xp_grid_smem_bytes(int H, int U, int fast) {
  return (long long)(fast ? xf_smem(H, U) : xg_smem(H));
}

// K3 in the grid design: xp_f, xp_b (T, B, 3H) f32 (x W_ih + b_ih per
// direction), h0 (B, H), W_hh (H, 3H), b_hh (3H,) per direction; writes
// out_f/out_b (T, B, H) in original time order and hn_f/hn_b (B, H).
// `arrive`: 2 * 32 zeroed uint32, the directions' barrier counters. U units
// per block, ceil(H / U) blocks per direction, all co-resident: a grid the
// card cannot hold at once is refused (cudaErrorCooperativeLaunchTooLarge).
// `rpt`: the tile's rows per thread, 8 or 4 (ops/gru_window_xp_grid.py
// grid_tile, a rule of B).
int bigru_window_xp_grid(const float* xp_f, const float* xp_b, const float* h0_f,
                         const float* h0_b, const float* wh_f, const float* bh_f,
                         const float* wh_b, const float* bh_b, float* out_f, float* out_b,
                         float* hn_f, float* hn_b, unsigned* arrive, int T, int B, int H,
                         int U, int rpt, void* stream) {
  if (int e = check_grid(T, B, H, U, XG_MAX_UNITS)) return e;
  int C = (H + U - 1) / U;
  GridXp<float> pf{xp_f, h0_f, wh_f, bh_f, out_f, hn_f, nullptr};
  GridXp<float> pb{xp_b, h0_b, wh_b, bh_b, out_b, hn_b, nullptr};
  void* args[] = {&pf, &pb, &arrive, &T, &B, &H, &U, &C};
  if (rpt != 8 && rpt != 4) return (int)cudaErrorInvalidValue;
  const int rg = xg_row_groups(B, rpt), threads = XG_UG * rg;
  const size_t smem = xg_smem(H);
  switch (rpt * 100 + rg) {
    case 832: return launch_cooperative(xp_grid_kernel<8, 32>, 2 * C, threads, smem, args, stream);
    case 432: return launch_cooperative(xp_grid_kernel<4, 32>, 2 * C, threads, smem, args, stream);
    default: return launch_cooperative(xp_grid_kernel<4, 16>, 2 * C, threads, smem, args, stream);
  }
}

// K3f in the grid design: K3's arguments with bf16 xp streams and bf16 W_hh
// (b_hh, h0 and the outputs fp32), and hx (2 dirs, 2, B, H) bf16, the
// scratch through which the blocks exchange h rounded to bf16.
int bigru_window_xp_fast_grid(const __nv_bfloat16* xp_f, const __nv_bfloat16* xp_b,
                              const float* h0_f, const float* h0_b,
                              const __nv_bfloat16* wh_f, const float* bh_f,
                              const __nv_bfloat16* wh_b, const float* bh_b, float* out_f,
                              float* out_b, float* hn_f, float* hn_b, __nv_bfloat16* hx,
                              unsigned* arrive, int T, int B, int H, int U, void* stream) {
  if (int e = check_grid(T, B, H, U, XF_MAX_UNITS)) return e;
  int C = (H + U - 1) / U;
  GridXp<__nv_bfloat16> pf{xp_f, h0_f, wh_f, bh_f, out_f, hn_f, hx};
  GridXp<__nv_bfloat16> pb{xp_b, h0_b, wh_b, bh_b, out_b, hn_b, hx + (size_t)2 * B * H};
  void* args[] = {&pf, &pb, &arrive, &T, &B, &H, &U, &C};
  const int threads = XF_WARPS * 32;
  const size_t smem = xf_smem(H, U);
  switch (xf_units8(U) / 8) {
    case 1: return launch_cooperative(xp_grid_fast_kernel<1>, 2 * C, threads, smem, args, stream);
    case 2: return launch_cooperative(xp_grid_fast_kernel<2>, 2 * C, threads, smem, args, stream);
    default: return launch_cooperative(xp_grid_fast_kernel<3>, 2 * C, threads, smem, args, stream);
  }
}

}  // extern "C"
