// The parity K1/K2 of the main path as two launches each, for Hopper
// (sm_90a), exposed through a plain C ABI and loaded with ctypes by
// helen_tpu_torch/ops/gru_window_smem.py:
//   bigru_window_proj_in1 / _in2: the input projection of both directions
//       over all T * B rows of a window, xp = x W_ih + b_ih, into a
//       (2, T, B, 3H) fp32 scratch; x is the uint8 image read in place
//       (K1) or the previous layer's halves [xa | xb] (K2);
//   bigru_window_rec_smem: the recurrence over that scratch, one block per
//       (ROWS batch rows, direction), with the direction's W_hh held in
//       shared memory for all T steps.
// Together they replace the same Pallas bodies as K1/K2
// (helen_tpu/ops/gru_pallas.py:426 _kernel_inproj1, :474 _kernel_inproj2,
// and helen_tpu/ops/gru_pallas_train.py:259 _fwd_kernel_ip) and compute the
// same function bit for bit as bigru_window_kernel (gru_window.cu), which
// keeps the shapes whose W_hh does not fit a block (H > 136 at 8 rows) and
// the fast tier.
//
// Why they are bit-equal to bigru_window_kernel: every sum is taken in the
// same order. Each projection output is one fmaf chain from 0.0 over
// k = 0, 1, ..., D - 1 in order (K2: over all 2H inputs of [xa | xb] in one
// chain), then + b_ih: what fma_chain and `xr + bias.ir` in gru_step do.
// No split-k, no tensor cores; the zero padding of the last k stage adds
// fmaf(0, 0, acc) = acc. Each h W_hh sum is one fmaf chain over k in order
// from shared memory, and the gates come from the same gru_gates
// (gru_window_common.cuh). Threads split a unit's batch rows, never k.
//
// What bounds them on this card (B=512, T=100, H=128): the projection does
// 7.1 GFLOP (K1, D=90) or 20.1 GFLOP (K2, D=256) of fp32 FMA and writes the
// 157 MB scratch: bound by operations at the 67 TFLOP/s fp32 peak, 0.11 /
// 0.30 ms. The recurrence does 10.1 GFLOP and reads the scratch: bound by
// operations, 0.15 ms, but its T steps run one after another, each a small
// B x 3H x H product spread over 128 blocks; per step and block the W_hh
// reads from shared memory and the FMAs take about the same issue slots.
//
// What the design does about it:
//   * the projection leaves the serial loop: a tiled fp32 product (128 x
//     128 outputs per block of 256 threads, 8 x 8 per thread, k in stages of
//     8 staged in shared memory, double-buffered through registers), grid
//     (row tiles, column tiles, direction);
//   * the recurrence reads no weight from device memory after its start:
//     the block copies its direction's W_hh (196,608 bytes at H=128) into
//     shared memory once with cp.async; h is double-buffered beside it (one
//     __syncthreads() per step), read four k at a time as one float4
//     broadcast; the next step's xp is loaded into registers before the
//     current step's chain;
//   * ROWS (8, 4, 2 or 1 batch rows per block) is the fewest rows whose
//     grid of 2 * ceil(B / ROWS) blocks fits the H100's 132 SMs in one wave
//     (one block per SM: the shared memory), 8 when none does: 8 at B=512
//     (128 blocks), 4 at B=256 (128 blocks); at 2 rows and more two threads
//     share a hidden unit, ROWS / 2 rows each (8 warps at H=128).
//     ops/gru_window_smem.py rec_block_rows states the same rule.
// The scratch costs 2 x 157 MB of device traffic at B=512 (0.09 ms at 3.35
// TB/s), which the design trades for a projection out of the serial chain.
//
// The same file holds K5's cluster design (encdec_cluster_kernel, below): the
// fused encoder+decoder window of _kernel_fused_encdec
// (helen_tpu/ops/gru_pallas.py:756) as one cluster of two CTAs per group of
// ROWS batch rows (gru_window_cluster.cuh), each CTA one direction of both
// layers. Its consumer warps step through REC_SMEM_STEP with the layer's
// W_hh in shared memory, as window_rec_kernel does; its producer warps
// project each chunk of 32 rows through tile_fma_stage / tile_store, as the
// projection pass does. So K5 equals K1 -> K2 bit for bit. What bounds it:
// the same 47.3 GFLOP of fp32 FMA as K1 + K2 at B=512 (0.71 ms at the 67
// TFLOP/s peak), now on the recurrence's SMs only; the projection's 2 x 157
// MB scratch stays in a 98 KB ring per CTA, the encoder's outputs (52 MB)
// cross device memory once each way.

#include "gru_window_cluster.cuh"
#include "gru_window_smem.cuh"

namespace {

// The recurrence block's dynamic shared memory: h double-buffered, then W_hh.
__host__ __device__ inline size_t rec_smem(int H, int rows) {
  return sizeof(float) * (2 * (size_t)rows * round4(H) + 3 * (size_t)H * H);
}

// ---------------------------------------------------------------------------
// The projection pass: the tile product (gru_window_smem.cuh) of the window's
// input rows and W_ih, + b_ih
// ---------------------------------------------------------------------------

int check_proj(int D, int T, int B, int H) {
  if (H < 1 || D < 1 || T < 1 || B < 1 || (long long)T * B > (1LL << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The recurrence with W_hh in shared memory
// ---------------------------------------------------------------------------

// One step of the recurrence for a thread's RPT batch rows of hidden unit j:
// xp + b_ih of the step from nr / nz / nn, h W_hh as one fmaf chain per
// (row, gate) over k in order (as fma_chain), W_hh in shared memory (ws
// [H][3H]), the state HC [RPT][HP] read four k at a time as one float4
// broadcast; then the gates, h' to HX [RPT][HP]. PREFETCH runs once the sums
// are zeroed (the caller loads the next step's xp into nr / nz / nn there),
// EMIT once row i's h' (named h) is in HX. It expects nr, nz, nn, ws, H, H3,
// HP, j and bias in scope. The chain's recurrence (window_rec_kernel) and
// the fused encoder+decoder window's consumer warps (encdec_cluster_kernel)
// both expand it, so they give the same bits; each caller separates the
// steps with its own barrier. It is a macro, not a function: as a
// __device__ function (inlined, the same SASS opcodes) the chain's
// recurrence ran 9% slower at B=512 and 17% at B=256 on the H100.
#define REC_SMEM_STEP(RPT, HC, HX, PREFETCH, EMIT)                                     \
  {                                                                                    \
    float xr[RPT], xz[RPT], xn[RPT], hr[RPT], hz[RPT], hq[RPT];                        \
    _Pragma("unroll") for (int i = 0; i < RPT; ++i) {                                  \
      xr[i] = nr[i];                                                                   \
      xz[i] = nz[i];                                                                   \
      xn[i] = nn[i];                                                                   \
      hr[i] = hz[i] = hq[i] = 0.0f;                                                    \
    }                                                                                  \
    PREFETCH;                                                                          \
    const float* hc = (HC);                                                            \
    int kx = 0;                                                                        \
    _Pragma("unroll 2") for (; kx + 4 <= H; kx += 4) {                                 \
      float4 hv[RPT];                                                                  \
      _Pragma("unroll") for (int i = 0; i < RPT; ++i) {                                \
        hv[i] = *reinterpret_cast<const float4*>(hc + i * HP + kx);                    \
      }                                                                                \
      const float* wk = ws + kx * H3 + j;                                              \
      _Pragma("unroll") for (int q = 0; q < 4; ++q) {                                  \
        const float wr = wk[q * H3], wz = wk[q * H3 + H], wn = wk[q * H3 + 2 * H];     \
        _Pragma("unroll") for (int i = 0; i < RPT; ++i) {                              \
          const float hk = lane(hv[i], q);                                             \
          hr[i] = fmaf(hk, wr, hr[i]);                                                 \
          hz[i] = fmaf(hk, wz, hz[i]);                                                 \
          hq[i] = fmaf(hk, wn, hq[i]);                                                 \
        }                                                                              \
      }                                                                                \
    }                                                                                  \
    for (; kx < H; ++kx) {                                                             \
      const float* wk = ws + kx * H3 + j;                                              \
      const float wr = wk[0], wz = wk[H], wn = wk[2 * H];                              \
      _Pragma("unroll") for (int i = 0; i < RPT; ++i) {                                \
        const float hk = hc[i * HP + kx];                                              \
        hr[i] = fmaf(hk, wr, hr[i]);                                                   \
        hz[i] = fmaf(hk, wz, hz[i]);                                                   \
        hq[i] = fmaf(hk, wn, hq[i]);                                                   \
      }                                                                                \
    }                                                                                  \
    float* hx = (HX);                                                                  \
    _Pragma("unroll") for (int i = 0; i < RPT; ++i) {                                  \
      const float h = gru_gates<false>(xr[i], xz[i], xn[i], hr[i], hz[i], hq[i], bias,  \
                                       hc[i * HP + j]);                                \
      hx[i * HP + j] = h;                                                              \
      EMIT;                                                                            \
    }                                                                                  \
  }

template <int ROWS>
__global__ void __launch_bounds__(REC_MAX_THREADS)
window_rec_kernel(const float* __restrict__ xp, const float* __restrict__ h0_f,
                  const float* __restrict__ h0_b, const float* __restrict__ wh_f,
                  const float* __restrict__ wh_b, const float* __restrict__ bh_f,
                  const float* __restrict__ bh_b, float* __restrict__ out_f,
                  float* __restrict__ out_b, float* __restrict__ hn_f,
                  float* __restrict__ hn_b, int T, int B, int H) {
  constexpr int SPLIT = ROWS >= 2 ? REC_SPLIT : 1;
  constexpr int RPT = ROWS / SPLIT;  // batch rows per thread
  const int dir = blockIdx.y;
  const float* __restrict__ w = dir ? wh_b : wh_f;
  const float* __restrict__ bh = dir ? bh_b : bh_f;
  const float* __restrict__ h0 = dir ? h0_b : h0_f;
  float* __restrict__ out = dir ? out_b : out_f;
  float* __restrict__ hn = dir ? hn_b : hn_f;
  const int H3 = 3 * H, HP = round4(H);
  const int tid = threadIdx.x, nthreads = blockDim.x;  // blockDim.x == SPLIT * H
  const int j = tid % H;                // hidden unit
  const int g = tid / H;                // row group: rows g * RPT .. + RPT - 1
  const int b0 = blockIdx.x * ROWS + g * RPT;

  extern __shared__ __align__(16) float smem[];
  float* hbuf = smem;                // [2][ROWS][HP] the state
  float* ws = smem + 2 * ROWS * HP;  // [H][3H] W_hh, 16-byte aligned

  // W_hh into shared memory, once for all T steps
  stage_async(ws, w, H * H3, tid, nthreads);

  const CellBias bias{0.0f, 0.0f, 0.0f, bh[j], bh[H + j], bh[2 * H + j]};
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + i;
    hbuf[(g * RPT + i) * HP + j] = (b < B) ? h0[(size_t)b * H + j] : 0.0f;
  }
  // xp of one step for the thread's rows: xp + b_ih as gru_step forms it
  const float* __restrict__ xpd = xp + (size_t)dir * T * B * H3;
  float nr[RPT], nz[RPT], nn[RPT];
  auto load_xp = [&](int t) {
    const int tt = dir ? T - 1 - t : t;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int b = b0 + i;
      nr[i] = nz[i] = nn[i] = 0.0f;
      if (b < B) {
        const float* p = xpd + ((size_t)tt * B + b) * H3 + j;
        nr[i] = __ldg(p);
        nz[i] = __ldg(p + H);
        nn[i] = __ldg(p + 2 * H);
      }
    }
  };
  load_xp(0);
  cp_async_wait_all();
  __syncthreads();

  float hlast[RPT];
  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const int tt = dir ? T - 1 - t : t;
    REC_SMEM_STEP(RPT, hbuf + (cur * ROWS + g * RPT) * HP,
                  hbuf + ((cur ^ 1) * ROWS + g * RPT) * HP,
                  if (t + 1 < T) load_xp(t + 1),
                  hlast[i] = h;
                  const int b = b0 + i;
                  if (b < B) out[((size_t)tt * B + b) * H + j] = h);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int b = b0 + i;
    if (b < B) hn[(size_t)b * H + j] = hlast[i];
  }
}

template <int ROWS>
int launch_rec(const float* xp, const float* h0_f, const float* h0_b, const float* wh_f,
               const float* bh_f, const float* wh_b, const float* bh_b, float* out_f,
               float* out_b, float* hn_f, float* hn_b, int T, int B, int H, void* stream) {
  const int threads = (ROWS >= 2 ? REC_SPLIT : 1) * H;
  if (threads > REC_MAX_THREADS) return (int)cudaErrorInvalidValue;
  const size_t smem = rec_smem(H, ROWS);
  if (int e = allow_smem(window_rec_kernel<ROWS>, smem)) return e;
  dim3 grid((B + ROWS - 1) / ROWS, 2);
  window_rec_kernel<ROWS><<<grid, threads, smem, (cudaStream_t)stream>>>(
      xp, h0_f, h0_b, wh_f, wh_b, bh_f, bh_b, out_f, out_b, hn_f, hn_b, T, B, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fused encoder+decoder window (K5) as a cluster of two CTAs per group
// of ROWS batch rows (gru_window_cluster.cuh): the consumer warps step
// through REC_SMEM_STEP with the layer's W_hh in shared memory, the
// producer warps project each chunk of EC_ROWS rows through the tile
// product's arithmetic (tile_fma_stage, tile_store) into a ring in device
// memory (W_hh and h take 204,800 of the 232,448 bytes at H=128, 8 rows:
// the ring's 98 KB would not fit), read back through L2.
// ---------------------------------------------------------------------------

constexpr int ECP_PROD = 192;       // producer threads: 4 rows x ECP_TX columns of threads
constexpr int ECP_CONS_MAX = 256;   // consumer threads at most: REC_SPLIT * H, H <= 128
constexpr int ECP_N = 384;          // the producer tile's columns: 3H <= 384
constexpr int ECP_TX = ECP_PROD / 4;        // threads along the columns
constexpr int ECP_NB = ECP_N / 4 / ECP_TX;  // 4-column groups a thread: an 8 x 4 NB tile
constexpr int ECP_BK = PJ_BK;       // k per producer stage
constexpr int ECP_ALD = EC_ROWS + 4;  // row stride of the transposed A stage

// the block's dynamic shared memory: the ring's mbarriers, h and W_hh as
// the chain's recurrence holds them (rec_smem), the producer's A and W_ih
// stages, double-buffered
inline size_t ecp_smem(int H, int rows) {
  return EC_BAR_BYTES + round16(rec_smem(H, rows)) +
         sizeof(float) * 2 * ECP_BK * (ECP_ALD + ECP_N);
}

__host__ __device__ inline int ecp_consumers(int H, int rows) {
  return round32((rows >= 2 ? REC_SPLIT : 1) * H);
}

// the wrapper's scratch: the boundary [clusters][2][T][rows][H] and the ring
// [2 clusters][EC_STAGES][EC_ROWS][3H], fp32
inline size_t ecp_scratch(int H, int B, int T, int rows) {
  const size_t clusters = (B + rows - 1) / rows;
  return sizeof(float) * clusters * ((size_t)2 * T * rows * H + 2 * EC_STAGES * EC_ROWS * 3 * H);
}

// What both roles of a cluster CTA see: the arguments, the direction (the
// CTA's rank), the cluster's batch rows, and the block's shared memory.
template <int ROWS>
struct EcpBlock {
  static constexpr int SPLIT = ROWS >= 2 ? REC_SPLIT : 1;
  static constexpr int RPT = ROWS / SPLIT;  // batch rows per consumer thread
  static constexpr int C = EC_ROWS / ROWS;  // steps per chunk
  int T, B, H, H3, HP, dir, b0, ncons, nchunks;
  uint64_t* bars;
  float* hbuf;  // [2][ROWS][HP] the state
  float* ws;    // [H][3H] the layer's W_hh
  float* as;    // [2][BK][ALD] the producer's A stages, transposed
  float* bs;    // [2][BK][ECP_N] its W_ih stages
  float* eo;    // the cluster's boundary [2][T][ROWS][H]
  float* ring;  // the CTA's xp ring [EC_STAGES][EC_ROWS][3H]
};

// The consumer warps: each layer's recurrence, stepped by REC_SMEM_STEP as
// in window_rec_kernel, from xp in the ring; the encoder's outputs to the boundary, the
// decoder's to out_f / out_b and hn_f / hn_b. Thread (g, j) owns rows
// g RPT .. + RPT - 1 of hidden unit j; threads past SPLIT * H only meet the
// others.
template <int ROWS>
__device__ __forceinline__ void ecp_consume(const EncdecArgs<float>& p, const EcpBlock<ROWS>& k) {
  constexpr int RPT = EcpBlock<ROWS>::RPT, C = EcpBlock<ROWS>::C;
  const int T = k.T, B = k.B, H = k.H, H3 = k.H3, HP = k.HP, dir = k.dir;
  const float* ws = k.ws;
  const int tid = threadIdx.x;
  const bool active = tid < EcpBlock<ROWS>::SPLIT * H;
  const int j = tid % H, rb = (tid / H) * RPT;
  float hlast[RPT];
  for (int L = 0; L < 2; ++L) {
    if (L == 1) cluster_handoff();
    const DirParams<float>& lp = p.layer(L, dir);
    stage_async(k.ws, lp.w_hh, H * H3, tid, k.ncons);
    const CellBias bias{0.0f, 0.0f, 0.0f, lp.b_hh[j], lp.b_hh[H + j], lp.b_hh[2 * H + j]};
    if (L == 0 && active) {
      const float* __restrict__ h0 = dir ? p.h0_b : p.h0_f;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int b = k.b0 + rb + i;
        k.hbuf[(rb + i) * HP + j] = (b < B) ? h0[(size_t)b * H + j] : 0.0f;
      }
    }
    float nr[RPT], nz[RPT], nn[RPT];
    auto load_xp = [&](int t) {
      const float* xt = k.ring + (size_t)RingPos(L * k.nchunks + t / C).slot * EC_ROWS * H3 +
                        (size_t)((t % C) * ROWS + rb) * H3 + j;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        nr[i] = nz[i] = nn[i] = 0.0f;
        if (k.b0 + rb + i < B) {
          nr[i] = __ldcg(xt + i * H3);
          nz[i] = __ldcg(xt + i * H3 + H);
          nn[i] = __ldcg(xt + i * H3 + 2 * H);
        }
      }
    };
    cp_async_wait_all();
    named_sync(EC_BAR_CONS, k.ncons);
    ring_wait_full(k.bars, L * k.nchunks);
    if (active) load_xp(0);
    float* __restrict__ out = dir ? p.out_b : p.out_f;
    for (int t = 0; t < T; ++t) {
      const int cur = (L * T + t) & 1;
      const int tt = dir ? T - 1 - t : t;
      if (active) {
        REC_SMEM_STEP(RPT, k.hbuf + (cur * ROWS + rb) * HP,
                      k.hbuf + ((cur ^ 1) * ROWS + rb) * HP,
                      if (t + 1 < T) {
                        const int q1 = L * k.nchunks + (t + 1) / C;
                        if ((t + 1) % C == 0) ring_wait_full(k.bars, q1);
                        load_xp(t + 1);
                      },
                      hlast[i] = h;
                      if (L == 0) {
                        // the boundary, at the original time position
                        k.eo[(((size_t)dir * T + tt) * ROWS + rb + i) * H + j] = h;
                      } else if (k.b0 + rb + i < B) {
                        out[((size_t)tt * B + k.b0 + rb + i) * H + j] = h;
                      });
      }
      if (t % C == C - 1 || t == T - 1) {
        mbar_arrive(k.bars + EC_STAGES + RingPos(L * k.nchunks + t / C).slot);
      }
      named_sync(EC_BAR_CONS, k.ncons);
    }
  }
  if (active) {
    float* __restrict__ hn = dir ? p.hn_b : p.hn_f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int b = k.b0 + rb + i;
      if (b < B) hn[(size_t)b * H + j] = hlast[i];
    }
  }
}

// The producer warps: xp = x W_ih + b_ih of each layer, chunk by chunk, in
// the direction's step order, into the ring. Thread (tx, ty) owns rows
// ty*4 + 0..3 and 16 + ty*4 + 0..3, columns c 4 ECP_TX + tx*4 + 0..3 (c <
// ECP_NB) of the chunk's 32 x 384 tile; each output one fmaf chain from 0.0
// over k in order (tile_fma_stage), then + b_ih (tile_store), as the
// chain's projection pass.
template <int ROWS>
__device__ __forceinline__ void ecp_produce(const EncdecArgs<float>& p, const EcpBlock<ROWS>& k) {
  constexpr int C = EcpBlock<ROWS>::C;
  const int T = k.T, B = k.B, H = k.H, H3 = k.H3, dir = k.dir;
  const int pt = threadIdx.x - k.ncons;
  const int tx = pt % ECP_TX, ty = pt / ECP_TX;
  // the A elements the thread stages: (row pt / 8 [+ ECP_PROD / 8], k pt % 8)
  const int ak = pt % ECP_BK;
  const int na = pt < EC_ROWS * ECP_BK - ECP_PROD ? 2 : 1;
  for (int L = 0; L < 2; ++L) {
    if (L == 1) cluster_handoff();
    const DirParams<float>& lp = p.layer(L, dir);
    const int K = L ? 2 * H : p.D;
    const float* __restrict__ w = lp.w_ih;
    const bool wvec = H3 % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    const int stages = (K + ECP_BK - 1) / ECP_BK;
    for (int c = 0; c < k.nchunks; ++c) {
      const int q = L * k.nchunks + c;
      // the rows of the A elements: step c C + m / ROWS, batch row m % ROWS
      const float* erow[2];
      const uint8_t* irow[2];
      bool aok[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = (pt + e * ECP_PROD) / ECP_BK;
        const int s = c * C + m / ROWS, r = m % ROWS;
        aok[e] = e < na && s < T && k.b0 + r < B;
        const int tt = aok[e] ? (dir ? T - 1 - s : s) : 0;
        irow[e] = p.in.img + (long long)(k.b0 + (aok[e] ? r : 0)) * p.in.sb +
                  (long long)(p.in.start + tt) * p.in.sl;
        erow[e] = k.eo + ((size_t)tt * ROWS + r) * H;
      }
      float av[2];
      auto load_a = [&](int k0) {
        const int kk = k0 + ak;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          av[e] = 0.0f;
          if (aok[e] && kk < K) {
            // the decoder's row [eo_f(t) | eo_b(t)]: the backward plane T
            // steps of ROWS rows on
            av[e] = L == 0 ? (float)__ldg(irow[e] + kk)
                           : __ldcg(erow[e] + (kk < H ? kk : (size_t)T * ROWS * H + kk - H));
          }
        }
      };
      auto store_a = [&](int s) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (e < na) k.as[(s * ECP_BK + ak) * ECP_ALD + (pt + e * ECP_PROD) / ECP_BK] = av[e];
        }
      };
      auto fill_b = [&](int s, int k0) {
#pragma unroll
        for (int i = 0; i < ECP_BK * ECP_N / 4 / ECP_PROD; ++i) {
          const int cc = pt + ECP_PROD * i;
          const int kk = k0 + cc / (ECP_N / 4), n = (cc % (ECP_N / 4)) * 4;
          float* d = k.bs + (s * ECP_BK + cc / (ECP_N / 4)) * ECP_N + n;
          if (kk < K && wvec && n + 4 <= H3) {
            cp_async16(d, w + (size_t)kk * H3 + n);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (kk < K && n + e < H3) {
                cp_async4(d + e, w + (size_t)kk * H3 + n + e);
              } else {
                d[e] = 0.0f;
              }
            }
          }
        }
      };
      float acc[8][4 * ECP_NB];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int jj = 0; jj < 4 * ECP_NB; ++jj) acc[i][jj] = 0.0f;
      }
      load_a(0);
      fill_b(0, 0);
      store_a(0);
      cp_async_wait_all();
      named_sync(EC_BAR_PROD, ECP_PROD);
      for (int ks = 0; ks < stages; ++ks) {
        const int s = ks & 1;
        if (ks + 1 < stages) {
          load_a((ks + 1) * ECP_BK);
          fill_b(s ^ 1, (ks + 1) * ECP_BK);
        }
        tile_fma_stage<ECP_BK, ECP_NB>(acc, k.as + s * ECP_BK * ECP_ALD + ty * 4, ECP_ALD, 16,
                                       k.bs + s * ECP_BK * ECP_N + tx * 4, ECP_N, 4 * ECP_TX);
        if (ks + 1 < stages) store_a(s ^ 1);
        cp_async_wait_all();
        named_sync(EC_BAR_PROD, ECP_PROD);
      }
      ring_wait_empty(k.bars, q);
      tile_store<true, ECP_NB>(acc, k.ring + (size_t)RingPos(q).slot * EC_ROWS * H3, H3,
                               EC_ROWS, H3, ty * 4, 16, tx * 4, 4 * ECP_TX, lp.b_ih);
      mbar_arrive(k.bars + RingPos(q).slot);
    }
  }
}

template <int ROWS>
__global__ void __launch_bounds__(ECP_CONS_MAX + ECP_PROD, 1)
encdec_cluster_kernel(EncdecArgs<float> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  EcpBlock<ROWS> k;
  k.T = p.T;
  k.B = p.B;
  k.H = p.H;
  k.H3 = 3 * p.H;
  k.HP = round4(p.H);
  k.dir = (int)cluster_rank();
  const int cl = (int)cluster_id_x();
  k.b0 = cl * ROWS;
  k.ncons = ecp_consumers(p.H, ROWS);
  k.nchunks = (p.T + EcpBlock<ROWS>::C - 1) / EcpBlock<ROWS>::C;
  k.bars = reinterpret_cast<uint64_t*>(smem_raw);
  k.hbuf = reinterpret_cast<float*>(smem_raw + EC_BAR_BYTES);
  k.ws = k.hbuf + 2 * ROWS * k.HP;
  k.as = reinterpret_cast<float*>(smem_raw + EC_BAR_BYTES + round16(rec_smem(p.H, ROWS)));
  k.bs = k.as + 2 * ECP_BK * ECP_ALD;
  k.eo = static_cast<float*>(p.eo) + (size_t)cl * 2 * p.T * ROWS * p.H;
  k.ring = p.ring + (size_t)blockIdx.x * EC_STAGES * EC_ROWS * k.H3;

  ring_init(k.bars, ECP_PROD, k.ncons);
  __syncthreads();
  // the roles split once, so that neither holds the other's registers
  if (threadIdx.x < k.ncons) {
    ecp_consume<ROWS>(p, k);
  } else {
    ecp_produce<ROWS>(p, k);
  }
}

template <int ROWS>
int launch_encdec_cluster(const EncdecArgs<float>& a, size_t smem, void* stream) {
  const int threads = ecp_consumers(a.H, ROWS) + ECP_PROD;
  if (int e = allow_smem(encdec_cluster_kernel<ROWS>, smem)) return e;
  const ClusterLaunch l((a.B + ROWS - 1) / ROWS, threads, smem, stream);
  if (cudaError_t e = cudaLaunchKernelEx(&l.cfg, encdec_cluster_kernel<ROWS>, a)) return (int)e;
  return (int)cudaGetLastError();
}

template <int ROWS>
int active_encdec_cluster(int H) {
  return active_clusters(encdec_cluster_kernel<ROWS>, ecp_consumers(H, ROWS) + ECP_PROD,
                         ecp_smem(H, ROWS));
}

inline bool ecp_takes(int H, int rows, int D, int T, int B) {
  return H >= 1 && 3 * H <= ECP_N && ecp_consumers(H, rows) <= ECP_CONS_MAX && D >= 1 &&
         T >= 1 && B >= 1 && (rows == 1 || rows == 2 || rows == 4 || rows == 8) &&
         (long long)T * B <= (1LL << 30);
}

}  // namespace

extern "C" {

// the recurrence block's dynamic shared memory at hidden size H and `rows`
// batch rows (ops/gru_window_smem.py rec_smem_bytes mirrors it)
long long bigru_window_rec_smem_bytes(int H, int rows) { return (long long)rec_smem(H, rows); }

int bigru_window_rec_max_threads() { return REC_MAX_THREADS; }

// K1's projection: image (B, L, D) uint8 with element strides (sb, sl),
// window columns [start, start + T); xp (2, T, B, 3H) fp32.
int bigru_window_proj_in1(const uint8_t* img, long long sb, long long sl, int start, int D,
                          const float* wi_f, const float* bi_f, const float* wi_b,
                          const float* bi_b, float* xp, int T, int B, int H, void* stream) {
  if (int e = check_proj(D, T, B, H)) return e;
  const ImageRows src{WindowIn{img, sb, sl, start, nullptr, nullptr}, D, B};
  return launch_tile_product<true>(src, T * B, D, 3 * H, wi_f, wi_b, bi_f, bi_b, xp,
                                   stream);
}

// K2's projection: xa, xb (T, B, H) fp32, W_ih (2H, 3H): rows [0, H) take
// xa, [H, 2H) xb; xp (2, T, B, 3H) fp32.
int bigru_window_proj_in2(const float* xa, const float* xb, const float* wi_f,
                          const float* bi_f, const float* wi_b, const float* bi_b, float* xp,
                          int T, int B, int H, void* stream) {
  if (int e = check_proj(2 * H, T, B, H)) return e;
  const PairRows src{xa, xb, H};
  return launch_tile_product<true>(src, T * B, 2 * H, 3 * H, wi_f, wi_b, bi_f, bi_b, xp,
                                   stream);
}

// The recurrence over xp (2, T, B, 3H) from h0_f/h0_b (B, H), W_hh (H, 3H),
// b_hh (3H,) per direction, `rows` (1, 2, 4 or 8) batch rows per block;
// outputs out_f/out_b (T, B, H), hn_f/hn_b (B, H), f32.
int bigru_window_rec_smem(const float* xp, const float* h0_f, const float* h0_b,
                          const float* wh_f, const float* bh_f, const float* wh_b,
                          const float* bh_b, float* out_f, float* out_b, float* hn_f,
                          float* hn_b, int T, int B, int H, int rows, void* stream) {
  if (H < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  switch (rows) {
    case 1:
      return launch_rec<1>(xp, h0_f, h0_b, wh_f, bh_f, wh_b, bh_b, out_f, out_b, hn_f, hn_b,
                           T, B, H, stream);
    case 2:
      return launch_rec<2>(xp, h0_f, h0_b, wh_f, bh_f, wh_b, bh_b, out_f, out_b, hn_f, hn_b,
                           T, B, H, stream);
    case 4:
      return launch_rec<4>(xp, h0_f, h0_b, wh_f, bh_f, wh_b, bh_b, out_f, out_b, hn_f, hn_b,
                           T, B, H, stream);
    case 8:
      return launch_rec<8>(xp, h0_f, h0_b, wh_f, bh_f, wh_b, bh_b, out_f, out_b, hn_f, hn_b,
                           T, B, H, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K5's cluster design: the dynamic shared memory of one CTA, its threads,
// the scratch the wrapper passes (ops/gru_window_encdec.py mirrors them),
// and how many clusters the card holds at once (negative: a CUDA error)
long long transducer_window_encdec_cluster_smem(int H, int rows) {
  return (long long)ecp_smem(H, rows);
}

int transducer_window_encdec_cluster_threads(int H, int rows) {
  return ecp_consumers(H, rows) + ECP_PROD;
}

long long transducer_window_encdec_cluster_scratch(int H, int B, int T, int rows) {
  return (long long)ecp_scratch(H, B, T, rows);
}

int transducer_window_encdec_cluster_active(int H, int rows) {
  switch (rows) {
    case 1: return active_encdec_cluster<1>(H);
    case 2: return active_encdec_cluster<2>(H);
    case 4: return active_encdec_cluster<4>(H);
    case 8: return active_encdec_cluster<8>(H);
    default: return -(int)cudaErrorInvalidValue;
  }
}

// K5 in its cluster design: K5's arguments (gru_window_encdec.cu), `rows`
// (1, 2, 4 or 8) batch rows per cluster, and the scratch of
// transducer_window_encdec_cluster_scratch bytes.
int transducer_window_encdec_cluster(
    const uint8_t* img, long long sb, long long sl, int start, int D, const float* h0_f,
    const float* h0_b, const float* ewi_f, const float* ewh_f, const float* ebi_f,
    const float* ebh_f, const float* ewi_b, const float* ewh_b, const float* ebi_b,
    const float* ebh_b, const float* dwi_f, const float* dwh_f, const float* dbi_f,
    const float* dbh_f, const float* dwi_b, const float* dwh_b, const float* dbi_b,
    const float* dbh_b, float* out_f, float* out_b, float* hn_f, float* hn_b, int T, int B,
    int H, int rows, void* scratch, void* stream) {
  if (!ecp_takes(H, rows, D, T, B)) return (int)cudaErrorInvalidValue;
  const size_t clusters = (B + rows - 1) / rows;
  EncdecArgs<float> a{WindowIn{img, sb, sl, start, nullptr, nullptr},
                      D, h0_f, h0_b,
                      DirParams<float>{ewi_f, ewh_f, ebi_f, ebh_f},
                      DirParams<float>{ewi_b, ewh_b, ebi_b, ebh_b},
                      DirParams<float>{dwi_f, dwh_f, dbi_f, dbh_f},
                      DirParams<float>{dwi_b, dwh_b, dbi_b, dbh_b},
                      out_f, out_b, hn_f, hn_b, scratch,
                      static_cast<float*>(scratch) + clusters * 2 * T * rows * H, T, B, H};
  const size_t smem = ecp_smem(H, rows);
  switch (rows) {
    case 1: return launch_encdec_cluster<1>(a, smem, stream);
    case 2: return launch_encdec_cluster<2>(a, smem, stream);
    case 4: return launch_encdec_cluster<4>(a, smem, stream);
    default: return launch_encdec_cluster<8>(a, smem, stream);
  }
}

}  // extern "C"
