// The fast tier's K1f/K2f as two launches each, on bf16 tensor cores, for
// Hopper (sm_90a), exposed through a plain C ABI and loaded with ctypes by
// helen_tpu_torch/ops/gru_window_smem.py:
//   bigru_window_proj_in1_fast / _in2_fast: the input projection of both
//       directions over all T * B rows of a window, xp = x W_ih + b_ih,
//       into the (2, T, B, 3H) fp32 scratch that the parity projection
//       writes; x is the uint8 image read in place (K1f) or the previous
//       layer's halves [xa | xb] rounded to bf16 (K2f);
//   bigru_window_rec_fast: the recurrence over that scratch, one block per
//       (rows batch rows, direction), the direction's bf16 W_hh held in the
//       block's registers as mma.sync A fragments for all T steps.
// Together they replace the same Pallas bodies as K1f/K2f, run with
// fast=True (helen_tpu/ops/gru_pallas.py:426 _kernel_inproj1, :474
// _kernel_inproj2): one bf16 pass for each product with fp32 sums, and fp32
// gates (_proj_passes and _gru_gates with w_lo None, :190-192, :220-221).
// bigru_window_kernel<FAST> (gru_window.cu) keeps the shapes past
// FR_MAX_H and is what design "chain" forces.
//
// The arithmetic. Every product is bf16 x bf16 on mma.sync.m16n8k16 with
// fp32 sums (gru_window_mma.cuh); a product of two bf16 values is exact in
// fp32, and uint8 image values are exact in bf16. Only the order of the
// sums differs from the plain fast versions (ordered_product's k order): the
// tensor cores add 16 products at a time, and their adds truncate. So the
// pair agrees with bigru_window_kernel<FAST> and with the plain version to
// FAST_TOL, not to the bit. b_ih is added in fp32 after the sum, b_hh inside
// the gates; the gates, z * h and the carried state are fp32 through
// gru_gates<true> (gru_window_common.cuh), the plain fast cell's lines; the
// operand copy of h is rounded to bf16 (nearest even) once per step.
//
// What bounds them on this card (B=512, T=100, H=128): the projection does
// 7.5 GFLOP (K1f, D=90 padded to 96) or 20.1 GFLOP (K2f, D=256) of bf16
// products, 0.008 / 0.020 ms at the 989 TFLOP/s dense bf16 peak, and writes
// the 157 MB scratch (K2f also reads its 52 MB of fp32 halves): bound by
// bytes, 0.048 / 0.063 ms. The recurrence does 10.1 GFLOP, 0.010 ms at that
// peak, but reads the scratch and writes its outputs, 210 MB: bound by
// bytes, 0.063 ms; its T steps run one after another.
//
// What the design does about it:
//   * the projection is a tiled bf16 product: 128 x 128 outputs per block of
//     8 warps (4 along the rows x 2 along the columns, 32 x 64 each: 2 x 8
//     m16n8k16 tiles), k in stages of 32 in shared memory, W_ih's by
//     cp.async. K1f's image rows (90 bytes, not 4-byte aligned) come through
//     registers, double-buffered, and are stored as bf16; K2f's fp32 halves
//     go by cp.async into a 3-stage ring, two stages in flight while one is
//     summed, and are rounded to bf16 as the A fragments are read. The
//     column tiles of a row tile are neighbours in the grid, so its rows are
//     read from device memory once. The epilogue adds b_ih and writes each
//     lane's pairs of columns as float2;
//   * the recurrence puts the gate axis on M and the block's batch rows on
//     N: its warp w owns hidden units [16 w, 16 w + 16) and holds their r,
//     z and n rows of W_hh^T as A fragments in registers (3 x KT x 4, KT =
//     ceil(H / 32) x 2 k tiles: 96 registers at H=128), copied once from
//     shared memory where the block stages W_hh by cp.async. A step is 3 KT
//     mma.sync per warp on the bf16 h of up to 8 rows (B fragments read
//     from a double-buffered shared tile, one barrier per step), each gate
//     summed in two chains (even and odd k tiles) added in fp32; the lane
//     that holds (unit, row) in gate r's tile holds it in z's and n's too,
//     so the gates need no exchange, and each lane keeps its four fp32
//     states in registers;
//   * each lane copies its own 12 xp values of step s + FR_STAGES - 1 into a
//     ring in shared memory by cp.async (4 stages, over the W_hh staging
//     area once the fragments are out), so the scratch's reads are in
//     flight three steps ahead and need no barrier of their own;
//   * rows (8, 4, 2 or 1 per block) follows ops/gru_window_smem.py
//     rec_block_rows: 8 at B=512 (128 blocks), 4 at B=256 (128 blocks).
//
// The same file holds K5f's cluster design (encdec_cluster_fast_kernel,
// below): _kernel_fused_encdec with fast=True (helen_tpu/ops/gru_pallas.py:756)
// as one cluster of two CTAs per group of batch rows (gru_window_cluster.cuh),
// each CTA one direction of both layers. Its consumer warps step through the
// recurrence's pieces (fr_*), its producer warps project each chunk of 32
// rows through mma_k16 / store_acc in the projection pass's order of sums,
// into a ring in shared memory over W_hh's staging area. So K5f equals the
// two-launch K1f -> K2f bit for bit. What bounds it: 47.3 GFLOP of bf16
// products (0.048 ms at the dense bf16 peak) and 59 MB of inputs and
// outputs; the 2 x 157 MB scratch of the chain stays on the SM, the bf16
// boundary (26 MB) crosses device memory once each way; the 200 serial
// steps remain.

#include "gru_window_cluster.cuh"
#include "gru_window_mma.cuh"
#include "gru_window_smem.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// The projection pass
// ---------------------------------------------------------------------------

constexpr int FP_BM = 128;          // product rows per block
constexpr int FP_BN = 128;          // product columns per block
constexpr int FP_BK = 32;           // k per shared-memory stage
constexpr int FP_THREADS = 256;     // 8 warps: 4 along the rows x 2 along the columns
constexpr int FP_AS = FP_BK + 8;    // A row stride, bf16 (K1f) or fp32 (K2f): conflict-free
constexpr int FP_BS = FP_BN + 8;    // B stage row stride (bf16)
constexpr int FP_STAGES = 3;        // K2f's cp.async ring: stages ks + 1, ks + 2 in flight

// K2f's dynamic shared memory: the fp32 A ring, then the bf16 B ring
constexpr size_t FP_PAIR_SMEM = FP_STAGES * (sizeof(float) * FP_BM * FP_AS +
                                             sizeof(bf16) * FP_BK * FP_BS);

// The block's tile: blockIdx.x = row tile * column tiles + column tile, so
// that the column tiles of one row tile run side by side and read its rows
// from L2; blockIdx.y is the direction.
struct ProjTile {
  int m0, n0, dir;
  __device__ ProjTile(int N) {
    const int nt = (N + FP_BN - 1) / FP_BN;
    m0 = (blockIdx.x / nt) * FP_BM;
    n0 = (blockIdx.x % nt) * FP_BN;
    dir = blockIdx.y;
  }
};

// K1f's rows: the uint8 image window, row m = t * B + b at column start + t;
// a4(row, k) returns elements k .. k + 3 as fp32 (0.0 past the depth)
struct ImageRowsFast {
  WindowIn in;
  int D, B;
  __device__ const uint8_t* row(int m) const {
    const int t = m / B, b = m - t * B;
    return in.img + (long long)b * in.sb + (long long)(in.start + t) * in.sl;
  }
  __device__ float4 a4(const uint8_t* r, int k) const {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = k + e < D ? (float)__ldg(r + k + e) : 0.0f;
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

// four fp32 values rounded to bf16 (nearest even), packed
__device__ __forceinline__ uint2 pack_bf16x4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                    *reinterpret_cast<const unsigned*>(&hi));
}

__device__ __forceinline__ unsigned pack_bf16x2(float2 v) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<const unsigned*>(&p);
}

// 8 bf16 of W_ih row k from column n into a B stage, zeros past K and N: by
// cp.async where the 16 bytes lie within the row and are aligned
__device__ __forceinline__ void stage_w8(bf16* d, const bf16* w, int k, int n, int K, int N,
                                         bool wvec) {
  if (k < K && wvec && n + 8 <= N) {
    cp_async16(reinterpret_cast<float*>(d), reinterpret_cast<const float*>(w + (size_t)k * N + n));
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      d[q] = (k < K && n + q < N) ? w[(size_t)k * N + n + q] : __float2bfloat16_rn(0.0f);
    }
  }
}

// The warp's 2 x NT m16n8k16 tiles of one k16 step (NT even): A fragments
// a[2] (its 32 rows), B read transposed from the stage [k][n] (row stride
// ldb, the warp's columns from col0), two n-tiles per x4: matrices (k 0-7,
// tile 2p), (k 8-15, 2p), (k 0-7, 2p + 1), (k 8-15, 2p + 1). The projection
// pass (NT = 8) and the fused encoder+decoder window's producer warps share
// it.
template <int NT>
__device__ __forceinline__ void mma_k16(float (&acc)[2][NT][4], const unsigned (&a)[2][4],
                                        const bf16* bs, int ldb, int kk, int col0, int ln) {
  static_assert(NT % 2 == 0, "two n-tiles per ldmatrix");
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) {
    unsigned r[4];
    ldmatrix_x4_trans(r, bs + (kk + ln % 8 + 8 * ((ln / 8) % 2)) * ldb + col0 +
                             (2 * p + ln / 16) * 8);
    const unsigned b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mma_bf16(acc[i][2 * p], a[i], b0);
      mma_bf16(acc[i][2 * p + 1], a[i], b1);
    }
  }
}

// out = acc + b_ih in fp32: lane (g, q) holds rows g, g + 8 of each m16
// tile at columns 2q, 2q + 1 of each n8 tile, written as float2; the warp's
// rows from m0 (those below M), its columns from n0 (those below N), row m
// at out + m * ldo
template <int NT>
__device__ __forceinline__ void store_acc(const float (&acc)[2][NT][4], float* out, int ldo,
                                          int m0, int M, int n0, int N, const float* bias,
                                          int ln) {
  const bool pairs = ((N | ldo) & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + i * 16 + ln / 4 + 8 * h;
      if (m >= M) continue;
      float* orow = out + (size_t)m * ldo;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + j * 8 + 2 * (ln % 4);
        if (pairs && n + 1 < N) {
          *reinterpret_cast<float2*>(orow + n) =
              make_float2(acc[i][j][2 * h] + __ldg(bias + n),
                          acc[i][j][2 * h + 1] + __ldg(bias + n + 1));
        } else {
          if (n < N) orow[n] = acc[i][j][2 * h] + __ldg(bias + n);
          if (n + 1 < N) orow[n + 1] = acc[i][j][2 * h + 1] + __ldg(bias + n + 1);
        }
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[2][NT][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }
}

// K1f's projection: the image's bytes through registers (its rows are not
// 4-byte aligned), converted to bf16 on the way into a double-buffered A
// stage; W_ih's stage by cp.async
__global__ void __launch_bounds__(FP_THREADS, 2)
proj_image_fast_kernel(ImageRowsFast src, int M, int K, int N, const bf16* __restrict__ w_f,
                       const bf16* __restrict__ w_b, const float* __restrict__ b_f,
                       const float* __restrict__ b_b, float* __restrict__ out, bool wvec) {
  const ProjTile tl(N);
  const bf16* __restrict__ w = tl.dir ? w_b : w_f;
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;

  __shared__ __align__(16) bf16 As[2][FP_BM][FP_AS];  // x rows, [m][k]
  __shared__ __align__(16) bf16 Bs[2][FP_BK][FP_BS];  // W_ih, [k][n]

  // each thread stages k 4 (tid % 8) .. + 3 of A rows tid / 8 + 32 i, and
  // the 8 columns (c % 16) 8 .. + 7 of W rows c / 16, c = tid + 256 i
  const int ak = 4 * (tid % 8), ar = tid / 8;
  const uint8_t* arow[4];
  bool aok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = tl.m0 + ar + 32 * i;
    aok[i] = m < M;
    arow[i] = src.row(aok[i] ? m : 0);
  }
  uint2 av[4];
  auto load_a = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = pack_bf16x4(aok[i] ? src.a4(arow[i], k0 + ak)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
  };
  auto fill_b = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + FP_THREADS * i;
      stage_w8(&Bs[s][c / 16][(c % 16) * 8], w, k0 + c / 16, tl.n0 + (c % 16) * 8, K, N,
               wvec);
    }
    cp_async_commit();
  };
  auto store_a = [&](int s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) *reinterpret_cast<uint2*>(&As[s][ar + 32 * i][ak]) = av[i];
  };

  const int wm = warp % 4, wn = warp / 4;  // the warp's rows wm 32 .., columns wn 64 ..
  float acc[2][8][4];
  zero_acc(acc);
  const int stages = (K + FP_BK - 1) / FP_BK;
  fill_b(0, 0);
  load_a(0);
  store_a(0);
  cp_async_wait_all();
  __syncthreads();
  for (int ks = 0; ks < stages; ++ks) {
    const int s = ks & 1;
    if (ks + 1 < stages) {
      fill_b(s ^ 1, (ks + 1) * FP_BK);
      load_a((ks + 1) * FP_BK);
    }
#pragma unroll
    for (int kk = 0; kk < FP_BK; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldmatrix_x4(a[i], &As[s][wm * 32 + i * 16 + ln % 16][kk + 8 * (ln / 16)]);
      }
      mma_k16(acc, a, &Bs[s][0][0], FP_BS, kk, wn * 64, ln);
    }
    if (ks + 1 < stages) store_a(s ^ 1);
    cp_async_wait_all();
    __syncthreads();
  }
  store_acc(acc, out + (size_t)tl.dir * M * N, N, tl.m0 + wm * 32, M, tl.n0 + wn * 64, N,
            tl.dir ? b_b : b_f, ln);
}

// K2f's projection: the previous layer's fp32 halves, row m = [xa[m] |
// xb[m]], and W_ih both through a FP_STAGES-deep cp.async ring; the A
// fragments are rounded to bf16 (nearest even) as they are read from the
// fp32 stage. vec: H a multiple of 4 and both halves 16-byte aligned (else
// the rows are copied by plain loads and stores)
__global__ void __launch_bounds__(FP_THREADS, 2)
proj_pair_fast_kernel(const float* __restrict__ xa, const float* __restrict__ xb, int H,
                      bool vec, int M, int N, const bf16* __restrict__ w_f,
                      const bf16* __restrict__ w_b, const float* __restrict__ b_f,
                      const float* __restrict__ b_b, float* __restrict__ out, bool wvec) {
  const ProjTile tl(N);
  const bf16* __restrict__ w = tl.dir ? w_b : w_f;
  const int K = 2 * H;
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* af = reinterpret_cast<float*>(smem_raw);  // [STAGES][BM][AS] fp32 rows
  bf16* bs = reinterpret_cast<bf16*>(af + FP_STAGES * FP_BM * FP_AS);  // [STAGES][BK][BS]

  // stage `ks` of the ring: 16 bytes of A (rows tid / 8 + 32 i, k 4 (tid %
  // 8)) and of W (as proj_image_fast_kernel) per thread and copy; one commit
  // group per stage, empty past the last, so that wait_group counts stages
  const int stages = (K + FP_BK - 1) / FP_BK;
  const int ak = 4 * (tid % 8), ar = tid / 8;
  auto fill = [&](int ks) {
    if (ks < stages) {
      const int slot = ks % FP_STAGES, k = ks * FP_BK + ak;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = tl.m0 + ar + 32 * i;
        float* d = af + ((size_t)slot * FP_BM + ar + 32 * i) * FP_AS + ak;
        const float* r = (k < H ? xa + (size_t)m * H + k : xb + (size_t)m * H + (k - H));
        if (m < M && k < K && vec) {
          cp_async16(d, r);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = k + e;
            d[e] = (m >= M || kk >= K) ? 0.0f
                   : kk < H ? xa[(size_t)m * H + kk] : xb[(size_t)m * H + (kk - H)];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = tid + FP_THREADS * i;
        stage_w8(bs + ((size_t)slot * FP_BK + c / 16) * FP_BS + (c % 16) * 8, w,
                 ks * FP_BK + c / 16, tl.n0 + (c % 16) * 8, K, N, wvec);
      }
    }
    cp_async_commit();
  };

  const int wm = warp % 4, wn = warp / 4;
  float acc[2][8][4];
  zero_acc(acc);
#pragma unroll
  for (int i = 0; i < FP_STAGES - 1; ++i) fill(i);
  for (int ks = 0; ks < stages; ++ks) {
    cp_async_wait_group<FP_STAGES - 2>();
    // stage ks is in; every thread is done with stage ks - 1, whose slot
    // the next fill overwrites
    __syncthreads();
    fill(ks + FP_STAGES - 1);
    const float* as = af + (size_t)(ks % FP_STAGES) * FP_BM * FP_AS;
    const bf16* bst = bs + (size_t)(ks % FP_STAGES) * FP_BK * FP_BS;
#pragma unroll
    for (int kk = 0; kk < FP_BK; kk += 16) {
      // A fragments from the fp32 stage: rows g, g + 8 at k 2q and 2q + 8
      unsigned a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* r0 = as + (wm * 32 + i * 16 + ln / 4) * FP_AS + kk + 2 * (ln % 4);
        const float* r1 = r0 + 8 * FP_AS;
        a[i][0] = pack_bf16x2(*reinterpret_cast<const float2*>(r0));
        a[i][1] = pack_bf16x2(*reinterpret_cast<const float2*>(r1));
        a[i][2] = pack_bf16x2(*reinterpret_cast<const float2*>(r0 + 8));
        a[i][3] = pack_bf16x2(*reinterpret_cast<const float2*>(r1 + 8));
      }
      mma_k16(acc, a, bst, FP_BS, kk, wn * 64, ln);
    }
  }
  store_acc(acc, out + (size_t)tl.dir * M * N, N, tl.m0 + wm * 32, M, tl.n0 + wn * 64, N,
            tl.dir ? b_b : b_f, ln);
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int check_proj_fast(int D, int T, int B, int H) {
  if (H < 1 || D < 1 || T < 1 || B < 1 || (long long)T * B > (1LL << 30) ||
      (long long)((T * B + FP_BM - 1) / FP_BM) * ((3 * H + FP_BN - 1) / FP_BN) > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

// the grid of a projection: (row tiles x column tiles, 2 directions)
inline dim3 proj_grid(int M, int N) {
  return dim3((unsigned)(((M + FP_BM - 1) / FP_BM) * ((N + FP_BN - 1) / FP_BN)), 2);
}

// ---------------------------------------------------------------------------
// The recurrence with W_hh^T as A fragments in registers
// ---------------------------------------------------------------------------

constexpr int FR_MAX_H = 160;   // KT <= 10: 120 registers of A fragments a lane
constexpr int FR_ROWS = 8;      // batch rows per block at most: the mma's n
constexpr int FR_STAGES = 4;    // the xp ring: step s + 3 in flight during step s
constexpr int FR_XP = 12;       // xp values a lane reads per step: 4 (unit, row) x 3 gates
constexpr int FR_MAX_THREADS = FR_MAX_H / 16 * 32;

// H rounded up to 16 (the units of the block's warps) and to 32 (the k
// depth of the fragments: an even number of k16 tiles)
__host__ __device__ inline int fr_up(int H) { return (H + 15) / 16 * 16; }
__host__ __device__ inline int fr_kp(int H) { return (H + 31) / 32 * 32; }
// row strides in shared memory (bf16): ldmatrix's 8 rows 16 bytes apart
// modulo 128; the h tile's rows 4 banks apart
__host__ __device__ inline int fr_ldw(int H) { return 3 * fr_up(H) + 8; }
__host__ __device__ inline int fr_ldh(int H) { return fr_kp(H) + 8; }

// the block's dynamic shared memory: the W_hh staging area (then the xp
// ring over it), and h's bf16 operand tile, double-buffered
inline size_t fr_region(int H) {
  const size_t w = sizeof(bf16) * (size_t)fr_kp(H) * fr_ldw(H);
  const size_t ring = sizeof(float) * (size_t)FR_STAGES * FR_XP * (fr_up(H) / 16 * 32);
  return w > ring ? w : ring;
}
inline size_t fr_smem(int H) {
  return fr_region(H) + sizeof(bf16) * 2 * FR_ROWS * (size_t)fr_ldh(H);
}

// ---- the recurrence's step pieces, shared by the chain's recurrence
// (window_rec_fast_kernel) and the fused encoder+decoder window's consumer
// warps (encdec_cluster_fast_kernel), so that the two give the same bits ----

// W_hh (H, 3H) bf16 into the staging area ws [KP][LDW], gate-major columns
// padded to UP units, zeros past H in k and in u: 16 bytes at a time where a
// chunk of 8 units lies within H and the rows are 16-byte aligned. The
// caller waits (cp_async_wait_all) and meets its threads.
__device__ __forceinline__ void fr_stage_whh(bf16* ws, const bf16* __restrict__ w, int H, int KP,
                                             int tid, int nthreads) {
  const int H3 = 3 * H, UP = fr_up(H), LDW = fr_ldw(H);
  const bool wvec = (H % 8) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
  const int chunks = UP / 8;
  for (int idx = tid; idx < KP * 3 * chunks; idx += nthreads) {
    const int k = idx / (3 * chunks), c = idx - k * 3 * chunks;
    const int g = c / chunks, u = (c - g * chunks) * 8;
    bf16* d = ws + (size_t)k * LDW + g * UP + u;
    const bf16* s = w + (size_t)k * H3 + g * H + u;
    if (k < H && wvec && u + 8 <= H) {
      cp_async16(reinterpret_cast<float*>(d), reinterpret_cast<const float*>(s));
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] = (k < H && u + e < H) ? s[e] : __float2bfloat16_rn(0.0f);
      }
    }
  }
}

// the warp's A fragments: rows g UP + 16 warp .. + 15 of W_hh^T, k tile
// kt; stored k-major, so each 8 x 8 matrix is read transposed: lanes 0-7
// (k 0-7, m 0-7), 8-15 (k 0-7, m 8-15), 16-23 (k 8-15, m 0-7), 24-31 (k
// 8-15, m 8-15)
template <int KT>
__device__ __forceinline__ void fr_load_frags(unsigned (&a)[3][KT][4], const bf16* ws, int H,
                                              int warp, int ln) {
  const int UP = fr_up(H), LDW = fr_ldw(H);
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      ldmatrix_x4_trans(a[g][kt], ws + (size_t)(kt * 16 + ln % 8 + 8 * (ln / 16)) * LDW +
                                      g * UP + warp * 16 + 8 * ((ln / 8) % 2));
    }
  }
}

// the lane's (unit, row) pairs e = 0..3: unit 16 warp + ln / 4 + 8 (e / 2),
// row 2 (ln % 4) + e % 2 (the C fragment's c0..c3); ok where the unit is
// below H and the row below `rows` and B
__device__ __forceinline__ void fr_pairs(int (&unit)[4], int (&brow)[4], bool (&ok)[4], int warp,
                                         int ln, int H, int rows, int b0, int B) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    unit[e] = warp * 16 + ln / 4 + 8 * (e / 2);
    brow[e] = 2 * (ln % 4) + e % 2;
    ok[e] = unit[e] < H && brow[e] < rows && b0 + brow[e] < B;
  }
}

__device__ __forceinline__ void fr_bias(CellBias (&bias)[2], const int (&unit)[4],
                                        const float* __restrict__ bh, int H) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = unit[2 * i] < H ? unit[2 * i] : 0;
    bias[i] = CellBias{0.0f, 0.0f, 0.0f, bh[j], bh[H + j], bh[2 * H + j]};
  }
}

// the product bf16(h) W_hh for the warp's 16 units x 8 rows, per gate, from
// the lane's place hc in the h tile: two sums, over the even and the odd k
// tiles, so that each chain of dependent mma is half as long, added in fp32
template <int KT>
__device__ __forceinline__ void fr_hh_product(float (&acc)[3][4], const unsigned (&a)[3][KT][4],
                                              const bf16* hc) {
  float acc2[3][4];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = acc2[g][e] = 0.0f;
  }
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    const unsigned b[2] = {*reinterpret_cast<const unsigned*>(hc + kt * 16),
                           *reinterpret_cast<const unsigned*>(hc + kt * 16 + 8)};
#pragma unroll
    for (int g = 0; g < 3; ++g) mma_bf16(kt % 2 ? acc2[g] : acc[g], a[g][kt], b);
  }
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] += acc2[g][e];
  }
}

// the four pairs' gates side by side (no branch between them), from xp + b_ih
// x[gate][pair] and the products acc[gate][pair]
__device__ __forceinline__ void fr_gates(float (&hreg)[4], const float (&acc)[3][4],
                                         const float (&x)[3][4], const CellBias (&bias)[2]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hreg[e] = gru_gates<true>(x[0][e], x[1][e], x[2][e], acc[0][e], acc[1][e], acc[2][e],
                              bias[e / 2], hreg[e]);
  }
}

template <int KT>
__global__ void __launch_bounds__(FR_MAX_THREADS, 1)
window_rec_fast_kernel(const float* __restrict__ xp, const float* __restrict__ h0_f,
                       const float* __restrict__ h0_b, const bf16* __restrict__ wh_f,
                       const bf16* __restrict__ wh_b, const float* __restrict__ bh_f,
                       const float* __restrict__ bh_b, float* __restrict__ out_f,
                       float* __restrict__ out_b, float* __restrict__ hn_f,
                       float* __restrict__ hn_b, int T, int B, int H, int rows,
                       size_t region) {
  const int dir = blockIdx.y;
  const bf16* __restrict__ w = dir ? wh_b : wh_f;
  const float* __restrict__ bh = dir ? bh_b : bh_f;
  const float* __restrict__ h0 = dir ? h0_b : h0_f;
  float* __restrict__ out = dir ? out_b : out_f;
  float* __restrict__ hn = dir ? hn_b : hn_f;
  const int H3 = 3 * H, LDH = fr_ldh(H);
  constexpr int KP = 16 * KT;
  const int tid = threadIdx.x, nthreads = blockDim.x;  // 32 * UP / 16
  const int warp = tid / 32, ln = tid % 32;
  const int b0 = blockIdx.x * rows;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ws = reinterpret_cast<bf16*>(smem_raw);   // [KP][LDW]: W_hh, column g UP + u
  float* ring = reinterpret_cast<float*>(smem_raw);  // then [STAGES][12][nthreads]
  bf16* hs = reinterpret_cast<bf16*>(smem_raw + region);  // [2][FR_ROWS][LDH]

  fr_stage_whh(ws, w, H, KP, tid, nthreads);
  for (int i = tid; i < 2 * FR_ROWS * LDH; i += nthreads) hs[i] = __float2bfloat16_rn(0.0f);
  cp_async_wait_all();
  __syncthreads();

  unsigned a[3][KT][4];
  fr_load_frags<KT>(a, ws, H, warp, ln);
  __syncthreads();  // the ring overwrites the staging area from here on

  int unit[4], brow[4];
  bool ok[4];
  fr_pairs(unit, brow, ok, warp, ln, H, rows, b0, B);
  float hreg[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hreg[e] = ok[e] ? h0[(size_t)(b0 + brow[e]) * H + unit[e]] : 0.0f;
  }
  CellBias bias[2];
  fr_bias(bias, unit, bh, H);
  for (int i = tid; i < rows * H; i += nthreads) {
    const int n = i / H, k = i - n * H;
    if (b0 + n < B) hs[n * LDH + k] = __float2bfloat16_rn(h0[(size_t)(b0 + n) * H + k]);
  }

  // step s's xp of the lane's own pairs into ring stage s % FR_STAGES: the
  // lane reads only what it copied, so wait_group alone orders the two. A
  // pair past B or H copies the value of the block's first row or of unit
  // H - 1, which its warp reads anyway and no one uses, so that neither the
  // copies nor the gates below branch (and no address is shared across
  // blocks, as a common stand-in would be)
  const float* __restrict__ xpd = xp + (size_t)dir * T * B * H3;
  int xoff[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int b = brow[e] < rows && b0 + brow[e] < B ? b0 + brow[e] : b0;
    xoff[e] = b * H3 + (unit[e] < H ? unit[e] : H - 1);
  }
  auto fill = [&](int s) {
    if (s < T) {
      const float* xt = xpd + (size_t)(dir ? T - 1 - s : s) * B * H3;
      float* st = ring + (size_t)(s % FR_STAGES) * FR_XP * nthreads + tid;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          cp_async4(st + (g * 4 + e) * nthreads, xt + xoff[e] + g * H);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < FR_STAGES - 1; ++s) fill(s);
  __syncthreads();  // hs[0] holds bf16(h0)

  for (int s = 0; s < T; ++s) {
    const int tt = dir ? T - 1 - s : s;
    fill(s + FR_STAGES - 1);
    float acc[3][4];
    fr_hh_product<KT>(acc, a, hs + (s & 1) * FR_ROWS * LDH + (ln / 4) * LDH + 2 * (ln % 4));
    cp_async_wait_group<FR_STAGES - 1>();  // step s's xp has landed
    const float* xs = ring + (size_t)(s % FR_STAGES) * FR_XP * nthreads + tid;
    float x[3][4];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[g][e] = xs[(g * 4 + e) * nthreads];
    }
    fr_gates(hreg, acc, x, bias);
    // then the stores of the pairs that exist
    bf16* hx = hs + ((s & 1) ^ 1) * FR_ROWS * LDH;
    float* ot = out + (size_t)tt * B * H;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (ok[e]) {
        ot[(b0 + brow[e]) * H + unit[e]] = hreg[e];
        hx[brow[e] * LDH + unit[e]] = __float2bfloat16_rn(hreg[e]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (ok[e]) hn[(size_t)(b0 + brow[e]) * H + unit[e]] = hreg[e];
  }
}

template <int KT>
int launch_rec_fast_kt(const float* xp, const float* h0_f, const float* h0_b,
                       const bf16* wh_f, const float* bh_f, const bf16* wh_b,
                       const float* bh_b, float* out_f, float* out_b, float* hn_f,
                       float* hn_b, int T, int B, int H, int rows, void* stream) {
  const size_t smem = fr_smem(H);
  if (int e = allow_smem(window_rec_fast_kernel<KT>, smem)) return e;
  dim3 grid((B + rows - 1) / rows, 2);
  window_rec_fast_kernel<KT><<<grid, fr_up(H) / 16 * 32, smem, (cudaStream_t)stream>>>(
      xp, h0_f, h0_b, wh_f, wh_b, bh_f, bh_b, out_f, out_b, hn_f, hn_b, T, B, H, rows,
      fr_region(H));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fused encoder+decoder window in the fast tier (K5f) as a cluster of
// two CTAs per group of `rows` batch rows (gru_window_cluster.cuh): the
// consumer warps step through the recurrence's pieces above with the
// layer's W_hh^T as A fragments, the producer warps project each chunk of
// EC_ROWS rows on bf16 mma.sync as the projection pass does (one fp32 sum
// per output over the k16 tiles in order, + b_ih after it: mma_k16,
// store_acc) into a ring in shared memory, over W_hh's staging area.
// ---------------------------------------------------------------------------

constexpr int ECF_PROD = 128;          // producer threads: 4 warps
constexpr int ECF_MAX_KT = 8;          // H <= 128: the consumers' 96 fragment registers
constexpr int ECF_KS = 32;             // k per producer stage
constexpr int ECF_ALD = ECF_KS + 8;    // A stage row stride (bf16): ldmatrix conflict-free

// n8 tiles per producer warp at KT k tiles of W_hh (3H <= 48 KT columns
// over the 4 warps, an even count)
__host__ __device__ constexpr int ecf_ntw(int KT) { return 2 * ((6 * KT + 7) / 8); }
// the ring's row stride (fp32) and the W_ih stage's (bf16)
__host__ __device__ inline int ecf_nrs(int H) { return round32(3 * H) + 4; }
__host__ __device__ inline int ecf_bld(int KT) { return 4 * 8 * ecf_ntw(KT) + 8; }

// the region the consumers stage W_hh in at each layer's start, and the
// producers then hold their ring, W_ih and A stages in
inline size_t ecf_region(int H) {
  const size_t staging = sizeof(bf16) * (size_t)fr_kp(H) * fr_ldw(H);
  const size_t prod = sizeof(float) * EC_STAGES * EC_ROWS * ecf_nrs(H) +
                      sizeof(bf16) * 2 * ECF_KS * ecf_bld(fr_kp(H) / 16) +
                      sizeof(bf16) * 2 * EC_ROWS * ECF_ALD;
  return staging > prod ? staging : prod;
}

// the block's dynamic shared memory: the ring's mbarriers, the h tile
// [2][FR_ROWS][LDH] (bf16), the region
inline size_t ecf_smem(int H) {
  return EC_BAR_BYTES + sizeof(bf16) * 2 * FR_ROWS * (size_t)fr_ldh(H) + ecf_region(H);
}

__host__ __device__ inline int ecf_consumers(int H) { return fr_up(H) / 16 * 32; }

// the wrapper's scratch: the boundary [clusters][2][T][rows][H], bf16
inline size_t ecf_scratch(int H, int B, int T, int rows) {
  return sizeof(bf16) * (size_t)((B + rows - 1) / rows) * 2 * T * rows * H;
}

// What both roles of a fast cluster CTA see.
struct EcfBlock {
  int T, B, H, H3, LDH, NRS, BLD, C, rows, dir, b0, ncons, nchunks;
  uint64_t* bars;
  bf16* hs;     // [2][FR_ROWS][LDH] the bf16 h tile
  bf16* ws;     // W_hh's staging area [KP][LDW] (the region, at a layer's start)
  float* ring;  // then the xp ring [EC_STAGES][EC_ROWS][NRS] (the region)
  bf16* bst;    // the producer's W_ih stages [2][KS][BLD]
  bf16* ast;    // its A stages [2][EC_ROWS][ALD]
  bf16* eo;     // the cluster's boundary [2][T][rows][H]
};

// The consumer warps: each layer's recurrence, as window_rec_fast_kernel
// steps it, from xp in the ring; the encoder's outputs (rounded to bf16, as
// K2f rounds its halves) to the boundary, the decoder's to out_f / out_b and
// hn_f / hn_b. At each layer's start they stage W_hh in the region, take
// their A fragments out, and hand the region to the producers.
template <int KT>
__device__ __forceinline__ void ecf_consume(const EncdecArgs<bf16>& p, const EcfBlock& k) {
  constexpr int KP = 16 * KT;
  const int T = k.T, B = k.B, H = k.H, LDH = k.LDH, NRS = k.NRS, C = k.C, dir = k.dir;
  const int tid = threadIdx.x, warp = tid / 32, ln = tid % 32;
  int unit[4], brow[4], xoff[4];
  bool ok[4];
  float hreg[4];
  for (int i = tid; i < 2 * FR_ROWS * LDH; i += k.ncons) k.hs[i] = __float2bfloat16_rn(0.0f);
  fr_pairs(unit, brow, ok, warp, ln, H, k.rows, k.b0, B);
  const float* __restrict__ h0 = dir ? p.h0_b : p.h0_f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hreg[e] = ok[e] ? h0[(size_t)(k.b0 + brow[e]) * H + unit[e]] : 0.0f;
    // a pair past the rows or H reads row 0 or unit H - 1 of the chunk's
    // step, which exist, and stores nothing
    xoff[e] = (brow[e] < k.rows ? brow[e] : 0) * NRS + (unit[e] < H ? unit[e] : H - 1);
  }
  for (int L = 0; L < 2; ++L) {
    if (L == 1) cluster_handoff();
    const DirParams<bf16>& lp = p.layer(L, dir);
    fr_stage_whh(k.ws, lp.w_hh, H, KP, tid, k.ncons);
    cp_async_wait_all();
    named_sync(EC_BAR_CONS, k.ncons);
    unsigned a[3][KT][4];
    fr_load_frags<KT>(a, k.ws, H, warp, ln);
    if (L == 0) {
      for (int i = tid; i < k.rows * H; i += k.ncons) {
        const int n = i / H, kk = i - n * H;
        if (k.b0 + n < B) k.hs[n * LDH + kk] = __float2bfloat16_rn(h0[(size_t)(k.b0 + n) * H + kk]);
      }
    }
    // the fragments are out: the region is the producers' from here on
    named_sync(EC_BAR_ALL, k.ncons + ECF_PROD);
    CellBias bias[2];
    fr_bias(bias, unit, lp.b_hh, H);
    float* __restrict__ out = dir ? p.out_b : p.out_f;
    for (int s = 0; s < T; ++s) {
      const int tt = dir ? T - 1 - s : s;
      const int cur = (L * T + s) & 1;
      float acc[3][4];
      fr_hh_product<KT>(acc, a, k.hs + cur * FR_ROWS * LDH + (ln / 4) * LDH + 2 * (ln % 4));
      const int q = L * k.nchunks + s / C;
      if (s % C == 0) ring_wait_full(k.bars, q);
      const float* xs =
          k.ring + (size_t)RingPos(q).slot * EC_ROWS * NRS + (size_t)(s % C) * k.rows * NRS;
      float x[3][4];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[g][e] = xs[xoff[e] + g * H];
      }
      fr_gates(hreg, acc, x, bias);
      bf16* hx = k.hs + (cur ^ 1) * FR_ROWS * LDH;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (ok[e]) {
          const bf16 hb = __float2bfloat16_rn(hreg[e]);
          if (L == 0) {
            // the boundary, at the original time position
            k.eo[(((size_t)dir * T + tt) * k.rows + brow[e]) * H + unit[e]] = hb;
          } else {
            out[((size_t)tt * B + k.b0 + brow[e]) * H + unit[e]] = hreg[e];
          }
          hx[brow[e] * LDH + unit[e]] = hb;
        }
      }
      if (s % C == C - 1 || s == T - 1) mbar_arrive(k.bars + EC_STAGES + RingPos(q).slot);
      named_sync(EC_BAR_CONS, k.ncons);
    }
  }
  float* __restrict__ hn = dir ? p.hn_b : p.hn_f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (ok[e]) hn[(size_t)(k.b0 + brow[e]) * H + unit[e]] = hreg[e];
  }
}

// The producer warps: xp = x W_ih + b_ih of each layer, chunk by chunk, in
// the direction's step order, into the ring: warp pw owns the chunk's 32
// rows x NTW n8 tiles from column pw NTW 8; each output one fp32 sum over
// the k16 tiles in order (mma_k16), then + b_ih (store_acc), as the
// projection pass.
template <int KT>
__device__ __forceinline__ void ecf_produce(const EncdecArgs<bf16>& p, const EcfBlock& k) {
  constexpr int NTW = ecf_ntw(KT);
  const int T = k.T, B = k.B, H = k.H, H3 = k.H3, BLD = k.BLD, NRS = k.NRS, dir = k.dir;
  const int pt = threadIdx.x - k.ncons, ln = pt % 32;
  const int col0 = (pt / 32) * NTW * 8;
  const bool evec = H % 8 == 0;
  // the thread stages A row m = pt / 4, k (pt % 4) * 8 .. + 7 (and every
  // 32 k on) of each stage
  const int m = pt / 4;
  for (int L = 0; L < 2; ++L) {
    if (L == 1) cluster_handoff();
    const DirParams<bf16>& lp = p.layer(L, dir);
    const int K = L ? 2 * H : p.D;
    const int nks = (K + ECF_KS - 1) / ECF_KS;
    const bf16* __restrict__ w = lp.w_ih;
    const bool wvec = H3 % 8 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
    named_sync(EC_BAR_ALL, k.ncons + ECF_PROD);  // the consumers have their fragments
    for (int c = 0; c < k.nchunks; ++c) {
      const int q = L * k.nchunks + c;
      const int st = c * k.C + m / k.rows, r = m % k.rows;
      const bool aok = st < T && k.b0 + r < B;
      const int tt = aok ? (dir ? T - 1 - st : st) : 0;
      const uint8_t* irow = p.in.img + (long long)(k.b0 + (aok ? r : 0)) * p.in.sb +
                            (long long)(p.in.start + tt) * p.in.sl;
      // the decoder's row [eo_f(t) | eo_b(t)]: the backward plane T steps of
      // `rows` rows on
      const bf16* erow = k.eo + ((size_t)tt * k.rows + r) * H;
      const size_t eback = (size_t)T * k.rows * H - H;
      auto fill = [&](int buf, int k0) {
        for (int i = pt; i < ECF_KS * 4 * NTW; i += ECF_PROD) {
          const int kr = i / (4 * NTW), cn = (i % (4 * NTW)) * 8;
          stage_w8(k.bst + ((size_t)buf * ECF_KS + kr) * BLD + cn, w, k0 + kr, cn, K, H3, wvec);
        }
        for (int k8 = (pt % 4) * 8; k8 < ECF_KS; k8 += 32) {
          bf16* d = k.ast + ((size_t)buf * EC_ROWS + m) * ECF_ALD + k8;
          const int kk = k0 + k8;
          if (L == 1 && aok && evec && kk + 8 <= K) {
            cp_async16_cg(d, erow + (kk < H ? kk : eback + kk));
          } else {
            float v[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const int ke = kk + e;
              v[e] = 0.0f;
              if (aok && ke < K) {
                v[e] = L == 0 ? (float)__ldg(irow + ke)
                              : __bfloat162float(__ldcg(erow + (ke < H ? ke : eback + ke)));
              }
            }
            *reinterpret_cast<uint4*>(d) = make_uint4(
                pack_bf16x2(make_float2(v[0], v[1])), pack_bf16x2(make_float2(v[2], v[3])),
                pack_bf16x2(make_float2(v[4], v[5])), pack_bf16x2(make_float2(v[6], v[7])));
          }
        }
        cp_async_commit();
      };
      float acc[2][NTW][4];
      zero_acc(acc);
      named_sync(EC_BAR_PROD, ECF_PROD);  // every producer is done with the stages
      fill(0, 0);
      for (int ks = 0; ks < nks; ++ks) {
        cp_async_wait_all();
        named_sync(EC_BAR_PROD, ECF_PROD);
        if (ks + 1 < nks) fill((ks + 1) & 1, (ks + 1) * ECF_KS);
        const bf16* as = k.ast + (size_t)(ks & 1) * EC_ROWS * ECF_ALD;
        const bf16* bs = k.bst + (size_t)(ks & 1) * ECF_KS * BLD;
#pragma unroll
        for (int kk = 0; kk < ECF_KS; kk += 16) {
          unsigned af[2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            ldmatrix_x4(af[i], as + (i * 16 + ln % 16) * ECF_ALD + kk + 8 * (ln / 16));
          }
          mma_k16(acc, af, bs, BLD, kk, col0, ln);
        }
      }
      ring_wait_empty(k.bars, q);
      store_acc(acc, k.ring + (size_t)RingPos(q).slot * EC_ROWS * NRS, NRS, 0, EC_ROWS, col0,
                H3, lp.b_ih, ln);
      mbar_arrive(k.bars + RingPos(q).slot);
    }
  }
}

template <int KT>
__global__ void __launch_bounds__(ECF_MAX_KT * 32 + ECF_PROD, 1)
encdec_cluster_fast_kernel(EncdecArgs<bf16> p, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  EcfBlock k;
  k.T = p.T;
  k.B = p.B;
  k.H = p.H;
  k.H3 = 3 * p.H;
  k.LDH = fr_ldh(p.H);
  k.NRS = ecf_nrs(p.H);
  k.BLD = ecf_bld(KT);
  k.rows = rows;
  k.C = EC_ROWS / rows;
  k.dir = (int)cluster_rank();
  const int cl = (int)cluster_id_x();
  k.b0 = cl * rows;
  k.ncons = ecf_consumers(p.H);
  k.nchunks = (p.T + k.C - 1) / k.C;
  k.bars = reinterpret_cast<uint64_t*>(smem_raw);
  k.hs = reinterpret_cast<bf16*>(smem_raw + EC_BAR_BYTES);
  unsigned char* region = smem_raw + EC_BAR_BYTES + sizeof(bf16) * 2 * FR_ROWS * k.LDH;
  k.ws = reinterpret_cast<bf16*>(region);
  k.ring = reinterpret_cast<float*>(region);
  k.bst = reinterpret_cast<bf16*>(k.ring + EC_STAGES * EC_ROWS * k.NRS);
  k.ast = k.bst + 2 * ECF_KS * k.BLD;
  k.eo = static_cast<bf16*>(p.eo) + (size_t)cl * 2 * p.T * rows * p.H;

  ring_init(k.bars, ECF_PROD, k.ncons);
  __syncthreads();
  // the roles split once, so that neither holds the other's registers
  if (threadIdx.x < k.ncons) {
    ecf_consume<KT>(p, k);
  } else {
    ecf_produce<KT>(p, k);
  }
}

template <int KT>
int launch_encdec_cluster_fast(const EncdecArgs<bf16>& a, int rows, void* stream) {
  const size_t smem = ecf_smem(a.H);
  if (int e = allow_smem(encdec_cluster_fast_kernel<KT>, smem)) return e;
  const ClusterLaunch l((a.B + rows - 1) / rows, ecf_consumers(a.H) + ECF_PROD, smem, stream);
  if (cudaError_t e = cudaLaunchKernelEx(&l.cfg, encdec_cluster_fast_kernel<KT>, a, rows)) {
    return (int)e;
  }
  return (int)cudaGetLastError();
}

inline bool ecf_takes(int H, int rows, int D, int T, int B) {
  return H >= 1 && fr_kp(H) / 16 <= ECF_MAX_KT && D >= 1 && T >= 1 && B >= 1 && rows >= 1 &&
         rows <= FR_ROWS && EC_ROWS % rows == 0 && (long long)T * B <= (1LL << 30);
}

}  // namespace

extern "C" {

// the recurrence block's dynamic shared memory at hidden size H, and the
// largest H it takes (ops/gru_window_smem.py fast_rec_smem_bytes and
// FAST_REC_MAX_H mirror them)
long long bigru_window_rec_fast_smem_bytes(int H) { return (long long)fr_smem(H); }

int bigru_window_rec_fast_max_h() { return FR_MAX_H; }

// K1f's projection: image (B, L, D) uint8 with element strides (sb, sl),
// window columns [start, start + T); W_ih (D, 3H) bf16, b_ih (3H,) fp32 per
// direction; xp (2, T, B, 3H) fp32.
int bigru_window_proj_in1_fast(const uint8_t* img, long long sb, long long sl, int start,
                               int D, const bf16* wi_f, const float* bi_f, const bf16* wi_b,
                               const float* bi_b, float* xp, int T, int B, int H,
                               void* stream) {
  if (int e = check_proj_fast(D, T, B, H)) return e;
  const ImageRowsFast src{WindowIn{img, sb, sl, start, nullptr, nullptr}, D, B};
  const int M = T * B, N = 3 * H;
  const bool wvec = N % 8 == 0 && aligned16(wi_f) && aligned16(wi_b);
  proj_image_fast_kernel<<<proj_grid(M, N), FP_THREADS, 0, (cudaStream_t)stream>>>(
      src, M, D, N, wi_f, wi_b, bi_f, bi_b, xp, wvec);
  return (int)cudaGetLastError();
}

// K2f's projection: xa, xb (T, B, H) fp32, rounded to bf16 here; W_ih
// (2H, 3H) bf16: rows [0, H) take xa, [H, 2H) xb; xp (2, T, B, 3H) fp32.
int bigru_window_proj_in2_fast(const float* xa, const float* xb, const bf16* wi_f,
                               const float* bi_f, const bf16* wi_b, const float* bi_b,
                               float* xp, int T, int B, int H, void* stream) {
  if (int e = check_proj_fast(2 * H, T, B, H)) return e;
  if (int e = allow_smem(proj_pair_fast_kernel, FP_PAIR_SMEM)) return e;
  const int M = T * B, N = 3 * H;
  const bool vec = H % 4 == 0 && aligned16(xa) && aligned16(xb);
  const bool wvec = N % 8 == 0 && aligned16(wi_f) && aligned16(wi_b);
  proj_pair_fast_kernel<<<proj_grid(M, N), FP_THREADS, FP_PAIR_SMEM, (cudaStream_t)stream>>>(
      xa, xb, H, vec, M, N, wi_f, wi_b, bi_f, bi_b, xp, wvec);
  return (int)cudaGetLastError();
}

// The recurrence over xp (2, T, B, 3H) from h0_f/h0_b (B, H), W_hh (H, 3H)
// bf16, b_hh (3H,) fp32 per direction, `rows` (1..8) batch rows per block;
// outputs out_f/out_b (T, B, H), hn_f/hn_b (B, H), fp32.
int bigru_window_rec_fast(const float* xp, const float* h0_f, const float* h0_b,
                          const bf16* wh_f, const float* bh_f, const bf16* wh_b,
                          const float* bh_b, float* out_f, float* out_b, float* hn_f,
                          float* hn_b, int T, int B, int H, int rows, void* stream) {
  if (H < 1 || H > FR_MAX_H || T < 1 || B < 1 || rows < 1 || rows > FR_ROWS ||
      (long long)T * B > (1LL << 30) || (long long)B * 3 * H > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
#define REC_FAST_ARGS xp, h0_f, h0_b, wh_f, bh_f, wh_b, bh_b, out_f, out_b, hn_f, hn_b, T, B, H, \
                      rows, stream
  switch (fr_kp(H) / 16) {
    case 2: return launch_rec_fast_kt<2>(REC_FAST_ARGS);
    case 4: return launch_rec_fast_kt<4>(REC_FAST_ARGS);
    case 6: return launch_rec_fast_kt<6>(REC_FAST_ARGS);
    case 8: return launch_rec_fast_kt<8>(REC_FAST_ARGS);
    default: return launch_rec_fast_kt<10>(REC_FAST_ARGS);
  }
#undef REC_FAST_ARGS
}

// K5f's cluster design: the dynamic shared memory of one CTA, its threads,
// the scratch the wrapper passes (ops/gru_window_encdec.py mirrors them),
// and how many clusters the card holds at once (negative: a CUDA error)
long long transducer_window_encdec_cluster_fast_smem(int H) { return (long long)ecf_smem(H); }

int transducer_window_encdec_cluster_fast_threads(int H) { return ecf_consumers(H) + ECF_PROD; }

int transducer_window_encdec_cluster_fast_max_h() { return ECF_MAX_KT * 16; }

long long transducer_window_encdec_cluster_fast_scratch(int H, int B, int T, int rows) {
  return (long long)ecf_scratch(H, B, T, rows);
}

int transducer_window_encdec_cluster_fast_active(int H) {
  if (H < 1 || fr_kp(H) / 16 > ECF_MAX_KT) return -(int)cudaErrorInvalidValue;
  const int threads = ecf_consumers(H) + ECF_PROD;
  const size_t smem = ecf_smem(H);
  switch (fr_kp(H) / 16) {
    case 2: return active_clusters(encdec_cluster_fast_kernel<2>, threads, smem);
    case 4: return active_clusters(encdec_cluster_fast_kernel<4>, threads, smem);
    case 6: return active_clusters(encdec_cluster_fast_kernel<6>, threads, smem);
    default: return active_clusters(encdec_cluster_fast_kernel<8>, threads, smem);
  }
}

// K5f in its cluster design: K5f's arguments (gru_window_encdec.cu), `rows`
// (1, 2, 4 or 8) batch rows per cluster, and the scratch of
// transducer_window_encdec_cluster_fast_scratch bytes.
int transducer_window_encdec_cluster_fast(
    const uint8_t* img, long long sb, long long sl, int start, int D, const float* h0_f,
    const float* h0_b, const bf16* ewi_f, const bf16* ewh_f, const float* ebi_f,
    const float* ebh_f, const bf16* ewi_b, const bf16* ewh_b, const float* ebi_b,
    const float* ebh_b, const bf16* dwi_f, const bf16* dwh_f, const float* dbi_f,
    const float* dbh_f, const bf16* dwi_b, const bf16* dwh_b, const float* dbi_b,
    const float* dbh_b, float* out_f, float* out_b, float* hn_f, float* hn_b, int T, int B,
    int H, int rows, void* scratch, void* stream) {
  if (!ecf_takes(H, rows, D, T, B)) return (int)cudaErrorInvalidValue;
  EncdecArgs<bf16> a{WindowIn{img, sb, sl, start, nullptr, nullptr},
                     D, h0_f, h0_b,
                     DirParams<bf16>{ewi_f, ewh_f, ebi_f, ebh_f},
                     DirParams<bf16>{ewi_b, ewh_b, ebi_b, ebh_b},
                     DirParams<bf16>{dwi_f, dwh_f, dbi_f, dbh_f},
                     DirParams<bf16>{dwi_b, dwh_b, dbi_b, dbh_b},
                     out_f, out_b, hn_f, hn_b, scratch, nullptr, T, B, H};
  switch (fr_kp(H) / 16) {
    case 2: return launch_encdec_cluster_fast<2>(a, rows, stream);
    case 4: return launch_encdec_cluster_fast<4>(a, rows, stream);
    case 6: return launch_encdec_cluster_fast<6>(a, rows, stream);
    default: return launch_encdec_cluster_fast<8>(a, rows, stream);
  }
}

}  // extern "C"
