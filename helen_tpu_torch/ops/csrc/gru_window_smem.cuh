// What the shared-memory designs share (gru_window_smem.cu, the forward;
// gru_window_bwd_smem.cu, the backward): the cp.async copies that stage a
// weight matrix in shared memory once per launch, and the tiled fp32 product
// of their parallel passes.
//
// The tile product's arithmetic (tile_fma_stage, tile_store) is shared with
// the producer warps of K5's cluster design (gru_window_smem.cu), so that
// they project in the same order and K5 keeps the chain's bits.
//
// The tile product: out[dir] = A[dir] W[dir] (+ bias[dir]) over M rows, depth
// K, N columns, for both directions of a window (grid z). 128 x 128 outputs
// per block of 256 threads, 8 x 8 per thread, k in stages of 8 staged in
// shared memory, double-buffered through registers. Each output is one fmaf
// chain from 0.0 over k = 0, 1, ..., K - 1 in order, then + bias rounded
// once: the tile loop never splits k, and the zero padding of the last stage
// adds fmaf(0, 0, acc) = acc. So it sums in the order of the recurrence
// kernels' own chains (fma_chain, gru_window_common.cuh), and a design that
// moves a product out of the serial loop into this pass keeps its bits.
// The A operand is a row source (below): the uint8 image window, the
// previous layer's halves, the h_prev stream, or a dense float stream.

#pragma once

#include "gru_window_common.cuh"

namespace {

constexpr int PJ_BM = 128;          // product rows per block
constexpr int PJ_BN = 128;          // product columns per block
constexpr int PJ_BK = 8;            // k per shared-memory stage
constexpr int PJ_THREADS = 256;     // 16 x 16 threads, 8 x 8 outputs each
constexpr int PJ_APAD = PJ_BM + 4;  // row stride of the transposed A stage
constexpr int REC_SPLIT = 2;        // recurrences: threads per hidden unit at >= 2 rows
constexpr int REC_MAX_THREADS = 320;  // recurrences: the launch bound

// n rounded up to 4 floats: a row stride in shared memory read as float4
__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying n floats of src into the 16-byte-aligned dst, spread over the
// block's threads: 16 bytes at a time where src is 16-byte aligned, else 4.
// The caller waits with cp_async_wait_all() and a __syncthreads().
__device__ __forceinline__ void stage_async(float* dst, const float* src, int n, int tid,
                                            int nthreads) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n / 4;
    for (int i = tid; i < n4; i += nthreads) cp_async16(dst + 4 * i, src + 4 * i);
    for (int i = 4 * n4 + tid; i < n; i += nthreads) cp_async4(dst + i, src + i);
  } else {
    for (int i = tid; i < n; i += nthreads) cp_async4(dst + i, src + i);
  }
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// Row sources of the tile product: row(dir, m) locates row m of direction
// dir's A operand as a Row, at(row, k) reads its element k (0.0 past the
// depth).
// ---------------------------------------------------------------------------

// Layer 0: the uint8 image window, row m = t * B + b at column start + t
struct ImageRows {
  using Row = const uint8_t*;
  WindowIn in;
  int D, B;
  __device__ const uint8_t* row(int, int m) const {
    const int t = m / B, b = m - t * B;
    return in.img + (long long)b * in.sb + (long long)(in.start + t) * in.sl;
  }
  __device__ float at(const uint8_t* r, int k) const {
    return k < D ? (float)__ldg(r + k) : 0.0f;
  }
};

// Later layers: the previous layer's halves, row m = [xa[m] | xb[m]]
struct PairRows {
  using Row = long long;
  const float* xa;
  const float* xb;
  int H;
  __device__ long long row(int, int m) const { return (long long)m * H; }
  __device__ float at(long long r, int k) const {
    if (k >= 2 * H) return 0.0f;
    return k < H ? __ldg(xa + r + k) : __ldg(xb + r + (k - H));
  }
};

// A (2, M, K) float stream, direction-major (the backward's dxp)
struct DenseRows {
  using Row = const float*;
  const float* a;
  int M, K;
  __device__ const float* row(int dir, int m) const {
    return a + ((size_t)dir * M + m) * K;
  }
  __device__ float at(const float* r, int k) const { return k < K ? __ldg(r + k) : 0.0f; }
};

// h_prev of each direction at row m = t * B + b: the forward output stream
// shifted one step (out[t-1] forward, out[t+1] backward), h0 at the window
// boundary, as hprev_at reads it
struct HprevRows {
  using Row = const float*;
  const float* out_f;
  const float* out_b;
  const float* h0_f;
  const float* h0_b;
  int T, B, H;
  __device__ const float* row(int dir, int m) const {
    const int t = m / B, b = m - t * B;
    const int tp = dir ? t + 1 : t - 1;
    return (tp >= 0 && tp < T) ? (dir ? out_b : out_f) + ((size_t)tp * B + b) * H
                               : (dir ? h0_b : h0_f) + (size_t)b * H;
  }
  __device__ float at(const float* r, int k) const { return k < H ? __ldg(r + k) : 0.0f; }
};

// The tile product's arithmetic, shared with the producer warps of the
// fused encoder+decoder window (gru_window_smem.cu): a thread's 8 x 4 NB
// register tile over one staged k slice of BK, rows a[0..3] at as[k][0..3]
// and a[4..7] at as[k][hm + 0..3] (as: the A stage transposed, row stride
// lda), columns c hn + 0..3 of bs for c < NB (row stride ldb); each output
// one fmaf chain over kk = 0 .. BK-1 in order.
template <int BK, int NB>
__device__ __forceinline__ void tile_fma_stage(float (&acc)[8][4 * NB], const float* as, int lda,
                                               int hm, const float* bs, int ldb, int hn) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + kk * lda);
    const float4 a1 = *reinterpret_cast<const float4*>(as + kk * lda + hm);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float v[4 * NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(bs + kk * ldb + c * hn);
      v[4 * c] = b.x;
      v[4 * c + 1] = b.y;
      v[4 * c + 2] = b.z;
      v[4 * c + 3] = b.w;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4 * NB; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
  }
}

// The tile's epilogue: out[m][n] = acc (+ bias[n]), one rounding, as
// gru_step's `xr + bias.ir`, at rows mr + 0..3 and mr + hm + 0..3 (those
// below M), columns nc + c hn + 0..3 for c < NB (those below N); row m at
// out + m * ldo, float4 stores where N and ldo are multiples of 4.
template <bool BIAS, int NB>
__device__ __forceinline__ void tile_store(const float (&acc)[8][4 * NB], float* out, int ldo,
                                           int M, int N, int mr, int hm, int nc, int hn,
                                           const float* __restrict__ bias) {
  auto value = [&](int i, int c, int n) {
    return BIAS ? acc[i][c] + __ldg(bias + n) : acc[i][c];
  };
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = mr + (i < 4 ? i : hm + (i - 4));
    if (m >= M) continue;
    float* row = out + (size_t)m * ldo;
#pragma unroll
    for (int half = 0; half < NB; ++half) {
      const int n = nc + half * hn;
      const int c = half * 4;
      if (((N | ldo) & 3) == 0) {
        if (n < N) {
          *reinterpret_cast<float4*>(row + n) = make_float4(
              value(i, c, n), value(i, c + 1, n + 1), value(i, c + 2, n + 2),
              value(i, c + 3, n + 3));
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (n + q < N) row[n + q] = value(i, c + q, n + q);
        }
      }
    }
  }
}

template <bool BIAS, typename Src>
__global__ void __launch_bounds__(PJ_THREADS, 2)
tile_product_kernel(Src src, int M, int K, int N, const float* __restrict__ w_f,
                    const float* __restrict__ w_b, const float* __restrict__ b_f,
                    const float* __restrict__ b_b, float* __restrict__ out) {
  const int dir = blockIdx.z;
  const float* __restrict__ w = dir ? w_b : w_f;
  const float* __restrict__ bias = dir ? b_b : b_f;  // read only when BIAS
  const int m0 = blockIdx.x * PJ_BM, n0 = blockIdx.y * PJ_BN;
  const int tid = threadIdx.x;

  __shared__ __align__(16) float As[2][PJ_BK][PJ_APAD];  // A stage, transposed
  __shared__ __align__(16) float Bs[2][PJ_BK][PJ_BN];    // W stage

  // each thread loads A rows ar + 32 i at k = ak, and W rows bk + 2 i at
  // column bn, of every stage
  const int ak = tid % PJ_BK, ar = tid / PJ_BK;
  const int bn = tid % PJ_BN, bk = tid / PJ_BN;
  typename Src::Row arow[4];
  bool aok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ar + 32 * i;
    aok[i] = m < M;
    arow[i] = src.row(dir, aok[i] ? m : 0);
  }
  const bool bok = n0 + bn < N;
  float av[4], bv[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = aok[i] ? src.at(arow[i], k0 + ak) : 0.0f;
      const int k = k0 + bk + 2 * i;
      bv[i] = (bok && k < K) ? __ldg(w + (size_t)k * N + n0 + bn) : 0.0f;
    }
  };
  auto store = [&](int s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[s][ak][ar + 32 * i] = av[i];
      Bs[s][bk + 2 * i][bn] = bv[i];
    }
  };

  // thread (tx, ty) owns rows ty*4 + {0..3}, 64 + ty*4 + {0..3} and columns
  // tx*4 + {0..3}, 64 + tx*4 + {0..3} of the block's tile
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }
  const int stages = (K + PJ_BK - 1) / PJ_BK;
  load(0);
  store(0);
  __syncthreads();
  for (int ks = 0; ks < stages; ++ks) {
    const int s = ks & 1;
    if (ks + 1 < stages) load((ks + 1) * PJ_BK);
    tile_fma_stage<PJ_BK, 2>(acc, &As[s][0][ty * 4], PJ_APAD, 64, &Bs[s][0][tx * 4], PJ_BN, 64);
    if (ks + 1 < stages) store(s ^ 1);
    __syncthreads();
  }

  tile_store<BIAS, 2>(acc, out + (size_t)dir * M * N, N, M, N, m0 + ty * 4, 64, n0 + tx * 4, 64,
                      bias);
}

// out (2, M, N) = A W (+ bias, where BIAS) per direction; W (K, N)
// row-major per direction, bias (N,) per direction (unread without BIAS)
template <bool BIAS, typename Src>
int launch_tile_product(const Src& src, int M, int K, int N, const float* w_f,
                        const float* w_b, const float* b_f, const float* b_b, float* out,
                        void* stream) {
  if (M < 1 || K < 1 || N < 1 || M > (1 << 30)) return (int)cudaErrorInvalidValue;
  dim3 grid((M + PJ_BM - 1) / PJ_BM, (N + PJ_BN - 1) / PJ_BN, 2);
  tile_product_kernel<BIAS, Src><<<grid, PJ_THREADS, 0, (cudaStream_t)stream>>>(
      src, M, K, N, w_f, w_b, b_f, b_b, out);
  return (int)cudaGetLastError();
}

}  // namespace
