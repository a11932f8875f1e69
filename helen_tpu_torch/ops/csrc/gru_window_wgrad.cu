// Pass 2 of both training backwards: the weight cotangents of one window as
// a split-N reduction on 3xTF32 tensor cores, then a fixed-order sum of the
// slices. Replaces the weight-gradient half of helen_tpu's _bwd_kernel_ip
// (helen_tpu/ops/gru_pallas_train.py:321, its VMEM accumulators :380-408)
// and of _bwd_kernel (:166), which on the TPU add each grid step's product
// into one scratch sum.
//
// Per direction, over the window's N = T * B rows n = t * B + b:
//   [dW_ih; db_ih] = [x | 1]^T dxp                         (D + 1) x 3H, with_ih only
//   [dW_hh; db_hh] = [h_prev | 1]^T [dxp_r | dxp_z | dhp_n] (H + 1) x 3H
// x is read where it lies (the uint8 image at column start + t, or the
// previous layer's halves), h_prev is the output stream shifted one step
// with h0 at the boundary (x_at / hprev_at's indexing, gru_window_common.cuh),
// dxp (2, T, B, 3H) and dhp_n (2, T, B, H) come from pass 1.
//
// What bounds it on the H100: operations. 23.8 GFLOP per flagship training
// window (B=256, both layers) against 293 MB; at fp32 FMA rate (67 TFLOP/s)
// 0.36 ms, more than the bytes' 0.09 ms; 3xTF32 on the tensor cores
// (3 x FLOP at 495 TFLOP/s) 0.14 ms. In practice the loop's instruction
// stream (splits, fills, mmas) bounds it: 0.74 ms on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md). The design:
//   1. N is cut into slices of WS_SLICE_ROWS rows, a constant of this
//      source: the slices, and so the bits, follow from the shape alone,
//      never from the card's SM count. One block per (64 x 128 output tile,
//      slice, direction): 768 blocks at the flagship's decoder layer where
//      the one-slice design had 336 blocks walking all 25,600 rows.
//   2. Each of the block's 8 warps sums a 32 x 32 sub-tile in fp32 fragments
//      of mma.sync.m16n8k8 tf32. Each operand is split in registers into
//      hi = tf32_rna(a) and lo = tf32_rna(a - hi), rounded to nearest, ties
//      away (cvt.rna's rounding, in integer operations), and each k step
//      runs three products, lo*hi, hi*lo and hi*hi (3xTF32: about fp32's
//      accuracy). The uint8 image and the bias row's ones are exact in TF32
//      (lo = 0), so layer 0's ih tiles run two.
//   3. Both operands are staged in shared memory by cp.async (16 bytes where
//      rows are 16-byte aligned, else 4), double-buffered over chunks of
//      WS_KC rows; the image rows (90 bytes, unaligned) are converted to
//      float while staging. The bias is a row of ones of A (row M).
//   4. At S > 1 slices each block writes its partial tile to a scratch
//      (S, 2, R, 3H); wgrad_sum_kernel adds the slices in s = 0 .. S-1 order
//      into the outputs. No float atomics: two launches give the same bits.
//      At S = 1 the blocks write the outputs themselves.
// The slice length caps each sequential fp32 sum, which keeps the sum's
// error from growing with B (the one-slice design's dW_ih landed 1.03e-5 of
// its scale from the exact sum at B=512).

#include "gru_window_common.cuh"

namespace {

constexpr int WS_WARPS_M = 2;         // warps along the output rows
constexpr int WS_WARPS_N = 4;         // warps along the output columns
constexpr int WS_BM = 32 * WS_WARPS_M;  // output rows per block, 32 per warp
constexpr int WS_BN = 32 * WS_WARPS_N;  // output columns per block, 32 per warp
constexpr int WS_THREADS = 32 * WS_WARPS_M * WS_WARPS_N;
constexpr int WS_KC = 32;             // reduction rows per shared-memory stage
constexpr int WS_STAGES = 2;          // stages in flight
constexpr int WS_MIN_BLOCKS = 2;      // blocks per SM the registers must allow
constexpr int WS_LDA = WS_BM + 8;     // stage row strides: 8 mod 32 floats, so
constexpr int WS_LDB = WS_BN + 8;     // a fragment's 32 reads hit 32 banks
constexpr int WS_SLICE_ROWS = 1600;   // rows per slice, a multiple of WS_KC
constexpr int WS_SUM_THREADS = 256;
static_assert(WS_SLICE_ROWS % WS_KC == 0, "a slice is whole stages");
constexpr int WS_STAGE_FLOATS = WS_KC * (WS_LDA + WS_LDB);
constexpr size_t WS_SMEM = sizeof(float) * WS_STAGES * WS_STAGE_FLOATS;

inline int ws_slices(int T, int B) {
  return (int)(((long long)T * B + WS_SLICE_ROWS - 1) / WS_SLICE_ROWS);
}
// rows of one direction's outputs: [dW_ih; db_ih] (with_ih) then [dW_hh; db_hh]
__host__ __device__ inline int ws_rows(int D, int with_ih, int H) {
  return (with_ih ? D + 1 : 0) + H + 1;
}
__host__ __device__ inline int ws_col_tiles(int H) { return (3 * H + WS_BN - 1) / WS_BN; }
__host__ __device__ inline int ws_ih_tiles(int D, int with_ih, int H) {
  return with_ih ? (D + WS_BM) / WS_BM * ws_col_tiles(H) : 0;
}
inline int ws_tiles(int D, int with_ih, int H) {
  return ws_ih_tiles(D, with_ih, H) + (H + WS_BM) / WS_BM * ws_col_tiles(H);
}

struct WgArgs {
  WindowIn in;          // the layer's input (with_ih only)
  int D, with_ih;
  int vec;              // every float row 16-byte aligned: 16-byte copies
  const float* h0[2];   // (B, H) per direction
  const float* out[2];  // (T, B, H) per direction
  const float* dxp;     // (2, T, B, 3H)
  const float* dhpn;    // (2, T, B, H)
  float* part;          // (S, 2, R, 3H) partial sums; null at S = 1
  DirG g[2];
  int T, B, H;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a b: A 16 x 8 (row-major fragment), B 8 x 8 (column), C 16 x 8 fp32.
// The tensor cores add into c with truncation, not to nearest, so each mma
// leaves an error of up to an ulp of c, always toward zero. Carried over
// 1,542 rows (579 mmas) into one c, those errors reached 1.2e-5 of the
// scale on an H100. So the kernel sums each WS_KC-row chunk from 0 in the
// tensor cores (12 mmas) and adds the chunk to the running sums in fp32,
// rounded to nearest.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four consecutive elements k = k0 .. k0+3 of a row of width M, then `at_m`
// at k = M (A's bias row: 1; B: 0) and zeros past it: elem(k) points at
// element k < M. One 16-byte copy where the four lie inside the row and `vec`.
template <typename Elem>
__device__ __forceinline__ void stage4(float* dst, int k0, int M, float at_m, bool vec,
                                       Elem elem) {
  if (vec && k0 + 3 < M) {
    cp_async16(dst, elem(k0));
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = k0 + j;
    if (k < M) {
      cp_async4(dst + j, elem(k));
    } else {
      dst[j] = k == M ? at_m : 0.0f;
    }
  }
}

__device__ __forceinline__ void zero4(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// One block's output tile, rows m0.. of the ih (hh = false) or hh product,
// columns c0.., summed over slice s's rows. EXACT_A: A's values are exact in
// TF32 (the uint8 image and the ones), so its lo part is 0.
template <bool PAIR, bool EXACT_A>
__device__ __forceinline__ void wgrad_tile(const WgArgs& a, int dir, int s, bool hh,
                                           int m0, int c0, float* smem) {
  // stage b: A [WS_KC][WS_LDA] then B [WS_KC][WS_LDB]
  auto As = [&](int b, int i, int m) { return smem + b * WS_STAGE_FLOATS + i * WS_LDA + m; };
  auto Bs = [&](int b, int i, int c) {
    return smem + b * WS_STAGE_FLOATS + WS_KC * WS_LDA + i * WS_LDB + c;
  };
  const int H = a.H, H3 = 3 * H, B = a.B, T = a.T;
  const int N = T * B;
  const int M = hh ? H : a.D;  // row M of the product is the bias row
  const int n_begin = s * WS_SLICE_ROWS;
  const int n_end = min(N, n_begin + WS_SLICE_ROWS);
  const int chunks = (n_end - n_begin + WS_KC - 1) / WS_KC;
  const float* __restrict__ out = dir ? a.out[1] : a.out[0];
  const float* __restrict__ h0 = dir ? a.h0[1] : a.h0[0];
  const float* __restrict__ dxp = a.dxp + (size_t)dir * N * H3;
  const float* __restrict__ dhpn = a.dhpn + (size_t)dir * N * H;
  const bool vec = a.vec;
  const int tid = threadIdx.x;

  // Every chunk, each thread stages the same columns (one group of 4 of A,
  // one of B) in rows ia, ia + WS_THREADS / GA, ... (and ib, ...): only the
  // row advances, so the columns' sources are found once.
  constexpr int GA = WS_BM / 4, GB = WS_BN / 4;  // groups of 4 per stage row
  constexpr int RA = WS_THREADS / GA, RB = WS_THREADS / GB;  // rows apart
  static_assert(WS_THREADS % GA == 0 && WS_THREADS % GB == 0 && WS_KC % RA == 0 &&
                    WS_KC % RB == 0, "each thread stages fixed columns");
  const int ma = (tid % GA) * 4, ia = tid / GA, mm = m0 + ma;
  const int cb = (tid % GB) * 4, ib = tid / GB, cc = c0 + cb;
  // B's column: dxp's (every column of the ih product; r and z of the hh
  // one) or dhp_n's; with H a multiple of 4 a group lies inside one of them
  const bool b_dxp = !hh || cc < 2 * H;
  const float* __restrict__ bsrc = b_dxp ? dxp + cc : dhpn + (cc - 2 * H);
  const int bstride = b_dxp ? H3 : H;

  auto fill = [&](int buf, int nb) {
#pragma unroll
    for (int j = 0; j < WS_KC / RA; ++j) {
      const int i = ia + j * RA, n = nb + i;
      float* dst = As(buf, i, ma);
      if (n >= n_end || mm > M) {
        zero4(dst);
        continue;
      }
      if (hh) {
        // h_prev of row n = t B + b: out's row n - B (forward) or n + B
        // (backward), or h0's row b at the window's edge
        const float* row = dir ? (n < N - B ? out + (size_t)(n + B) * H
                                            : h0 + (size_t)(n - (N - B)) * H)
                               : (n >= B ? out + (size_t)(n - B) * H : h0 + (size_t)n * H);
        stage4(dst, mm, M, 1.0f, vec, [&](int k) { return row + k; });
      } else if (PAIR) {
        const float* ra = a.in.xa + (size_t)n * H;
        const float* rb = a.in.xb + (size_t)n * H;
        stage4(dst, mm, M, 1.0f, vec, [&](int k) { return k < H ? ra + k : rb + (k - H); });
      } else {
        const int t = n / B, b = n - t * B;
        const uint8_t* row = a.in.img + (size_t)b * a.in.sb + (size_t)(a.in.start + t) * a.in.sl;
#pragma unroll
        for (int q4 = 0; q4 < 4; ++q4) {
          const int k = mm + q4;
          dst[q4] = k < M ? (float)row[k] : (k == M ? 1.0f : 0.0f);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < WS_KC / RB; ++j) {
      const int i = ib + j * RB, n = nb + i;
      float* dst = Bs(buf, i, cb);
      if (n >= n_end || cc >= H3) {
        zero4(dst);
      } else if (vec) {
        cp_async16(dst, bsrc + (size_t)n * bstride);
      } else {  // H no multiple of 4: a group may straddle 2H or 3H
        const float* rx = dxp + (size_t)n * H3;
        const float* rn = dhpn + (size_t)n * H;
        stage4(dst, cc, H3, 0.0f, false,
               [&](int k) { return (!hh || k < 2 * H) ? rx + k : rn + (k - 2 * H); });
      }
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = (warp % WS_WARPS_M) * 32, wn = (warp / WS_WARPS_M) * 32;
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.0f;

  // chunk c in stage c % WS_STAGES; WS_STAGES - 1 chunks' copies in flight
#pragma unroll
  for (int c = 0; c < WS_STAGES - 1; ++c) {
    if (c < chunks) fill(c, n_begin + c * WS_KC);
    cp_async_commit();
  }
  for (int c = 0; c < chunks; ++c) {
    const int next = c + WS_STAGES - 1;
    if (next < chunks) fill(next % WS_STAGES, n_begin + next * WS_KC);
    cp_async_commit();
    cp_async_wait_group<WS_STAGES - 1>();  // chunk c's copies have landed
    __syncthreads();
    const int buf = c % WS_STAGES;
    // the chunk's products sum from 0 in the tensor cores, then join the
    // running sums in fp32 adds (see the note at mma_tf32)
    float cs[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) cs[mi][ni][r] = 0.0f;
#pragma unroll
    for (int k8 = 0; k8 < WS_KC; k8 += 8) {
      unsigned ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        // a0 (row g, k q), a1 (row g+8, k q), a2 (row g, k q+4), a3 (row g+8, k q+4)
        const float* p = As(buf, k8 + q, wm + mi * 16 + g);
        split_tf32(p[0], ah[mi][0], al[mi][0]);
        split_tf32(p[8], ah[mi][1], al[mi][1]);
        split_tf32(p[4 * WS_LDA], ah[mi][2], al[mi][2]);
        split_tf32(p[4 * WS_LDA + 8], ah[mi][3], al[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        // b0 (k q, column g), b1 (k q+4, column g)
        const float* p = Bs(buf, k8 + q, wn + ni * 8 + g);
        split_tf32(p[0], bh[ni][0], bl[ni][0]);
        split_tf32(p[4 * WS_LDB], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          if (!EXACT_A) mma_tf32(cs[mi][ni], al[mi], bh[ni]);
          mma_tf32(cs[mi][ni], ah[mi], bl[ni]);
          mma_tf32(cs[mi][ni], ah[mi], bh[ni]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] += cs[mi][ni][r];
    __syncthreads();  // the buffer is refilled next iteration
  }

  // c0 (row g, columns 2q, 2q+1), c2 (row g+8, the same columns)
  const DirG og = dir ? a.g[1] : a.g[0];
  float* w = hh ? og.w_hh : og.w_ih;
  float* bias = hh ? og.b_hh : og.b_ih;
  const int rbase = (hh && a.with_ih) ? a.D + 1 : 0;
  float* part = a.part == nullptr ? nullptr
                : a.part + ((size_t)s * 2 + dir) * ws_rows(a.D, a.with_ih, H) * H3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int mm = m0 + wm + mi * 16 + g + (r >> 1) * 8;
        const int cc = c0 + wn + ni * 8 + 2 * q + (r & 1);
        if (mm > M || cc >= H3) continue;
        const float v = acc[mi][ni][r];
        if (part != nullptr) {
          part[(size_t)(rbase + mm) * H3 + cc] = v;
        } else if (mm < M) {
          w[(size_t)mm * H3 + cc] = v;
        } else {
          bias[cc] = v;
        }
      }
    }
  }
}

// grid (tiles, S, 2): blockIdx.x walks the ih tiles (with_ih), then the hh
// tiles, row-tile major; blockIdx.y is the slice, blockIdx.z the direction
template <bool PAIR>
__global__ void __launch_bounds__(WS_THREADS, WS_MIN_BLOCKS) wgrad_split_kernel(const WgArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int dir = blockIdx.z, s = blockIdx.y;
  const int ct = ws_col_tiles(a.H);
  const int ih_tiles = ws_ih_tiles(a.D, a.with_ih, a.H);
  int tile = blockIdx.x;
  const bool hh = tile >= ih_tiles;
  if (hh) tile -= ih_tiles;
  const int m0 = (tile / ct) * WS_BM, c0 = (tile % ct) * WS_BN;
  if (!hh && !PAIR) {
    wgrad_tile<false, true>(a, dir, s, false, m0, c0, smem);
  } else {
    wgrad_tile<PAIR, false>(a, dir, s, hh, m0, c0, smem);
  }
}

// V consecutive floats (V = 4: one 16-byte access)
template <int V>
__device__ __forceinline__ void load_v(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

// out[dir][row][c] = part[0] + part[1] + ... + part[S-1], added in that
// order, V columns of one row per thread (V = 4 where 3H and every pointer
// allow 16-byte accesses)
template <int V>
__global__ void __launch_bounds__(WS_SUM_THREADS) wgrad_sum_kernel(
    const float* __restrict__ part, int S, int D, int with_ih, int H, DirG g0, DirG g1) {
  const int H3 = 3 * H, R = ws_rows(D, with_ih, H);
  const long long per_dir = (long long)R * H3, total = 2 * per_dir;
  for (long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V; idx < total;
       idx += (long long)gridDim.x * blockDim.x * V) {
    float acc[V], v[V];
    load_v(acc, part + idx);
#pragma unroll 4
    for (int s = 1; s < S; ++s) {
      load_v(v, part + (size_t)s * total + idx);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += v[j];
    }
    const int dir = (int)(idx / per_dir);
    const int rem = (int)(idx - dir * per_dir);
    int row = rem / H3;
    const int cc = rem - row * H3;
    float* dst;
    if (with_ih && row <= D) {
      dst = row < D ? (dir ? g1.w_ih : g0.w_ih) + (size_t)row * H3 + cc
                    : (dir ? g1.b_ih : g0.b_ih) + cc;
    } else {
      row -= with_ih ? D + 1 : 0;
      dst = row < H ? (dir ? g1.w_hh : g0.w_hh) + (size_t)row * H3 + cc
                    : (dir ? g1.b_hh : g0.b_hh) + cc;
    }
    store_v(dst, acc);
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int launch_split(WgArgs& a, float* part, bool pair, void* stream) {
  const int S = ws_slices(a.T, a.B);
  if (S > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  a.part = S > 1 ? part : nullptr;
  a.vec = (a.H % 4) == 0 && aligned16(a.h0[0]) && aligned16(a.h0[1]) &&
          aligned16(a.out[0]) && aligned16(a.out[1]) && aligned16(a.dxp) &&
          aligned16(a.dhpn) && aligned16(a.in.xa) && aligned16(a.in.xb);
  dim3 grid(ws_tiles(a.D, a.with_ih, a.H), S, 2);
  const auto kernel = pair ? wgrad_split_kernel<true> : wgrad_split_kernel<false>;
  if (int e = allow_smem(kernel, WS_SMEM)) return e;
  kernel<<<grid, WS_THREADS, WS_SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bigru_window_wgrad_slice_rows() { return WS_SLICE_ROWS; }

// the partials' bytes: (S, 2, R, 3H) float32 at S > 1 slices, else none
long long bigru_window_wgrad_scratch_bytes(int D, int with_ih, int T, int B, int H) {
  const int S = ws_slices(T, B);
  return S > 1 ? 4LL * S * 2 * ws_rows(D, with_ih, H) * 3 * H : 0;
}

// The in-projection form (pass 2 of bigru_window_bwd): the image (img
// non-null) or the pair (xa, xb, D = 2H); writes dW_ih (D, 3H), dW_hh
// (H, 3H), db_ih, db_hh (3H,) per direction, or at S > 1 each slice's
// partials into `part`, which bigru_window_wgrad_sum then adds.
int bigru_window_wgrad_split_in(const uint8_t* img, long long sb, long long sl, int start,
                                const float* xa, const float* xb, int D, const float* h0_f,
                                const float* h0_b, const float* out_f, const float* out_b,
                                const float* dxp, const float* dhpn, float* dwi_f,
                                float* dwh_f, float* dbi_f, float* dbh_f, float* dwi_b,
                                float* dwh_b, float* dbi_b, float* dbh_b, float* part, int T,
                                int B, int H, void* stream) {
  if (H < 1 || H > MAX_H || D < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const bool pair = img == nullptr;
  if (pair && D != 2 * H) return (int)cudaErrorInvalidValue;
  WgArgs a{WindowIn{img, sb, sl, start, xa, xb}, D, 1, 0, {h0_f, h0_b}, {out_f, out_b},
           dxp, dhpn, nullptr,
           {DirG{dwi_f, dwh_f, dbi_f, dbh_f}, DirG{dwi_b, dwh_b, dbi_b, dbh_b}}, T, B, H};
  return launch_split(a, part, pair, stream);
}

// The xp form (pass 2 of bigru_window_xp_bwd): dW_hh (H, 3H) and db_hh (3H,)
// per direction, or the partials.
int bigru_window_wgrad_split_xp(const float* h0_f, const float* h0_b, const float* out_f,
                                const float* out_b, const float* dxp, const float* dhpn,
                                float* dwh_f, float* dbh_f, float* dwh_b, float* dbh_b,
                                float* part, int T, int B, int H, void* stream) {
  if (H < 1 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  WgArgs a{WindowIn{nullptr, 0, 0, 0, nullptr, nullptr}, 0, 0, 0, {h0_f, h0_b},
           {out_f, out_b}, dxp, dhpn, nullptr,
           {DirG{nullptr, dwh_f, nullptr, dbh_f}, DirG{nullptr, dwh_b, nullptr, dbh_b}},
           T, B, H};
  return launch_split(a, part, false, stream);
}

// The slices' partials added in s order into the outputs of either form
// (with_ih: the in-projection form's four per direction, else dW_hh, db_hh).
int bigru_window_wgrad_sum(const float* part, int D, int with_ih, int T, int B, int H,
                           float* dwi_f, float* dwh_f, float* dbi_f, float* dbh_f,
                           float* dwi_b, float* dwh_b, float* dbi_b, float* dbh_b,
                           void* stream) {
  const int S = ws_slices(T, B);
  if (H < 1 || T < 1 || B < 1 || S < 2 || part == nullptr ||
      (with_ih && D < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = 2LL * ws_rows(D, with_ih, H) * 3 * H;
  const DirG g0{dwi_f, dwh_f, dbi_f, dbh_f}, g1{dwi_b, dwh_b, dbi_b, dbh_b};
  const bool vec = H % 4 == 0 && aligned16(part) && aligned16(dwi_f) && aligned16(dwh_f) &&
                   aligned16(dbi_f) && aligned16(dbh_f) && aligned16(dwi_b) &&
                   aligned16(dwh_b) && aligned16(dbi_b) && aligned16(dbh_b);
  const int v = vec ? 4 : 1;
  const int blocks = (int)((total / v + WS_SUM_THREADS - 1) / WS_SUM_THREADS);
  if (vec) {
    wgrad_sum_kernel<4><<<blocks, WS_SUM_THREADS, 0, (cudaStream_t)stream>>>(
        part, S, D, with_ih, H, g0, g1);
  } else {
    wgrad_sum_kernel<1><<<blocks, WS_SUM_THREADS, 0, (cudaStream_t)stream>>>(
        part, S, D, with_ih, H, g0, g1);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
