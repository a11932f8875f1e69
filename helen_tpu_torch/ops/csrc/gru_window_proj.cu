// The xp route's input projection: both directions of one bi-GRU layer over
// one window in one launch,
//   xp[d] (M, 3H) = x (M, D) W_ih[d] (D, 3H) + b_ih[d],   M = T * B rows n = t * B + b,
// written as one (2, M, 3H) buffer whose halves K3 (gru_window_xp*.cu) takes
// as they are. x is read where it lies: the uint8 image (B, L, D) at column
// start + t, a float32 image the same way, or the previous layer's halves
// (xa, xb) (T, B, H), row [xa | xb]. It replaces no TPU kernel: helen_tpu
// leaves this product to XLA's dot; the port had it as torch.matmul (fp32
// FMA on cuBLAS, no tensor cores) plus a bias add and a cat or cast per
// direction (ops/gru_window_proj.py).
//
// What bounds it on the H100: operations at the decoder (M = 51,200 at
// B = 512, D = 2048, N = 6H = 6144: 1.29 TFLOP, 7.8 ms at the 3xTF32 rate of
// 165 TFLOP/s), bytes at layer 0 (D = 90: its 1.26 GB of output, 0.38 ms at
// 3.35 TB/s). fp32 FMA peaks at 67 TFLOP/s, so only the tensor cores move the
// decoder, and the parity tier never takes single-pass TF32. Operand traffic
// binds next to the tensor cores: each tf32 wgmma reads its shared-memory
// operand anew, and every 128 x 128 x 32 chunk brings 48 KB through L2. The
// design:
//   1. 3xTF32 on wgmma: each product is a_hi b_hi + a_hi b_lo + a_lo b_hi,
//      hi = tf32_rna(a), lo = tf32_rna(a - hi) (gru_window_common.cuh). The
//      image is exact in TF32 (lo = 0), so layer 0 runs two products.
//   2. The weights come split: the wrapper keeps W_ih's hi and lo parts for
//      both directions, K-major (2, 6H, KP), KP = XJ_BK x chunks with zero
//      rows at each half's pad, once per weights version. TMA loads their
//      128 x 32 tiles into shared memory, 128-byte swizzled.
//   3. A comes by TMA as well where its rows allow (the pair at H % 4 == 0;
//      the image's bytes at B % 64 == 0), else by the producer's cp.async,
//      and is split once per chunk, in registers: each consumer thread loads
//      its fragment of its warpgroup's 64 rows, splits it, and hands hi and
//      lo to wgmma as register operands, so that the tensor cores read only
//      B from shared memory. The image's bytes become floats the same way.
//   4. The tensor cores add into their sums with truncation, so each chunk
//      of XJ_BK = 32 (12 wgmmas) is summed from zero in them and then added
//      to fp32 running sums, rounded to nearest (the remedy pass 2 of the
//      backward takes, gru_window_wgrad.cu). The bias is added once, in the
//      epilogue.
//   5. A ring of stages (3 for float sources, 4 for the image), one
//      producer warp, two consumer warpgroups (64 x 128 each), each loading
//      the next k step's fragment while the step before runs (two k steps'
//      fragments in registers: with the 64 accumulators and 64 running sums
//      that fits the 168 registers a thread of nine warps gets, no spill). Persistent
//      blocks, one per SM, walk the tiles in groups of XJ_GROUP_M row blocks,
//      so that a group's rows and the weights' column tiles stay in L2; one
//      tile's epilogue overlaps the next one's loads. The epilogue writes the
//      tile (bias added) to shared memory and the TMA stores it.
// No atomics: two launches give the same bits.

#include <cuda.h>
#include <string.h>

#include "gru_window_cluster.cuh"

namespace {

constexpr int XJ_BM = 128;  // rows of a block tile: two warpgroups of 64
constexpr int XJ_BN = 128;  // columns of a block tile (of N = 6H)
constexpr int XJ_BK = 32;   // reduction columns of a chunk: one 128-byte fp32 row
constexpr int XJ_CONSUMERS = 2;  // warpgroups
constexpr int XJ_THREADS = 128 * XJ_CONSUMERS + 32;  // and one producer warp
constexpr int XJ_GROUP_M = 16;  // row blocks per group of the tile order
constexpr int XJ_RAW_ROW = 48;  // image bytes staged per row and chunk: 3 units of 16

enum { XJ_U8 = 0, XJ_F32 = 1, XJ_PAIR = 2 };

// A stage, from a 1024-byte aligned base (the 128-byte swizzle's period): B's
// hi and lo tiles, then A's float tile (swizzled) or the image's raw bytes.
// After the stages, each warpgroup's 64 x 128 output tile on its way out
// (as XJ_BN / 32 boxes of 64 x 32, 128-byte swizzled), then the mbarriers.
constexpr int XJ_TILE_B = XJ_BN * XJ_BK * 4;  // 16 KB, each of hi and lo
constexpr int XJ_TILE_A = XJ_BM * XJ_BK * 4;  // 16 KB
constexpr int XJ_RAW = XJ_BM * XJ_RAW_ROW;    // 6 KB
constexpr int XJ_OUT_BOX = 64 * 32 * 4;       // 8 KB
constexpr int XJ_OUT = 64 * XJ_BN * 4;        // 32 KB a warpgroup
// stages of the ring: 4 where A is the image's few bytes, 3 where it is a float tile
__host__ __device__ constexpr int xj_stages(int src) { return src == XJ_U8 ? 4 : 3; }
__host__ __device__ constexpr int xj_stage_bytes(int src) {
  return 2 * XJ_TILE_B + (src == XJ_U8 ? XJ_RAW : XJ_TILE_A);
}
__host__ __device__ constexpr int xj_out_offset(int src) {
  return xj_stages(src) * xj_stage_bytes(src);
}
__host__ __device__ constexpr int xj_bar_offset(int src) {
  return xj_out_offset(src) + XJ_CONSUMERS * XJ_OUT;
}
__host__ __device__ constexpr size_t xj_smem_bytes(int src) {
  return (size_t)xj_bar_offset(src) + 2 * xj_stages(src) * 8 + 1024;
}
static_assert(xj_stage_bytes(XJ_U8) % 1024 == 0 && xj_stage_bytes(XJ_F32) % 1024 == 0,
              "stages keep the swizzle's alignment");
static_assert(xj_smem_bytes(XJ_PAIR) <= 232448 && xj_smem_bytes(XJ_U8) <= 232448,
              "the H100's opt-in shared memory per block");
// A's bytes by TMA per chunk: the pair's float tile, or the image's bytes
__host__ __device__ constexpr unsigned xj_tma_a_bytes(int src) {
  return src == XJ_PAIR ? XJ_TILE_A : XJ_RAW;
}

struct ProjArgs {
  const void* a0;        // the image (uint8 or float32), or xa
  const void* a1;        // xb (pair only)
  long long sb, sl;      // the image's element strides (b, l); unit feature stride
  int start;             // the window's first image column
  const uint8_t* end;    // uint8 image: one past the last readable byte of its storage
  int vec;               // float sources: every row 16-byte aligned
  int tma;               // A by TMA (amap0/amap1), else by the producer's cp.async
  int tma_out;           // the output by TMA (omap: 3H % 32 == 0), else by st.global
  const float* b_f;      // (3H,)
  const float* b_b;
  float* out;            // (2, M, 3H)
  int M, B, D, H;
  int chunks, half;      // chunks of XJ_BK; pair: chunks per half
};

// ---------------------------------------------------------------------------
// Hopper primitives: TMA, cp.async with zero fill, wgmma (tf32, A in
// registers, B K-major in shared memory under the 128-byte swizzle)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// the stage's full barrier counts one arrival per thread once the thread's
// earlier cp.asyncs have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// `bytes` (0..16) of src, zeros for the rest of the 16
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int x, int y,
                                            int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int x,
                                             int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%1, %2, %3}], [%4];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(x), "r"(y), "r"(z), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the thread's bulk stores have read their shared memory (READ) or are done
template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if (READ) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// the generic proxy's shared-memory writes made visible to the TMA's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// B, K-major in 8-row groups 1024 bytes apart, 128-byte swizzled: start
// address, leading offset (unused by this layout: 1), stride offset 1024,
// layout SWIZZLE_128B. The k-th 8-column step starts 32 k bytes in.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// at most N of the warpgroup's committed wgmma groups still run
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulators, or reusing the
// registers of A's fragments, across a wgmma fence or wait
template <typename T, int N>
__device__ __forceinline__ void fence_operands(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(reinterpret_cast<unsigned&>(d[i]))::"memory");
}

#define XJ_R8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),         \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, the m64n128 fp32 fragment) = [d if ACC] + A (64 x 8) B (8 x 128),
// A this warpgroup's registers (a[j]: row g + 8 (j & 1), column q + 4 (j >> 1)
// of the warp's 16 x 8), B from shared memory
template <int ACC>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const unsigned (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : XJ_R8(0), XJ_R8(8), XJ_R8(16), XJ_R8(24), XJ_R8(32), XJ_R8(40), XJ_R8(48), XJ_R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(ACC)
      : "memory");
}

#undef XJ_R8

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// tile -> (first row, first column): groups of XJ_GROUP_M row blocks, the
// row block moving fastest within a group
__device__ __forceinline__ void tile_origin(int tile, int mt, int nt, int& m0, int& n0) {
  const int per_group = XJ_GROUP_M * nt;
  const int g = tile / per_group, first = g * XJ_GROUP_M;
  const int gm = min(mt - first, XJ_GROUP_M);
  const int r = tile - g * per_group;
  m0 = (first + r % gm) * XJ_BM;
  n0 = (r / gm) * XJ_BN;
}

// the image element (b, start + t, 0) of row n
template <typename T>
__device__ __forceinline__ const T* image_row(const ProjArgs& a, int n) {
  const int t = n / a.B, b = n - t * a.B;
  return static_cast<const T*>(a.a0) + b * a.sb + (a.start + t) * a.sl;
}

// The image's bytes of row n and chunk c are staged as the 16-byte units that
// cover them: the first of them sits `image_off` bytes into its row's 48.
__device__ __forceinline__ int image_off(const ProjArgs& a, int n, int c) {
  return (int)(reinterpret_cast<uintptr_t>(image_row<uint8_t>(a, n) + XJ_BK * c) & 15);
}

// The producer's A for chunk c of the tile at row m0 without TMA, all 32
// lanes: float rows into the stage's A tile (swizzled, zeros past the rows
// and columns), or the image's byte units into its raw area.
template <int SRC>
__device__ __forceinline__ void stage_a(const ProjArgs& a, uint8_t* A, int m0, int c, int lane) {
  if (SRC == XJ_U8) {
#pragma unroll 4
    for (int i = lane; i < XJ_BM * 3; i += 32) {
      const int R = i / 3, u = i - 3 * R, n = m0 + R;
      const uint8_t* src = static_cast<const uint8_t*>(a.a0);
      int bytes = 0;
      if (n < a.M) {
        const uint8_t* unit = reinterpret_cast<const uint8_t*>(
            (reinterpret_cast<uintptr_t>(image_row<uint8_t>(a, n) + XJ_BK * c) & ~(uintptr_t)15) +
            16 * u);
        const long long left = a.end - unit;
        bytes = left >= 16 ? 16 : (left > 0 ? (int)left : 0);
        if (bytes) src = unit;
      }
      cp_async16_zfill(A + R * XJ_RAW_ROW + 16 * u, src, bytes);
    }
    return;
  }
  const int u = lane & 7;  // 8 lanes a row, one 16-byte unit each
  int col = XJ_BK * c, klim = a.D;
  const float* half = nullptr;
  if (SRC == XJ_PAIR) {
    const bool second = c >= a.half;
    col = XJ_BK * (second ? c - a.half : c);
    klim = a.H;
    half = static_cast<const float*>(second ? a.a1 : a.a0);
  }
  const int k = col + 4 * u;
  const int kv = max(0, min(4, klim - k));  // this unit's columns inside the row
#pragma unroll 4
  for (int R = lane >> 3; R < XJ_BM; R += 4) {
    const int n = m0 + R;
    uint8_t* dst = A + R * 128 + ((u ^ (R & 7)) << 4);
    const bool live = n < a.M && kv > 0;
    const float* src = static_cast<const float*>(a.a0);
    if (live) {
      src = (SRC == XJ_PAIR ? half + (size_t)n * a.H : image_row<float>(a, n)) + k;
    }
    if (a.vec) {
      cp_async16_zfill(dst, src, live ? 4 * kv : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = live && e < kv;
        cp_async4_zfill(dst + 4 * e, in ? src + e : src, in ? 4 : 0);
      }
    }
  }
}

// The TMA form of stage_a, from the producer's lane 0. The pair: the half's
// 128 x 32 box (rows past M and columns past H filled with zeros), in the
// swizzled layout above. The image, at B % 64 == 0: two boxes of 64 rows x 48
// bytes, each at one window column t for 64 batch rows, from the 16-byte unit
// that holds the chunk's first byte (rows past M repeat the last 64; the
// consumers zero them).
template <int SRC>
__device__ __forceinline__ void tma_a(const ProjArgs& a, uint8_t* A, int m0, int c,
                                      const CUtensorMap* amap0, const CUtensorMap* amap1,
                                      uint64_t* bar) {
  if (SRC == XJ_PAIR) {
    const bool second = c >= a.half;
    tma_load_2d(A, second ? amap1 : amap0, XJ_BK * (second ? c - a.half : c), m0, bar);
  } else if (SRC == XJ_U8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = min(m0 + 64 * h, a.M - 64), t = n / a.B;
      tma_load_2d(A + 64 * XJ_RAW_ROW * h, amap0,
                  (int)((a.start + t) * a.sl + XJ_BK * c) & ~15, n - t * a.B, bar);
    }
  }
}

// A consumer thread's fragment of k step ks of a chunk: rows r and r + 8 (r =
// 16 w + g of its warpgroup's 64), columns 8 ks + q and 8 ks + q + 4. Float
// sources: split into hi and lo. The image: its bytes as floats, exact in
// TF32 (lo unused), from `k0` (the chunk's first column) at `off0`/`off1`
// into the rows' raw bytes (-1: a row past M); zeros past M and past D.
template <int SRC>
__device__ __forceinline__ void load_a(const ProjArgs& a, const uint8_t* A, int k0, int ks,
                                       int r, int q, int off0, int off1, unsigned (&hi)[4],
                                       unsigned (&lo)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = r + 8 * (j & 1), k = 8 * ks + q + 4 * (j >> 1);
    if (SRC == XJ_U8) {
      const int off = j & 1 ? off1 : off0;
      const bool in = off >= 0 && k0 + k < a.D;
      hi[j] = __float_as_uint(in ? (float)A[row * XJ_RAW_ROW + off + k] : 0.0f);
    } else {
      // the 128-byte swizzle: column k of row `row` in 16-byte unit (k / 4) ^ (row & 7)
      const int unit = (k >> 2) ^ (row & 7);
      split_tf32(*reinterpret_cast<const float*>(A + row * 128 + unit * 16 + 4 * q), hi[j],
                 lo[j]);
    }
  }
}

template <int SRC>
__global__ void __launch_bounds__(XJ_THREADS, 1)
    proj_kernel(const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap amap0,
                const __grid_constant__ CUtensorMap amap1,
                const __grid_constant__ CUtensorMap omap, const ProjArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  constexpr int STAGE = xj_stage_bytes(SRC), STAGES = xj_stages(SRC);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + xj_bar_offset(SRC));
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the expect_tx, and without TMA for A each producer lane's copies
      mbar_init(full + s, a.tma ? 1 : 32 + 1);
      mbar_init(empty + s, 4 * XJ_CONSUMERS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int H3 = 3 * a.H, N = 2 * H3;
  const int mt = (a.M + XJ_BM - 1) / XJ_BM, nt = (N + XJ_BN - 1) / XJ_BN;
  const int tiles = mt * nt;

  if (tid >= 128 * XJ_CONSUMERS) {  // the producer warp
    const int lane = tid & 31;
    int q = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, mt, nt, m0, n0);
      for (int c = 0; c < a.chunks; ++c, ++q) {
        const int slot = q % STAGES;
        mbar_wait(empty + slot, ((q / STAGES) & 1) ^ 1u);
        uint8_t* st = base + slot * STAGE;
        if (lane == 0) {
          mbar_expect_tx(full + slot, 2 * XJ_TILE_B + (a.tma ? xj_tma_a_bytes(SRC) : 0));
          tma_load_3d(st, &wmap, XJ_BK * c, n0, 0, full + slot);
          tma_load_3d(st + XJ_TILE_B, &wmap, XJ_BK * c, n0, 1, full + slot);
          if (a.tma) tma_a<SRC>(a, st + 2 * XJ_TILE_B, m0, c, &amap0, &amap1, full + slot);
        }
        if (!a.tma) {
          stage_a<SRC>(a, st + 2 * XJ_TILE_B, m0, c, lane);
          cp_async_arrive(full + slot);
        }
      }
    }
    // stay until the consumers have released every stage: no copy of this
    // block's is still landing when it exits
    for (int i = 0; i < STAGES; ++i, ++q) {
      mbar_wait(empty + q % STAGES, ((q / STAGES) & 1) ^ 1u);
    }
    return;
  }

  // a consumer warpgroup: rows 64 wg .. 64 wg + 63 of each tile
  const int wg = tid >> 7, t = tid & 127;
  const int w = t >> 5, g = (t & 31) >> 2, qd = t & 3;
  const int r = 64 * wg + 16 * w + g;  // the thread's first row of the tile
  uint8_t* out_tile = base + xj_out_offset(SRC) + wg * XJ_OUT;
  float acc[64], run[64];
  unsigned hi[2][4], lo[2][4];  // A's fragments of two k steps: the running one and the next
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  int q = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin(tile, mt, nt, m0, n0);
    // the image: where the rows' bytes start in their staged units (the same
    // in every chunk, 32 bytes apart), -1 past M
    const int off0 = SRC == XJ_U8 && m0 + r < a.M ? image_off(a, m0 + r, 0) : -1;
    const int off1 = SRC == XJ_U8 && m0 + r + 8 < a.M ? image_off(a, m0 + r + 8, 0) : -1;
#pragma unroll
    for (int i = 0; i < 64; ++i) run[i] = 0.0f;
    for (int c = 0; c < a.chunks; ++c, ++q) {
      const int slot = q % STAGES;
      const uint8_t* st = base + slot * STAGE;
      const uint8_t* A = st + 2 * XJ_TILE_B;
      const uint64_t dbh = sw128_desc(st), dbl = sw128_desc(st + XJ_TILE_B);
      mbar_wait(full + slot, (q / STAGES) & 1);
      fence_operands(acc);
      // each k step's fragment loaded while the step before runs, into the
      // registers of the step before that, which has read them by then
#pragma unroll
      for (int ks = 0; ks < XJ_BK / 8; ++ks) {
        const int p = ks & 1;
        load_a<SRC>(a, A, XJ_BK * c, ks, r, qd, off0, off1, hi[p], lo[p]);
        wgmma_fence();
        const uint64_t k = 2 * ks;  // 32 bytes, in the descriptor's 16-byte units
        if (ks == 0) {
          wgmma_tf32<0>(acc, hi[p], dbh + k);
        } else {
          wgmma_tf32<1>(acc, hi[p], dbh + k);
        }
        wgmma_tf32<1>(acc, hi[p], dbl + k);
        if (SRC != XJ_U8) wgmma_tf32<1>(acc, lo[p], dbh + k);
        wgmma_commit();
        if (ks > 0) {
          wgmma_wait<1>();
          fence_operands(hi[p ^ 1]);
          fence_operands(lo[p ^ 1]);
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      constexpr int last = (XJ_BK / 8 - 1) & 1;  // the last k step's fragment
      fence_operands(hi[last]);
      fence_operands(lo[last]);
      if ((t & 31) == 0) mbar_arrive(empty + slot);
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] = __fadd_rn(run[i], acc[i]);
    }
    // epilogue: + b_ih, into the direction's half; fragment element 4i + 2h + e
    // is row r + 8 h, column 8 i + 2 qd + e of the warpgroup's 64 x 128
    if (a.tma_out) {
      // through shared memory: the last tile's stores have read it, then the
      // warpgroup writes its tile and one thread hands it to the TMA
      if (t == 0) bulk_wait_all<true>();
      named_sync(1 + wg, 128);
#pragma unroll
      for (int i = 0; i < XJ_BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * qd, cb = (8 * i) & 31;
        float b2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = col + e >= H3;
          b2[e] = col + e < N ? __ldg((d ? a.b_b : a.b_f) + col + e - d * H3) : 0.0f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * w + g + 8 * h;  // of the warpgroup's 64
          const int unit = ((cb + 2 * qd) >> 2) ^ (row & 7);
          *reinterpret_cast<float2*>(out_tile + (8 * i / 32) * XJ_OUT_BOX + row * 128 +
                                     unit * 16 + ((2 * qd) & 3) * 4) =
              make_float2(run[4 * i + 2 * h] + b2[0], run[4 * i + 2 * h + 1] + b2[1]);
        }
      }
      fence_proxy_async();
      named_sync(1 + wg, 128);
      if (t == 0) {
        // each box of 32 columns into its direction (3H % 32 == 0: no box
        // crosses from one half to the other); rows past M are clipped
        for (int b = 0; b < XJ_BN / 32; ++b) {
          const int c0 = n0 + 32 * b;
          if (c0 >= N) break;
          const int d = c0 >= H3;
          tma_store_3d(&omap, out_tile + b * XJ_OUT_BOX, c0 - d * H3, m0 + 64 * wg, d);
        }
        bulk_commit();
      }
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = m0 + r + 8 * h;
      if (n >= a.M) continue;
#pragma unroll
      for (int i = 0; i < XJ_BN / 8; ++i) {
        const int col = n0 + 8 * i + 2 * qd;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e >= N) continue;
          const int d = col + e >= H3, j = col + e - d * H3;
          a.out[((size_t)d * a.M + n) * H3 + j] =
              run[4 * i + 2 * h + e] + __ldg((d ? a.b_b : a.b_f) + j);
        }
      }
    }
  }
  if (t == 0) bulk_wait_all<false>();
}

// The weights' split for the kernel above, in one pass: out[p][col][k] (p 0:
// hi, 1: lo; col < 6H, both directions side by side; k < kp) from W_ih's row
// for k (pair: row k of the first half up to H, row H + k - kp / 2 of the
// second; else row k up to D; zeros at the pads) and column col of its
// direction. 32 x 32 tiles transposed through shared memory, 32 x 8 threads.
__global__ void proj_split_kernel(const float* __restrict__ wf, const float* __restrict__ wb,
                                  int D, int H, int pair, int kp, float* __restrict__ out) {
  __shared__ float tile[32][33];
  const int H3 = 3 * H, N = 2 * H3, hp = kp / 2;
  const int k0 = blockIdx.x * 32, c0 = blockIdx.y * 32, tx = threadIdx.x;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int k = k0 + r, col = c0 + tx;
    const int row = pair ? (k < hp ? (k < H ? k : -1) : (k - hp < H ? H + k - hp : -1))
                         : (k < D ? k : -1);
    float v = 0.0f;
    if (row >= 0 && col < N) {
      const int d = col >= H3;
      v = (d ? wb : wf)[(size_t)row * H3 + col - d * H3];
    }
    tile[r][tx] = v;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int col = c0 + r;
    if (col < N) {
      unsigned hi, lo;
      split_tf32(tile[tx][r], hi, lo);
      out[(size_t)col * kp + k0 + tx] = __uint_as_float(hi);
      out[((size_t)N + col) * kp + k0 + tx] = __uint_as_float(lo);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int SRC>
int launch_proj(const CUtensorMap& map, const CUtensorMap& amap0, const CUtensorMap& amap1,
                const CUtensorMap& omap, const ProjArgs& a, void* stream) {
  const size_t smem = xj_smem_bytes(SRC);
  if (int e = allow_smem(proj_kernel<SRC>, smem)) return e;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (long long)((a.M + XJ_BM - 1) / XJ_BM) *
                          ((6 * a.H + XJ_BN - 1) / XJ_BN);
  const int grid = (int)(tiles < sms ? tiles : sms);
  proj_kernel<SRC><<<grid, XJ_THREADS, smem, (cudaStream_t)stream>>>(map, amap0, amap1, omap,
                                                                     a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int bigru_window_xp_proj_chunk() { return XJ_BK; }

// src 0: a0 the uint8 image (B, L, D), element strides (sb, sl), window
// columns [start, start + T), `extent` bytes readable from a0 on (to its
// storage's end); 1: a0 a float32 image, the same way; 2: the pair a0 = xa,
// a1 = xb (T, B, H) contiguous, D = 2H. w: the split weights (2, 6H, kp),
// [hi, lo], K-major, kp = 32 x chunks (src 2: ceil(H / 32) chunks a half, each
// half's rows from 32 c); b_f, b_b (3H,); out (2, T * B, 3H).
int bigru_window_xp_proj(int src, const void* a0, const void* a1, long long sb, long long sl,
                         int start, long long extent, const float* w, int kp, const float* b_f,
                         const float* b_b, float* out, int T, int B, int D, int H,
                         void* stream) {
  if (T < 1 || B < 1 || D < 1 || H < 1 || src < XJ_U8 || src > XJ_PAIR ||
      (src == XJ_PAIR && D != 2 * H) || (long long)T * B > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const int half = (H + XJ_BK - 1) / XJ_BK;
  const int chunks = src == XJ_PAIR ? 2 * half : (D + XJ_BK - 1) / XJ_BK;
  if (kp != XJ_BK * chunks || !aligned16(w)) return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t one[3] = {1, 1, 1};
  auto tiled = [&](CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                   const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle) {
    return encode(map, type, rank, const_cast<void*>(base), dims, strides, box, one,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  CUtensorMap map, amap0, amap1, omap;
  memset(&amap0, 0, sizeof(amap0));
  memset(&amap1, 0, sizeof(amap1));
  memset(&omap, 0, sizeof(omap));
  const cuuint64_t wdims[3] = {(cuuint64_t)kp, (cuuint64_t)(6 * H), 2};
  const cuuint64_t wstrides[2] = {(cuuint64_t)kp * 4, (cuuint64_t)kp * 4 * 6 * H};
  const cuuint32_t wbox[3] = {XJ_BK, XJ_BN, 1};
  if (!tiled(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, w, wdims, wstrides, wbox,
             CU_TENSOR_MAP_SWIZZLE_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  ProjArgs a{a0, a1, sb, sl, start, static_cast<const uint8_t*>(a0) + extent, 0, 0, 0, b_f,
             b_b, out, T * B, B, D, H, chunks, half};
  // the output as (2, M, 3H) floats, in boxes of 64 rows x 32 columns
  a.tma_out = (3 * H) % 32 == 0 && aligned16(out);
  const cuuint64_t odims[3] = {(cuuint64_t)(3 * H), (cuuint64_t)(T * B), 2};
  const cuuint64_t ostrides[2] = {(cuuint64_t)(3 * H) * 4, (cuuint64_t)(3 * H) * 4 * T * B};
  const cuuint32_t obox[3] = {32, 64, 1};
  if (a.tma_out && !tiled(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, out, odims, ostrides, obox,
                          CU_TENSOR_MAP_SWIZZLE_128B)) {
    return (int)cudaErrorInvalidValue;
  }
  if (src == XJ_U8) {
    // TMA where every 64 rows share a window column and whole 16-byte units
    // tile the image: the image as (B, sb) bytes, boxes from 16-byte units
    a.tma = B % 64 == 0 && sb % 16 == 0 && aligned16(a0);
    const cuuint64_t dims[2] = {(cuuint64_t)sb, (cuuint64_t)B}, strides[1] = {(cuuint64_t)sb};
    const cuuint32_t box[2] = {XJ_RAW_ROW, 64};
    if (a.tma && !tiled(&amap0, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, a0, dims, strides, box,
                        CU_TENSOR_MAP_SWIZZLE_NONE)) {
      return (int)cudaErrorInvalidValue;
    }
    return launch_proj<XJ_U8>(map, amap0, amap1, omap, a, stream);
  }
  if (src == XJ_F32) {
    a.vec = aligned16(a0) && sb % 4 == 0 && sl % 4 == 0;
    return launch_proj<XJ_F32>(map, amap0, amap1, omap, a, stream);
  }
  a.vec = H % 4 == 0 && aligned16(a0) && aligned16(a1);
  a.tma = a.vec;  // each half as (M, H) floats, rows of whole 16-byte units
  const cuuint64_t dims[2] = {(cuuint64_t)H, (cuuint64_t)(T * B)};
  const cuuint64_t strides[1] = {(cuuint64_t)H * 4};
  const cuuint32_t box[2] = {XJ_BK, XJ_BM};
  if (a.tma && !(tiled(&amap0, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a0, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B) &&
                 tiled(&amap1, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a1, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B))) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_proj<XJ_PAIR>(map, amap0, amap1, omap, a, stream);
}

// The split weights (2, 6H, kp) of one layer for bigru_window_xp_proj from its
// W_ih per direction (D, 3H), pair: D = 2H.
int bigru_window_xp_proj_split(const float* w_f, const float* w_b, int D, int H, int pair,
                               int kp, float* out, void* stream) {
  const int half = (H + XJ_BK - 1) / XJ_BK;
  if (D < 1 || H < 1 || (pair && D != 2 * H) ||
      kp != XJ_BK * (pair ? 2 * half : (D + XJ_BK - 1) / XJ_BK)) {
    return (int)cudaErrorInvalidValue;
  }
  proj_split_kernel<<<dim3(kp / 32, (6 * H + 31) / 32), dim3(32, 8), 0,
                      (cudaStream_t)stream>>>(w_f, w_b, D, H, pair, kp, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
