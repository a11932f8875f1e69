// What the two-CTA cluster designs of the fused encoder+decoder window
// share (K5 in gru_window_smem.cu, K5f in gru_window_fast.cu): the
// producer/consumer ring's constants and mbarriers, the named barriers that
// keep producer and consumer warps apart, the cluster barrier of the
// encoder -> decoder hand-off, and the cluster launch.
//
// The shape of both kernels: one cluster of two CTAs per group of R batch
// rows, CTA rank 0 the forward direction, rank 1 the backward one. Each CTA
// runs its direction's encoder layer, then its decoder layer. Its consumer
// warps (the first ones) run the recurrence step; its producer warps (the
// rest) project the layer's input, xp = x W_ih + b_ih, EC_ROWS rows at a
// time (a chunk: EC_ROWS / R steps of R rows, in the direction's own step
// order) into a ring of EC_STAGES chunks. A full[s] mbarrier tells the
// consumers that chunk slot s holds xp (every producer thread arrives once),
// an empty[s] one tells the producers that the consumers are done with it
// (every consumer thread arrives once). The consumers meet once per step on
// named barrier EC_BAR_CONS, the producers once per k stage on
// EC_BAR_PROD; neither joins the other's.
//
// The hand-off: the encoder's outputs (the boundary) go to a per-cluster
// slice of device memory at their original time positions. Both directions'
// decoders read both directions' encoder outputs, so each CTA fences its
// writes (__threadfence) and the cluster meets on its barrier
// (barrier.cluster arrive.release / wait.acquire) before any decoder input
// is read; those reads go through L2 only (__ldcg, cp.async.cg), since L1 is
// not coherent within a launch. The decoder's h0 is the encoder's final
// state, which the consumer holds.

#pragma once

#include "gru_window_grid.cuh"

namespace {

constexpr int EC_ROWS = 32;    // rows of one projected chunk (steps x batch rows)
constexpr int EC_STAGES = 2;   // chunks in the ring
constexpr int EC_BAR_CONS = 1;  // named barrier of the consumer warps
constexpr int EC_BAR_PROD = 2;  // named barrier of the producer warps
constexpr int EC_BAR_ALL = 3;   // named barrier of both, where the roles meet

// bar.sync on named barrier `id` for `n` threads (a multiple of 32)
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// arrive once (release, CTA scope: the thread's earlier reads and writes,
// to shared and to device memory, are ordered before the phase completes)
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait (acquire, CTA scope) for the completion of the phase of parity
// `parity`; a wait past GRID_SPIN_NS traps, so that a fault fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = globaltimer();
    } else if (globaltimer() - t0 > GRID_SPIN_NS) {
      __trap();
    }
  }
}

// The ring's position of global chunk q (chunks count on across both
// layers): its slot, and the parity of the phase that marks it full (and,
// for q >= EC_STAGES, that marked its slot empty the round before).
struct RingPos {
  int slot;
  unsigned parity;
  __device__ explicit RingPos(int q) : slot(q % EC_STAGES), parity((q / EC_STAGES) & 1) {}
};

// the full[EC_STAGES] and empty[EC_STAGES] mbarriers at the start of the
// block's dynamic shared memory
constexpr int EC_BAR_BYTES = 2 * EC_STAGES * 8;

__device__ __forceinline__ void ring_init(uint64_t* bars, int producers, int consumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < EC_STAGES; ++s) {
      mbar_init(bars + s, producers);
      mbar_init(bars + EC_STAGES + s, consumers);
    }
  }
}

// the producers' wait before they overwrite the slot of chunk q
__device__ __forceinline__ void ring_wait_empty(uint64_t* bars, int q) {
  if (q >= EC_STAGES) {
    const RingPos p(q);
    mbar_wait(bars + EC_STAGES + p.slot, p.parity ^ 1u);
  }
}

__device__ __forceinline__ void ring_wait_full(uint64_t* bars, int q) {
  const RingPos p(q);
  mbar_wait(bars + p.slot, p.parity);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_id_x() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of both CTAs has fenced its device-memory writes and met
// the others: the encoder -> decoder hand-off.
__device__ __forceinline__ void cluster_handoff() {
  __threadfence();
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The arguments of both cluster kernels: the image window, both layers'
// weights per direction (W: fp32, or bf16 in the fast tier), h0, the
// decoder's outputs, and the scratch the wrapper allocates: the boundary
// ([cluster][2][T][R][H], fp32 or bf16) and, in the parity tier, the xp
// ring ([CTA][EC_STAGES][EC_ROWS][3H] fp32).
template <typename W>
struct EncdecArgs {
  WindowIn in;
  int D;
  const float* h0_f;
  const float* h0_b;
  DirParams<W> ef, eb, df, db;
  float* out_f;
  float* out_b;
  float* hn_f;
  float* hn_b;
  void* eo;
  float* ring;
  int T, B, H;
  // the weights of layer L (0 the encoder, 1 the decoder) in direction dir
  __device__ const DirParams<W>& layer(int L, int dir) const {
    return L ? (dir ? db : df) : (dir ? eb : ef);
  }
};

__host__ __device__ inline int round32(int n) { return (n + 31) / 32 * 32; }
__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// The launch configuration of `clusters` clusters of two CTAs of `threads`.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int clusters, int threads, size_t smem, void* stream) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(2 * clusters);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of the kernel the card holds at once (0: none, and the
// launch would fail), or a negative CUDA error.
template <typename Kernel>
int active_clusters(Kernel kernel, int threads, size_t smem) {
  if (int e = allow_smem(kernel, smem)) return -e;
  ClusterLaunch l(1, threads, smem, nullptr);
  int n = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &l.cfg)) {
    return -(int)e;
  }
  return n;
}

}  // namespace
