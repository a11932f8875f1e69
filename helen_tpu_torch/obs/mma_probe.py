"""How the card sums a chain of bf16 tensor-core products: the card's
``mma.sync.m16n8k16`` results against the plain models of the fast tier's
step product.

    python -m helen_tpu_torch.obs.mma_probe [--seed 0]

A probe kernel (one warp per 16 x 8 tile, ``D = C + A B`` over K in k
order, one instruction per 16 k, as K3f's grid design issues them) runs on
random bf16 operands and float32 accumulators of several kinds: one
instruction with operands spread over 2^-8 .. 2^8, with plain normal
operands, with a zero, a large and a small ``C``; chains of K=64 and of
K=1024 from ``C = 0`` at the grid's operand sizes (``h`` in (-1, 1),
``W_hh`` ~ 1/32). Each line gives the share of the outputs that equal, bit
for bit, ``models.gru.mma_product`` (the model K3f's plain version uses for
the grid design) and k-order FMA chains (``models.gru.ordered_product``,
the chain design's order). It needs a CUDA device and ``nvcc``; it prints the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

SOURCE = r"""
#include <cuda_bf16.h>
__global__ void probe(const __nv_bfloat16* A, const __nv_bfloat16* Bt, const float* C,
                      float* D, int tiles, int K) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) / 32, ln = threadIdx.x % 32;
  if (warp >= tiles) return;
  const int g = ln / 4, tq = ln % 4;
  const __nv_bfloat16* a = A + (size_t)warp * 16 * K;
  const __nv_bfloat16* b = Bt + (size_t)warp * 8 * K;
  const float* c = C + (size_t)warp * 128;
  float acc[4] = {c[g * 8 + 2 * tq], c[g * 8 + 2 * tq + 1], c[(g + 8) * 8 + 2 * tq],
                  c[(g + 8) * 8 + 2 * tq + 1]};
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned ar[4], br[2];
    ar[0] = *(const unsigned*)(a + (size_t)g * K + k0 + 2 * tq);
    ar[1] = *(const unsigned*)(a + (size_t)(g + 8) * K + k0 + 2 * tq);
    ar[2] = *(const unsigned*)(a + (size_t)g * K + k0 + 2 * tq + 8);
    ar[3] = *(const unsigned*)(a + (size_t)(g + 8) * K + k0 + 2 * tq + 8);
    br[0] = *(const unsigned*)(b + (size_t)g * K + k0 + 2 * tq);
    br[1] = *(const unsigned*)(b + (size_t)g * K + k0 + 2 * tq + 8);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
        : "r"(ar[0]), "r"(ar[1]), "r"(ar[2]), "r"(ar[3]), "r"(br[0]), "r"(br[1]));
  }
  float* d = D + (size_t)warp * 128;
  d[g * 8 + 2 * tq] = acc[0];
  d[g * 8 + 2 * tq + 1] = acc[1];
  d[(g + 8) * 8 + 2 * tq] = acc[2];
  d[(g + 8) * 8 + 2 * tq + 1] = acc[3];
}
extern "C" int run_probe(const void* A, const void* Bt, const void* C, void* D, int tiles,
                         int K) {
  probe<<<(tiles * 32 + 255) / 256, 256>>>((const __nv_bfloat16*)A, (const __nv_bfloat16*)Bt,
                                          (const float*)C, (float*)D, tiles, K);
  return (int)cudaDeviceSynchronize();
}
"""


def build() -> ctypes.CDLL:
    from helen_tpu_torch.ops import library
    from helen_tpu_torch.utils.build import build_dir

    d = build_dir("mma_probe")
    src, so = os.path.join(d, "probe.cu"), os.path.join(d, "probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([library.nvcc(), *library.NVCC_FLAGS, "-shared", "-o", so, src], check=True,
                   capture_output=True)
    return ctypes.CDLL(so)


def cases(gen):
    """{name: (A (T, 16, K), Bt (T, 8, K) bf16, C (T, 16, 8) float32)} on the CPU."""
    import torch

    def case(T, K, spread, cscale, a_unit=False, w_scale=1.0):
        if a_unit:
            A = torch.rand(T, 16, K, generator=gen) * 2 - 1
            B = (torch.rand(T, 8, K, generator=gen) * 2 - 1) * w_scale
        else:
            A, B = torch.randn(T, 16, K, generator=gen), torch.randn(T, 8, K, generator=gen)
        if spread:
            A = A * torch.exp2(torch.randint(-spread, spread + 1, A.shape, generator=gen).float())
            B = B * torch.exp2(torch.randint(-spread, spread + 1, B.shape, generator=gen).float())
        C = torch.randn(T, 16, 8, generator=gen) * cscale
        return A.to(torch.bfloat16), B.to(torch.bfloat16), C

    return {"K=16, operands 2^-8..2^8, C ~ 4": case(2048, 16, 8, 4.0),
            "K=16, normal operands, C ~ 1": case(2048, 16, 0, 1.0),
            "K=16, C = 0": case(2048, 16, 4, 0.0),
            "K=16, C ~ 64": case(2048, 16, 2, 64.0),
            "K=16, C ~ 1/64": case(2048, 16, 2, 1 / 64),
            "K=64 chain, operands 2^-4..2^4": case(1024, 64, 4, 1.0),
            "K=1024 chain from 0, h in (-1, 1), W ~ 1/32": case(256, 1024, 0, 0.0, True,
                                                                1 / 32)}


def _chain(x, w, c):
    """``c + x @ w`` as k-order FMA chains from ``c``."""
    acc = c.clone()
    for k in range(x.shape[-1]):
        acc.addcmul_(x[..., k:k + 1], w[..., k:k + 1, :])
    return acc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mma_probe needs a CUDA device", file=sys.stderr)
        return 1
    from helen_tpu_torch.models.gru import mma_product

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    lib, dev = build(), torch.device("cuda")
    ok = True
    for name, (A, Bt, C) in cases(torch.Generator().manual_seed(args.seed)).items():
        T, _, K = A.shape
        a, b, c = A.to(dev), Bt.to(dev), C.to(dev)
        D = torch.empty(T, 16, 8, device=dev)
        rc = lib.run_probe(*(ctypes.c_void_p(t.data_ptr()) for t in (a, b, c, D)), T, K)
        if rc:
            raise RuntimeError(f"probe launch failed: CUDA error {rc}")
        x, w = a.float(), b.float().transpose(1, 2)
        model, chain = mma_product(x, w, c), _chain(x, w, c)
        m, o = (model == D).float().mean().item(), (chain == D).float().mean().item()
        ok &= m == 1.0
        print(f"{name}: {T * 128} outputs; equal bit for bit to mma_product {m:.6f}, "
              f"to ordered_product {o:.6f}")
    print("mma_product is the card's sum" if ok else "mma_product is NOT the card's sum")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
