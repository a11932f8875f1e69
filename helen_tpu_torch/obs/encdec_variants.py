"""Where the time of K5/K5f's cluster design goes: variants of its source,
timed on the card.

    python -m helen_tpu_torch.obs.encdec_variants [--iters 10]

Each variant is ``ops/csrc/gru_window_smem.cu`` (K5's cluster kernel) or
``gru_window_fast.cu`` (K5f's) with one role's work cut out, or with another
producer shape or stage depth, built with
nvcc into a library of its own under the build directory, all builds
started together (grid_variants.build_all). Each runs the cluster kernel
alone (``ops.gru_window_encdec.transducer_window_encdec_cluster`` /
``_fast``) on the flagship window (H=128, T=100, F=90) at B=512 and B=256,
timed with CUDA events over ``--iters`` launches; each line gives its
largest distance from the shipped kernel's outputs (the cut variants cannot
agree with it). Without the producers' products a layer takes what its
consumers, the ring and the hand-off take; without the consumers' step,
what its producers take. It needs a CUDA device and ``nvcc``; it prints the
card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess

_PARITY_FMA = ("        tile_fma_stage<ECP_BK, ECP_NB>(acc, k.as + s * ECP_BK * ECP_ALD + ty * 4, "
               "ECP_ALD, 16,\n"
               "                                       k.bs + s * ECP_BK * ECP_N + tx * 4, ECP_N, "
               "4 * ECP_TX);")
_PARITY_FMA_L1 = """        if ((ks + 1) * ECP_BK <= K) {
          tile_fma_stage<ECP_BK, ECP_NB>(acc, k.as + s * ECP_BK * ECP_ALD + ty * 4, ECP_ALD, 16,
                                         w + (size_t)ks * ECP_BK * H3 + tx * 4, H3, 4 * ECP_TX);
        } else {
          for (int kk = 0; ks * ECP_BK + kk < K; ++kk) {
            tile_fma_stage<1, ECP_NB>(acc, k.as + (s * ECP_BK + kk) * ECP_ALD + ty * 4, ECP_ALD,
                                      16, w + (size_t)(ks * ECP_BK + kk) * H3 + tx * 4, H3,
                                      4 * ECP_TX);
          }
        }"""
_PARITY_STEP = "        REC_SMEM_STEP(RPT, k.hbuf + (cur * ROWS + rb) * HP,"
# the step with its sums and gates cut: the prefetch and the stores stay
_PARITY_NO_STEP = "        ECP_NO_STEP(RPT, k.hbuf + (cur * ROWS + rb) * HP,"
_PARITY_NO_STEP_DEF = """#define ECP_NO_STEP(RPT, HC, HX, PREFETCH, EMIT)               \\
  {                                                             \\
    PREFETCH;                                                   \\
    float* hx = (HX);                                           \\
    for (int i = 0; i < RPT; ++i) {                             \\
      const float h = nr[i] + nz[i] + nn[i];                    \\
      hx[i * HP + j] = h;                                       \\
      EMIT;                                                     \\
    }                                                           \\
  }

// What both roles of a cluster CTA see"""
_PARITY_A = """            av[e] = L == 0 ? (float)__ldg(irow[e] + kk)
                           : __ldcg(erow[e] + (kk < H ? kk : (size_t)T * ROWS * H + kk - H));"""
_PARITY_W = "            cp_async16(d, w + (size_t)kk * H3 + n);"
_FAST_MMA = "          mma_k16(acc, af, bs, BLD, kk, col0, ln);"
_FAST_A = (("            cp_async16_cg(d, erow + (kk < H ? kk : eback + kk));",
            "            (void)d;"),
           ("""                v[e] = L == 0 ? (float)__ldg(irow + ke)
                              : __bfloat162float(__ldcg(erow + (ke < H ? ke : eback + ke)));""",
            "                v[e] = (float)ke;"))
_FAST_W = ("          stage_w8(k.bst + ((size_t)buf * ECF_KS + kr) * BLD + cn, w, k0 + kr, cn, K, "
           "H3, wvec);")
_FAST_PRODUCT = ("      fr_hh_product<KT>(acc, a, k.hs + cur * FR_ROWS * LDH + (ln / 4) * LDH "
                 "+ 2 * (ln % 4));")
_FAST_GATES = "      fr_gates(hreg, acc, x, bias);"
#: source -> {name: (constants to replace, (text, replacement) edits)}
VARIANTS = {
    "gru_window_smem.cu": {
        "shipped": ({}, ()),
        "no producer FMAs (cut)": ({}, ((_PARITY_FMA, "        (void)ty;"),)),
        "no consumer step (cut)": ({}, ((_PARITY_STEP, _PARITY_NO_STEP),
                                        ("// What both roles of a cluster CTA see",
                                         _PARITY_NO_STEP_DEF))),
        "no producer A loads (cut)": ({}, ((_PARITY_A, "            av[e] = (float)kk;"),)),
        "no producer W_ih copies (cut)": ({}, ((_PARITY_W, "            (void)d;"),)),
        "4 producer warps, 8 x 12 tiles": ({"ECP_PROD": 128}, ()),
        # H=128 only: the tile's 384 columns are W_ih's rows, read in place
        "producer W_ih through L1, not staged": ({}, (
            ("      fill_b(0, 0);\n", ""),
            ("          fill_b(s ^ 1, (ks + 1) * ECP_BK);\n", ""),
            (_PARITY_FMA, _PARITY_FMA_L1))),
    },
    "gru_window_fast.cu": {
        "shipped": ({}, ()),
        "no producer mma (cut)": ({}, ((_FAST_MMA, "          (void)af;"),)),
        "no consumer step (cut)": ({}, (
            (_FAST_PRODUCT, "      for (int g = 0; g < 3; ++g) for (int e = 0; e < 4; ++e) "
                            "acc[g][e] = 0.0f;"),
            (_FAST_GATES, "      for (int e = 0; e < 4; ++e) hreg[e] = x[0][e] + x[1][e] + "
                          "x[2][e] + acc[0][e];"))),
        "no producer A loads (cut)": ({}, _FAST_A),
        "no producer W_ih copies (cut)": ({}, ((_FAST_W, "          (void)cn;"),)),
        "producer k stages of 48": ({"ECF_KS": 48}, ()),
        "producer k stages of 64": ({"ECF_KS": 64}, ()),
    },
}
ENTRIES = {"gru_window_smem.cu": "transducer_window_encdec_cluster",
           "gru_window_fast.cu": "transducer_window_encdec_cluster_fast"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=20261024)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("encdec_variants: no CUDA device is visible")
        return 1
    from helen_tpu_torch.io.checkpoint import fast_layer
    from helen_tpu_torch.obs.grid_variants import build_all, timed
    from helen_tpu_torch.ops import gru_window_encdec as ge
    from helen_tpu_torch.ops import library
    from helen_tpu_torch.utils.build import build_dir

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    builds = {src: build_all(build_dir(f"encdec_variants_{src.split('.')[0]}"), src, v)
              for src, v in VARIANTS.items()}
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    T, H, F = 100, 128, 90

    def layer(d):
        k = 1.0 / H ** 0.5
        u = lambda *s: torch.from_numpy(  # noqa: E731
            rng.uniform(-k, k, s).astype("float32")).to(dev)
        return {r: {"w_ih": u(d, 3 * H), "w_hh": u(H, 3 * H), "b_ih": u(3 * H),
                    "b_hh": u(3 * H)} for r in ("fwd", "bwd")}

    enc, dec = layer(F), layer(2 * H)
    image = torch.from_numpy(rng.integers(0, 40, (512, T + 10, F), dtype=np.uint8)).to(dev)
    for src, built in builds.items():
        entry = ENTRIES[src]
        fast = entry.endswith("_fast")
        layers = (fast_layer(enc), fast_layer(dec)) if fast else (enc, dec)
        kernel = getattr(ge, entry)
        libs = {}
        for name, (so, note) in built.items():
            print(f"{src}: {name}: {note}", flush=True)
            if so is not None:
                libs[name] = library.load_variant(so, ge.ENTRIES)
        for B in (512, 256):
            h0f, h0b = (torch.from_numpy(rng.uniform(-0.5, 0.5, (B, H)).astype("float32"))
                        .to(dev) for _ in range(2))
            run = lambda: kernel(image[:B], 5, T, h0f, h0b, *layers)  # noqa: E731
            want = run()
            for name, lib in libs.items():
                try:
                    with library.launching_into(lib):
                        got = run()
                        ms = timed(run, args.iters)
                except RuntimeError as e:
                    print(f"B={B}: {entry}: {name}: {e}", flush=True)
                    continue
                err = max(float((g - w).abs().max()) for g, w in zip(got, want))
                print(f"B={B} T={T} H={H}: {entry}: {name}: {ms:.4f} ms, "
                      f"max |variant - shipped| {err:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
