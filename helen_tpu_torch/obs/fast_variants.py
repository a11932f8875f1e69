"""Where the time of the fast tier's K1f/K2f recurrence goes: variants of its
source, timed on the card.

    python -m helen_tpu_torch.obs.fast_variants [--iters 20]

Each variant is ``ops/csrc/gru_window_fast.cu`` with some of its constants
replaced, its step product rewritten, or one part of its step cut out,
built with nvcc into a library of its own under the build directory, all
builds started together (grid_variants.build_all). Each runs
``bigru_window_rec_fast`` through ops.gru_window_smem's own launch on the
flagship's decoder window (H=128, T=100) at B=512 (8 rows per block) and
B=256 (4 rows), over the scratch the shipped K2f projection writes from
random halves; each is timed with CUDA events over ``--iters`` launches,
and each line gives its largest distance from the recurrence's plain
version (the cut variants cannot agree with it). It needs a CUDA device and
``nvcc``; it prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess

SOURCE = "gru_window_fast.cu"
_MMA = "for (int g = 0; g < 3; ++g) mma_bf16(kt % 2 ? acc2[g] : acc[g], a[g][kt], b);"
_GATES = """    hreg[e] = gru_gates<true>(x[0][e], x[1][e], x[2][e], acc[0][e], acc[1][e], acc[2][e],
                              bias[e / 2], hreg[e]);"""
_COPY = "cp_async4(st + (g * 4 + e) * nthreads, xt + xoff[e] + g * H);"
_STORE = "ot[(b0 + brow[e]) * H + unit[e]] = hreg[e];"
#: name -> (constants to replace, (text, replacement) edits); the cut
#: variants give wrong outputs and show what their part costs
VARIANTS = {
    "shipped": ({}, ()),
    "xp ring of 2 stages": ({"FR_STAGES": 2}, ()),
    "xp ring of 6 stages": ({"FR_STAGES": 6}, ()),
    "one sum per gate (the first version)": ({}, (
        (_MMA, "for (int g = 0; g < 3; ++g) mma_bf16(acc[g], a[g][kt], b);"),)),
    "no mma (cut)": ({}, ((_MMA, "acc[0][0] += __uint_as_float(b[0] ^ b[1]);"),)),
    "no gates (cut)": ({}, ((_GATES, "    hreg[e] = acc[0][e] + acc[1][e] + acc[2][e] + "
                                     "x[0][e] + x[2][e];"),)),
    "no xp copies (cut)": ({}, ((_COPY, "(void)st;"),)),
    "no output stores (cut)": ({}, ((_STORE, ";"),)),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=20261023)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fast_variants: no CUDA device is visible")
        return 1
    from helen_tpu_torch.io.checkpoint import fast_layer
    from helen_tpu_torch.obs.grid_variants import build_all, timed
    from helen_tpu_torch.ops import gru_window_smem as gs
    from helen_tpu_torch.ops import library
    from helen_tpu_torch.utils.build import build_dir

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    libs = {}
    for name, (so, note) in build_all(build_dir("fast_variants"), SOURCE, VARIANTS).items():
        print(f"{name}: {note}", flush=True)
        if so is not None:
            libs[name] = library.load_variant(so, gs.ENTRIES)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    T, H = 100, 128

    def r(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype("float32")).to(dev)

    k = 1.0 / H ** 0.5
    layer = fast_layer({d: {"w_ih": r(2 * H, 3 * H) * k, "w_hh": r(H, 3 * H) * k,
                            "b_ih": r(3 * H) * k, "b_hh": r(3 * H) * k}
                        for d in ("fwd", "bwd")})
    for B in (512, 256):
        xp = gs.bigru_window_proj_in2_fast(r(T, B, H), r(T, B, H), layer)
        h0f, h0b = r(B, H), r(B, H)
        want = gs.window_rec_plain(xp, h0f, h0b, layer)
        for name, lib in libs.items():
            run = lambda: gs.bigru_window_rec_fast(xp, h0f, h0b, layer)  # noqa: E731
            try:
                with library.launching_into(lib):
                    got = run()
                    ms = timed(run, args.iters)
            except RuntimeError as e:
                print(f"B={B}: {name}: {e}", flush=True)
                continue
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            print(f"B={B} T={T} H={H} ({gs.rec_block_rows(B)} rows per block): {name}: "
                  f"{ms:.4f} ms, max |variant - plain| {err:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
