"""Where the time of pass 2's split design goes: variants of its source,
timed on the card.

    python -m helen_tpu_torch.obs.wgrad_variants [--iters 10]

Each variant is ``ops/csrc/gru_window_wgrad.cu`` with some of its constants
replaced or its product loop rewritten, built with nvcc into a library of its own under the build
directory, all builds started together (grid_variants.build_all). Each runs
pass 2 through ``gru_window_wgrad``'s own wrappers, split kernel and slice
sum, on the flagship's training window at B=256 (layer 0 on a full-range
uint8 image, D=90, and the decoder on two halves, D=256; H=128, T=100) and
on K4's at B=64, H=1024, pass 1's streams from the shipped kernels; each is
timed with CUDA events over ``--iters`` launches, and each line gives the
largest error against the plain version, scaled by max(1, the output's
largest magnitude), and whether its bits equal the shipped variant's (a
change of the stage rows or the slice rows changes the order of the sums).
It needs a CUDA device and ``nvcc``; it prints the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import subprocess

SOURCE = "gru_window_wgrad.cu"
_MMA = r"""  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));"""
_FILL = "    if (next < chunks) fill(next % WS_STAGES, n_begin + next * WS_KC);"
#: name -> (constants to replace, (text, replacement) edits); the last two
#: give wrong sums and show what their part costs (the TF32 split is in
#: gru_window_common.cuh, shared with the xp projection, and is not edited)
VARIANTS = {
    "shipped": ({}, ()),
    "64 x 64 tiles, 4 warps, 3,200-row slices": (
        {"WS_WARPS_N": 2, "WS_MIN_BLOCKS": 3, "WS_SLICE_ROWS": 3200}, ()),
    "64-row stages": ({"WS_KC": 64}, ()),
    "3 stages": ({"WS_STAGES": 3}, ()),
    "no mma": ({}, ((_MMA, "  c[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0]"
                                " ^ b[1]);"),)),
    "no fills past the first": ({}, ((_FILL, ""),)),
}


def cases(dev, seed: int):
    """(label, run(wgrad module) -> grads, the plain version's grads)."""
    import numpy as np
    import torch

    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    rng = np.random.default_rng(seed)

    def r(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype("float32")).to(dev)

    def layer(d, h):
        k = 1.0 / h ** 0.5
        return {x: {"w_ih": r(d, 3 * h) * k, "w_hh": r(h, 3 * h) * k, "b_ih": r(3 * h) * k,
                    "b_hh": r(3 * h) * k} for x in ("fwd", "bwd")}

    T, B, H = 100, 256, 128
    out = []
    for label, D in (("layer 0, image D=90", 90), ("decoder, halves D=256", 2 * H)):
        lay = layer(D, H)
        h0f, h0b, dhf, dhb = (r(B, H) for _ in range(4))
        if D == 90:
            src, start = torch.from_numpy(rng.integers(0, 256, (B, T + 20, D),
                                                       dtype=np.uint8)).to(dev), 11
            of, ob, _, _ = gw.bigru_window_in1(src, start, T, h0f, h0b, lay)
        else:
            src, start = (r(T, B, H), r(T, B, H)), 0
            of, ob, _, _ = gw.bigru_window_in2(*src, h0f, h0b, lay)
        dxp, dhpn, *_ = gb.bigru_window_bwd_rec(src, start, h0f, h0b, of, ob, r(T, B, H),
                                                 r(T, B, H), dhf, dhb, lay, need_dx=False)
        args = (src, start, h0f, h0b, of, ob, dxp, dhpn)
        out.append((f"B={B} H={H} {label}", lambda m, a=args: m.bigru_window_wgrad(*a),
                    gb.bigru_window_bwd_wgrad_plain(*args)))
    B, H = 64, 1024
    lay = layer(2 * H, H)
    xp_f, xp_b, h0f, h0b = r(T, B, 3 * H), r(T, B, 3 * H), r(B, H), r(B, H)
    of, ob, _, _ = gx.bigru_window_xp(xp_f, xp_b, h0f, h0b, lay)
    dxp, dhpn, *_ = gxb.bigru_window_xp_bwd_rec(xp_f, xp_b, h0f, h0b, of, ob, r(T, B, H),
                                                r(T, B, H), r(B, H), r(B, H), lay)
    args = (h0f, h0b, of, ob, dxp, dhpn)
    out.append((f"B={B} H={H} K4 pass 2", lambda m, a=args: m.bigru_window_xp_wgrad(*a),
                gxb.bigru_window_xp_bwd_wgrad_plain(*args)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=20261021)
    args = ap.parse_args(argv)
    import torch

    from helen_tpu_torch.models.transducer import set_fp32_precision
    from helen_tpu_torch.obs.grid_variants import build_all, timed
    from helen_tpu_torch.ops import gru_window_wgrad as gwg
    from helen_tpu_torch.ops import library
    from helen_tpu_torch.utils.build import build_dir

    if not torch.cuda.is_available():
        print("wgrad_variants: no CUDA device is visible")
        return 1
    set_fp32_precision()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    built = build_all(build_dir("wgrad_variants"), SOURCE, VARIANTS)
    libs = {}
    for name, (so, note) in built.items():
        print(f"{name}: {note}", flush=True)
        if so is not None:
            libs[name] = library.load_variant(so, gwg.ENTRIES)
    dev = torch.device("cuda")
    runs = cases(dev, args.seed)
    rows = gwg.SLICE_ROWS
    ref = {}
    try:
        for name, lib in libs.items():
            gwg.SLICE_ROWS = lib.bigru_window_wgrad_slice_rows()
            for label, run, want in runs:
                try:
                    with library.launching_into(lib):
                        got = run(gwg)
                        ms = timed(lambda: run(gwg), args.iters)
                except RuntimeError as e:
                    print(f"{label}: {name}: {e}", flush=True)
                    continue
                err = max(float((got[d][k] - w).abs().max()) / max(1.0, float(w.abs().max()))
                          for d in want for k, w in want[d].items())
                if name == "shipped":
                    ref[label] = got
                same = label in ref and all(torch.equal(got[d][k], ref[label][d][k])
                                            for d in want for k in want[d])
                print(f"{label}: {name}: {ms:.4f} ms, max scaled error {err:.3g}, "
                      f"equal to shipped: {same}", flush=True)
    finally:
        gwg.SLICE_ROWS = rows
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
