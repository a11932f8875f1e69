"""Where the time of the grid recurrences goes: variants of their sources,
timed on the card.

    python -m helen_tpu_torch.obs.grid_variants [--batch 64] [--hidden 1024 640]
    python -m helen_tpu_torch.obs.grid_variants --kernel fwd [--batch 512 64] [--hidden 1024]

Each variant is the shipped source with some of its block-shape constants
replaced, or one part of its step cut out, built with nvcc into a library of
its own under the build directory, all builds started together. ``bwd``
(the default): ``ops/csrc/gru_window_xp_bwd_grid.cu``, K4's pass 1, on a
window of T=100 at the given batch and widths, random weights from a seed,
the gate pass's ``hp`` from the shipped kernels, each variant at each of
the entry's tiles (rows per thread), the one ``grid_tile`` picks first;
each line says whether its outputs equal the one-launch
``xp_bwd_rec_kernel`` bit for bit (the cut variants cannot). ``fwd``:
``ops/csrc/gru_window_xp_grid.cu``, K3 and K3f in their grid design on the
same kind of window; a K3 line says whether its
outputs equal ``xp_window_kernel`` bit for bit, a K3f line gives its largest
distance from the fast plain version's kernel, ``xp_window_kernel<FAST>``;
each K3 variant runs at each of its thread tiles (8 and 4 rows a
thread), the one ``grid_tile`` picks first, and the cut variants that make
fragments in registers give wrong outputs by design. Every variant is timed
with CUDA events over 5 launches, and each line of a build gives ptxas's
registers and spills per kernel. It needs a CUDA device and ``nvcc``; it
prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import subprocess
import sys

SOURCE = "gru_window_xp_bwd_grid.cu"
_FMA = "acc[p][q] = fmaf(dv[f & 1][p][e], wv[f & 1][q][e], acc[p][q]);"
_CP = "cp_async16(st + foff[n], k < H2 ? fx[n] + k : fn[n] + (k - H2));"
_LDD = ("*reinterpret_cast<const float4*>(st + ob[f ^ swz(4 * p, NF)] + 16 * p * NF);")
_LDW = "const float4 v = *reinterpret_cast<const float4*>(wq[q] + k);"
# fragments made in registers from their addresses, so that nothing is hoisted
_NOLDD = "make_float4(__int_as_float((int)(size_t)st + p + f), 1.0f, 0.5f, 0.25f);"
_NOLDW = "const float4 v = make_float4(__int_as_float(k + q), 0.5f, 0.25f, 1.0f);"
_NCH = "const int nch = (H3 + KC - 1) / KC;"
_PRE = "pre = s + 1 < T;"

#: name -> (constants to replace, (text, replacement) edits); each is timed
#: at each tile the entry has (GRID_TILES)
VARIANTS = {
    "shipped": ({}, ()),
    "128 threads (16 row groups: a warp an SM quarter)": ({"BG_RG": 16}, ()),
    "16-k chunks x 8 stages": ({"BG_KC": 8}, ()),
    "16-k chunks x 4 stages (a 16 KB ring)": ({"BG_KC": 8, "BG_RING": 4096}, ()),
    "gate inputs loaded in the gate pass (not during the product)": (
        {}, ((_PRE, "pre = false;"),)),
    "no FMAs in the carry product (nor the loads they read)": ({}, ((_FMA, ";"),)),
    "no dhp loads in the carry product": ({}, ((_CP, "(void)st;"),)),
    "no shared-memory loads in the carry product (fragments made in registers)": (
        {}, ((_LDD, _NOLDD), (_LDW, _NOLDW))),
    "FMAs alone (no dhp loads, no shared-memory loads)": (
        {}, ((_CP, "(void)st;"), (_LDD, _NOLDD), (_LDW, _NOLDW))),
    "one chunk of the carry product a row block (gates and barriers)": (
        {}, ((_NCH, "const int nch = 1;"),)),
}


FWD_SOURCE = "gru_window_xp_grid.cu"
_FWD_FMA = "a = fmaf(hv[f & 1][p][e], wv[f & 1][e][j], a);"
_FWD_CP = "if (fval >> n & 1) cp_async16(st + foff[n], hprev + fsrc[n] + fk0);"
_FWD_LDS = "const float4 v = *reinterpret_cast<const float4*>(s);"
_FWD_LDSW = ("const float4 a = *reinterpret_cast<const float4*>(row + 4 * ug);\n"
             "  const float2 b = *reinterpret_cast<const float2*>(row + 4 * XG_UG + 2 * ug);")
_FWD_NOW = ("const float4 a = make_float4(__int_as_float((int)(size_t)row + ug), 1.0f, 0.5f, "
            "0.25f);\n  const float2 b = make_float2(__int_as_float((int)(size_t)row - ug), 0.5f);")
_FWD_NCH = "const int nch = (H + KC - 1) / KC;"
_FWD_PF = "for (int g = 0; g < 3; ++g) prefetch_l2(io.xp + ((size_t)tt * B + b) * H3 + g * H + u0);"
_FAST_MMA = "mma_bf16(acc[m][n], a[m], bf[n]);"
_FAST_CP = "cp_async16_cg(dst, hsrc + at);"
_FAST_NCH = "const int nch = (H + XF_KC - 1) / XF_KC;"

#: the forward's variants: name -> (constants to replace, (text, replacement)
#: edits); K3's constants are XG_*, K3f's XF_*, and a library holds both. A
#: K3 variant is timed at each of its tiles (rows per thread, XG_TILES).
FWD_VARIANTS = {
    "shipped": ({}, ()),
    "K3: no L2 prefetch of the gate inputs": ({}, ((_FWD_PF, ";"),)),
    "K3: no FMAs in the step product (nor the loads they read)": ({}, ((_FWD_FMA, ";"),)),
    "K3: no h loads in the step product": ({}, ((_FWD_CP, "(void)st;"),)),
    "K3: no shared-memory loads in the step product (fragments made in registers)": (
        {}, ((_FWD_LDS, "const float4 v = make_float4(__int_as_float((int)(size_t)s), 1.0f, "
                        "0.5f, 0.25f);"),
             (_FWD_LDSW, _FWD_NOW))),
    "K3: FMAs alone (no shared-memory loads, no h loads)": (
        {}, ((_FWD_CP, "(void)st;"),
             (_FWD_LDS, "const float4 v = make_float4(__int_as_float((int)(size_t)s), 1.0f, "
                        "0.5f, 0.25f);"),
             (_FWD_LDSW, _FWD_NOW))),
    "K3: one chunk of the step product a row block (gates and barriers)": (
        {}, ((_FWD_NCH, "const int nch = 1;"),)),
    "K3f: 3 stages": ({"XF_STAGES": 3}, ()),
    "K3f: 32-k x 4 stages": ({"XF_KC": 32, "XF_STAGES": 4}, ()),
    "K3f: 1 m-tile per warp (128-row blocks)": ({"XF_MT": 1}, ()),
    "K3f: 1 m-tile per warp, 128-k x 2 stages": ({"XF_MT": 1, "XF_KC": 128}, ()),
    "K3f: no mma in the step product": ({}, ((_FAST_MMA, ";"),)),
    "K3f: no h loads in the step product": ({}, ((_FAST_CP, "(void)dst;"),)),
    "K3f: no step product (gates and barriers only)": (
        {}, ((_FAST_NCH, "const int nch = 0;"),)),
}


def variant_source(src: str, consts: dict, edits, source: str = SOURCE) -> str:
    for name, value in consts.items():
        src, n = re.subn(rf"constexpr int {name} = [^;]*;", f"constexpr int {name} = {value};",
                         src)
        if n != 1:
            raise ValueError(f"{source} has no constant {name}")
    for text, repl in edits:
        if text not in src:
            raise ValueError(f"{source} no longer holds {text!r}")
        src = src.replace(text, repl)
    return src


def build_all(out_dir: str, source: str = SOURCE, variants=None) -> dict:
    """{name: (library path or None, ptxas's register lines or the error)}."""
    from helen_tpu_torch.ops import library

    variants = VARIANTS if variants is None else variants
    src = open(os.path.join(library.CSRC, source)).read()
    procs = {}
    for i, (name, (consts, edits)) in enumerate(variants.items()):
        d = os.path.join(out_dir, f"v{i}")
        os.makedirs(d, exist_ok=True)
        for header in glob.glob(os.path.join(library.CSRC, "*.cuh")):
            with open(header) as f, open(os.path.join(d, os.path.basename(header)), "w") as g:
                g.write(f.read())
        with open(os.path.join(d, source), "w") as f:
            f.write(variant_source(src, consts, edits, source))
        so = os.path.join(d, "lib.so")
        cmd = [library.nvcc(), *library.NVCC_FLAGS, "-shared", "-o", so, os.path.join(d, source)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        built[name] = ((so if proc.returncode == 0 else None),
                       ptxas_summary(log) if proc.returncode == 0 else log[-2000:])
    return built


def ptxas_summary(log: str) -> str:
    """ptxas's report, one entry per kernel: "name<template args>: registers,
    spill stores"."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?\d+([a-z]\w*?kernel)(I\w*?E)?E", line)
        if m:
            args = re.findall(r"Li(\d+)E", m.group(2) or "")
            # an anonymous namespace's name ends in digits: the kernel's follows
            name = re.sub(r"^.*\d(?=[a-z])", "", m.group(1))
            name += f"<{','.join(args)}>" if args else ""
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{name}: {regs} regs, {spill} B spilled")
            name = None
    return "; ".join(out)


def timed(launch, iters: int = 5) -> float:
    import torch

    launch()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        launch()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def run_fwd(args) -> int:
    """The forward's variants: K3 and K3f at each batch and width."""
    import numpy as np
    import torch

    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_grid as xg
    from helen_tpu_torch.ops import library
    from helen_tpu_torch.ops.library import GRID_COUNTERS, card_limits
    from helen_tpu_torch.utils.build import build_dir

    built = build_all(build_dir("grid_variants_fwd"), FWD_SOURCE, FWD_VARIANTS)
    libs = {}
    for name, (so, note) in built.items():
        print(f"{name}: {note}")
        if so is not None:
            libs[name] = library.load_variant(so, xg.ENTRIES)
    dev = torch.device("cuda")
    T = 100
    for H in args.hidden:
        for B in args.batch:
            rng = np.random.default_rng(args.seed)

            def r(*shape):
                return torch.from_numpy(rng.uniform(-1, 1, shape).astype("float32")).to(dev)
            k = 1.0 / H ** 0.5
            layer = {d: {"w_hh": r(H, 3 * H) * k, "b_hh": r(3 * H) * k} for d in ("fwd", "bwd")}
            fast = {d: {"w_hh": layer[d]["w_hh"].to(torch.bfloat16), "b_hh": layer[d]["b_hh"]}
                    for d in ("fwd", "bwd")}
            xp_f, xp_b, h0f, h0b = r(T, B, 3 * H), r(T, B, 3 * H), r(B, H), r(B, H)
            fx = (xp_f.to(torch.bfloat16), xp_b.to(torch.bfloat16))
            want = gx.bigru_window_xp(xp_f, xp_b, h0f, h0b, layer, design="chain")
            fwant = gx.bigru_window_xp_fast(*fx, h0f, h0b, fast, design="chain")
            for tier, ins, lay, ref in ((False, (xp_f, xp_b), layer, want),
                                        (True, fx, fast, fwant)):
                units = xg.grid_units(H, *card_limits(), tier)
                w = [lay[d][q] for d in ("fwd", "bwd") for q in ("w_hh", "b_hh")]
                # K3 at each tile (rows per thread), the rule's first
                tiles = [None] if tier else sorted(
                    xg.XG_TILES, key=lambda t: t != xg.grid_tile(B))
                for (name, lib), rpt in ((nl, t) for nl in libs.items() for t in tiles):
                    if name != "shipped" and name.startswith("K3f" if not tier else "K3:"):
                        continue
                    outs = library.outputs(T, B, H, dev)
                    scratch = ([torch.empty((2, 2, B, H), dtype=torch.bfloat16, device=dev)]
                               if tier else [])
                    fn = getattr(lib, xg.KERNELS[tier])
                    tile = [] if tier else [rpt]

                    def launch():
                        arrive = torch.zeros(GRID_COUNTERS, dtype=torch.int32, device=dev)
                        err = fn(*(t.data_ptr() for t in (*ins, h0f, h0b, *w, *outs, *scratch,
                                                          arrive)),
                                 T, B, H, units, *tile, torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"{name}: CUDA error {err}")

                    label = "K3f" if tier else f"K3 ({rpt} rows a thread)"
                    try:
                        ms = timed(launch)
                    except RuntimeError as e:
                        print(f"B={B} T={T} H={H} U={units}: {label} {name}: {e}", flush=True)
                        continue
                    if tier:
                        cmp = ("max |grid - xp_window_kernel<FAST>| "
                               f"{max(float((a - b).abs().max()) for a, b in zip(outs, ref)):.3g}")
                    else:
                        cmp = ("equal to xp_window_kernel: "
                               f"{all(torch.equal(a, b) for a, b in zip(outs, ref))}")
                    print(f"B={B} T={T} H={H} U={units}: {label} {name}: {ms:.4f} ms, {cmp}",
                          flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("bwd", "fwd"), default="bwd")
    ap.add_argument("--batch", type=int, nargs="+", default=None,
                    help="bwd: one batch (64); fwd: one or more (512 64)")
    ap.add_argument("--hidden", type=int, nargs="+", default=None,
                    help="bwd: 1024 640; fwd: 1024")
    ap.add_argument("--seed", type=int, default=20261019)
    args = ap.parse_args(argv)
    fwd = args.kernel == "fwd"
    args.batch = args.batch or ([512, 64] if fwd else [64])
    args.hidden = args.hidden or ([1024] if fwd else [1024, 640])

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("grid_variants: no CUDA device is visible", file=sys.stderr)
        return 1
    from helen_tpu_torch.models.transducer import set_fp32_precision
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg
    from helen_tpu_torch.ops import library
    from helen_tpu_torch.utils.build import build_dir

    set_fp32_precision()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0])
    if fwd:
        return run_fwd(args)
    built = build_all(build_dir("grid_variants"))
    libs = {}
    for name, (so, note) in built.items():
        print(f"{name}: {note}")
        if so is not None:
            libs[name] = library.load_variant(so, gg.ENTRIES)
    dev = torch.device("cuda")
    T, B = 100, args.batch[0]
    for H in args.hidden:
        rng = np.random.default_rng(args.seed)
        r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype("float32")).to(dev)  # noqa: E731
        k = 1.0 / H ** 0.5
        layer = {d: {"w_hh": r(H, 3 * H) * k, "b_hh": r(3 * H) * k} for d in ("fwd", "bwd")}
        xp_f, xp_b = r(T, B, 3 * H), r(T, B, 3 * H)
        h0f, h0b, dhf, dhb = (r(B, H) for _ in range(4))
        dof, dob = r(T, B, H), r(T, B, H)
        with torch.no_grad():
            of, ob, _, _ = gx.bigru_window_xp(xp_f, xp_b, h0f, h0b, layer)
        hp = gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, layer)
        rest = (h0f, h0b, of, ob, dof, dob, dhf, dhb)
        want = gxb.bigru_window_xp_bwd_rec(xp_f, xp_b, *rest, layer, design="chain")
        units = gg.grid_units(H, *library.card_limits())
        e = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
        w = [layer[d][k] for d in ("fwd", "bwd") for k in ("w_hh", "b_hh")]
        # each tile the entry has (rows per thread), the rule's first
        tiles = sorted(gg.GRID_TILES, key=lambda t: t != gg.grid_tile(B))
        for (name, lib), rpt in ((nl, t) for nl in libs.items() for t in tiles):
            outs = (e(2, T, B, 3 * H), e(2, T, B, H), e(B, H), e(B, H))

            def launch():
                arrive = torch.zeros(library.GRID_COUNTERS, dtype=torch.int32, device=dev)
                err = lib.bigru_window_xp_bwd_rec_grid(
                    *(t.data_ptr() for t in (xp_f, xp_b, hp, *rest, *w, *outs, arrive)),
                    T, B, H, units, rpt, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            try:
                ms = timed(launch)
            except RuntimeError as err:
                print(f"B={B} T={T} H={H} U={units}: {name}: {err}", flush=True)
                continue
            same = all(torch.equal(a, b) for a, b in zip(outs, want))
            print(f"B={B} T={T} H={H} U={units}: {rpt} rows a thread, {name}: {ms:.4f} ms, "
                  f"equal to xp_bwd_rec_kernel: {same}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
