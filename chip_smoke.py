#!/usr/bin/env python3
"""On-card smoke test of helen_tpu_torch, the PyTorch/CUDA port.

Run from the root of a checkout on a machine with one NVIDIA GPU (built for
an H100, sm_90a):

    python3 chip_smoke.py

It builds the CUDA window kernels from ``helen_tpu_torch/ops/csrc``, holds
each kernel against its plain PyTorch version at the flagship shapes, times
both and cuDNN's GRU as a yardstick (phase 3: K1 and K2 in the main path's
design, a projection pass plus a recurrence with W_hh in shared memory, at
B=512 and B=256, bit for bit against the one-launch bigru_window_kernel and timed in
turns with it; each of the three two-launch kernels alone; H=136 on the two-launch
design and H=160 on the one-launch kernel), polishes the golden fixtures and an
unseen sequence with the trained checkpoint through the port's CLI,
drives a full-width polish (>= 2048 images at batch 512) while counting the
kernel launches, and then the training path: the backward against its
plain version and cuDNN's GRU backward (phase 7a: pass 1 in the main
path's design, a gate pass, a recurrence with W_hh^T in shared memory and
a dx pass, bit for bit against the one-launch bwd_rec_kernel and timed in
turns with it; each of its new kernels alone; pass 2 in its split design,
slices of rows on 3xTF32 tensor cores then a fixed-order slice sum, against
its plain version at B=256 and 512, timed beside it and cuBLAS's
products), one TBPTT batch through the
kernels against the plain route, and ``train`` then ``test`` through the
CLI on the full-width images with the launches counted (0 of
bwd_rec_kernel). Phase 9 drives the
wide models (H=1024) through the xp-stream kernels: K3 and K4 against their
plain versions (phase 9a: K3 in the main path's design, a grid-wide
recurrence with W_hh spread over the SMs' shared memory, bit for bit
against the one-launch xp_window_kernel and timed in turns with it, at
B=512 and B=64; phase 9b: K4's pass 1 in the main path's design, the gate
pass and a grid-wide recurrence, bit for bit against the one-launch
xp_bwd_rec_kernel and timed in turns with it; each of its kernels alone;
pass 2's split design against its plain version, timed),
the golden fixtures and a cross-route check at H=512 through the forced xp
route (K3 in the grid design; each fixture's encoder layer through K4's
grid design), then ``train``, ``test`` and ``polish`` at H=1024 with the
launches counted (0 of xp_window_kernel and xp_bwd_rec_kernel). Phase 10
drives the fast (bf16) tier, ``polish --fast``: K1f, K2f and K3f against
their plain versions (phase 10a: K1f and K2f in the main path's design, a
projection pass and a recurrence on bf16 tensor cores, at B=512 and B=256,
within FAST_TOL of the one-launch bigru_window_kernel<FAST> and timed in
turns with it; each of its kernels alone; phase 10b: K3f's grid design, its
step product on bf16 tensor cores, against its plain version in the
tensor cores' order of sums, timed in turns with the one-launch K3f), a
label flip
audit against the fast plain route and the fp32 route (the flagship and
the wide model, random weights), the trained
checkpoint under ``--fast`` against the parity tier, and the flagship and
wide polishes through the fast kernels with the launches counted. Phase 11
drives the fused encoder+decoder window (``route="encdec"``, library only):
K5 and K5f in both designs (phase 11a: the two-CTA cluster, producer warps
projecting while consumer warps run the recurrence, and the one-pass
kernel; at B=512 and B=256) against the chained kernels (bit for bit: the
cluster design against K1 -> K2 and the two-launch K1f -> K2f, the one-pass
kernel against K1 -> K2 and the one-launch K1f -> K2f) and their plain
versions, timed in turns beside the chains and cuDNN, the full-width images
with the trained checkpoint through the route in both tiers with the
launches counted (all of the cluster kernel), and the golden fixtures
through it (h160 on the one-pass kernel, in both tiers). Phase 12 drives the
single-host I/O flags on phase 6's images at -b 512: ``polish --pack --writers 4
--fastq`` fresh (the image cache built write-through) and again (the cache
reused), with their labels against phase 6's (0 flips), the FASTQ's sequences
against its FASTA, the launches counted and the host stages tabled beside phase
6's; ``call_consensus`` on half the image files then ``--resume`` over all
(launches = the remaining batches x 19 x layers; the first run's file left as
it was, the new records in the store's next file; the stores stitch to phase
6's FASTA byte for byte); ``polish --fast --pack`` against phase 10e (0
flips); ``train --pack`` against phase 7c's first epoch (bit for bit).
Phase 13 polishes the golden images as h5py writes them chunked and
compressed, in the earliest format and in the newest, and after a 512-byte
user block under h5py's lzf (committed under tests/torch_hdf5_variants/;
the port reads them with its own HDF5 reader),
and runs ``call_consensus --pack`` over the chunked one: each to the golden
FASTA byte for byte with 0+0 label flips, its image reads timed beside the
contiguous file's. Phase 14 runs multi-process jobs on the one card: two
processes of this script (``--coordinator_address ... <command>``), gloo
over a loopback port, each with its own CUDA context: ``polish`` of phase
6's images under ``--host_shard image`` and ``file`` (phase 6's FASTA byte
for byte, 0+0 flips, each process's K1/K2 launches its own images'
batches x 19 x layers), ``test`` against one process (the confusion
matrices exactly, the loss within 1e-5), one ``train`` epoch against one
process (rtol 2e-4 / atol 2e-5, the processes bit for bit after every
batch), a barrier whose peer never comes (it raises within its timeout),
and the polish again through the local launcher on ["cuda:0", "cuda:0"].
Phase 15 drives what the port took last: K3, K3f and K4 past H=1024 (1056,
1152, 2048 at B=64) in the designs the rule picks, the chain designs at 8
or 4 rows per block, against their plain versions; ``polish`` with default
flags of an H=1056 checkpoint (launches counted, labels against
``--backend torch``), ``polish --fast`` at H=1152 and 2048 and TBPTT
batches at H=1056 and 2048, so that a path launches each chain kernel;
``hyperband`` (its schedule replayed, each trial's launches counted, its
best checkpoint re-tested), ``test --debug_mismatches``, ``train
--model_parallel 2`` through the CLI and the library's two-shard trainer on
["cuda:0", "cuda:0"] against the data-parallel trainer, ``convert`` to
.pkl, .npz and .onnx (self-checked on the card), ``download_models`` over
file:// then ``polish`` of the golden images, and ``assess`` with a BED.
Phase 16 runs helen_tpu's last three tools as written for the card:
``gpu_validation`` (tpu_validation's checks and bars: the kernels against
their plain versions in both tiers, the two kernel families, three more
geometries, a TBPTT batch), ``scaling_bench`` as jobs of one and two
processes on the card (the job's label sums against one process's, each
process's launches counted) and ``sharding_overhead`` (the two-process
job's training loss against one process's).
Every phase fails the script on error; nothing falls back.
The second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result. It imports nothing of JAX.
"""
from __future__ import annotations

import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
FIXTURES = ("model", "l2_h128", "h160")  # golden_<name>.pkl / _labels.npz / .fa

# flagship shapes of the main path
B, L, F, H, T = 512, 1000, 90, 128, 100
# fp32 kernel vs plain: the same arithmetic summed in another order
TOL = 1e-5
# label flips allowed against a reference, per head
FLIPS_PER_LABEL = 1e-4
# published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# the fast tier (phase 10): its products are bf16 with fp32 sums, so its
# bound counts them at the dense bf16 tensor-core peak (NVIDIA data sheet);
# kernel vs plain version, and the flips the kernels may add per head
PEAK_BF16 = 989e12
FAST_TOL = 1e-3
N_AUDIT = 128
N_FULL = 2048
FULL_CONTIG_BP = 800_000
# training: batch, the held-out contig, epochs, and the backward's tolerance
# (1e-5 times the output's largest magnitude, at least 1: the weight
# cotangents are sums over the window's 25,600 rows)
TB = 256
TEST_CONTIG_BP = 200_000
TRAIN_EPOCHS = 3
BWD_PASSES = ("bigru_window_bwd_rec", "bigru_window_bwd_wgrad")
# pass 1's kernels in its main-path design (ops.gru_window_bwd_smem), beside
# K1/K2's projection
BWD_SMEM_KERNELS = ("bigru_window_bwd_hp", "bigru_window_bwd_rec_smem", "bigru_window_bwd_dx")
# pass 2 of both backwards (ops.gru_window_wgrad): the split design's
# library entries (in-projection form, xp form, the slice sum), its two
# kernels' counters, and the dense TF32 tensor-core peak (NVIDIA data sheet)
# that bounds its 3 x FLOP of 3xTF32 products
WGRAD_IN = ("bigru_window_wgrad_split_in", "bigru_window_wgrad_sum")
WGRAD_XP = ("bigru_window_wgrad_split_xp", "bigru_window_wgrad_sum")
WGRAD_KERNELS = ("bigru_window_wgrad_split", "bigru_window_wgrad_sum")
PEAK_TF32 = 495e12
# the xp route's projection (phase 9f): 3xTF32, three TF32 products a
# product, so its bound counts the FLOP at a third of the TF32 peak
PEAK_3XTF32 = PEAK_TF32 / 3
# the wide configuration (phase 9): the flagship transducer at H=1024,
# trained at -b 64 on 128 images, polished at -b 256
WH = 1024
WB_TRAIN, N_WIDE_TRAIN, WB_POLISH = 64, 128, 256
XP_PASSES = ("bigru_window_xp_bwd_rec", "bigru_window_xp_bwd_wgrad")
# the kernels ops.gru_window counts beside K1/K2 that no parity path of
# the default route launches: the fast tier's (phase 10) and the fused
# encoder+decoder window's (phase 11, route="encdec" only)
OFF_PATH_ZERO = {"bigru_window_in1_fast": 0, "bigru_window_in2_fast": 0,
                 "bigru_window_proj_in1_fast": 0, "bigru_window_proj_in2_fast": 0,
                 "bigru_window_rec_fast": 0,
                 "transducer_window_encdec": 0, "transducer_window_encdec_fast": 0,
                 "transducer_window_encdec_cluster": 0,
                 "transducer_window_encdec_cluster_fast": 0,
                 "transducer_window_encdec_onepass": 0,
                 "transducer_window_encdec_onepass_fast": 0}
# the kernels of K1f/K2f's two-launch design (ops.gru_window_smem,
# gru_window_fast.cu), which the flagship's fast path runs
FAST_SMEM_KERNELS = ("bigru_window_proj_in1_fast", "bigru_window_proj_in2_fast",
                     "bigru_window_rec_fast")
# the kernels of K1/K2's two-launch design (ops.gru_window_smem), which the
# flagship's parity path runs
SMEM_KERNELS = ("bigru_window_proj_in1", "bigru_window_proj_in2", "bigru_window_rec_smem")


def parity_counts(in1: int, in2: int) -> dict:
    """The launches of ``in1`` K1s and ``in2`` K2s on the two-launch design: each a
    projection and a recurrence."""
    return {"bigru_window_in1": in1, "bigru_window_in2": in2,
            "bigru_window_proj_in1": in1, "bigru_window_proj_in2": in2,
            "bigru_window_rec_smem": in1 + in2}


def fast_counts(in1: int, in2: int) -> dict:
    """The launches of ``in1`` K1fs and ``in2`` K2fs on the two-launch design:
    each a projection and a recurrence, never bigru_window_kernel<FAST>."""
    return {"bigru_window_in1_fast": in1, "bigru_window_in2_fast": in2,
            "bigru_window_proj_in1_fast": in1, "bigru_window_proj_in2_fast": in2,
            "bigru_window_rec_fast": in1 + in2}


def train_counts(fwd: int, trained: int) -> dict:
    """The launches of ``fwd`` flagship windows forward, ``trained`` of them
    with a backward (layer 0 and the decoder each): K1/K2 in the two-launch
    design, and each layer's backward as pass 2 plus pass 1 in its
    shared-memory design (the projection, the hp product, the recurrence and,
    for the decoder, the dx pass), never bwd_rec_kernel."""
    counts = {**OFF_PATH_ZERO, **parity_counts(fwd, fwd)}
    counts["bigru_window_proj_in1"] += trained
    counts["bigru_window_proj_in2"] += trained
    return {**counts, BWD_PASSES[0]: 2 * trained, BWD_PASSES[1]: 2 * trained,
            "bigru_window_bwd_rec_chain": 0, "bigru_window_bwd_hp": 2 * trained,
            "bigru_window_bwd_rec_smem": 2 * trained, "bigru_window_bwd_dx": trained,
            **wgrad_counts(2 * trained)}


def wgrad_counts(passes: int) -> dict:
    """The launches of ``passes`` passes 2 at a batch past one slice of
    1,600 rows (B=256 and B=64 at T=100): the split kernel and the slice sum
    each."""
    return {WGRAD_KERNELS[0]: passes, WGRAD_KERNELS[1]: passes}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    log(f"\n=== {name}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(flops: float, nbytes: float, peak: float = PEAK_FP32):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def random_layer(rng, d: int, h: int, device):
    import torch

    k = 1.0 / h ** 0.5
    u = lambda *s: torch.from_numpy(  # noqa: E731
        rng.uniform(-k, k, s).astype("float32")).to(device)
    return {d_: {"w_ih": u(d, 3 * h), "w_hh": u(h, 3 * h),
                 "b_ih": u(3 * h), "b_hh": u(3 * h)} for d_ in ("fwd", "bwd")}


def cudnn_gru(layer, d: int, h: int, device, dtype=None):
    """torch.nn.GRU (cuDNN) holding the same weights, made in ``dtype``
    (float32 by default) so that cuDNN keeps them in one flat buffer: the
    library yardstick."""
    import torch

    gru = torch.nn.GRU(d, h, bidirectional=True, device=device, dtype=dtype)
    gru.flatten_parameters()
    with torch.no_grad():
        for name, p in (("", layer["fwd"]), ("_reverse", layer["bwd"])):
            getattr(gru, f"weight_ih_l0{name}").copy_(p["w_ih"].T)
            getattr(gru, f"weight_hh_l0{name}").copy_(p["w_hh"].T)
            getattr(gru, f"bias_ih_l0{name}").copy_(p["b_ih"])
            getattr(gru, f"bias_hh_l0{name}").copy_(p["b_hh"])
    return gru


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def store_labels(pred_dir: str):
    """{"contig-start-end-chunk": (bases, rles)} from a prediction store."""
    import glob

    from helen_tpu_torch.io import hdf5

    out = {}
    for path in glob.glob(os.path.join(pred_dir, "*.hdf")):
        with hdf5.File(path) as f:
            for contig, cg in f["predictions"].items():
                for region, rg in cg.items():
                    for chunk, ch in rg.items():
                        if isinstance(ch, hdf5.Group):
                            out[f"{region}-{chunk}"] = (ch["bases"][()], ch["rles"][()])
    return out


def polish_cli(image_dir: str, model: str, out: str, extra=()) -> tuple:
    """``python -m helen_tpu_torch polish`` (its main, in this process);
    returns (FASTA path, predictions dir)."""
    from helen_tpu_torch.cli import main

    if main(["polish", "-i", image_dir, "-m", model, "-o", out, "-t", "2",
             *extra]) != 0:
        fail(f"polish of {image_dir} with {model} returned non-zero")
    preds = [d for d in os.listdir(out) if d.startswith("predictions_")]
    return os.path.join(out, "HELEN_prediction.fa"), os.path.join(out, preds[0])


def window_cost(bsz: int, d: int, h: int = H, in_bytes: float = None,
                w_bytes: int = 4) -> tuple:
    """(FLOP, bytes) of one K1/K2 (K1f/K2f: ``w_bytes`` 2, bf16 weights)
    launch at batch ``bsz``, input width ``d``: each input read once
    (``in_bytes``: the uint8 window, or two float32 halves), each output
    written once."""
    bt = bsz * T
    if in_bytes is None:
        in_bytes = bt * d if d == F else 4 * bt * d
    return (2.0 * bt * 2 * (d * 3 * h + h * 3 * h),
            in_bytes + 2 * (w_bytes * (d + h) * 3 * h + 4 * 6 * h) + 4 * 4 * bsz * h
            + 2 * 4 * bt * h)


def scratch_bytes(bsz: int, h: int = H) -> int:
    """The two-launch design's xp scratch (2, T, B, 3H) float32."""
    return 4 * 2 * T * bsz * 3 * h


def check_kernels(images_u8, results) -> None:
    """Phase 3: K1 on the uint8 image window and K2 on K1's outputs at the
    flagship shapes, at B=512 (polish) and B=256 (training). Each in the
    main path's design (the projection pass plus the recurrence with W_hh
    in shared memory) against its plain version (TOL) and against the
    one-launch bigru_window_kernel (max abs diff exactly 0.0); both designs
    timed in turns (two-launch, one-launch, one-launch, two-launch) beside
    the plain version and cuDNN. Then each two-launch kernel alone against
    its plain version, timed beside it and a library call, and the second
    shapes: H=136 through the two-launch design, H=160 through the
    one-launch kernel, told apart by the launch counters."""
    import numpy as np
    import torch

    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_smem as gs

    dev = images_u8.device
    rng = np.random.default_rng(20261016)
    l1, l2 = random_layer(rng, F, H, dev), random_layer(rng, 2 * H, H, dev)
    h0 = [torch.from_numpy(rng.uniform(-0.5, 0.5, (B, H)).astype("float32")).to(dev)
          for _ in range(4)]
    start = 450
    g1, g2 = cudnn_gru(l1, F, H, dev), cudnn_gru(l2, 2 * H, H, dev)
    replaces = {
        "bigru_window_in1": "helen_tpu/ops/gru_pallas.py:426 (_kernel_inproj1); "
                            "helen_tpu/ops/gru_pallas_train.py:259 (_fwd_kernel_ip, layer 0)",
        "bigru_window_in2": "helen_tpu/ops/gru_pallas.py:474 (_kernel_inproj2); "
                            "helen_tpu/ops/gru_pallas_train.py:259 (_fwd_kernel_ip, later layers)",
    }
    for bsz in (B, TB):
        img, hs = images_u8[:bsz], [h[:bsz] for h in h0]
        x_f32 = img[:, start:start + T].to(torch.float32).transpose(0, 1).contiguous()
        k1 = gw.bigru_window_in1(img, start, T, hs[0], hs[1], l1)
        xa, xb = k1[0], k1[1]  # K2 reads K1's outputs, as on the main path
        x_cat = torch.cat([xa, xb], dim=-1)
        hx1, hx2 = torch.stack(hs[:2]), torch.stack(hs[2:])
        kinds = {
            "bigru_window_in1": (
                lambda d: gw.bigru_window_in1(img, start, T, hs[0], hs[1], l1, design=d),
                lambda: gw.bigru_window_in1_plain(img, start, T, hs[0], hs[1], l1),
                lambda: g1(x_f32, hx1), window_cost(bsz, F)),
            "bigru_window_in2": (
                lambda d: gw.bigru_window_in2(xa, xb, hs[2], hs[3], l2, design=d),
                lambda: gw.bigru_window_in2_plain(xa, xb, hs[2], hs[3], l2),
                lambda: g2(x_cat, hx2), window_cost(bsz, 2 * H)),
        }
        for name, (run, pfn, lfn, (flops, nbytes)) in kinds.items():
            if gw.window_design(H, bsz) != "smem":
                fail(f"{name} at B={bsz} does not take the two-launch design")
            new, old, plain = run("smem"), run("chain"), pfn()
            with torch.no_grad():
                lib_out = lfn()
            torch.cuda.synchronize()
            diff = max_err(new, old)
            err_out, err_h = max_err(new[:2], plain[:2]), max_err(new[2:], plain[2:])
            cud = max(float((lib_out[0] - torch.cat([new[0], new[1]], -1)).abs().max()),
                      float((lib_out[1] - torch.stack([new[2], new[3]])).abs().max()))
            with torch.no_grad():
                turns = [cuda_ms(lambda: run(d)) for d in ("smem", "chain", "chain", "smem")]
                plain_ms = cuda_ms(pfn, iters=3, warmup=1)
                lib_ms = cuda_ms(lfn)
            ms, chain_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            bound_ms, bound_by = bound(flops, nbytes + 2 * scratch_bytes(bsz))
            chain_bound_ms, _ = bound(flops, nbytes)
            log(f"{name} at B={bsz}: max |two-launch - one-launch| {diff!r} (limit 0.0); "
                f"max |two-launch - plain| outputs {err_out:.3g}, final states {err_h:.3g} "
                f"(limit {TOL:g}); |two-launch - cuDNN| {cud:.3g}")
            log(f"{name} at B={bsz}: two-launch {ms:.4f} ms, one-launch {chain_ms:.4f} ms "
                f"(in turns: {', '.join(f'{t:.4f}' for t in turns)}), plain {plain_ms:.3f} ms, "
                f"cuDNN GRU {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                f"{flops / 1e9:.1f} GFLOP, {(nbytes + 2 * scratch_bytes(bsz)) / 1e6:.1f} MB "
                f"with the scratch written and read; one-launch {chain_bound_ms:.4f} ms)")
            if diff != 0.0:
                fail(f"{name} at B={bsz}: the two designs differ")
            if not (err_out <= TOL and err_h <= TOL):
                fail(f"{name} at B={bsz} disagrees with its plain version")
            entry = {"ms": ms, "chain_ms": chain_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "chain_bound_ms": chain_bound_ms,
                     "library_ms": lib_ms, "max_abs_err": max(err_out, err_h),
                     "max_abs_diff_chain": diff}
            if bsz == B:
                results[name] = {
                    "name": name, "route": "cuda",
                    "source": "helen_tpu_torch/ops/csrc/gru_window_smem.cu (the projection "
                              "pass + bigru_window_rec_smem, H <= 136 at 8 rows per block); "
                              "helen_tpu_torch/ops/csrc/gru_window.cu (bigru_window_kernel, "
                              "otherwise)",
                    "replaces": replaces[name], **entry, "kernel_ms": ms,
                    "per": f"one K1/K2 at B={B}, T={T}, H={H} (ms: the two-launch "
                           "design; chain_ms: bigru_window_kernel in the same call; "
                           "launches: layer-windows)"}
            else:
                results[name][f"b{bsz}"] = entry

    # the two-launch design's kernels alone at B=512, each against its plain version
    x_f32 = images_u8[:, start:start + T].to(torch.float32).transpose(0, 1).contiguous()
    k1 = gw.bigru_window_in1(images_u8, start, T, h0[0], h0[1], l1)
    x_cat = torch.cat([k1[0], k1[1]], dim=-1)
    stacked = lambda layer, k: torch.stack([layer[d][k] for d in ("fwd", "bwd")])  # noqa: E731
    bt, n3 = B * T, 3 * H
    xp_bytes = scratch_bytes(B)
    projs = {
        "bigru_window_proj_in1": (
            "helen_tpu/ops/gru_pallas.py:426 (_kernel_inproj1: its input projection)",
            lambda: gs.bigru_window_proj_in1(images_u8, start, T, l1), x_f32, l1, F, bt * F),
        "bigru_window_proj_in2": (
            "helen_tpu/ops/gru_pallas.py:474 (_kernel_inproj2: its input projection)",
            lambda: gs.bigru_window_proj_in2(k1[0], k1[1], l2), x_cat, l2, 2 * H, 4 * bt * 2 * H),
    }
    xp2 = None
    for name, (repl, kfn, x, layer, d, x_bytes) in projs.items():
        got = kfn()
        want = gs.window_proj_plain(x, layer)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        b_ih, w_ih = stacked(layer, "b_ih").unsqueeze(1), stacked(layer, "w_ih")
        x2 = x.reshape(1, bt, d).expand(2, bt, d)
        with torch.no_grad():
            ms = cuda_ms(kfn)
            plain_ms = cuda_ms(lambda: gs.window_proj_plain(x, layer), iters=2, warmup=1)
            lib_ms = cuda_ms(lambda: torch.baddbmm(b_ih, x2, w_ih))
        flops, nbytes = 2.0 * bt * 2 * d * n3, x_bytes + 2 * 4 * (d * n3 + n3) + xp_bytes
        bound_ms, bound_by = bound(flops, nbytes)
        log(f"{name}: max |kernel - plain (k in order)| {err:.3g} (limit {TOL:g} x "
            f"{max(1.0, float(want.abs().max())):.4g}); kernel {ms:.4f} ms, plain {plain_ms:.3f} "
            f"ms, torch.baddbmm {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        if not err <= TOL * max(1.0, float(want.abs().max())):
            fail(f"{name} disagrees with its plain version")
        results[name] = {
            "name": name, "route": "cuda",
            "source": "helen_tpu_torch/ops/csrc/gru_window_smem.cu", "replaces": repl,
            "max_abs_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library": "torch.baddbmm of the float32 input rows (cuBLAS, TF32 off)",
            "per": f"one launch at B={B}, T={T}, H={H}, D={d}"}
        xp2 = got
    name = "bigru_window_rec_smem"
    rec = lambda: gs.bigru_window_rec_smem(xp2, h0[2], h0[3], l2)  # noqa: E731
    got, want = rec(), gs.window_rec_plain(xp2, h0[2], h0[3], l2)
    torch.cuda.synchronize()
    err = max_err(got, want)
    with torch.no_grad():
        ms = cuda_ms(rec)
        plain_ms = cuda_ms(lambda: gs.window_rec_plain(xp2, h0[2], h0[3], l2), iters=2, warmup=1)
    flops = 2.0 * bt * 2 * H * n3
    nbytes = xp_bytes + 2 * 4 * (H * n3 + n3) + 2 * 4 * B * H + 2 * 4 * bt * H + 2 * 4 * B * H
    bound_ms, bound_by = bound(flops, nbytes)
    rows = gs.rec_block_rows(B)
    log(f"{name}: {rows} rows per block, {2 * -(-B // rows)} blocks of "
        f"{(gs.REC_SPLIT if rows >= 2 else 1) * H} threads, {gs.rec_smem_bytes(H, rows)} bytes "
        f"of shared memory each; max |kernel - plain| {err:.3g} (limit {TOL:g}); kernel "
        f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    if not err <= TOL:
        fail(f"{name} disagrees with its plain version")
    results[name] = {
        "name": name, "route": "cuda", "source": "helen_tpu_torch/ops/csrc/gru_window_smem.cu",
        "replaces": "helen_tpu/ops/gru_pallas.py:426 and :474 (_kernel_inproj1/2: the "
                    "recurrence); helen_tpu/ops/gru_pallas_train.py:259 (_fwd_kernel_ip)",
        "max_abs_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library": "none: no one PyTorch call runs a GRU recurrence without its projection",
        "block_rows": rows, "smem_bytes": gs.rec_smem_bytes(H, rows),
        "per": f"one launch at B={B}, T={T}, H={H}"}

    # the second shapes: H=136 (the widest W_hh at 8 rows) and H=160
    new_kernels = ("bigru_window_proj_in1", "bigru_window_proj_in2", "bigru_window_rec_smem")
    for hx, want_design in ((136, "smem"), (160, "chain")):
        la, lb = random_layer(rng, F, hx, dev), random_layer(rng, 2 * hx, hx, dev)
        hh = [torch.from_numpy(rng.uniform(-0.5, 0.5, (B, hx)).astype("float32")).to(dev)
              for _ in range(4)]
        before = {k: gw.launch_counts[k] for k in new_kernels}
        ka = gw.bigru_window_in1(images_u8, start, T, hh[0], hh[1], la)
        kb = gw.bigru_window_in2(ka[0], ka[1], hh[2], hh[3], lb)
        ran = {k: gw.launch_counts[k] - before[k] for k in new_kernels}
        pa = gw.bigru_window_in1_plain(images_u8, start, T, hh[0], hh[1], la)
        pb = gw.bigru_window_in2_plain(ka[0], ka[1], hh[2], hh[3], lb)
        chain = gw.bigru_window_in2(ka[0], ka[1], hh[2], hh[3], lb, design="chain")
        torch.cuda.synchronize()
        err, diff = max(max_err(ka, pa), max_err(kb, pb)), max_err(kb, chain)
        want = dict.fromkeys(new_kernels, 0) if want_design == "chain" else {
            "bigru_window_proj_in1": 1, "bigru_window_proj_in2": 1, "bigru_window_rec_smem": 2}
        which = "the two-launch design" if want_design == "smem" else "bigru_window_kernel"
        log(f"H={hx}, B={B}: K1 and K2 ran {ran} (expected {want}: {which}); max |kernels - "
            f"plain| {err:.3g} (limit {TOL:g}); K2 against bigru_window_kernel {diff!r}")
        if ran != want:
            fail(f"H={hx} did not take the expected design")
        if not err <= TOL or diff != 0.0:
            fail(f"H={hx}: the kernels disagree with their plain versions or each other")


def golden_label_flips(preds: str, stem: str = "golden") -> tuple:
    """(base flips, rle flips, labels per head) of a prediction store
    against the recorded ``<stem>_labels.npz``; fails unless it holds the
    recorded images."""
    import numpy as np

    want = np.load(os.path.join(GOLDEN, f"{stem}_labels.npz"))
    got = store_labels(preds)
    keys = sorted(k[len("base/"):] for k in want.files if k.startswith("base/"))
    if sorted(got) != keys:
        fail(f"{stem}: stored images differ from the recorded ones")
    return (sum(int((got[k][0] != want[f"base/{k}"]).sum()) for k in keys),
            sum(int((got[k][1] != want[f"rle/{k}"]).sum()) for k in keys),
            sum(want[f"base/{k}"].size for k in keys))


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as x, open(b, "rb") as y:
        return x.read() == y.read()


def check_golden(work: str) -> None:
    """Phase 4: the golden fixtures through the CLI on the card."""
    img_dir = os.path.join(work, "golden_images")
    os.makedirs(img_dir)
    with gzip.open(os.path.join(GOLDEN, "golden_images.h5.gz"), "rb") as src, \
            open(os.path.join(img_dir, "golden_images.h5"), "wb") as dst:
        shutil.copyfileobj(src, dst)
    for name in FIXTURES:
        stem = "golden" if name == "model" else f"golden_{name}"
        pkl = os.path.join(GOLDEN, f"golden_{name}.pkl")
        fasta, preds = polish_cli(img_dir, pkl, os.path.join(work, f"out_{name}"))
        flips_b, flips_r, n = golden_label_flips(preds, stem)
        same = same_bytes(fasta, os.path.join(GOLDEN, f"{stem}.fa"))
        log(f"golden {name}: {flips_b}+{flips_r} base+rle label flips of {n} "
            f"per head, FASTA byte-identical: {same}")
        if max(flips_b, flips_r) > FLIPS_PER_LABEL * n:
            fail(f"golden {name}: too many label flips")


def check_trained(work: str) -> tuple:
    """Phase 5: the trained checkpoint polishes an unseen sequence exactly.
    Returns (image dir, FASTA path, predictions dir) for phase 10d."""
    from helen_tpu_torch.io.fasta import read_fasta
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    img_dir = os.path.join(work, "unseen")
    os.makedirs(img_dir)
    seq = random_sequence(20000, seed=555)
    write_image_file(os.path.join(img_dir, "img.h5"), {"unseen_ctg": seq},
                     region_cols=1000, overlap_cols=80, noise=0.1, seed=556)
    fasta, preds = polish_cli(img_dir, os.path.join(GOLDEN, "trained_synth30mb.npz"),
                              os.path.join(work, "out_unseen"))
    exact = dict(read_fasta(fasta)).get("unseen_ctg") == seq
    log(f"trained checkpoint on an unseen 20 kb sequence: polished == truth: {exact}")
    if not exact:
        fail("the trained checkpoint did not polish the unseen sequence exactly")
    return img_dir, fasta, preds


def make_full_width(img_dir: str):
    """>= N_FULL synthetic 1000-column images; returns {contig: truth}."""
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file

    os.makedirs(img_dir)
    truth, n, i = {}, 0, 0
    while n < N_FULL:
        seq = random_sequence(FULL_CONTIG_BP, seed=1000 + i)
        truth[f"full_{i}"] = seq
        n += write_image_file(os.path.join(img_dir, f"full_{i}.h5"), {f"full_{i}": seq},
                              region_cols=1000, overlap_cols=80, noise=0.1,
                              seed=2000 + i)
        i += 1
    return truth, n


def run_full_width(img_dir: str, truth, n_images: int, work: str, results):
    """Phase 6: a full-width polish at -b 512 with the kernel launches
    counted, and the first 64 images' labels against the plain path. It
    calls ``polish``, the function behind ``python -m helen_tpu_torch polish
    -b 512 -t 4``, with a stage timer of its own, which it returns (phase
    12 sets its stages beside its own)."""
    import numpy as np
    import torch

    from helen_tpu_torch.config import IMAGE, WINDOW
    from helen_tpu_torch.infer.consensus import ConsensusStep
    from helen_tpu_torch.infer.polish import polish
    from helen_tpu_torch.io.checkpoint import load_model_any
    from helen_tpu_torch.io.fasta import read_fasta
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.obs import StageTimer
    from helen_tpu_torch.ops import gru_window as gw

    model = os.path.join(GOLDEN, "trained_synth30mb.npz")
    out = os.path.join(work, "out_full")
    timer = StageTimer()
    torch.cuda.reset_peak_memory_stats()
    gw.reset_launch_counts()
    t0 = time.perf_counter()
    fasta = polish(img_dir, model, out, batch_size=B, threads=4, stage_timer=timer)
    wall = time.perf_counter() - t0
    launches = dict(gw.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2**20
    n_win = WINDOW.num_windows(IMAGE.seq_length)
    batches = -(-n_images // B)
    consensus_s = timer.stages["call_consensus"]
    log(f"full width: {n_images} images ({len(truth)} contigs, "
        f"{sum(map(len, truth.values())) / 1e6:.1f} Mb) at -b {B}: polish wall "
        f"{wall:.2f} s, consensus {consensus_s:.2f} s = "
        f"{n_images * n_win / consensus_s:,.0f} windows/s, peak device memory "
        f"{peak:.0f} MiB")
    log("stage timings:\n" + timer.report())
    polished = dict(read_fasta(fasta))
    exact = sum(polished.get(c) == s for c, s in truth.items())
    log(f"full width: {exact}/{len(truth)} contigs polished == truth")
    if exact != len(truth):
        fail("the trained checkpoint did not polish every full-width contig exactly")
    layers = 1  # the trained checkpoint is the flagship geometry
    want = {**OFF_PATH_ZERO, **parity_counts(batches * n_win * layers,
                                             batches * n_win * (2 * layers - 1))}
    log(f"kernel launches {launches}, expected {want} ({batches} batches x "
        f"{n_win} windows x layers; each K1/K2 a projection and a recurrence)")
    if launches != want:
        fail("kernel launch counts differ from batches x windows x layers")
    for name in ("bigru_window_in1", "bigru_window_in2", *SMEM_KERNELS):
        results[name]["launches"] = launches[name]
    busy = sum(launches[name] * results[name]["ms"] for name in SMEM_KERNELS) / 1e3
    log(f"window kernels' share of call_consensus (launches x phase-3 ms): "
        f"{busy:.3f} s of {consensus_s:.3f} s = {100 * busy / consensus_s:.1f}%")

    # the first 64 images through the plain path on the card
    params, _ = load_model_any(model)
    ds = MarginPolishDataset(sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)))
    recs = [ds.load(i) for i in range(min(64, len(ds)))]
    plain = ConsensusStep(params, torch.device("cuda"), backend="torch")
    base, rle = plain(np.stack([r.image for r in recs]))
    got = store_labels(os.path.join(out, [d for d in os.listdir(out)
                                          if d.startswith("predictions_")][0]))
    fb = fr = 0
    for j, r in enumerate(recs):
        kb, kr = got[f"{r.contig}-{r.contig_start}-{r.contig_end}-{r.chunk_id}"]
        fb += int((kb != base[j]).sum())
        fr += int((kr != rle[j]).sum())
    log(f"first 64 images, kernels vs plain path: {fb}+{fr} base+rle label "
        f"flips of {base.size} per head")
    if max(fb, fr) > FLIPS_PER_LABEL * base.size:
        fail("the kernel path's labels disagree with the plain path")
    return timer


def timed_passes(fn, iters: int = 10, warmup: int = 2, passes=BWD_PASSES) -> dict:
    """Device ms of each of a backward wrapper's two launches: CUDA events
    recorded around each call into the kernel library while ``fn`` runs."""
    import torch

    from helen_tpu_torch.ops import gru_window as gw

    lib = gw.get_lib()
    orig = {n: getattr(lib, n) for n in passes}
    spans = {n: [] for n in passes}

    def timed(name):
        def call(*args):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            err = orig[name](*args)
            e1.record()
            spans[name].append((e0, e1))
            return err
        return call

    for _ in range(warmup):
        fn()
    try:
        for n in passes:
            setattr(lib, n, timed(n))
        for _ in range(iters):
            fn()
    finally:
        for n in passes:
            setattr(lib, n, orig[n])
    torch.cuda.synchronize()
    return {n: sum(a.elapsed_time(b) for a, b in spans[n]) / iters for n in passes}


def check_backward(images_u8, results) -> None:
    """Phase 7a: the backward at the flagship training shapes (B=256, T=100,
    H=128; layer 0 on the uint8 image, D=90, no dx; the decoder on two
    halves, D=256). Pass 1 in the main path's design (the gate pass, the
    recurrence with W_hh^T in shared memory, the dx pass) against its plain
    version (TOL) and against the one-launch bwd_rec_kernel (exactly 0.0 in
    dxp, dhp_n, dx, dh0 and every dW/db), bit-identity of two launches;
    both designs timed in turns (new, one-launch, one-launch, new) beside
    the plain version, the bound and the libraries (cuDNN's GRU backward
    for pass 1, cuBLAS's products for pass 2; the port calls neither); then
    each new kernel alone against its plain version, its bound and a
    library call."""
    import numpy as np
    import torch

    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import gru_window_smem as gs

    dev = images_u8.device
    rng = np.random.default_rng(20261017)
    img = images_u8[:TB]
    r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype("float32")).to(dev)  # noqa: E731
    n = TB * T
    keys = ("ms", "chain_ms", "plain_ms", "bound_ms", "library_ms", "flops", "bytes")
    sums = {name: {**dict.fromkeys(keys, 0.0), "max_abs_err": 0.0, "max_scaled_err": 0.0}
            for name in (*BWD_PASSES, *BWD_SMEM_KERNELS)}
    if gb.bwd_design(H, TB) != "smem":
        fail(f"pass 1 at H={H}, B={TB} does not take the shared-memory design")
    for label, D in (("layer 0, image D=90", F), ("decoder, halves D=256", 2 * H)):
        layer = random_layer(rng, D, H, dev)
        h0f, h0b, dhf, dhb = (r(TB, H) for _ in range(4))
        dof, dob = r(T, TB, H), r(T, TB, H)
        if D == F:
            src, start, need_dx = img, 450, False
            fwd = lambda: gw.bigru_window_in1(img, start, T, h0f, h0b, layer)  # noqa: E731
            fwd_plain = lambda: gw.bigru_window_in1_plain(  # noqa: E731
                img, start, T, h0f, h0b, layer)
            x_bytes = n * F
            proj = "bigru_window_proj_in1"
        else:
            src, start, need_dx = (r(T, TB, H), r(T, TB, H)), 0, True
            fwd = lambda: gw.bigru_window_in2(*src, h0f, h0b, layer)  # noqa: E731
            fwd_plain = lambda: gw.bigru_window_in2_plain(*src, h0f, h0b, layer)  # noqa: E731
            x_bytes = 4 * n * D
            proj = "bigru_window_proj_in2"
        of, ob, _, _ = fwd()
        args = (src, start, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer)
        got = gb.bigru_window_bwd(*args)
        again = gb.bigru_window_bwd(*args)
        chain = gb.bigru_window_bwd(*args, design="chain")
        rec_new = gb.bigru_window_bwd_rec(*args, design="smem")
        rec_old = gb.bigru_window_bwd_rec(*args, design="chain")
        want = gb.bigru_window_bwd_plain(*args, need_dx=need_dx)
        torch.cuda.synchronize()
        flat = lambda res: ([("dx", res[0])] if res[0] is not None else []) + [  # noqa: E731
            ("dh0_f", res[1]), ("dh0_b", res[2])] + [
            (f"{d}.{k}", res[3][d][k]) for d in ("fwd", "bwd")
            for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
        worst = worst_scaled = 0.0
        for (what, g), (_, w), (_, a), (_, c) in zip(flat(got), flat(want), flat(again),
                                                     flat(chain)):
            err = float((g - w).abs().max())
            scale = max(1.0, float(w.abs().max()))
            worst = max(worst, err)
            worst_scaled = max(worst_scaled, err / scale)
            diff = float((g - c).abs().max())
            log(f"backward {label}: {what}: max |kernels - plain| {err:.3g} "
                f"(limit {TOL:g} x {scale:.4g}); max |new design - one-launch| {diff!r} "
                "(limit 0.0)")
            if err > TOL * scale:
                fail(f"backward {label}: {what} disagrees with its plain version")
            if not torch.equal(g, a):
                fail(f"backward {label}: {what} differs between two launches")
            if not torch.equal(g, c):
                fail(f"backward {label}: {what} differs between pass 1's two designs")
        for what, x, y in zip(("dxp", "dhp_n", "dx", "dh0_f", "dh0_b"), rec_new, rec_old):
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                fail(f"backward {label}: pass 1's {what} differs between the designs")
        log(f"backward {label}: two launches bit-identical; pass 1's dxp, dhp_n, dx, dh0 and "
            f"every dW/db equal in both designs")

        # pass 1 in turns: new design (its kernels, the projection included),
        # one-launch, one-launch, new; pass 2 beside the new design
        new_names = (proj, "bigru_window_bwd_hp", "bigru_window_bwd_rec_smem",
                     *(("bigru_window_bwd_dx",) if need_dx else ()))
        turns = []
        for d in ("smem", "chain", "chain", "smem"):
            if d == "smem":
                turns.append(timed_passes(lambda: gb.bigru_window_bwd(*args),
                                          passes=(*new_names, *WGRAD_IN)))
            else:
                turns.append(timed_passes(lambda: gb.bigru_window_bwd_rec(
                    *args, design="chain"), passes=("bigru_window_bwd_rec",)))
        kern = {k: (turns[0][k] + turns[3][k]) / 2 for k in turns[0]}
        rec_ms = sum(kern[k] for k in new_names)
        chain_ms = (turns[1]["bigru_window_bwd_rec"] + turns[2]["bigru_window_bwd_rec"]) / 2
        log(f"pass 1 ({label}) at B={TB}: new design {rec_ms:.4f} ms ("
            + ", ".join(f"{k} {kern[k]:.4f}" for k in new_names)
            + f"), one-launch {chain_ms:.4f} ms (in turns: "
            + ", ".join(f"{sum(t[k] for k in new_names):.4f}" if i in (0, 3)
                        else f"{t['bigru_window_bwd_rec']:.4f}" for i, t in enumerate(turns))
            + f"): {chain_ms / rec_ms:.2f}x")
        ms = {BWD_PASSES[0]: rec_ms, BWD_PASSES[1]: sum(kern[k] for k in WGRAD_IN)}
        dxp, dhpn, *_ = gb.bigru_window_bwd_rec_plain(*args, need_dx=need_dx)
        plain = {
            BWD_PASSES[0]: cuda_ms(lambda: gb.bigru_window_bwd_rec_plain(
                *args, need_dx=need_dx), iters=3, warmup=1),
            BWD_PASSES[1]: cuda_ms(lambda: gb.bigru_window_bwd_wgrad_plain(
                src, start, h0f, h0b, of, ob, dxp, dhpn), iters=3, warmup=1),
        }
        # the libraries: cuDNN's GRU backward (forward+backward minus
        # forward) for the recurrence; cuBLAS's products with a row of ones
        # for the bias sums, for the weight cotangents
        gru = cudnn_gru(layer, D, H, dev)
        x = gb.window_input(src, start, T, torch.float32).contiguous()
        x.requires_grad_(need_dx)
        hx = torch.stack([h0f, h0b]).requires_grad_(True)
        dout_cat, dh_cat = torch.cat([dof, dob], -1), torch.stack([dhf, dhb])

        def fwd_bwd():
            out, hn = gru(x, hx)
            torch.autograd.backward([out, hn], [dout_cat, dh_cat])

        cudnn_ms = cuda_ms(fwd_bwd) - cuda_ms(lambda: gru(x, hx))
        # the training forward is K1/K2 as they stand: their times at B=256
        with torch.no_grad():
            fwd_ms, fwd_plain_ms = cuda_ms(fwd), cuda_ms(fwd_plain, iters=3, warmup=1)
            fwd_cudnn_ms = cuda_ms(lambda: gru(x, hx))
        fwd_bound, fwd_by = bound(*window_cost(TB, D))
        log(f"training forward ({label}, {'K1' if D == F else 'K2'}) at B={TB}: kernel "
            f"{fwd_ms:.4f} ms, plain {fwd_plain_ms:.3f} ms, cuDNN GRU {fwd_cudnn_ms:.4f} ms, "
            f"bound {fwd_bound:.4f} ms ({fwd_by})")
        ones = torch.ones(n, 1, device=dev)
        x1 = torch.cat([x.detach().reshape(n, D), ones], 1)
        prods = []
        for i, (out, h0, rev) in enumerate(((of, h0f, False), (ob, h0b, True))):
            g_x = dxp[i].reshape(n, 3 * H)
            g_h = torch.cat([g_x[:, :2 * H], dhpn[i].reshape(n, H)], 1)
            h1 = torch.cat([gbs.h_prev_of(out, h0, rev).reshape(n, H), ones], 1)
            prods += [(x1, g_x), (h1, g_h)]
        cublas_ms = cuda_ms(lambda: [a.T @ b for a, b in prods])
        library = {BWD_PASSES[0]: cudnn_ms, BWD_PASSES[1]: cublas_ms}
        w_bytes = 4 * 2 * ((D + H) * 3 * H + 6 * H)
        vec = 4 * TB * H  # one (B, H) float32 array
        stream = 4 * n * H  # one (T, B, H) float32 array
        cost = {
            BWD_PASSES[0]: (
                2 * 2.0 * n * 3 * H * (D + 2 * H + (D if need_dx else 0)),
                x_bytes + 4 * stream + 4 * vec + w_bytes   # x, out, dout, h0, dh, W
                + 2 * (3 * stream + stream) + 2 * vec      # dxp, dhp_n, dh0
                + (2 * 4 * n * D if need_dx else 0)),      # dx per direction
            BWD_PASSES[1]: (
                2 * 2.0 * n * 3 * H * (D + 1 + H + 1),
                x_bytes + 2 * stream + 2 * vec + 2 * (3 * stream + stream) + w_bytes),
        }
        for name in BWD_PASSES:
            flops, nbytes = cost[name]
            bound_ms, bound_by = bound(flops, nbytes)
            extra = f", one-launch {chain_ms:.4f} ms" if name == BWD_PASSES[0] else ""
            log(f"{name} ({label}): kernels {ms[name]:.4f} ms{extra}, plain "
                f"{plain[name]:.3f} ms, library {library[name]:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
            acc = sums[name]
            for key, v in (("ms", ms[name]), ("plain_ms", plain[name]),
                           ("bound_ms", bound_ms), ("library_ms", library[name]),
                           ("flops", flops), ("bytes", nbytes)):
                acc[key] += v
            acc["max_abs_err"] = max(acc["max_abs_err"], worst)
            acc["max_scaled_err"] = max(acc["max_scaled_err"], worst_scaled)
        sums[BWD_PASSES[0]]["chain_ms"] += chain_ms

        # each new kernel alone, against its plain version and a library call
        whl = {k: torch.stack([layer[d][k] for d in ("fwd", "bwd")]) for k in ("w_hh", "w_ih")}
        xp = (gs.bigru_window_proj_in2(*src, layer) if need_dx
              else gs.bigru_window_proj_in1(img, start, T, layer))
        hprev = torch.stack([gbs.h_prev_of(of, h0f, False), gbs.h_prev_of(ob, h0b, True)]
                            ).reshape(2, n, H)
        rest = (h0f, h0b, of, ob, dof, dob, dhf, dhb, layer)
        hp = gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, layer)
        rec = gbs.bigru_window_bwd_rec_smem(xp, hp, *rest)
        kernels = {
            "bigru_window_bwd_hp": (
                lambda: gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, layer),
                lambda: gbs.bwd_hp_plain(h0f, h0b, of, ob, layer),
                lambda: torch.bmm(hprev, whl["w_hh"]),
                (2 * 2.0 * n * H * 3 * H,
                 2 * stream + 2 * vec + 2 * 4 * H * 3 * H + 2 * 4 * n * 3 * H)),
            "bigru_window_bwd_rec_smem": (
                lambda: gbs.bigru_window_bwd_rec_smem(xp, hp, *rest),
                lambda: gbs.bwd_rec_smem_plain(xp, hp, *rest),
                None,
                (2 * 2.0 * n * 3 * H * H,
                 2 * 2 * 4 * n * 3 * H + 4 * stream + 4 * vec + 2 * 4 * (3 * H * H + 3 * H)
                 + 2 * 4 * n * 3 * H + 2 * stream + 2 * vec)),
        }
        if need_dx:
            dxp2, w_ihT = rec[0], whl["w_ih"].transpose(1, 2)
            kernels["bigru_window_bwd_dx"] = (
                lambda: gbs.bigru_window_bwd_dx(dxp2, layer),
                lambda: gbs.bwd_dx_plain(dxp2, layer),
                lambda: torch.bmm(dxp2.reshape(2, n, 3 * H), w_ihT),
                (2 * 2.0 * n * 3 * H * D,
                 2 * 4 * n * 3 * H + 2 * 4 * 3 * H * D + 2 * 4 * n * D))
        for name, (kfn, pfn, lfn, (flops, nbytes)) in kernels.items():
            out, ref = kfn(), pfn()
            torch.cuda.synchronize()
            outs = out if isinstance(out, tuple) else (out,)
            refs = ref if isinstance(ref, tuple) else (ref,)
            err = max(float((o - w).abs().max()) for o, w in zip(outs, refs))
            scale = max(max(1.0, float(w.abs().max())) for w in refs)
            with torch.no_grad():
                k_ms = kern[name]
                p_ms = cuda_ms(pfn, iters=2, warmup=1)
                l_ms = cuda_ms(lfn) if lfn is not None else None
            bound_ms, bound_by = bound(flops, nbytes)
            log(f"{name} ({label}): max |kernel - plain| {err:.3g} (limit {TOL:g} x "
                f"{scale:.4g}); kernel {k_ms:.4f} ms (timed in pass 1's turns), plain "
                f"{p_ms:.3f} ms, library "
                f"{'none' if l_ms is None else f'{l_ms:.4f} ms'}, bound {bound_ms:.4f} ms "
                f"({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
            if err > TOL * scale:
                fail(f"{name} ({label}) disagrees with its plain version")
            acc = sums[name]
            for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", bound_ms),
                           ("flops", flops), ("bytes", nbytes)):
                acc[key] += v
            acc["library_ms"] = None if l_ms is None else acc["library_ms"] + l_ms
            acc["max_abs_err"] = max(acc["max_abs_err"], err)
            acc["max_scaled_err"] = max(acc["max_scaled_err"], err / scale)

    per = "one training window: layer 0 (D=90) + decoder (D=256), B=256"
    for name in (*BWD_PASSES, *BWD_SMEM_KERNELS):
        acc = sums[name]
        _, bound_by = bound(acc["flops"], acc["bytes"])
        smem_kernel = name in BWD_SMEM_KERNELS
        results[name] = {
            "name": name, "route": "cuda",
            "source": "helen_tpu_torch/ops/csrc/gru_window_bwd_smem.cu" if smem_kernel else (
                "helen_tpu_torch/ops/csrc/gru_window_bwd_smem.cu with bigru_window_proj_in1/"
                "_in2 (gru_window_smem.cu), W_hh^T fitting a block; "
                "helen_tpu_torch/ops/csrc/gru_window_bwd.cu (bwd_rec_kernel), otherwise"
                if name == BWD_PASSES[0] else "helen_tpu_torch/ops/csrc/gru_window_wgrad.cu "
                "(wgrad_split_kernel, then wgrad_sum_kernel past one slice)"),
            "replaces": "helen_tpu/ops/gru_pallas_train.py:321 (_bwd_kernel_ip"
                        + (", pass 1)" if name != BWD_PASSES[1] else ", pass 2)"),
            "max_abs_err": acc["max_abs_err"],
            # max |kernel - plain| / max(1, max |plain|) over the outputs
            "max_scaled_err": acc["max_scaled_err"],
            "ms": acc["ms"], "kernel_ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"], "bound_by": bound_by,
            "library_ms": acc["library_ms"],
            "per": per + (" (the dx pass: the decoder only)"
                          if name == "bigru_window_bwd_dx" else ""),
        }
        if name == BWD_PASSES[0]:
            results[name]["chain_ms"] = acc["chain_ms"]
            results[name]["per"] += ("; ms: the new design's kernels, the projection "
                                     "included; chain_ms: bwd_rec_kernel in the same call")
        lib = acc["library_ms"]
        log(f"{name}, one training window (layer 0 + decoder): kernel {acc['ms']:.4f} ms"
            + (f" (one-launch {acc['chain_ms']:.4f} ms: {acc['chain_ms'] / acc['ms']:.2f}x)"
               if name == BWD_PASSES[0] else "")
            + f", bound {acc['bound_ms']:.4f} ms ({bound_by}), plain {acc['plain_ms']:.3f} ms, "
            f"library {'none' if lib is None else f'{lib:.4f} ms'}")


def wgrad_split(label: str, run, want, entries, iters: int = 10) -> dict:
    """Pass 2 in its split design against its plain version ``want`` (TOL x
    scale per output), two launches bit-identical, then timed by its
    library calls ``entries`` (the split kernel, the slice sum). ``run()``
    launches one pass 2."""
    import torch

    got, again = run(), run()
    torch.cuda.synchronize()
    err = scaled = 0.0
    for d in ("fwd", "bwd"):
        for k, w in want[d].items():
            scale = max(1.0, float(w.abs().max()))
            e = float((got[d][k] - w).abs().max())
            err, scaled = max(err, e), max(scaled, e / scale)
            if e > TOL * scale:
                fail(f"{label}: {d}.{k} disagrees with its plain version: {e!r} (limit "
                     f"{TOL:g} x {scale:.4g})")
            if not torch.equal(got[d][k], again[d][k]):
                fail(f"{label}: {d}.{k} differs between two launches")
    t = timed_passes(run, iters=iters, warmup=2, passes=entries)
    split_ms, sum_ms = (t[k] for k in entries)
    log(f"{label}: max |split - plain| {err:.3g}, scaled {scaled:.3g} (limit {TOL:g}); two "
        f"launches bit-identical; {split_ms + sum_ms:.4f} ms")
    return {"ms": split_ms + sum_ms, "split_ms": split_ms, "sum_ms": sum_ms, "err": err,
            "scaled": scaled}


def check_wgrad(results) -> None:
    """Phase 7a, pass 2 alone at the flagship's training batch (B=256) and
    at B=512, per training window: layer 0 on a full-range uint8 image
    (D=90) and the decoder on two halves (D=256), pass 1's dxp and dhp_n
    from its kernels. The split design against its plain version, two
    launches bit-identical, timed (wgrad_split) beside the plain version,
    cuBLAS's products and the bounds: FLOP at the fp32
    rate, and 3 x FLOP (3xTF32) at the dense TF32 rate. Adds the split and
    sum kernels' entries."""
    import numpy as np
    import torch

    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import gru_window_proj as gp
    from helen_tpu_torch.ops import gru_window_wgrad as gwg

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261020)
    r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype("float32")).to(dev)  # noqa: E731
    per_b = {}
    for bsz in (TB, B):
        n = bsz * T
        acc = dict.fromkeys(("ms", "split_ms", "sum_ms", "plain_ms", "library_ms",
                             "sum_plain_ms", "sum_library_ms", "flops", "bytes", "sum_bytes",
                             "err", "scaled"), 0.0)
        for label, D in (("layer 0, full-range image D=90", F), ("decoder, halves D=256", 2 * H)):
            layer = random_layer(rng, D, H, dev)
            h0f, h0b, dhf, dhb = (r(bsz, H) for _ in range(4))
            dof, dob = r(T, bsz, H), r(T, bsz, H)
            if D == F:
                src, start = torch.from_numpy(rng.integers(0, 256, (bsz, T + 20, F),
                                                           dtype=np.uint8)).to(dev), 11
                of, ob, _, _ = gw.bigru_window_in1(src, start, T, h0f, h0b, layer)
                x_bytes = n * F
            else:
                src, start = (r(T, bsz, H), r(T, bsz, H)), 0
                of, ob, _, _ = gw.bigru_window_in2(*src, h0f, h0b, layer)
                x_bytes = 4 * n * D
            dxp, dhpn, *_ = gb.bigru_window_bwd_rec(src, start, h0f, h0b, of, ob, dof, dob,
                                                     dhf, dhb, layer, need_dx=False)
            args = (src, start, h0f, h0b, of, ob, dxp, dhpn)
            w = wgrad_split(f"pass 2 ({label}, B={bsz})",
                            lambda: gwg.bigru_window_wgrad(*args),
                            gwg.bigru_window_bwd_wgrad_plain(*args), WGRAD_IN)
            plain_ms = cuda_ms(lambda: gwg.bigru_window_bwd_wgrad_plain(*args), iters=3,
                               warmup=1)
            ones = torch.ones(n, 1, device=dev)
            x1 = torch.cat([gp.window_input(src, start, T, torch.float32).reshape(n, D),
                            ones], 1)
            prods = []
            for i, (out, h0, rev) in enumerate(((of, h0f, False), (ob, h0b, True))):
                g_x = dxp[i].reshape(n, 3 * H)
                g_h = torch.cat([g_x[:, :2 * H], dhpn[i].reshape(n, H)], 1)
                h1 = torch.cat([gbs.h_prev_of(out, h0, rev).reshape(n, H), ones], 1)
                prods += [(x1, g_x), (h1, g_h)]
            cublas_ms = cuda_ms(lambda: [a.T @ b for a, b in prods])
            # the slice sum alone: its plain version adds the partials in
            # order, its library call is one torch.sum over the slices
            plan = gwg.wgrad_design(D, H, T, bsz, True)
            part = r(plan.slices, 2 * plan.rows * 3 * H)

            def ordered():
                total = part[0].clone()
                for s_ in range(1, plan.slices):
                    total += part[s_]
                return total

            sum_plain_ms = cuda_ms(ordered)
            sum_library_ms = cuda_ms(lambda: part.sum(0))
            stream = 4 * n * H
            flops = 2 * 2.0 * n * 3 * H * (D + 1 + H + 1)
            nbytes = (x_bytes + 2 * stream + 2 * 4 * bsz * H + 2 * (3 * stream + stream)
                      + 4 * 2 * ((D + H) * 3 * H + 6 * H))
            for k, v in (("ms", w["ms"]), ("split_ms", w["split_ms"]), ("sum_ms", w["sum_ms"]),
                         ("plain_ms", plain_ms),
                         ("library_ms", cublas_ms), ("sum_plain_ms", sum_plain_ms),
                         ("sum_library_ms", sum_library_ms), ("flops", flops),
                         ("bytes", nbytes), ("sum_bytes", plan.scratch_bytes
                                             + 4 * 2 * plan.rows * 3 * H)):
                acc[k] += v
            for k in ("err", "scaled"):
                acc[k] = max(acc[k], w[k])
        acc["bound_ms"], acc["bound_by"] = bound(acc["flops"], acc["bytes"])
        acc["bound_tf32_ms"], acc["bound_tf32_by"] = bound(3 * acc["flops"], acc["bytes"],
                                                           PEAK_TF32)
        log(f"pass 2, one training window at B={bsz} (layer 0 + decoder): split {acc['ms']:.4f} "
            f"ms (split kernel {acc['split_ms']:.4f}, slice sum {acc['sum_ms']:.4f}), plain "
            f"{acc['plain_ms']:.3f} ms, cuBLAS {acc['library_ms']:.4f} ms; bound "
            f"{acc['bound_ms']:.4f} ms ({acc['bound_by']}) at the fp32 rate, "
            f"{acc['bound_tf32_ms']:.4f} ms ({acc['bound_tf32_by']}) at 3 x FLOP on TF32 "
            f"tensor cores; max scaled error {acc['scaled']:.3g}")
        per_b[bsz] = acc
    a, a512 = per_b[TB], per_b[B]
    results[BWD_PASSES[1]].update(
        ms=a["ms"], kernel_ms=a["ms"], plain_ms=a["plain_ms"], library_ms=a["library_ms"],
        bound_ms=a["bound_ms"], bound_by=a["bound_by"], bound_tf32_ms=a["bound_tf32_ms"],
        max_abs_err=a["err"], max_scaled_err=a["scaled"], ms_b512=a512["ms"],
        library_ms_b512=a512["library_ms"], bound_ms_b512=a512["bound_ms"],
        max_scaled_err_b512=a512["scaled"],
        per="one training window: layer 0 (D=90, a full-range uint8 image) + decoder (D=256), "
            "B=256 (*_b512: B=512); ms: the split design (split kernel + slice sum); "
            "bound_tf32_ms: 3 x FLOP at the dense TF32 rate; library: cuBLAS's products")
    src = "helen_tpu_torch/ops/csrc/gru_window_wgrad.cu"
    replaces = ("helen_tpu/ops/gru_pallas_train.py:321 (_bwd_kernel_ip, pass 2); "
                "helen_tpu/ops/gru_pallas_train.py:166 (_bwd_kernel, pass 2)")
    sum_bound, sum_by = bound(0.0, a["sum_bytes"])
    results[WGRAD_KERNELS[0]] = {
        "name": WGRAD_KERNELS[0], "route": "cuda", "source": f"{src} (wgrad_split_kernel)",
        "replaces": replaces, "max_abs_err": a["err"], "max_scaled_err": a["scaled"],
        "ms": a["split_ms"], "kernel_ms": a["split_ms"], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
        "bound_tf32_ms": a["bound_tf32_ms"], "library_ms": a["library_ms"],
        "per": "one training window at B=256 (layer 0 + decoder); plain: the whole pass 2's "
               "plain version; error: pass 2 (with the slice sum) against it",
    }
    results[WGRAD_KERNELS[1]] = {
        "name": WGRAD_KERNELS[1], "route": "cuda", "source": f"{src} (wgrad_sum_kernel)",
        "replaces": replaces, "max_abs_err": a["err"], "max_scaled_err": a["scaled"],
        "ms": a["sum_ms"], "kernel_ms": a["sum_ms"], "plain_ms": a["sum_plain_ms"],
        "bound_ms": sum_bound, "bound_by": sum_by, "library_ms": a["sum_library_ms"],
        "per": "one training window at B=256 (layer 0 + decoder: 16 slices each); plain: the "
               "partials added in slice order, library: torch.sum over the slices, both on "
               "random partials of the same shape; error: pass 2 (with the split kernel)",
    }


def load_labeled(img_dir: str, n: int):
    """The first ``n`` labeled images of a directory, on the card."""
    import numpy as np
    import torch

    from helen_tpu_torch.io.images import MarginPolishDataset

    ds = MarginPolishDataset(sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)),
                             with_labels=True)
    recs = [ds.load(i) for i in range(n)]
    t = lambda a: torch.from_numpy(np.stack(a)).cuda()  # noqa: E731
    return (t([r.image for r in recs]), t([r.label_base for r in recs]).long(),
            t([r.label_rle for r in recs]).long())


def check_tbptt(img_dir: str) -> None:
    """Phase 7b: one TBPTT batch of 256 full-width images (19 windows, 19
    Adam updates at lr 1e-4) through the kernels and through the plain
    route on the card, from the same initial params."""
    import torch

    from helen_tpu_torch.config import IMAGE, MODEL, WINDOW
    from helen_tpu_torch.io.checkpoint import opt_leaves, params_to_torch
    from helen_tpu_torch.models.transducer import init_params, param_leaves
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_wgrad as gwg
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    images, yb, yr = load_labeled(img_dir, TB)
    params0 = init_params(torch.Generator().manual_seed(7), MODEL)
    n_win = WINDOW.num_windows(IMAGE.seq_length)
    runs = {}
    for backend in ("cuda", "torch"):
        p = params_to_torch(params0, images.device)
        for t in param_leaves(p):
            t.requires_grad_(True)
        adam = Adam(0.0)
        state = adam.init(p)
        for m in (gw, gb, gwg):
            m.reset_launch_counts()
        t0 = time.perf_counter()
        tot = tbptt_step(p, adam, state, 1e-4, images, yb, yr, TB, backend)
        sums = [float(v) for v in tot]
        log(f"one TBPTT batch via {backend}: loss sums {sums} in "
            f"{time.perf_counter() - t0:.2f} s")
        launches = {**gw.launch_counts, **gb.launch_counts, **gwg.launch_counts}
        want = (train_counts(n_win, n_win) if backend == "cuda"
                else dict.fromkeys(launches, 0))
        log(f"one TBPTT batch via {backend}: launches {launches}, expected {want}")
        if launches != want:
            fail(f"the TBPTT batch via {backend} launched other kernels than expected")
        runs[backend] = (sums, [t.detach() for t in param_leaves(p)],
                         [torch.as_tensor(v) for v in opt_leaves(state)[1:]])
    (ks, kp, ko), (ps, pp, po) = runs["cuda"], runs["torch"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ks, ps))
    perr = max(float((a - b).abs().max()) for a, b in zip(kp, pp))
    oerr = max(float((a - b).abs().max()) for a, b in zip(ko, po))
    log(f"one TBPTT batch, kernels vs plain: loss sums rel diff {rel:.3g} (limit 1e-5), "
        f"params max abs diff {perr:.3g} (limit 2e-5), Adam moments {oerr:.3g}")
    if rel > 1e-5 or perr > 2e-5:
        fail("the kernel path's TBPTT batch disagrees with the plain path")


def run_train(img_dir: str, n_images: int, work: str, results) -> None:
    """Phase 7c: ``train`` then ``test`` through the CLI (its main, in this
    process) on the full-width labeled images at -b 256, held out on a
    separate labeled contig, with the kernel launches counted."""
    import glob

    import torch

    from helen_tpu_torch.cli import main as cli
    from helen_tpu_torch.config import IMAGE, WINDOW
    from helen_tpu_torch.io.synthetic import random_sequence, write_image_file
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_wgrad as gwg

    test_dir = os.path.join(work, "train_test")
    os.makedirs(test_dir)
    n_test = write_image_file(os.path.join(test_dir, "held_out.h5"),
                              {"held_out": random_sequence(TEST_CONTIG_BP, seed=777)},
                              region_cols=1000, overlap_cols=80, noise=0.1, seed=778)
    out = os.path.join(work, "train_out")
    mods = (gw, gb, gwg)
    counts = lambda: {k: v for m in mods for k, v in m.launch_counts.items()}  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    for m in mods:
        m.reset_launch_counts()
    t0 = time.perf_counter()
    if cli(["train", "--train_image_dir", img_dir, "--test_image_dir", test_dir,
            "-b", str(TB), "-e", str(TRAIN_EPOCHS), "-w", "8", "-o", out,
            "--lr", "3e-3", "--seed", "11"]) != 0:
        fail("train returned non-zero")
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    run = glob.glob(os.path.join(out, "trained_models_*"))[0]
    with open(os.path.join(run, "stats", "epochs.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    for e in epochs:
        log(f"train epoch {e['epoch']}: train loss {e['train_loss']:.5f}, test loss "
            f"{e['test_loss']:.5f}, base acc {e['base_accuracy']:.3f}%, rle acc "
            f"{e['rle_accuracy']:.3f}%, training {e['train_seconds']:.2f} s = "
            f"{e['train_windows'] / e['train_seconds']:,.0f} train windows/s, "
            f"evaluation {e['eval_seconds']:.2f} s")
    log(f"train: {n_images} images x {TRAIN_EPOCHS} epochs at -b {TB}, held out "
        f"{n_test} images; wall {wall:.2f} s, peak device memory {peak:.0f} MiB")
    last = epochs[-1]
    if len(epochs) != TRAIN_EPOCHS:
        fail("train ran another number of epochs")
    if not (last["base_accuracy"] > 90.0 and last["rle_accuracy"] > 90.0):
        fail("training did not reach 90% base and rle accuracy on the held-out images")
    if not last["test_loss"] < epochs[0]["test_loss"]:
        fail("the held-out loss did not fall")

    n_win = WINDOW.num_windows(IMAGE.seq_length)
    train_batches, test_batches = -(-n_images // TB), -(-n_test // TB)
    fwd = TRAIN_EPOCHS * (train_batches + test_batches) * n_win
    trained = TRAIN_EPOCHS * train_batches * n_win  # windows with a backward
    want = train_counts(fwd, trained)
    log(f"train launches {launches}, expected {want} ({TRAIN_EPOCHS} epochs x "
        f"({train_batches} train + {test_batches} test batches) x {n_win} windows; "
        f"the backward: 2 layers per training window, each pass counted, pass 1 as the "
        f"projection, the hp product, the recurrence and (decoder) the dx pass, never "
        f"bwd_rec_kernel; pass 2 as the split kernel and the slice sum)")
    if launches != want:
        fail("train launch counts differ from batches x windows x layers")
    for name in (*BWD_PASSES, *BWD_SMEM_KERNELS, *WGRAD_KERNELS):
        results[name]["launches"] = launches[name]
    for name in ("bigru_window_in1", "bigru_window_in2", *SMEM_KERNELS):
        results[name]["launches_train"] = launches[name]

    for m in mods:
        m.reset_launch_counts()
    tout = os.path.join(work, "test_out")
    latest = os.path.join(run, "models", "HELEN_latest_checkpoint.npz")
    if cli(["test", "--test_image_dir", test_dir, "-m", latest, "-b", str(TB),
            "-o", tout]) != 0:
        fail("test returned non-zero")
    with open(os.path.join(tout, "test_stats.json")) as f:
        stats = json.load(f)
    same = (stats["loss"] == last["test_loss"]
            and stats["base_confusion_matrix"] == last["base_confusion_matrix"]
            and stats["rle_confusion_matrix"] == last["rle_confusion_matrix"])
    tl = counts()
    log(f"test of the latest checkpoint: loss {stats['loss']!r} (last epoch "
        f"{last['test_loss']!r}), both confusion matrices equal: {same}; "
        f"launches {tl}")
    if not same:
        fail("test did not reproduce the last epoch's loss and confusion matrices")
    if tl != train_counts(test_batches * n_win, 0):
        fail("test launch counts differ from batches x windows")


# ---------------------------------------------------------------------------
# phase 9: the wide models (H > 512) through the xp-stream kernels K3/K4
# ---------------------------------------------------------------------------

def project(x, layer):
    """The xp route's input projections ``x @ W_ih + b_ih`` per direction."""
    return tuple(x @ layer[d]["w_ih"] + layer[d]["b_ih"] for d in ("fwd", "bwd"))


def in_turns(run, iters: int = 5) -> tuple:
    """``run(design)`` timed in turns, grid, chain, chain, grid: (the grid
    design's ms, the chain design's ms, the four turns)."""
    turns = [cuda_ms(lambda: run(d), iters=iters, warmup=1)
             for d in ("grid", "chain", "chain", "grid")]
    return (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2, turns


def xp_cost(bsz: int, stream_bytes: int, w_bytes: int, h: int = WH) -> tuple:
    """(FLOP, bytes) of one K3/K3f launch at batch ``bsz``, T=100, hidden
    size ``h``: the step products of both directions; xp in
    (``stream_bytes`` per element), out written, W_hh and b_hh read, h0 in,
    hn out."""
    return (2.0 * T * bsz * 3 * h * h * 2,
            2 * stream_bytes * T * bsz * 3 * h + 2 * 4 * T * bsz * h
            + 2 * (w_bytes * h * 3 * h + 4 * 3 * h) + 4 * 4 * bsz * h)


def proj_cost(bsz: int, d: int, in_bytes: int, h: int = WH) -> tuple:
    """(FLOP, bytes) of one projection launch at batch ``bsz``, T=100,
    input width ``d``: both directions' products; x read once
    (``in_bytes`` per element), W_ih and b_ih read once, xp written."""
    m = T * bsz
    return (2.0 * m * d * 6 * h,
            in_bytes * m * d + 4 * (d * 6 * h + 6 * h) + 4 * m * 6 * h)


def check_xp_proj(images_u8, results) -> None:
    """Phase 9f: the xp route's projection (ops.gru_window_proj) at H=1024,
    T=100, B=512 and the wide train's B=64, for both layer kinds (the uint8
    image window, D=90; the decoder's pair of halves, D=2048): its largest
    error against a float64 product beside torch.matmul's (TF32 off), two
    launches bit for bit, and its time beside its bound (FLOP at 3xTF32's
    165 TFLOP/s against bytes at 3.35 TB/s), the plain version's (the
    route's expression: the input's cat or cast, two matmuls, two bias
    adds) and torch.matmul + add on the input as it is made (library)."""
    import numpy as np
    import torch

    from helen_tpu_torch.ops import gru_window_proj as gp
    from helen_tpu_torch.ops.gru_window_bwd import window_input

    dev = images_u8.device
    rng = np.random.default_rng(20261019)
    start = 450
    entry = {"name": "bigru_window_xp_proj", "route": "cuda",
             "source": "helen_tpu_torch/ops/csrc/gru_window_proj.cu (proj_kernel)",
             "replaces": "no Pallas body: helen_tpu leaves it to XLA's dot "
                         "(helen_tpu/ops/gru_pallas.py bigru_apply_fused)"}
    halves = [torch.from_numpy(rng.uniform(-1, 1, (T, B, WH)).astype("float32")).to(dev)
              for _ in range(2)]
    for bsz in (B, WB_TRAIN):
        for label, d, src, st in (("image", F, images_u8[:bsz], start),
                                  ("pair", 2 * WH, tuple(x[:, :bsz].contiguous()
                                                         for x in halves), 0)):
            layer = random_layer(rng, d, WH, dev)
            with torch.no_grad():
                got = gp.bigru_window_xp_proj(src, st, T, layer)
                again = gp.bigru_window_xp_proj(src, st, T, layer)
                x = window_input(src, st, T, torch.float32)
                want = [x.double() @ layer[k]["w_ih"].double() + layer[k]["b_ih"].double()
                        for k in ("fwd", "bwd")]
                mm = [x @ layer[k]["w_ih"] + layer[k]["b_ih"] for k in ("fwd", "bwd")]
                torch.cuda.synchronize()
                err = max(float((g.double() - w).abs().max()) for g, w in zip(got, want))
                err_mm = max(float((g.double() - w).abs().max()) for g, w in zip(mm, want))
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"the projection ({label}, B={bsz}): two launches differ")
                if not err <= 4 * err_mm:
                    fail(f"the projection ({label}, B={bsz}): error {err!r} against float64, "
                         f"over 4x torch.matmul's {err_mm!r}")
                ms = cuda_ms(lambda: gp.bigru_window_xp_proj(src, st, T, layer), iters=10)
                plain_ms = cuda_ms(lambda: gp.bigru_window_xp_proj_plain(src, st, T, layer),
                                   iters=10)
                lib_ms = cuda_ms(lambda: [x @ layer[k]["w_ih"] + layer[k]["b_ih"]
                                          for k in ("fwd", "bwd")], iters=10)
            flops, nbytes = proj_cost(bsz, d, 1 if label == "image" else 4)
            bound_ms, bound_by = bound(flops, nbytes, PEAK_3XTF32)
            log(f"projection bigru_window_xp_proj ({label}, D={d}, B={bsz}): max |kernel - "
                f"float64| {err:.3g} (torch.matmul fp32 {err_mm:.3g}); {ms:.4f} ms = "
                f"{flops / ms / 1e9:.1f} TFLOP/s, bound {bound_ms:.4f} ms ({bound_by}: "
                f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); plain {plain_ms:.4f} ms, "
                f"torch.matmul + add {lib_ms:.4f} ms")
            key = f"{label}_b{bsz}"
            entry.update({f"ms_{key}": ms, f"bound_ms_{key}": bound_ms,
                          f"bound_by_{key}": bound_by, f"plain_ms_{key}": plain_ms,
                          f"library_ms_{key}": lib_ms, f"max_abs_err_{key}": err,
                          f"matmul_err_{key}": err_mm})
    entry.update({"ms": entry[f"ms_pair_b{B}"], "kernel_ms": entry[f"ms_pair_b{B}"],
                  "bound_ms": entry[f"bound_ms_pair_b{B}"],
                  "plain_ms": entry[f"plain_ms_pair_b{B}"],
                  "library_ms": entry[f"library_ms_pair_b{B}"],
                  "per": f"one launch, both directions, at T=100, H={WH} (ms, bound_ms, plain_ms, "
                         f"library_ms: the decoder's pair at B={B}; *_image_b*, *_pair_b*: each "
                         "layer kind and batch)"})
    results["bigru_window_xp_proj"] = entry


def ptxas_report(kernel: str) -> dict:
    """ptxas's report for each instance of the ``__global__`` function
    ``kernel`` in the kernel library's build log: {"kernel<8,3>": "N regs, S
    B spilled"}."""
    from helen_tpu_torch.obs.grid_variants import ptxas_summary
    from helen_tpu_torch.ops import library

    with open(library.build_kernels() + ".log") as f:
        entries = ptxas_summary(f.read()).split("; ")
    return dict(e.split(": ", 1) for e in entries if e.startswith(kernel + "<"))


def check_xp_kernel(images_u8, results) -> None:
    """Phase 9a: K3 at B=512, T=100, H=1024 for both layer kinds (xp from
    the uint8 image window, D=90; from the pair of K3's outputs, D=2048). In
    its main-path design (the grid recurrence with W_hh spread over the SMs'
    shared memory) against its plain version (TOL) and against the
    one-launch xp_window_kernel (exactly 0.0 in out and hn), bit-identity
    of two launches; both designs timed in turns (grid, chain, chain, grid)
    beside the plain version, the projection GEMMs and cuDNN's GRU forward
    at the same (D, H); then both designs in turns at the wide train's
    B=64 (the decoder layer). Logs the thread tile at each batch and ptxas's
    registers and spills for each instance of the kernel."""
    import numpy as np
    import torch

    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_grid as xg
    from helen_tpu_torch.ops.library import card_limits

    dev = images_u8.device
    design, units = gx.xp_fwd_design(WH, B), xg.grid_units(WH, *card_limits())
    log(f"K3 at H={WH}, B={B}: design {design!r} ({units} units per block, "
        f"{2 * -(-WH // (units or 1))} blocks, {xg.grid_smem_bytes(WH, units or 1)} bytes of "
        f"shared memory each; card: (SMs, opt-in bytes) {card_limits()})")
    if design != "grid":
        fail(f"K3 at H={WH}, B={B} does not take the grid design")
    tiles = {b: xg.grid_tile(b) for b in (B, WB_TRAIN)}
    log("K3's thread tiles: " + "; ".join(
        f"B={b}: {r} rows x {xg.XG_UPT} units x 3 gates a thread, "
        f"{xg.grid_threads(b, r)} threads" for b, r in tiles.items()))
    ptxas = ptxas_report("xp_grid_kernel")
    log("ptxas: " + "; ".join(f"{k}: {v}" for k, v in sorted(ptxas.items())))
    rng = np.random.default_rng(20261018)
    h0 = [torch.from_numpy(rng.uniform(-0.5, 0.5, (B, WH)).astype("float32")).to(dev)
          for _ in range(4)]
    start = 450
    x0 = images_u8[:, start:start + T].to(torch.float32).transpose(0, 1).contiguous()
    acc = {k: 0.0 for k in ("ms", "chain_ms", "plain_ms", "library_ms", "projection_ms",
                            "err")}
    flops, nbytes = xp_cost(B, 4, 4)
    bound_ms, bound_by = bound(flops, nbytes)
    x, hf, hb = x0, h0[0], h0[1]
    layers, ms_by, chain_by = [], {}, {}
    for label, D in (("layer 0, image D=90", F), ("decoder, pair D=2048", 2 * WH)):
        layer = random_layer(rng, D, WH, dev)
        layers.append(layer)
        with torch.no_grad():
            xp_f, xp_b = project(x, layer)
            got = gx.bigru_window_xp(xp_f, xp_b, hf, hb, layer)
            again = gx.bigru_window_xp(xp_f, xp_b, hf, hb, layer)
            chain = gx.bigru_window_xp(xp_f, xp_b, hf, hb, layer, design="chain")
            want = gx.bigru_window_xp_plain(xp_f, xp_b, hf, hb, layer)
            torch.cuda.synchronize()
            err, apart = max_err(got, want), max_err(got, chain)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"K3 ({label}): two launches differ")
            if not all(torch.equal(a, b) for a, b in zip(got, chain)):
                fail(f"K3 ({label}): the grid design differs from xp_window_kernel by {apart!r}")
            ms, chain_ms, turns = in_turns(
                lambda d: gx.bigru_window_xp(xp_f, xp_b, hf, hb, layer, design=d))
            plain_ms = cuda_ms(lambda: gx.bigru_window_xp_plain(xp_f, xp_b, hf, hb, layer),
                               iters=2, warmup=1)
            proj_ms = cuda_ms(lambda: project(x, layer), iters=5, warmup=1)
            gru = cudnn_gru(layer, D, WH, dev)
            hx = torch.stack([hf, hb])
            lib_ms = cuda_ms(lambda: gru(x, hx), iters=5, warmup=1)
        log(f"K3 bigru_window_xp ({label}): max |kernel - plain| {err:.3g} (limit {TOL:g}); "
            f"max |grid - xp_window_kernel| {apart!r} (limit 0.0); grid {ms:.4f} ms, "
            f"xp_window_kernel {chain_ms:.4f} ms (in turns: "
            + ", ".join(f"{t:.4f}" for t in turns) + f"; {chain_ms / ms:.2f}x), plain "
            f"{plain_ms:.3f} ms, projection GEMMs {proj_ms:.4f} ms, cuDNN GRU forward "
            f"{lib_ms:.4f} ms (TF32 off), bound {bound_ms:.4f} ms ({bound_by}: "
            f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
        if not err <= TOL:
            fail(f"K3 ({label}) disagrees with its plain version")
        for k, v in (("ms", ms), ("chain_ms", chain_ms), ("plain_ms", plain_ms),
                     ("library_ms", lib_ms), ("projection_ms", proj_ms)):
            acc[k] += v / 2
        ms_by[D], chain_by[D] = ms, chain_ms
        acc["err"] = max(acc["err"], err)
        # the decoder reads layer 0's outputs, as on the main path
        x, hf, hb = torch.cat([got[0], got[1]], -1), h0[2], h0[3]
    # the wide train's batch: the decoder layer at B=64
    xs, hs = x[:, :WB_TRAIN].contiguous(), [h[:WB_TRAIN].contiguous() for h in (hf, hb)]
    with torch.no_grad():
        xp_f, xp_b = project(xs, layer)
        small = [gx.bigru_window_xp(xp_f, xp_b, *hs, layer, design=d) for d in ("grid", "chain")]
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(*small)):
            fail(f"K3 at B={WB_TRAIN}: the grid design differs from xp_window_kernel")
        ms64, chain64, turns = in_turns(
            lambda d: gx.bigru_window_xp(xp_f, xp_b, *hs, layer, design=d))
        plain64 = cuda_ms(lambda: gx.bigru_window_xp_plain(xp_f, xp_b, *hs, layer), iters=2,
                          warmup=1)
        # cuDNN's GRU forward of each layer at B=64, projection included
        lib64 = {}
        for lay, D, xin in ((layers[0], F, x0), (layer, 2 * WH, x)):
            gru = cudnn_gru(lay, D, WH, dev)
            xin64, hx = xin[:, :WB_TRAIN].contiguous(), torch.stack(hs)
            lib64[D] = cuda_ms(lambda: gru(xin64, hx), iters=5, warmup=1)
    bound64, by64 = bound(*xp_cost(WB_TRAIN, 4, 4))
    log(f"K3 at B={WB_TRAIN} (decoder layer): grid {ms64:.4f} ms, xp_window_kernel "
        f"{chain64:.4f} ms (in turns: " + ", ".join(f"{t:.4f}" for t in turns)
        + f"; {chain64 / ms64:.2f}x), 0.0 apart; plain {plain64:.3f} ms, cuDNN GRU forward "
        f"{lib64[F]:.4f} ms (D=90) / {lib64[2 * WH]:.4f} ms (D=2048); bound {bound64:.4f} ms "
        f"({by64})")
    results["bigru_window_xp"] = {
        "name": "bigru_window_xp", "route": "cuda",
        "source": "helen_tpu_torch/ops/csrc/gru_window_xp_grid.cu (xp_grid_kernel), design "
                  "'grid' (ran here); helen_tpu_torch/ops/csrc/gru_window_xp.cu "
                  "(xp_window_kernel), design 'chain', where W_hh does not fit the SMs",
        "replaces": "helen_tpu/ops/gru_pallas.py:231 (_kernel); "
                    "helen_tpu/ops/gru_pallas_train.py:119 (_fwd_kernel)",
        "max_abs_err": acc["err"], "ms": acc["ms"], "kernel_ms": acc["ms"],
        "chain_ms": acc["chain_ms"], "plain_ms": acc["plain_ms"], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": acc["library_ms"],
        "projection_ms": acc["projection_ms"], "design": design, "units": units,
        "ms_b64": ms64, "chain_ms_b64": chain64, "bound_ms_b64": bound64,
        "plain_ms_b64": plain64, "library_ms_b64_d90": lib64[F],
        "library_ms_b64_d2048": lib64[2 * WH], "tile_rows": tiles[B],
        "tile_rows_b64": tiles[WB_TRAIN], "ptxas": ptxas,
        "ms_d90": ms_by[F], "ms_d2048": ms_by[2 * WH], "chain_ms_d90": chain_by[F],
        "chain_ms_d2048": chain_by[2 * WH],
        "per": "one launch at B=512, T=100, H=1024 (mean of layer 0, D=90, and the "
               "decoder, D=2048; ms: the grid design; chain_ms: xp_window_kernel in the same "
               "call; library: cuDNN's GRU forward of the layer, projection included; *_b64: "
               "the decoder layer at B=64, library_ms_b64_d90: cuDNN at layer 0's D=90)",
    }


def check_xp_backward(results) -> None:
    """Phase 9b: K4 at B=64, T=100, H=1024, the decoder layer of a training
    window. In its main-path design (pass 1 as the gate pass
    bigru_window_bwd_hp plus the grid recurrence with W_hh spread over the
    SMs' shared memory) against its plain version (TOL) and against the
    one-launch xp_bwd_rec_kernel (exactly 0.0 in dxp, dh0, dW_hh, db_hh and
    pass 1's dhp_n), bit-identity of two launches; pass 1 in both designs
    timed in turns (grid, chain, chain, grid), the gate pass and the
    recurrence each beside its plain version and its bound, the whole of
    pass 1 beside cuDNN's GRU backward at D=2048, pass 2 beside cuBLAS's
    products (the port calls neither)."""
    import numpy as np
    import torch

    from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
    from helen_tpu_torch.ops import gru_window_wgrad as gwg
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg
    from helen_tpu_torch.ops import library
    from helen_tpu_torch.ops.gru_window_bwd_smem import h_prev_of

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261019)
    r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype("float32")).to(dev)  # noqa: E731
    Bw, D, n = WB_TRAIN, 2 * WH, WB_TRAIN * T
    design = gxb.xp_bwd_design(WH, Bw)
    units = gg.grid_units(WH, *library.card_limits())
    rpt = gg.grid_tile(Bw)
    log(f"K4 pass 1 at H={WH}, B={Bw}: design {design!r} ({units} units per block, "
        f"{2 * -(-WH // (units or 1))} blocks, {gg.grid_smem_bytes(WH, units or 1)} bytes of "
        f"shared memory each; card: (SMs, opt-in bytes) {library.card_limits()}); the carry "
        f"product's tile {rpt} rows x 2 units a thread, {gg.BG_UG * gg.BG_RG} threads")
    ptxas = ptxas_report("xp_bwd_rec_grid_kernel")
    log("ptxas: " + "; ".join(f"{k}: {v}" for k, v in sorted(ptxas.items())))
    if design != "grid":
        fail(f"K4 pass 1 at H={WH}, B={Bw} does not take the grid design")
    layer = random_layer(rng, D, WH, dev)
    x = r(T, Bw, D)
    h0f, h0b, dhf, dhb = (r(Bw, WH) for _ in range(4))
    dof, dob = r(T, Bw, WH), r(T, Bw, WH)
    with torch.no_grad():
        xp_f, xp_b = project(x, layer)
        of, ob, _, _ = gx.bigru_window_xp(xp_f, xp_b, h0f, h0b, layer)
    args = (xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer)
    got = gxb.bigru_window_xp_bwd(*args)
    again = gxb.bigru_window_xp_bwd(*args)
    chain = gxb.bigru_window_xp_bwd(*args, design="chain")
    rec_new = gxb.bigru_window_xp_bwd_rec(*args, design="grid")
    rec_old = gxb.bigru_window_xp_bwd_rec(*args, design="chain")
    want = gxb.bigru_window_xp_bwd_plain(*args)
    torch.cuda.synchronize()
    flat = lambda res: [("dxp_f", res[0]), ("dxp_b", res[1]), ("dh0_f", res[2]),  # noqa: E731
                        ("dh0_b", res[3])] + [(f"{d}.{k}", res[4][d][k])
                                              for d in ("fwd", "bwd")
                                              for k in ("w_hh", "b_hh")]
    worst = worst_scaled = 0.0
    for (what, g), (_, w), (_, a), (_, c) in zip(flat(got), flat(want), flat(again),
                                                 flat(chain)):
        err = float((g - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        worst, worst_scaled = max(worst, err), max(worst_scaled, err / scale)
        log(f"K4 backward: {what}: max |kernel - plain| {err:.3g} (limit {TOL:g} x "
            f"{scale:.4g}); max |grid design - one-launch| {float((g - c).abs().max())!r} "
            "(limit 0.0)")
        if err > TOL * scale:
            fail(f"K4: {what} disagrees with its plain version")
        if not torch.equal(g, a):
            fail(f"K4: {what} differs between two launches")
        if not torch.equal(g, c):
            fail(f"K4: {what} differs between pass 1's two designs")
    for what, a, b in zip(("dxp", "dhp_n", "dh0_f", "dh0_b"), rec_new, rec_old):
        if not torch.equal(a, b):
            fail(f"K4: pass 1's {what} differs between the designs")
    log("K4 backward: two launches bit-identical; pass 1's dxp, dhp_n, dh0 and dW_hh, db_hh "
        "equal in both designs")

    # pass 1 in turns: grid design (the gate pass and the recurrence), one-launch,
    # one-launch, grid; pass 2 beside the grid design
    grid_names = ("bigru_window_bwd_hp", "bigru_window_xp_bwd_rec_grid")
    turns = []
    for d in ("grid", "chain", "chain", "grid"):
        if d == "grid":
            turns.append(timed_passes(lambda: gxb.bigru_window_xp_bwd(*args), iters=5,
                                      warmup=1, passes=(*grid_names, *WGRAD_XP)))
        else:
            turns.append(timed_passes(lambda: gxb.bigru_window_xp_bwd_rec(
                *args, design="chain"), iters=3, warmup=1, passes=(XP_PASSES[0],)))
    kern = {k: (turns[0][k] + turns[3][k]) / 2 for k in turns[0]}
    rec_ms = sum(kern[k] for k in grid_names)
    chain_ms = (turns[1][XP_PASSES[0]] + turns[2][XP_PASSES[0]]) / 2
    log(f"K4 pass 1 at B={Bw}: grid design {rec_ms:.4f} ms (gate pass {kern[grid_names[0]]:.4f}, "
        f"recurrence {kern[grid_names[1]]:.4f}), one-launch {chain_ms:.4f} ms (in turns: "
        + ", ".join(f"{sum(t[k] for k in grid_names):.4f}" if i in (0, 3)
                    else f"{t[XP_PASSES[0]]:.4f}" for i, t in enumerate(turns))
        + f"): {chain_ms / rec_ms:.2f}x")
    ms = {XP_PASSES[0]: rec_ms, XP_PASSES[1]: sum(kern[k] for k in WGRAD_XP)}
    dxp, dhpn, *_ = gxb.bigru_window_xp_bwd_rec_plain(*args)
    plain = {
        XP_PASSES[0]: cuda_ms(lambda: gxb.bigru_window_xp_bwd_rec_plain(*args),
                              iters=2, warmup=1),
        XP_PASSES[1]: cuda_ms(lambda: gxb.bigru_window_xp_bwd_wgrad_plain(
            h0f, h0b, of, ob, dxp, dhpn), iters=3, warmup=1),
    }
    gru = cudnn_gru(layer, D, WH, dev)
    xg = x.clone().requires_grad_(True)
    hx = torch.stack([h0f, h0b]).requires_grad_(True)
    dout_cat, dh_cat = torch.cat([dof, dob], -1), torch.stack([dhf, dhb])

    def fwd_bwd():
        out, hn = gru(xg, hx)
        torch.autograd.backward([out, hn], [dout_cat, dh_cat])

    cudnn_ms = cuda_ms(fwd_bwd, iters=5, warmup=1) - cuda_ms(lambda: gru(xg, hx), iters=5,
                                                             warmup=1)
    ones = torch.ones(n, 1, device=dev)
    prods = []
    for i, (out, h0, rev) in enumerate(((of, h0f, False), (ob, h0b, True))):
        g_x = dxp[i].reshape(n, 3 * WH)
        g_h = torch.cat([g_x[:, :2 * WH], dhpn[i].reshape(n, WH)], 1)
        prods.append((torch.cat([h_prev_of(out, h0, rev).reshape(n, WH), ones], 1), g_h))
    cublas_ms = cuda_ms(lambda: [a.T @ b for a, b in prods], iters=5, warmup=1)
    library = {XP_PASSES[0]: cudnn_ms, XP_PASSES[1]: cublas_ms}
    stream, stream3, vec = 4 * n * WH, 4 * n * 3 * WH, 4 * Bw * WH
    w_bytes = 2 * 4 * (WH * 3 * WH + 3 * WH)
    cost = {
        XP_PASSES[0]: (2 * 2 * 2.0 * n * 3 * WH * WH,              # gates + carry, 2 dirs
                       2 * (stream3 + 2 * stream) + 4 * vec + w_bytes   # xp, out, dout, h0, dh
                       + 2 * (stream3 + stream) + 2 * vec),             # dxp, dhp_n, dh0
        XP_PASSES[1]: (2 * 2.0 * n * (WH + 1) * 3 * WH,
                       2 * stream + 2 * vec + 2 * (stream3 + stream) + w_bytes),
    }
    per = "one launch at B=64, T=100, H=1024"
    for name in XP_PASSES:
        flops, nbytes = cost[name]
        bound_ms, bound_by = bound(flops, nbytes)
        extra = f", one-launch {chain_ms:.4f} ms" if name == XP_PASSES[0] else ""
        log(f"{name} (B={Bw}, T={T}, H={WH}): kernel {ms[name]:.4f} ms{extra}, plain "
            f"{plain[name]:.3f} ms, library {library[name]:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        results[name] = {
            "name": name, "route": "cuda",
            "source": ("helen_tpu_torch/ops/csrc/gru_window_xp_bwd_grid.cu with the gate pass "
                       "bigru_window_bwd_hp (gru_window_bwd_smem.cu), design 'grid' (ran here); "
                       "helen_tpu_torch/ops/csrc/gru_window_xp_bwd.cu (xp_bwd_rec_kernel), "
                       "design 'chain', where W_hh does not fit the SMs"
                       if name == XP_PASSES[0] else
                       "helen_tpu_torch/ops/csrc/gru_window_wgrad.cu (wgrad_split_kernel, then "
                       "wgrad_sum_kernel past one slice)"),
            "replaces": "helen_tpu/ops/gru_pallas_train.py:166 (_bwd_kernel"
                        + (", pass 1)" if name == XP_PASSES[0] else ", pass 2)"),
            "max_abs_err": worst, "max_scaled_err": worst_scaled,
            "ms": ms[name], "kernel_ms": ms[name], "plain_ms": plain[name],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library[name],
            "per": per + (" (library: cuDNN's GRU backward at D=2048)"
                          if name == XP_PASSES[0] else " (library: cuBLAS's products)"),
        }
    results[XP_PASSES[0]].update(
        design=design, chain_ms=chain_ms, tile_rows=rpt, ptxas=ptxas,
        per=results[XP_PASSES[0]]["per"] + "; ms: the grid design's two kernels; chain_ms: "
        "xp_bwd_rec_kernel in the same call")
    w = wgrad_split("K4 pass 2", lambda: gwg.bigru_window_xp_wgrad(h0f, h0b, of, ob, dxp, dhpn),
                    gwg.bigru_window_xp_bwd_wgrad_plain(h0f, h0b, of, ob, dxp, dhpn), WGRAD_XP)
    flops, nbytes = cost[XP_PASSES[1]]
    bound_ms, _ = bound(flops, nbytes)
    tf32_ms, tf32_by = bound(3 * flops, nbytes, PEAK_TF32)
    log(f"K4 pass 2 (B={Bw}, H={WH}): split {w['ms']:.4f} ms (split kernel "
        f"{w['split_ms']:.4f}, slice sum {w['sum_ms']:.4f}), cuBLAS {cublas_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms at the fp32 rate, {tf32_ms:.4f} ms ({tf32_by}) at 3 x FLOP on TF32 "
        "tensor cores")
    results[XP_PASSES[1]].update(
        ms=w["ms"], kernel_ms=w["ms"], bound_tf32_ms=tf32_ms, max_scaled_err=w["scaled"],
        max_abs_err=w["err"],
        per=results[XP_PASSES[1]]["per"] + "; ms: the split design (split kernel + slice sum); "
        "bound_tf32_ms: 3 x FLOP at the dense TF32 rate")

    # each kernel of the grid design alone, against its plain version
    whh = torch.stack([layer[d]["w_hh"] for d in ("fwd", "bwd")])
    hprev = torch.stack([h_prev_of(of, h0f, False), h_prev_of(ob, h0b, True)]).reshape(2, n, WH)
    hp = gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, layer)
    rest = (h0f, h0b, of, ob, dof, dob, dhf, dhb, layer)
    kernels = {
        "bigru_window_xp_bwd_hp": (
            "helen_tpu_torch/ops/csrc/gru_window_bwd_smem.cu (bigru_window_bwd_hp: the tile "
            "product of gru_window_smem.cuh)", grid_names[0],
            lambda: gbs.bigru_window_bwd_hp(h0f, h0b, of, ob, layer),
            lambda: gbs.bwd_hp_plain(h0f, h0b, of, ob, layer),
            lambda: torch.bmm(hprev, whh),
            (2 * 2.0 * n * WH * 3 * WH, 2 * stream + 2 * vec + 2 * 4 * WH * 3 * WH + 2 * stream3),
            "library: torch.bmm"),
        "bigru_window_xp_bwd_rec_grid": (
            "helen_tpu_torch/ops/csrc/gru_window_xp_bwd_grid.cu", grid_names[1],
            lambda: gxb.bigru_window_xp_bwd_rec_grid(xp_f, xp_b, hp, *rest),
            lambda: gg.xp_bwd_rec_grid_plain(xp_f, xp_b, hp, *rest),
            None,
            (2 * 2.0 * n * 3 * WH * WH,
             2 * 2 * stream3 + 4 * stream + 4 * vec + w_bytes      # xp, hp, out, dout, h0, dh, W
             + 2 * stream3 + 2 * stream + 2 * vec),               # dxp, dhp_n, dh0
            "library: none"),
    }
    for name, (source, timed, kfn, pfn, lfn, (flops, nbytes), lib_note) in kernels.items():
        out, ref = kfn(), pfn()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        refs = ref if isinstance(ref, tuple) else (ref,)
        err = max(float((o - w).abs().max()) for o, w in zip(outs, refs))
        scale = max(max(1.0, float(w.abs().max())) for w in refs)
        with torch.no_grad():
            p_ms = cuda_ms(pfn, iters=2, warmup=1)
            l_ms = cuda_ms(lfn, iters=5, warmup=1) if lfn is not None else None
        bound_ms, bound_by = bound(flops, nbytes)
        log(f"{name}: max |kernel - plain| {err:.3g} (limit {TOL:g} x {scale:.4g}); kernel "
            f"{kern[timed]:.4f} ms (timed in pass 1's turns), plain {p_ms:.3f} ms, library "
            f"{'none' if l_ms is None else f'{l_ms:.4f} ms'}, bound {bound_ms:.4f} ms "
            f"({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        if err > TOL * scale:
            fail(f"{name} disagrees with its plain version")
        results[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": "helen_tpu/ops/gru_pallas_train.py:166 (_bwd_kernel, pass 1)",
            "max_abs_err": err, "max_scaled_err": err / scale, "ms": kern[timed],
            "kernel_ms": kern[timed], "plain_ms": p_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": l_ms, "per": f"{per} ({lib_note})",
        }


def check_golden_xp() -> None:
    """Phase 9c: the three golden fixtures through the xp route, forced on
    the cuda backend, on the card: 0 + 0 label flips. Then each fixture's
    encoder layer over the first window of the images through K4, as the
    forced xp route trains it (H=128 and H=160): pass 1 takes the grid
    design, equal bit for bit to the one-launch design."""
    import numpy as np
    import torch

    from helen_tpu_torch.io.checkpoint import load_model_any, params_to_torch
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.models.transducer import consensus_labels
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    with tempfile.TemporaryDirectory(prefix="golden_xp_") as d:
        path = os.path.join(d, "golden_images.h5")
        with gzip.open(os.path.join(GOLDEN, "golden_images.h5.gz"), "rb") as src, \
                open(path, "wb") as dst:
            shutil.copyfileobj(src, dst)
        ds = MarginPolishDataset([path])
        recs = [ds.load(i) for i in range(len(ds))]
    images = torch.from_numpy(np.stack([r.image for r in recs])).cuda()
    keys = [f"{r.contig}-{r.contig_start}-{r.contig_end}-{r.chunk_id}" for r in recs]
    for name in FIXTURES:
        stem = "golden" if name == "model" else f"golden_{name}"
        params, _ = load_model_any(os.path.join(GOLDEN, f"golden_{name}.pkl"))
        before = dict(gx.launch_counts)
        with torch.no_grad():
            base, rle = consensus_labels(params_to_torch(params, images.device), images,
                                         backend="cuda", route="xp")
        ran = {k: gx.launch_counts[k] - before[k] for k in before}
        launched = ran["bigru_window_xp"]
        want = np.load(os.path.join(GOLDEN, f"{stem}_labels.npz"))
        base, rle = base.cpu().numpy(), rle.cpu().numpy()
        fb = sum(int((base[j] != want[f"base/{k}"]).sum()) for j, k in enumerate(keys))
        fr = sum(int((rle[j] != want[f"rle/{k}"]).sum()) for j, k in enumerate(keys))
        log(f"golden {name} through the xp route: {fb}+{fr} base+rle label flips of "
            f"{base.size} per head ({launched} K3 launches: {ran['bigru_window_xp_grid']} in "
            f"the grid design, {ran['bigru_window_xp_chain']} in xp_window_kernel)")
        if fb or fr or not launched:
            fail(f"golden {name}: the xp route flips labels")
        if ran["bigru_window_xp_grid"] != launched or ran["bigru_window_xp_chain"]:
            fail(f"golden {name}: K3 did not take the grid design")
        p = params_to_torch(params, images.device)
        layer = {d: p["encoder"][d] for d in ("fwd", "bwd")}
        Bg, Hg = images.shape[0], layer["fwd"]["w_hh"].shape[0]
        rng = np.random.default_rng(Hg)
        r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype("float32")).cuda()  # noqa: E731
        x = images[:, :T].to(torch.float32).transpose(0, 1).contiguous()
        with torch.no_grad():
            xp_f, xp_b = project(x, layer)
            of, ob, _, _ = gx.bigru_window_xp(xp_f, xp_b, r(Bg, Hg), r(Bg, Hg), layer)
        args = (xp_f, xp_b, r(Bg, Hg), r(Bg, Hg), of, ob, r(T, Bg, Hg), r(T, Bg, Hg),
                r(Bg, Hg), r(Bg, Hg), layer)
        design = gxb.xp_bwd_design(Hg, Bg)
        before = dict(gxb.launch_counts)
        grid = gxb.bigru_window_xp_bwd(*args)
        ran = {k: gxb.launch_counts[k] - before[k] for k in before}
        chain = gxb.bigru_window_xp_bwd(*args, design="chain")
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(grid[:4], chain[:4])) and all(
            torch.equal(grid[4][d][k], chain[4][d][k]) for d in ("fwd", "bwd")
            for k in ("w_hh", "b_hh"))
        log(f"golden {name}: encoder layer (H={Hg}, B={Bg}) through K4: design {design!r}, "
            f"launches {ran}; equal bit for bit to the one-launch design: {same}")
        if design != "grid" or ran["bigru_window_xp_bwd_rec_grid"] != 1 or not same:
            fail(f"golden {name}: K4 at H={Hg} did not take the grid design or differs from "
                 "the one-launch design")


def check_routes_h512(images_u8) -> None:
    """Phase 9d: at H=512, where both routes serve, a random-weight model on
    the full-width images through the in-projection route and the xp
    route: label flips between the two, and each route's time per window
    (in turns: inproj, xp, xp, inproj)."""
    import dataclasses

    import torch

    from helen_tpu_torch.config import MODEL, WINDOW
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import consensus_labels, init_params
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_xp as gx

    params = params_to_torch(init_params(torch.Generator().manual_seed(512),
                                         dataclasses.replace(MODEL, hidden_size=512)),
                             images_u8.device)
    n_win = len(WINDOW.starts(images_u8.shape[1]))
    labels, secs = {}, {"inproj": [], "xp": []}
    for i, route in enumerate(("inproj", "xp", "xp", "inproj")):
        gw.reset_launch_counts()
        gx.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = consensus_labels(params, images_u8, backend="cuda", route=route)
        torch.cuda.synchronize()
        secs[route].append(time.perf_counter() - t0)
        labels[route] = [o.cpu() for o in out]
        if i == 0:
            counts = {k: v for k, v in gw.launch_counts.items() if v}
            want = {"bigru_window_in1": n_win, "bigru_window_in2": n_win}
            log(f"H=512 in-projection route launches {counts}, expected {want}: "
                "bigru_window_kernel (W_hh does not fit a block's shared memory)")
            if counts != want:
                fail("the in-projection route at H=512 did not run bigru_window_kernel")
        if i == 1:
            counts = {k: v for k, v in gx.launch_counts.items() if v}
            want = {"bigru_window_xp": 2 * n_win, "bigru_window_xp_grid": 2 * n_win}
            log(f"H=512 xp route launches {counts}, expected {want}: K3 in the grid design")
            if counts != want:
                fail("the xp route at H=512 did not run K3 in the grid design")
    (ib, ir), (xb, xr) = labels["inproj"], labels["xp"]
    fb, fr = int((ib != xb).sum()), int((ir != xr).sum())
    per = {k: 1e3 * min(v) / n_win for k, v in secs.items()}
    log(f"H=512, {images_u8.shape[0]} full-width images, random weights: {fb}+{fr} "
        f"base+rle label flips of {ib.numel()} per head between the routes; per window "
        f"(B={images_u8.shape[0]}, the faster of two runs): in-projection K1/K2 "
        f"{per['inproj']:.2f} ms, xp (projection GEMMs + K3) {per['xp']:.2f} ms")
    if max(fb, fr) > FLIPS_PER_LABEL * ib.numel():
        fail("the two routes disagree at H=512")


def write_exact(path: str, name: str, n: int, seed: int) -> None:
    """A labeled synthetic image file of exactly ``n`` full-width images: the
    sequence is cut where its RLE columns give ``n`` overlapping regions."""
    from helen_tpu_torch.io.synthetic import random_sequence, rle_encode, write_image_file

    seq = random_sequence(4000 * n, seed=seed)
    _, runs = rle_encode(seq)
    seq = seq[:int(runs[:1000 + (n - 1) * 920].sum())]
    got = write_image_file(path, {name: seq}, region_cols=1000, overlap_cols=80,
                           noise=0.1, seed=seed + 1)
    if got != n:
        fail(f"wrote {got} images, wanted {n}")


def run_wide_cli(work: str, results) -> tuple:
    """Phase 9e: ``train --hidden_size 1024 -b 64`` for one epoch on 128
    labeled full-width images, ``test`` of its checkpoint, and ``polish``
    with it on 256 images at ``-b 256`` (the function behind the CLI, with a
    stage timer), each with every kernel's launches counted from 0; the
    polish labels against the plain route on the card. Returns (the
    checkpoint, the polish images, the polish output) for phase 10e."""
    import glob

    import numpy as np
    import torch

    from helen_tpu_torch.cli import main as cli
    from helen_tpu_torch.config import IMAGE, WINDOW
    from helen_tpu_torch.infer.consensus import ConsensusStep
    from helen_tpu_torch.infer.polish import polish
    from helen_tpu_torch.io.checkpoint import load_model_any
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.models.transducer import engaged_kernel
    from helen_tpu_torch.obs import StageTimer
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_proj as gp
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_wgrad as gwg
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg

    mods = (gw, gb, gx, gxb, gwg, gp)
    counts = lambda: {k: v for m in mods for k, v in m.launch_counts.items()}  # noqa: E731

    def reset():
        for m in mods:
            m.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()

    dirs = {k: os.path.join(work, f"wide_{k}") for k in ("train", "test", "polish")}
    for (k, d), (n, seed) in zip(dirs.items(), ((N_WIDE_TRAIN, 901), (WB_TRAIN, 903),
                                                 (WB_POLISH, 905))):
        os.makedirs(d)
        write_exact(os.path.join(d, f"{k}.h5"), f"wide_{k}", n, seed)
    n_win = WINDOW.num_windows(IMAGE.seq_length)
    zero_inproj = {k: 0 for m in (gw, gb) for k in m.launch_counts}
    zero_xp = {k: 0 for m in (gx, gxb, gwg, gp) for k in m.launch_counts}
    if gxb.xp_bwd_design(WH, WB_TRAIN) != "grid":
        fail(f"K4 pass 1 at H={WH}, B={WB_TRAIN} does not take the grid design")

    out = os.path.join(work, "wide_train_out")
    reset()
    t0 = time.perf_counter()
    if cli(["train", "--train_image_dir", dirs["train"], "--test_image_dir", dirs["test"],
            "-b", str(WB_TRAIN), "-e", "1", "-w", "8", "-o", out, "--hidden_size", str(WH),
            "--seed", "17"]) != 0:
        fail("wide train returned non-zero")
    wall = time.perf_counter() - t0
    launches, peak = counts(), torch.cuda.max_memory_allocated() / 2**20
    run = glob.glob(os.path.join(out, "trained_models_*"))[0]
    with open(os.path.join(run, "stats", "epochs.jsonl")) as f:
        epoch = json.loads(f.readline())
    train_b, test_b = N_WIDE_TRAIN // WB_TRAIN, 1
    trained = train_b * n_win * 2
    fwd = (train_b + test_b) * n_win * 2
    # the projection's weights split again after every Adam step (each train
    # layer-window), then once for the evaluation's weights
    want = {**zero_inproj, **zero_xp, "bigru_window_xp": fwd, "bigru_window_xp_grid": fwd,
            XP_PASSES[0]: trained, XP_PASSES[1]: trained, "bigru_window_xp_bwd_hp": trained,
            "bigru_window_xp_bwd_rec_grid": trained,
            f"bigru_window_xp_bwd_rec_grid_r{gg.grid_tile(WB_TRAIN)}": trained,
            **wgrad_counts(trained),
            "bigru_window_xp_proj": fwd, "bigru_window_xp_proj_split": trained + 2}
    log(f"wide train (H={WH}, {N_WIDE_TRAIN} images, -b {WB_TRAIN}, 1 epoch): train loss "
        f"{epoch['train_loss']:.5f}, test loss {epoch['test_loss']:.5f}, base acc "
        f"{epoch['base_accuracy']:.3f}%, training {epoch['train_seconds']:.2f} s = "
        f"{epoch['train_windows'] / epoch['train_seconds']:,.1f} train windows/s, "
        f"evaluation {epoch['eval_seconds']:.2f} s; wall {wall:.2f} s, peak device "
        f"memory {peak:.0f} MiB")
    log(f"wide train launches {launches}, expected {want} ({train_b} train + {test_b} "
        f"test batches x {n_win} windows x 2 layers; K3 in the grid design, 0 "
        "xp_window_kernel; K4 on the train batches only, pass 1 in the grid design: the gate "
        "pass and the grid recurrence, 0 xp_bwd_rec_kernel; pass 2 as the split kernel and "
        "the slice sum; the projection once a layer-window, its weights split "
        "after each Adam step and once for the evaluation)")
    if launches != want:
        fail("wide train launch counts differ from batches x windows x layers")
    for name in (*XP_PASSES, "bigru_window_xp_bwd_hp", "bigru_window_xp_bwd_rec_grid"):
        results[name]["launches"] = launches[name]
    for name in WGRAD_KERNELS:
        results[name]["launches_wide_train"] = launches[name]
    rate = epoch["train_windows"] / epoch["train_seconds"]
    results[XP_PASSES[0]]["wide_train_windows_per_s"] = rate
    results["bigru_window_xp"]["wide_train_windows_per_s"] = rate
    results["bigru_window_xp"]["launches_train"] = launches["bigru_window_xp"]
    for name in ("bigru_window_xp_proj", "bigru_window_xp_proj_split"):
        results["bigru_window_xp_proj"][f"launches_train_{name}"] = launches[name]

    latest = os.path.join(run, "models", "HELEN_latest_checkpoint.npz")
    params, _ = load_model_any(latest)
    kernels = engaged_kernel(params, "cuda")
    log(f"the checkpoint's kernels on the card: {kernels}")
    if kernels != "cuda_xp":
        fail("the wide checkpoint does not take the xp route")
    tout = os.path.join(work, "wide_test_out")
    reset()
    if cli(["test", "--test_image_dir", dirs["test"], "-m", latest, "-b", str(WB_TRAIN),
            "-o", tout]) != 0:
        fail("wide test returned non-zero")
    with open(os.path.join(tout, "test_stats.json")) as f:
        stats = json.load(f)
    same = (stats["loss"] == epoch["test_loss"]
            and stats["base_confusion_matrix"] == epoch["base_confusion_matrix"]
            and stats["rle_confusion_matrix"] == epoch["rle_confusion_matrix"])
    tl = counts()
    log(f"wide test: loss {stats['loss']!r} (the epoch's {epoch['test_loss']!r}), both "
        f"confusion matrices equal: {same}; launches {tl}")
    if not same:
        fail("wide test did not reproduce the epoch's loss and confusion matrices")
    if tl != {**zero_inproj, **zero_xp, "bigru_window_xp": test_b * n_win * 2,
              "bigru_window_xp_grid": test_b * n_win * 2,
              "bigru_window_xp_proj": test_b * n_win * 2, "bigru_window_xp_proj_split": 2}:
        fail("wide test launch counts differ from batches x windows x layers")

    pout = os.path.join(work, "wide_polish_out")
    timer = StageTimer()
    reset()
    t0 = time.perf_counter()
    polish(dirs["polish"], latest, pout, batch_size=WB_POLISH, threads=4,
           stage_timer=timer)
    wall = time.perf_counter() - t0
    pl, peak = counts(), torch.cuda.max_memory_allocated() / 2**20
    consensus_s = timer.stages["call_consensus"]
    log(f"wide polish ({WB_POLISH} images at -b {WB_POLISH}): wall {wall:.2f} s, consensus "
        f"{consensus_s:.2f} s = {WB_POLISH * n_win / consensus_s:,.1f} windows/s, peak "
        f"device memory {peak:.0f} MiB; launches {pl}")
    if pl != {**zero_inproj, **zero_xp, "bigru_window_xp": n_win * 2,
              "bigru_window_xp_grid": n_win * 2, "bigru_window_xp_proj": n_win * 2,
              "bigru_window_xp_proj_split": 2}:
        fail("wide polish launch counts differ from batches x windows x layers")
    results["bigru_window_xp"]["launches"] = pl["bigru_window_xp"]
    results["bigru_window_xp_proj"]["launches"] = pl["bigru_window_xp_proj"]
    results["bigru_window_xp_proj"]["launches_split"] = pl["bigru_window_xp_proj_split"]
    results["bigru_window_xp"]["wide_polish_windows_per_s"] = WB_POLISH * n_win / consensus_s

    ds = MarginPolishDataset(glob.glob(os.path.join(dirs["polish"], "*.h5")))
    recs = [ds.load(i) for i in range(len(ds))]
    base, rle = ConsensusStep(params, torch.device("cuda"), backend="torch")(
        np.stack([r.image for r in recs]))
    got = store_labels(glob.glob(os.path.join(pout, "predictions_*"))[0])
    fb = fr = 0
    for j, r in enumerate(recs):
        kb, kr = got[f"{r.contig}-{r.contig_start}-{r.contig_end}-{r.chunk_id}"]
        fb += int((kb != base[j]).sum())
        fr += int((kr != rle[j]).sum())
    log(f"wide polish, K3 vs the plain route (--backend torch) on the card: {fb}+{fr} "
        f"base+rle label flips of {base.size} per head")
    if max(fb, fr) > FLIPS_PER_LABEL * base.size:
        fail("the wide polish labels disagree with the plain route")
    return latest, dirs["polish"], pout


# ---------------------------------------------------------------------------
# phase 10: the fast (bf16) tier, polish --fast, through K1f, K2f and K3f
# ---------------------------------------------------------------------------

def timed_once(fn):
    """(fn(), its ms on the card): one call, for plain versions too slow to
    repeat."""
    import torch

    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def fast_entry(name: str, source: str, replaces: str, err: float, ms: float,
               plain_ms: float, lib_ms: float, flops: float, nbytes: float, per: str):
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
    log(f"{name}: max |kernel - plain| {err:.3g} (limit {FAST_TOL:g}); kernel {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, cuDNN GRU in bf16 {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}: {flops / 1e9:.1f} GFLOP at the bf16 peak, {nbytes / 1e6:.1f} MB)")
    if not err <= FAST_TOL:
        fail(f"{name} disagrees with its plain version")
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
            "library": "torch.nn.GRU in bf16 (cuDNN), timed only", "per": per}


def check_fast_inproj(images_u8, results) -> None:
    """Phase 10a: K1f on the uint8 image window and K2f on K1f's outputs at
    the flagship shapes, at B=512 (polish) and B=256. Each in the main
    path's design (the projection pass and the recurrence on bf16 tensor
    cores, gru_window_fast.cu) against its plain version (FAST_TOL) and
    against the one-launch bigru_window_kernel<FAST> (design "chain",
    FAST_TOL); both designs timed in turns (two-launch, one-launch,
    one-launch, two-launch) beside the plain version (B=512) and cuDNN's
    GRU in bf16. Then each kernel of the design alone against its plain
    version at B=512, timed beside its bound at the bf16 rate and, for the
    projections, torch.baddbmm in bf16; and each timed again at B=256."""
    import numpy as np
    import torch

    from helen_tpu_torch.io.checkpoint import fast_layer
    from helen_tpu_torch.models.gru import bf16_round
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_smem as gs

    dev = images_u8.device
    rng = np.random.default_rng(20261020)
    f1, f2 = random_layer(rng, F, H, dev), random_layer(rng, 2 * H, H, dev)
    l1, l2 = fast_layer(f1), fast_layer(f2)
    h0 = [torch.from_numpy(rng.uniform(-0.5, 0.5, (B, H)).astype("float32")).to(dev)
          for _ in range(4)]
    start = 450
    bf = torch.bfloat16
    # the library yardstick, timed and never compared: cuDNN's GRU in bf16
    # keeps a bf16 state, so it is not the same function
    g1, g2 = cudnn_gru(f1, F, H, dev, bf), cudnn_gru(f2, 2 * H, H, dev, bf)
    replaces = {"bigru_window_in1_fast": "helen_tpu/ops/gru_pallas.py:426 (_kernel_inproj1, "
                                         "fast=True)",
                "bigru_window_in2_fast": "helen_tpu/ops/gru_pallas.py:474 (_kernel_inproj2, "
                                         "fast=True)"}
    for bsz in (B, TB):
        img, hs = images_u8[:bsz], [h[:bsz] for h in h0]
        with torch.no_grad():
            k1 = gw.bigru_window_in1_fast(img, start, T, hs[0], hs[1], l1)
        xa, xb = k1[0], k1[1]  # K2f reads K1f's outputs, as on the main path
        x0 = img[:, start:start + T].to(bf).transpose(0, 1).contiguous()
        x1 = torch.cat([xa, xb], -1).to(bf)
        hx1, hx2 = torch.stack(hs[:2]).to(bf), torch.stack(hs[2:]).to(bf)
        kinds = {
            "bigru_window_in1_fast": (
                lambda d: gw.bigru_window_in1_fast(img, start, T, hs[0], hs[1], l1, design=d),
                lambda: gw.bigru_window_in1_fast_plain(img, start, T, hs[0], hs[1], l1),
                lambda: g1(x0, hx1), window_cost(bsz, F, w_bytes=2)),
            "bigru_window_in2_fast": (
                lambda d: gw.bigru_window_in2_fast(xa, xb, hs[2], hs[3], l2, design=d),
                lambda: gw.bigru_window_in2_fast_plain(xa, xb, hs[2], hs[3], l2),
                lambda: g2(x1, hx2), window_cost(bsz, 2 * H, w_bytes=2)),
        }
        for name, (run, pfn, lfn, (flops, nbytes)) in kinds.items():
            if gw.window_design(H, bsz, fast=True) != "smem":
                fail(f"{name} at B={bsz} does not take the two-launch design")
            with torch.no_grad():
                new, old = run("smem"), run("chain")
                plain, plain_ms = timed_once(pfn) if bsz == B else (None, None)
                torch.cuda.synchronize()
                apart = max_err(new, old)
                turns = [cuda_ms(lambda: run(d)) for d in ("smem", "chain", "chain", "smem")]
                lib_ms = cuda_ms(lfn)
            ms, chain_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
            scratch = 2 * scratch_bytes(bsz)
            scratch_bound_ms, _ = bound(flops, nbytes + scratch, PEAK_BF16)
            log(f"{name} at B={bsz}: max |two-launch - one-launch| {apart:.3g} (limit "
                f"{FAST_TOL:g}); two-launch {ms:.4f} ms, one-launch {chain_ms:.4f} ms (in "
                f"turns: {', '.join(f'{t:.4f}' for t in turns)}; {chain_ms / ms:.2f}x), cuDNN "
                f"GRU in bf16 {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                f"{flops / 1e9:.1f} GFLOP at the bf16 peak, {nbytes / 1e6:.1f} MB; with the "
                f"scratch written and read {scratch_bound_ms:.4f} ms)")
            if not apart <= FAST_TOL:
                fail(f"{name} at B={bsz}: the two designs differ past FAST_TOL")
            entry = {"ms": ms, "chain_ms": chain_ms, "library_ms": lib_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "scratch_bound_ms": scratch_bound_ms, "max_abs_from_chain": apart}
            if bsz == B:
                results[name] = fast_entry(
                    name, "helen_tpu_torch/ops/csrc/gru_window_fast.cu (the projection pass + "
                    "bigru_window_rec_fast, H <= 160); helen_tpu_torch/ops/csrc/gru_window.cu "
                    "(bigru_window_kernel<FAST>, otherwise)", replaces[name],
                    max_err(new, plain), ms, plain_ms, lib_ms, flops, nbytes,
                    f"one K1f/K2f at B={B}, T={T}, H={H} (ms: the two-launch design; "
                    "chain_ms: bigru_window_kernel<FAST> in the same call; library: cuDNN's "
                    "bf16 GRU of the layer; launches: layer-windows)")
                results[name].update(entry, kernel_ms=ms)
            else:
                results[name][f"b{bsz}"] = entry

    # the two-launch design's kernels alone at B=512, each against its plain version
    with torch.no_grad():
        k1 = gw.bigru_window_in1_fast(images_u8, start, T, h0[0], h0[1], l1)
    x0 = bf16_round(gs.image_window(images_u8, start, T))
    x1 = bf16_round(torch.cat([k1[0], k1[1]], dim=-1))
    stacked = lambda layer, k: torch.stack([layer[d][k] for d in ("fwd", "bwd")])  # noqa: E731
    bt, n3 = B * T, 3 * H
    projs = {
        "bigru_window_proj_in1_fast": (
            "helen_tpu/ops/gru_pallas.py:426 (_kernel_inproj1, fast=True: its input "
            "projection)", lambda: gs.bigru_window_proj_in1_fast(images_u8, start, T, l1),
            x0, l1, F, bt * F),
        "bigru_window_proj_in2_fast": (
            "helen_tpu/ops/gru_pallas.py:474 (_kernel_inproj2, fast=True: its input "
            "projection)", lambda: gs.bigru_window_proj_in2_fast(k1[0], k1[1], l2),
            x1, l2, 2 * H, 4 * bt * 2 * H),
    }
    xp2 = None
    for name, (repl, kfn, x, layer, d, x_bytes) in projs.items():
        with torch.no_grad():
            got = kfn()
            want, plain_ms = timed_once(lambda: gs.window_proj_plain(x, layer))
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = max(1.0, float(want.abs().max()))
            b_ih, w_ih = stacked(layer, "b_ih").unsqueeze(1).to(bf), stacked(layer, "w_ih")
            x2 = x.to(bf).reshape(1, bt, d).expand(2, bt, d)
            ms = cuda_ms(kfn)
            lib_ms = cuda_ms(lambda: torch.baddbmm(b_ih, x2, w_ih))
        flops = 2.0 * bt * 2 * d * n3
        nbytes = x_bytes + 2 * (2 * d * n3 + 4 * n3) + scratch_bytes(B)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
        log(f"{name}: max |kernel - plain (k in order)| {err:.3g} (limit {FAST_TOL:g} x "
            f"{scale:.4g}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, torch.baddbmm in bf16 "
            f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP "
            f"at the bf16 peak, {nbytes / 1e6:.1f} MB)")
        if not err <= FAST_TOL * scale:
            fail(f"{name} disagrees with its plain version")
        results[name] = {
            "name": name, "route": "cuda", "source": "helen_tpu_torch/ops/csrc/gru_window_fast.cu",
            "replaces": repl, "max_abs_err": err, "ms": ms, "kernel_ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
            "library": "torch.baddbmm of the bf16 rows in bf16 (cuBLAS; a bf16 result), "
                       "timed only",
            "per": f"one launch at B={B}, T={T}, H={H}, D={d}"}
        xp2 = got
    name = "bigru_window_rec_fast"
    rec = lambda: gs.bigru_window_rec_fast(xp2, h0[2], h0[3], l2)  # noqa: E731
    with torch.no_grad():
        got = rec()
        want, plain_ms = timed_once(lambda: gs.window_rec_plain(xp2, h0[2], h0[3], l2))
        torch.cuda.synchronize()
        err = max_err(got, want)
        ms = cuda_ms(rec)
    flops = 2.0 * bt * 2 * H * n3
    nbytes = (scratch_bytes(B) + 2 * (2 * H * n3 + 4 * n3) + 2 * 4 * B * H + 2 * 4 * bt * H
              + 2 * 4 * B * H)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
    rows = gs.rec_block_rows(B)
    log(f"{name}: {rows} rows per block, {2 * -(-B // rows)} blocks of {-(-H // 16) * 32} "
        f"threads, {gs.fast_rec_smem_bytes(H)} bytes of shared memory each; max |kernel - "
        f"plain| {err:.3g} (limit {FAST_TOL:g}); kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP at the bf16 peak, "
        f"{nbytes / 1e6:.1f} MB)")
    if not err <= FAST_TOL:
        fail(f"{name} disagrees with its plain version")
    results[name] = {
        "name": name, "route": "cuda", "source": "helen_tpu_torch/ops/csrc/gru_window_fast.cu",
        "replaces": "helen_tpu/ops/gru_pallas.py:426 and :474 (_kernel_inproj1/2, fast=True: "
                    "the recurrence)",
        "max_abs_err": err, "ms": ms, "kernel_ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library": "none: no one PyTorch call runs a GRU recurrence without its projection",
        "block_rows": rows, "smem_bytes": gs.fast_rec_smem_bytes(H),
        "per": f"one launch at B={B}, T={T}, H={H}"}

    # each kernel of the design again at the training batch, B=256
    bsz, bt = TB, TB * T
    img, hs = images_u8[:bsz], [h[:bsz].contiguous() for h in h0]
    with torch.no_grad():
        k1 = gw.bigru_window_in1_fast(img, start, T, hs[0], hs[1], l1)
        xp = gs.bigru_window_proj_in2_fast(k1[0], k1[1], l2)
    wb = lambda d: 2 * (2 * d * n3 + 4 * n3)  # noqa: E731  both directions' weights and bias
    parts = {
        "bigru_window_proj_in1_fast": (
            lambda: gs.bigru_window_proj_in1_fast(img, start, T, l1),
            2.0 * bt * 2 * F * n3, bt * F + wb(F) + scratch_bytes(bsz)),
        "bigru_window_proj_in2_fast": (
            lambda: gs.bigru_window_proj_in2_fast(k1[0], k1[1], l2),
            2.0 * bt * 2 * 2 * H * n3, 4 * bt * 2 * H + wb(2 * H) + scratch_bytes(bsz)),
        "bigru_window_rec_fast": (
            lambda: gs.bigru_window_rec_fast(xp, hs[2], hs[3], l2), 2.0 * bt * 2 * H * n3,
            scratch_bytes(bsz) + wb(H) + 4 * 4 * bsz * H + 2 * 4 * bt * H),
    }
    for name, (kfn, flops, nbytes) in parts.items():
        with torch.no_grad():
            ms = cuda_ms(kfn)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16)
        log(f"{name} at B={bsz}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        results[name]["b256"] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by}


def check_fast_xp(images_u8, results) -> None:
    """Phase 10b: K3f at B=512, T=100, H=1024 for both layer kinds (layer 0
    on the uint8 window, D=90; the decoder on K3f's outputs rounded to bf16,
    D=2048), each over the streams of the fast projection (a float32 GEMM of
    bf16 values, the bias, one rounding to bf16). In its main-path design
    (the grid recurrence, its step product on bf16 mma.sync) against its
    plain version in the grid's order (FAST_TOL), and the one-launch
    xp_window_kernel<FAST> against the plain version in its k order
    (FAST_TOL), their distance from each other reported, bit-identity of
    two launches; both
    designs timed in turns (grid, chain, chain, grid) beside the plain
    version, that projection and cuDNN's GRU in bf16 at the same (D, H);
    then both designs at the wide polish's B=256 (the decoder layer)."""
    import numpy as np
    import torch

    from helen_tpu_torch.io.checkpoint import fast_layer
    from helen_tpu_torch.models.gru import bf16_round
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_grid as xg
    from helen_tpu_torch.ops.library import card_limits

    dev = images_u8.device
    design, units = gx.xp_fwd_design(WH, B, fast=True), xg.grid_units(WH, *card_limits(), True)
    log(f"K3f at H={WH}, B={B}: design {design!r} ({units} units per block, "
        f"{xg.grid_smem_bytes(WH, units or 1, True)} bytes of shared memory each)")
    if design != "grid":
        fail(f"K3f at H={WH}, B={B} does not take the grid design")
    rng = np.random.default_rng(20261021)
    h0 = [torch.from_numpy(rng.uniform(-0.5, 0.5, (B, WH)).astype("float32")).to(dev)
          for _ in range(4)]
    start = 450
    x = images_u8[:, start:start + T].to(torch.float32).transpose(0, 1).contiguous()
    hf, hb = h0[0], h0[1]
    acc = {k: 0.0 for k in ("ms", "chain_ms", "plain_ms", "library_ms", "projection_ms",
                            "err", "apart", "err_chain")}
    for label, D in (("layer 0, image D=90", F), ("decoder, pair D=2048", 2 * WH)):
        f32 = random_layer(rng, D, WH, dev)
        layer = fast_layer(f32)
        proj = lambda: (gx.project_fast(x, layer["fwd"]),  # noqa: E731
                        gx.project_fast(x, layer["bwd"]))
        with torch.no_grad():
            xp_f, xp_b = proj()
            got = gx.bigru_window_xp_fast(xp_f, xp_b, hf, hb, layer)
            again = gx.bigru_window_xp_fast(xp_f, xp_b, hf, hb, layer)
            chain = gx.bigru_window_xp_fast(xp_f, xp_b, hf, hb, layer, design="chain")
            want, plain_ms = timed_once(
                lambda: gx.bigru_window_xp_fast_plain(xp_f, xp_b, hf, hb, layer))
            want_chain = gx.bigru_window_xp_fast_plain(xp_f, xp_b, hf, hb, layer,
                                                       design="chain")
            err, apart = max_err(got, want), max_err(got, chain)
            err_chain = max_err(chain, want_chain)
            if max(err, err_chain) > FAST_TOL:
                fail(f"K3f ({label}): a design differs from its plain version by "
                     f"{max(err, err_chain):.3g} (FAST_TOL {FAST_TOL:g})")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"K3f ({label}): two launches differ")
            ms, chain_ms, turns = in_turns(
                lambda d: gx.bigru_window_xp_fast(xp_f, xp_b, hf, hb, layer, design=d))
            proj_ms = cuda_ms(proj, iters=5, warmup=1)
            gru = cudnn_gru(f32, D, WH, dev, torch.bfloat16)
            xb16, hx = x.to(torch.bfloat16), torch.stack([hf, hb]).to(torch.bfloat16)
            lib_ms = cuda_ms(lambda: gru(xb16, hx), iters=5, warmup=1)
        log(f"K3f ({label}): max |grid - plain in its order| {err:.3g}, max "
            f"|xp_window_kernel<FAST> - plain in k order| {err_chain:.3g}, max |grid - "
            f"xp_window_kernel<FAST>| {apart:.3g}; grid {ms:.4f} ms, xp_window_kernel<FAST> "
            f"{chain_ms:.4f} ms (in turns: " + ", ".join(f"{t:.4f}" for t in turns)
            + f"; {chain_ms / ms:.2f}x), plain {plain_ms:.3f} ms, fast projection "
            f"{proj_ms:.4f} ms, cuDNN bf16 GRU {lib_ms:.4f} ms")
        for k, v in (("ms", ms), ("chain_ms", chain_ms), ("plain_ms", plain_ms),
                     ("library_ms", lib_ms), ("projection_ms", proj_ms)):
            acc[k] += v / 2
        acc["err"], acc["apart"] = max(acc["err"], err), max(acc["apart"], apart)
        acc["err_chain"] = max(acc["err_chain"], err_chain)
        # the decoder reads layer 0's outputs rounded to bf16, as on the main path
        x, hf, hb = bf16_round(torch.cat([got[0], got[1]], -1)), h0[2], h0[3]
    xs, hs = x[:, :WB_POLISH].contiguous(), [h[:WB_POLISH].contiguous() for h in (hf, hb)]
    with torch.no_grad():
        xp_f, xp_b = gx.project_fast(xs, layer["fwd"]), gx.project_fast(xs, layer["bwd"])
        ms256, chain256, turns = in_turns(
            lambda d: gx.bigru_window_xp_fast(xp_f, xp_b, *hs, layer, design=d))
    log(f"K3f at B={WB_POLISH} (decoder layer): grid {ms256:.4f} ms, xp_window_kernel<FAST> "
        f"{chain256:.4f} ms (in turns: " + ", ".join(f"{t:.4f}" for t in turns)
        + f"; {chain256 / ms256:.2f}x)")
    flops, nbytes = xp_cost(B, 2, 2)
    entry = fast_entry(
        "bigru_window_xp_fast",
        "helen_tpu_torch/ops/csrc/gru_window_xp_grid.cu (xp_grid_fast_kernel, bf16 mma.sync), "
        "design 'grid' (ran here); helen_tpu_torch/ops/csrc/gru_window_xp.cu "
        "(xp_window_kernel<FAST>), design 'chain', where W_hh does not fit the SMs",
        "helen_tpu/ops/gru_pallas.py:231 (_kernel, fast=True)", acc["err"], acc["ms"],
        acc["plain_ms"], acc["library_ms"], flops, nbytes,
        f"one launch at B={B}, T={T}, H={WH} (mean of layer 0, D=90, and the decoder, "
        "D=2048; ms: the grid design; chain_ms: xp_window_kernel<FAST> in the same call; "
        "library: cuDNN's bf16 GRU of the layer, projection included; *_b256: the decoder "
        "layer at B=256)")
    entry.update(projection_ms=acc["projection_ms"], chain_ms=acc["chain_ms"],
                 max_abs_from_chain=acc["apart"], chain_max_abs_err=acc["err_chain"],
                 design=design, units=units, ms_b256=ms256, chain_ms_b256=chain256)
    log(f"K3f projection (float32 GEMM of bf16 values + b_ih, one rounding): "
        f"{acc['projection_ms']:.4f} ms per layer")
    results["bigru_window_xp_fast"] = entry


def audit_fast_flips(images_u8) -> None:
    """Phase 10c: random-weight models on full-width images through the
    fast kernels, the fast plain versions (on the card) and the fp32
    kernels: the flagship (K1f/K2f) and the wide model at H=WH (the fast xp
    route, K3f). The fast kernels may flip at most FLIPS_PER_LABEL of the
    labels per head against the fast plain route. At H=WH K3f runs in its
    grid design, whose step product sums on bf16 tensor cores; its plain
    version takes that order (models.gru.mma_product; phase 10b holds each
    K3f design to its plain version's order)."""
    import dataclasses

    import torch

    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import fast_weights, params_to_torch
    from helen_tpu_torch.models.transducer import consensus_labels, engaged_kernel, init_params

    flips = lambda a, b: int((a != b).sum())  # noqa: E731
    for h, seed in ((H, 10), (WH, 12)):
        cfg = dataclasses.replace(MODEL, hidden_size=h)
        params = params_to_torch(init_params(torch.Generator().manual_seed(seed), cfg),
                                 images_u8.device)
        fast = fast_weights(params)
        with torch.no_grad():
            (kb, kr), fast_ms = timed_once(lambda: consensus_labels(fast, images_u8,
                                                                    backend="cuda_fast"))
            (pb, pr), plain_ms = timed_once(lambda: consensus_labels(fast, images_u8,
                                                                    backend="torch_fast"))
            (rb, rr), fp32_ms = timed_once(lambda: consensus_labels(params, images_u8,
                                                                    backend="cuda"))
        n = kb.numel()
        kp = (flips(kb, pb), flips(kr, pr))
        kr32, pr32 = (flips(kb, rb), flips(kr, rr)), (flips(pb, rb), flips(pr, rr))
        log(f"H={h} ({engaged_kernel(params, 'cuda_fast')}), {images_u8.shape[0]} images, "
            f"random weights: fast kernels vs fast plain route {kp[0]}+{kp[1]} base+rle "
            f"flips of {n} per head (limit FLIPS_PER_LABEL: {FLIPS_PER_LABEL * n:g}); vs the "
            f"fp32 route: fast kernels {kr32[0]}+{kr32[1]}, fast plain route "
            f"{pr32[0]}+{pr32[1]}; consensus: fast kernels {fast_ms:.1f} ms, fast plain route "
            f"{plain_ms / 1e3:.1f} s, fp32 kernels {fp32_ms:.1f} ms")
        if max(kp) > FLIPS_PER_LABEL * n:
            fail(f"the fast kernels flip labels against the fast plain route at H={h}")


def check_trained_fast(work: str, img_dir: str, fasta: str, preds: str) -> None:
    """Phase 10d: ``polish --fast`` of the trained checkpoint on phase 5's
    images through the CLI: a FASTA byte-identical to phase 5's and 0 + 0
    label flips against its prediction store (BENCH_r05's regime)."""
    fast_fasta, fast_preds = polish_cli(img_dir, os.path.join(GOLDEN, "trained_synth30mb.npz"),
                                        os.path.join(work, "out_unseen_fast"), ["--fast"])
    with open(fasta, "rb") as a, open(fast_fasta, "rb") as b:
        same = a.read() == b.read()
    want, got = store_labels(preds), store_labels(fast_preds)
    if sorted(got) != sorted(want):
        fail("polish --fast stored other images than polish")
    fb = sum(int((got[k][0] != want[k][0]).sum()) for k in want)
    fr = sum(int((got[k][1] != want[k][1]).sum()) for k in want)
    log(f"trained checkpoint, polish --fast vs polish: {fb}+{fr} base+rle label flips, "
        f"FASTA byte-identical: {same}")
    if fb or fr or not same:
        fail("polish --fast differs from polish with the trained checkpoint")


def run_fast_polish(img_dir: str, truth, n_images: int, work: str, wide_ckpt: str,
                    wide_dir: str, wide_parity_out: str, results) -> None:
    """Phase 10e: ``polish`` with ``backend="pallas_fast"`` (what ``polish
    --fast`` calls; a stage timer of its own) of phase 6's images at -b 512
    with the trained checkpoint, and of phase 9e's 256 images at -b 256 with
    its H=1024 checkpoint, every kernel's launches counted from 0: K1f/K2f
    batches x windows each on the flagship, in the two-launch design (a
    projection and a recurrence each, no bigru_window_kernel<FAST>), K3f
    windows x 2 layers on the wide model, no parity kernel. Labels against the parity runs of phases
    6 and 9e."""
    import glob

    import torch

    from helen_tpu_torch.config import IMAGE, WINDOW
    from helen_tpu_torch.infer.polish import polish
    from helen_tpu_torch.io.fasta import read_fasta
    from helen_tpu_torch.obs import StageTimer
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_wgrad as gwg
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    mods = (gw, gb, gx, gxb, gwg)
    n_win = WINDOW.num_windows(IMAGE.seq_length)

    def run(images, model, out, batch):
        timer = StageTimer()
        for m in mods:
            m.reset_launch_counts()
        t0 = time.perf_counter()
        fasta = polish(images, model, out, batch_size=batch, threads=4,
                       backend="pallas_fast", stage_timer=timer)
        wall = time.perf_counter() - t0
        counts = {k: v for m in mods for k, v in m.launch_counts.items()}
        return fasta, wall, timer, counts

    def flips_against(out, parity_out):
        got = store_labels(glob.glob(os.path.join(out, "predictions_*"))[0])
        want = store_labels(glob.glob(os.path.join(parity_out, "predictions_*"))[0])
        if sorted(got) != sorted(want):
            fail(f"{out} stored other images than {parity_out}")
        n = sum(v[0].size for v in want.values())
        return (sum(int((got[k][0] != want[k][0]).sum()) for k in want),
                sum(int((got[k][1] != want[k][1]).sum()) for k in want), n)

    zero = {k: 0 for m in mods for k in m.launch_counts}
    batches = -(-n_images // B)
    out = os.path.join(work, "out_full_fast")
    fasta, wall, timer, counts = run(img_dir, os.path.join(GOLDEN, "trained_synth30mb.npz"),
                                     out, B)
    consensus_s = timer.stages["call_consensus"]
    want = {**zero, **fast_counts(batches * n_win, batches * n_win)}
    polished = dict(read_fasta(fasta))
    exact = sum(polished.get(c) == s for c, s in truth.items())
    fb, fr, n = flips_against(out, os.path.join(work, "out_full"))
    log(f"polish --fast, flagship: {n_images} images at -b {B}: wall {wall:.2f} s, "
        f"consensus {consensus_s:.2f} s = {n_images * n_win / consensus_s:,.0f} windows/s; "
        f"{exact}/{len(truth)} contigs == truth; {fb}+{fr} base+rle flips of {n} per head "
        f"against phase 6's parity labels")
    log("stage timings:\n" + timer.report())
    log(f"launches {counts}, expected {want} ({batches} batches x {n_win} windows, "
        "K1f/K2f in the two-launch design)")
    if counts != want:
        fail("polish --fast launch counts differ from batches x windows x layers")
    if max(fb, fr) > FLIPS_PER_LABEL * n:
        fail("polish --fast labels disagree with the parity tier's")
    for name in ("bigru_window_in1_fast", "bigru_window_in2_fast", *FAST_SMEM_KERNELS):
        results[name]["launches"] = counts[name]

    out = os.path.join(work, "wide_polish_fast")
    _, wall, timer, counts = run(wide_dir, wide_ckpt, out, WB_POLISH)
    consensus_s = timer.stages["call_consensus"]
    want = {**zero, "bigru_window_xp_fast": n_win * 2, "bigru_window_xp_fast_grid": n_win * 2}
    fb, fr, n = flips_against(out, wide_parity_out)
    log(f"polish --fast, wide (H={WH}): {WB_POLISH} images at -b {WB_POLISH}: wall "
        f"{wall:.2f} s, consensus {consensus_s:.2f} s = "
        f"{WB_POLISH * n_win / consensus_s:,.1f} windows/s; {fb}+{fr} base+rle flips of "
        f"{n} per head against phase 9e's parity labels")
    log("stage timings:\n" + timer.report())
    log(f"launches {counts}, expected {want} (1 batch x {n_win} windows x 2 layers, K3f in "
        "the grid design)")
    if counts != want:
        fail("wide polish --fast launch counts differ from windows x layers")
    results["bigru_window_xp_fast"]["launches"] = counts["bigru_window_xp_fast"]
    results["bigru_window_xp_fast"]["wide_polish_windows_per_s"] = (WB_POLISH * n_win
                                                                    / consensus_s)


# ---------------------------------------------------------------------------
# phase 11: the fused encoder+decoder window (route="encdec"), K5 and K5f
# ---------------------------------------------------------------------------

def check_encdec(images_u8, results) -> None:
    """Phase 11a: K5 and K5f at the flagship shapes, B=512 and B=256, in both
    designs: the cluster design (two CTAs per group of rows, producer warps
    projecting while consumer warps run the recurrence; the default) and the
    one-pass kernel. In parity both equal K1 -> K2 in the main path's design
    (max abs diff 0.0); in the fast tier the cluster design equals K1f ->
    K2f in the two-launch design (0.0: the same sums in the same order) and
    the one-pass kernel the one-launch K1f -> K2f (0.0); each within TOL
    (FAST_TOL) of its plain version. Timed in turns (cluster, one-pass, the
    chains, two cuDNN GRU calls, then back) with each one's bound; the
    clusters the card holds at once are logged. The ptxas report
    (registers, spills) is in phase 2's build log."""
    import numpy as np
    import torch

    from helen_tpu_torch.io.checkpoint import fast_layer
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_encdec as ge
    from helen_tpu_torch.ops import gru_window_smem as gs

    dev = images_u8.device
    rng = np.random.default_rng(20261022)
    f1, f2 = random_layer(rng, F, H, dev), random_layer(rng, 2 * H, H, dev)
    h0f, h0b = (torch.from_numpy(rng.uniform(-0.5, 0.5, (B, H)).astype("float32")).to(dev)
                for _ in range(2))
    start = 450
    budget = ge.device_smem_budget()
    log(f"the card's opt-in shared memory per block: {budget} bytes")
    for fast in (False, True):
        sfx = "_fast" if fast else ""
        name, cname = "transducer_window_encdec" + sfx, "transducer_window_encdec_cluster" + sfx
        enc, dec = (fast_layer(f1), fast_layer(f2)) if fast else (f1, f2)
        kernel = getattr(ge, name)
        in1, in2 = ((gw.bigru_window_in1_fast, gw.bigru_window_in2_fast) if fast
                    else (gw.bigru_window_in1, gw.bigru_window_in2))
        wdt = torch.bfloat16 if fast else torch.float32
        g1, g2 = cudnn_gru(f1, F, H, dev, wdt), cudnn_gru(f2, 2 * H, H, dev, wdt)
        tol = FAST_TOL if fast else TOL
        w_bytes = (2 if fast else 4) * 2 * (F + H + 2 * H + H) * 3 * H + 4 * 2 * 2 * 6 * H
        onepass_rows = ge.encdec_block_rows(H, F, T, fast, budget)
        for bsz in (B, TB):
            imgs, hf, hb = images_u8[:bsz], h0f[:bsz], h0b[:bsz]
            x0 = imgs[:, start:start + T].to(wdt).transpose(0, 1).contiguous()
            hx = torch.stack([hf, hb]).to(wdt)
            rows = gs.rec_block_rows(bsz)
            clusters = -(-bsz // rows)
            active = ge.cluster_active(H, bsz, fast)
            log(f"{cname}: B={bsz}: {clusters} clusters of 2 CTAs x "
                f"{ge.cluster_threads(H, rows, fast)} threads ({rows} rows each), "
                f"{ge.cluster_smem_bytes(H, rows, fast)} bytes of shared memory per CTA; the "
                f"card holds {active} clusters at once: "
                f"{'one wave' if active >= clusters else 'more than one wave'}")
            if ge.encdec_design(H, bsz, fast) != "cluster":
                fail(f"{name}: the design rule does not pick the cluster at B={bsz}")
            runs = {
                "cluster": lambda: kernel(imgs, start, T, hf, hb, enc, dec, design="cluster"),
                "onepass": lambda: kernel(imgs, start, T, hf, hb, enc, dec, design="onepass"),
                # the chain in the main path's design (two launches per layer)
                "chain": lambda: in2(*in1(imgs, start, T, hf, hb, enc, design="smem"), dec,
                                     design="smem"),
            }
            if fast:
                runs["chain one-launch"] = lambda: in2(
                    *in1(imgs, start, T, hf, hb, enc, design="chain"), dec, design="chain")
            runs["cudnn"] = lambda: g2(*g1(x0, hx))
            with torch.no_grad():
                got = {k: f() for k, f in runs.items() if k != "cudnn"}
                diff_cluster = max_err(got["cluster"], got["chain"])
                diff_onepass = max_err(got["onepass"],
                                       got["chain one-launch" if fast else "chain"])
                if bsz == B:
                    cwant, cplain_ms = timed_once(lambda: getattr(ge, cname + "_plain")(
                        imgs, start, T, hf, hb, enc, dec))
                    want, plain_ms = timed_once(lambda: getattr(ge, name + "_plain")(
                        imgs, start, T, hf, hb, enc, dec))
                    cerr, err = max_err(got["cluster"], cwant), max_err(got["onepass"], want)
                order = list(runs) + list(reversed(runs))
                turns = {k: [] for k in runs}
                for k in order:
                    turns[k].append(cuda_ms(runs[k], iters=10, warmup=2))
            ms = {k: sum(v) / len(v) for k, v in turns.items()}
            bt = bsz * T
            flops = 2.0 * bt * 2 * 3 * H * (F + H + 2 * H + H)
            nbytes = bt * F + w_bytes + 2 * 4 * bsz * H + 2 * 4 * bt * H + 2 * 4 * bsz * H
            bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16 if fast else PEAK_FP32)
            chain = "K1f+K2f two-launch" if fast else "K1+K2"
            log(f"{name}: B={bsz}: max |cluster - {chain}| {diff_cluster:.3g} (limit 0.0), "
                f"max |one-pass - {'K1f+K2f one-launch' if fast else 'K1+K2'}| "
                f"{diff_onepass:.3g} (limit 0.0)")
            log(f"{name}: B={bsz}, in turns {order}: cluster {ms['cluster']:.4f} ms, one-pass "
                f"{ms['onepass']:.4f} ms ({onepass_rows} rows per block), chained {chain} "
                f"{ms['chain']:.4f} ms"
                + (f", chained K1f+K2f one-launch {ms['chain one-launch']:.4f} ms" if fast
                   else "")
                + f", two cuDNN GRU calls{' in bf16' if fast else ''} {ms['cudnn']:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB); turns {turns}")
            if diff_cluster != 0.0:
                fail(f"{cname} differs from the chained kernels at B={bsz}")
            if diff_onepass != 0.0:
                fail(f"{name}'s one-pass kernel differs from the chained kernels at B={bsz}")
            if bsz == B:
                log(f"{cname}: max |kernel - plain| {cerr:.3g}; the one-pass kernel "
                    f"{err:.3g} (limit {tol:g}); plain {cplain_ms:.3f} / {plain_ms:.3f} ms")
                if not (cerr <= tol and err <= tol):
                    fail(f"{name} disagrees with its plain version")
                per = f"one launch at B={B}, T={T}, H={H}, F={F}"
                lib = ("two torch.nn.GRU calls (cuDNN), encoder then decoder"
                       + (", in bf16" if fast else ""))
                results[cname] = {
                    "name": cname, "route": "cuda",
                    "source": "helen_tpu_torch/ops/csrc/"
                              + ("gru_window_fast.cu" if fast else "gru_window_smem.cu"),
                    "replaces": "helen_tpu/ops/gru_pallas.py:756 (_kernel_fused_encdec"
                                + (", fast=True)" if fast else ")"),
                    "max_abs_err": cerr, "max_abs_diff_chained": diff_cluster,
                    "ms": ms["cluster"], "kernel_ms": ms["cluster"],
                    "onepass_ms": ms["onepass"], "chained_ms": ms["chain"],
                    "plain_ms": cplain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": ms["cudnn"], "library": lib,
                    "active_clusters": active, "smem_bytes": ge.cluster_smem_bytes(H, rows, fast),
                    "per": per + f" (chained_ms: {chain} in the main path's design)",
                }
                results[name] = {
                    "name": name, "route": "cuda",
                    "source": "helen_tpu_torch/ops/csrc/gru_window_encdec.cu",
                    "replaces": "helen_tpu/ops/gru_pallas.py:756 (_kernel_fused_encdec"
                                + (", fast=True)" if fast else ")"),
                    "max_abs_err": err, "max_abs_diff_chained": diff_onepass,
                    "ms": ms["onepass"], "kernel_ms": ms["onepass"], "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": ms["cudnn"],
                    "library": lib, "block_rows": onepass_rows,
                    "smem_bytes": ge.encdec_smem_bytes(H, onepass_rows, F, T, fast),
                    "per": per + " in the one-pass design (launches: phase 11c, golden h160)",
                }
                if fast:
                    results[name]["chained_one_launch_ms"] = ms["chain one-launch"]
            else:
                results[cname].update({f"ms_b{bsz}": ms["cluster"],
                                       f"onepass_ms_b{bsz}": ms["onepass"],
                                       f"chained_ms_b{bsz}": ms["chain"],
                                       f"library_ms_b{bsz}": ms["cudnn"],
                                       f"bound_ms_b{bsz}": bound_ms})


def load_images(img_dir: str):
    """Every image of a directory, stacked on the card."""
    import numpy as np
    import torch

    from helen_tpu_torch.io.images import MarginPolishDataset

    ds = MarginPolishDataset(sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir)))
    return torch.from_numpy(np.stack([ds.load(i).image for i in range(len(ds))])).cuda()


def run_encdec_route(img_dir: str, results) -> None:
    """Phase 11b: the full-width images with the trained checkpoint through
    ``consensus_labels`` at B=512 in both tiers, on the default route and on
    ``route="encdec"`` (in turns: default, encdec, encdec, default). The
    first default run is counted from 0 (K1/K2 and K1f/K2f in their
    two-launch designs), the first encdec run too: exactly batches x 19 K5
    (K5f) launches, each one launch of the cluster kernel, and no other
    kernel. K5's labels equal the default route's; K5f's differ in at most
    FLIPS_PER_LABEL per head."""
    import torch

    from helen_tpu_torch.config import IMAGE, WINDOW
    from helen_tpu_torch.io.checkpoint import load_model_any, params_to_torch
    from helen_tpu_torch.models.transducer import consensus_labels
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_wgrad as gwg
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    t0 = time.perf_counter()
    images = load_images(img_dir)
    n = images.shape[0]
    log(f"{n} full-width images on the card in {time.perf_counter() - t0:.1f} s")
    params, _ = load_model_any(os.path.join(GOLDEN, "trained_synth30mb.npz"))
    mods = (gw, gb, gx, gxb, gwg)
    n_win = WINDOW.num_windows(IMAGE.seq_length)
    batches = -(-n // B)

    def consensus(p, backend, route):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = [consensus_labels(p, images[i:i + B], backend=backend, route=route)
                   for i in range(0, n, B)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        return [torch.cat([o[k] for o in out]) for k in (0, 1)], secs

    for backend in ("cuda", "cuda_fast"):
        name = "transducer_window_encdec" + ("_fast" if backend == "cuda_fast" else "")
        p = params_to_torch(params, images.device, fast=backend == "cuda_fast")
        secs = {"default": [], "encdec": []}
        for m in mods:
            m.reset_launch_counts()
        (db, dr), s = consensus(p, backend, None)
        secs["default"].append(s)
        counts = {k: v for m in mods for k, v in m.launch_counts.items()}
        per = batches * n_win
        want = {**{k: 0 for k in counts}, **(
            fast_counts(per, per) if backend == "cuda_fast" else parity_counts(per, per))}
        log(f"{backend} default route launches {counts}, expected {want}")
        if counts != want:
            fail(f"the {backend} default route's launch counts differ from batches x windows")
        for m in mods:
            m.reset_launch_counts()
        (kb, kr), s = consensus(p, backend, "encdec")
        counts = {k: v for m in mods for k, v in m.launch_counts.items()}
        secs["encdec"].append(s)
        secs["encdec"].append(consensus(p, backend, "encdec")[1])
        secs["default"].append(consensus(p, backend, None)[1])
        fb, fr = int((kb != db).sum()), int((kr != dr).sum())
        rate = {k: n * n_win / min(v) for k, v in secs.items()}
        cname = name.replace("encdec", "encdec_cluster")
        want = {**{k: 0 for k in counts}, name: batches * n_win, cname: batches * n_win}
        log(f"{backend}: {n} images at B={B}, route='encdec' vs the default route: {fb}+{fr} "
            f"base+rle label flips of {kb.numel()} per head; {rate['encdec']:,.0f} vs "
            f"{rate['default']:,.0f} windows/s (consensus on the card, the faster of two "
            f"runs each: encdec {secs['encdec']}, default {secs['default']} s)")
        log(f"{backend} route='encdec' launches {counts}, expected {want} ({batches} "
            f"batches x {n_win} windows)")
        if counts != want:
            fail(f"{name} launch counts differ from batches x windows")
        # parity: K5 is the chain bit for bit; fast: K5f's cluster design sums
        # as the default route's two-launch K1f -> K2f (held to the flip limit)
        limit = FLIPS_PER_LABEL * kb.numel() if backend == "cuda_fast" else 0
        if max(fb, fr) > limit:
            fail(f"route 'encdec' flips labels against the default route ({backend}; "
                 f"limit {limit:g} per head)")
        results[cname]["launches"] = counts[cname]
        results[cname]["windows_per_s"] = rate["encdec"]
        results[cname]["chained_windows_per_s"] = rate["default"]


def check_golden_encdec(results) -> None:
    """Phase 11c: the one-layer golden fixtures through ``route="encdec"`` on
    the card: the flagship (the cluster design) and H=160 (the one-pass
    kernel) at 0 + 0 label flips against the recorded labels; H=160 in the
    fast tier (K5f's one-pass kernel) at 0 + 0 against the fast route with
    K1f/K2f in their one-launch design, whose sums the one-pass kernel
    shares (the default fast route at H=160 sums on the tensor cores). The
    launches of each design are counted."""
    import numpy as np
    import torch

    from helen_tpu_torch.io.checkpoint import load_model_any, params_to_torch
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.models.transducer import consensus_labels
    from helen_tpu_torch.ops import gru_window as gw

    with tempfile.TemporaryDirectory(prefix="golden_encdec_") as d:
        path = os.path.join(d, "golden_images.h5")
        with gzip.open(os.path.join(GOLDEN, "golden_images.h5.gz"), "rb") as src, \
                open(path, "wb") as dst:
            shutil.copyfileobj(src, dst)
        ds = MarginPolishDataset([path])
        recs = [ds.load(i) for i in range(len(ds))]
    images = torch.from_numpy(np.stack([r.image for r in recs])).cuda()
    keys = [f"{r.contig}-{r.contig_start}-{r.contig_end}-{r.chunk_id}" for r in recs]
    for name, design in (("model", "cluster"), ("h160", "onepass")):
        stem = "golden" if name == "model" else f"golden_{name}"
        params, _ = load_model_any(os.path.join(GOLDEN, f"golden_{name}.pkl"))
        kernel = f"transducer_window_encdec_{design}"
        before = dict(gw.launch_counts)
        with torch.no_grad():
            base, rle = consensus_labels(params_to_torch(params, images.device), images,
                                         backend="cuda", route="encdec")
        launched = {k: gw.launch_counts[k] - before[k] for k in
                    ("transducer_window_encdec", kernel)}
        want = np.load(os.path.join(GOLDEN, f"{stem}_labels.npz"))
        base, rle = base.cpu().numpy(), rle.cpu().numpy()
        fb = sum(int((base[j] != want[f"base/{k}"]).sum()) for j, k in enumerate(keys))
        fr = sum(int((rle[j] != want[f"rle/{k}"]).sum()) for j, k in enumerate(keys))
        log(f"golden {name} through route 'encdec': {fb}+{fr} base+rle label flips of "
            f"{base.size} per head (launches {launched})")
        if fb or fr or not launched[kernel] or launched[kernel] != launched[
                "transducer_window_encdec"]:
            fail(f"golden {name}: route 'encdec' flips labels or skips its {design} design")
        if name == "h160":
            results["transducer_window_encdec"]["launches"] = launched[kernel]
            pf = params_to_torch(params, images.device, fast=True)
            before = dict(gw.launch_counts)
            rule = gw.window_design
            with torch.no_grad():
                kb, kr = consensus_labels(pf, images, backend="cuda_fast", route="encdec")
                launched = gw.launch_counts["transducer_window_encdec_onepass_fast"] - before[
                    "transducer_window_encdec_onepass_fast"]
                # the fast route with K1f/K2f held to their one-launch design
                gw.window_design = lambda h, b, fast=False, design=None: rule(
                    h, b, fast, design or ("chain" if fast else None))
                try:
                    db, dr = consensus_labels(pf, images, backend="cuda_fast")
                finally:
                    gw.window_design = rule
            fb, fr = int((kb != db).sum()), int((kr != dr).sum())
            log(f"golden h160 in the fast tier through route 'encdec' (K5f's one-pass "
                f"kernel, {launched} launches) vs the fast route in the one-launch design: "
                f"{fb}+{fr} flips of {kb.numel()} per head")
            if fb or fr or not launched:
                fail("golden h160: route 'encdec' in the fast tier flips labels")
            results["transducer_window_encdec_fast"]["launches"] = launched


# ---------------------------------------------------------------------------
# phase 12: the single-host I/O flags (--pack, --writers, --resume, --fastq)
# ---------------------------------------------------------------------------

# the host stages the I/O flags exist for, in the order of the table
IO_STAGES = ("call_consensus", "image_read", "device_transfer", "device_submit",
             "device_read", "write", "flush", "pack_tee", "stream_stitch", "stitch")


def io_polish(img_dir: str, out: str, **flags):
    """``polish`` as ``python -m helen_tpu_torch polish -b 512 -t 4`` with
    ``flags`` calls it, with a stage timer and every kernel's launches
    counted from 0; returns (output path, wall s, timer, launches)."""
    from helen_tpu_torch.infer.polish import polish
    from helen_tpu_torch.obs import StageTimer
    from helen_tpu_torch.ops import gru_window as gw

    timer = StageTimer()
    gw.reset_launch_counts()
    t0 = time.perf_counter()
    path = polish(img_dir, os.path.join(GOLDEN, "trained_synth30mb.npz"), out,
                  batch_size=B, threads=4, stage_timer=timer, **flags)
    return path, time.perf_counter() - t0, timer, dict(gw.launch_counts)


def label_flips(got, want, what: str) -> None:
    """Fail unless two {image: (bases, rles)} maps hold the same images and
    the same labels (0 flips)."""
    if sorted(got) != sorted(want):
        fail(f"{what}: other images stored ({len(got)} against {len(want)})")
    fb = sum(int((got[k][0] != want[k][0]).sum()) for k in want)
    fr = sum(int((got[k][1] != want[k][1]).sum()) for k in want)
    n = sum(v[0].size for v in want.values())
    log(f"{what}: {fb}+{fr} base+rle label flips of {n} per head")
    if fb or fr:
        fail(f"{what}: labels differ")


def run_io_flags(img_dir: str, truth, n_images: int, work: str, timer6) -> None:
    """Phase 12, on phase 6's images with the trained checkpoint at -b 512:
    12a ``polish --pack --writers 4 --fastq`` fresh (the cache built
    write-through; the FASTQ's sequences == phase 6's FASTA == truth; the
    four shards' labels == phase 6's store, 0 flips; launches = batches x 19
    x layers; mean q and the share of columns at q=60), 12b the same again
    (the cache reused: its mtime unchanged, no pack_tee stage; the stage
    table beside 12a's and phase 6's), 12c ``call_consensus`` on the first
    half of the image files then ``--resume`` over all of them (launches =
    the remaining batches x 19 x layers; the union of the stores stitches to
    phase 6's FASTA byte for byte, and ``stitch --fastq`` to its sequences),
    12d ``polish --fast --pack`` (0 flips against phase 10e's fast labels,
    the same FASTA), 12e ``train --pack``, phase 7c's command for one epoch
    (its parameters equal to phase 7c's first epoch, bit for bit). 12c and
    12e go through the CLI's main, the others through ``polish`` with a
    stage timer."""
    import glob

    import numpy as np

    from helen_tpu_torch.cli import main as cli
    from helen_tpu_torch.config import IMAGE, WINDOW
    from helen_tpu_torch.io import hdf5
    from helen_tpu_torch.io.fasta import read_fasta, read_fastq
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.ops import gru_window as gw

    n_win = WINDOW.num_windows(IMAGE.seq_length)
    batches = -(-n_images // B)
    fasta6 = os.path.join(work, "out_full", "HELEN_prediction.fa")
    labels6 = store_labels(glob.glob(os.path.join(work, "out_full", "predictions_*"))[0])
    polished6 = list(read_fasta(fasta6))
    if dict(polished6) != truth:
        fail("phase 6's FASTA is not the truth")
    out = os.path.join(work, "out_io")
    cache = os.path.join(out, "images_cache.h5")

    def check_polish(what, path, wall, timer, launches, want_launches):
        preds = sorted(glob.glob(os.path.join(out, "predictions_*")))[-1]
        shards = sorted(os.path.basename(p) for p in glob.glob(os.path.join(preds, "*.hdf")))
        want_shards = [f"helen_predictions_0_w{k}.hdf" for k in range(4)]
        if shards != want_shards:
            fail(f"{what}: shards {shards}, expected {want_shards}")
        got = [r[:2] for r in read_fastq(path)]
        log(f"{what}: {n_images} images, wall {wall:.2f} s, consensus "
            f"{timer.stages['call_consensus']:.2f} s = "
            f"{n_images * n_win / timer.stages['call_consensus']:,.0f} windows/s; "
            f"FASTQ sequences == phase 6's FASTA: {got == polished6}")
        if got != polished6:
            fail(f"{what}: the FASTQ's sequences differ from phase 6's FASTA")
        label_flips(store_labels(preds), labels6, f"{what} against phase 6's store")
        log(f"{what}: launches {launches}, expected {want_launches}")
        if launches != want_launches:
            fail(f"{what}: launch counts differ from batches x windows x layers")
        return preds

    want = {**OFF_PATH_ZERO, **parity_counts(batches * n_win, batches * n_win)}
    flags = dict(pack=True, num_writers=4, fastq=True)
    path, wall, timer_a, launches = io_polish(img_dir, out, **flags)
    if "pack_tee" not in timer_a.stages or not os.path.exists(cache):
        fail("12a: the packed cache was not built write-through")
    preds = check_polish("12a polish --pack --writers 4 --fastq", path, wall, timer_a,
                         launches, want)
    quals = []
    for shard in glob.glob(os.path.join(preds, "*.hdf")):
        with hdf5.File(shard) as f:
            for _, cg in f["predictions"].items():
                for _, rg in cg.items():
                    quals += [ch["quals"][()] for _, ch in rg.items()
                              if isinstance(ch, hdf5.Group)]
    q = np.concatenate(quals)
    log(f"12a qualities: {q.size} columns, mean q {q.mean():.2f}, at q=60 "
        f"{100 * (q == 60).mean():.2f}%, median {np.median(q):.0f}, min {q.min()}")

    stamp = os.stat(cache).st_mtime_ns
    path, wall, timer_b, launches = io_polish(img_dir, out, **flags)
    check_polish("12b the same again", path, wall, timer_b, launches, want)
    if os.stat(cache).st_mtime_ns != stamp or "pack_tee" in timer_b.stages:
        fail("12b: the packed cache was rebuilt, not reused")
    log("12b: the cache was reused (mtime unchanged, no pack_tee stage)")
    log("stage seconds (calls): phase 6 (no flags) | 12a (--pack, tee) | 12b (--pack, cached)")
    for st in IO_STAGES:
        cells = [f"{t.stages[st]:9.3f} ({t.counts[st]:3d})" if st in t.stages else " " * 15
                 for t in (timer6, timer_a, timer_b)]
        log(f"  {st:<16} " + " | ".join(cells))

    # 12c: call_consensus --resume --qualities through the CLI, after a run
    # over the first half of the image files; then stitch and stitch --fastq
    files = sorted(glob.glob(os.path.join(img_dir, "*.h5")))
    first = files[:len(files) // 2]
    half_dir = os.path.join(work, "io_half")
    os.makedirs(half_dir)
    for f in first:
        os.symlink(f, os.path.join(half_dir, os.path.basename(f)))
    m = len(MarginPolishDataset(first))
    pred_dir = os.path.join(work, "io_resume")
    args = ["-m", os.path.join(GOLDEN, "trained_synth30mb.npz"), "-o", pred_dir,
            "-b", str(B), "--qualities"]
    if cli(["call_consensus", "-i", half_dir, *args]) != 0:
        fail("12c: call_consensus on half the files returned non-zero")
    first_store = os.path.join(pred_dir, "helen_predictions_0.hdf")
    first_bytes = open(first_store, "rb").read()
    gw.reset_launch_counts()
    if cli(["call_consensus", "-i", img_dir, *args, "--resume"]) != 0:
        fail("12c: call_consensus --resume returned non-zero")
    launches = dict(gw.launch_counts)
    # the complete store is not written again: the new records go to its
    # next file
    stores = sorted(os.listdir(pred_dir))
    log(f"12c: the stores after the resume: {stores}; the first run's file unchanged: "
        f"{open(first_store, 'rb').read() == first_bytes}")
    if (stores != ["helen_predictions_0.hdf", "helen_predictions_0.r1.hdf"]
            or open(first_store, "rb").read() != first_bytes):
        fail("12c: the resume rewrote the complete store, or wrote no next file")
    remaining = batches - m // B  # batches holding an image the first run lacks
    want_c = {**OFF_PATH_ZERO, **parity_counts(remaining * n_win, remaining * n_win)}
    log(f"12c call_consensus --resume --qualities: the first run stored {m} images "
        f"({len(first)} of {len(files)} files); the resumed run's launches {launches}, "
        f"expected {want_c} ({remaining} of {batches} batches)")
    if launches != want_c:
        fail("12c: the resumed run's launches differ from the remaining batches x 19 x layers")
    out_c = os.path.join(work, "io_resume_out")
    for extra in ([], ["--fastq"]):
        if cli(["stitch", "-i", pred_dir, "-o", out_c, "-t", "4", *extra]) != 0:
            fail(f"12c: stitch {' '.join(extra)} returned non-zero")
    same = open(os.path.join(out_c, "HELEN_prediction.fa"), "rb").read() == open(
        fasta6, "rb").read()
    fq = [r[:2] for r in read_fastq(os.path.join(out_c, "HELEN_prediction.fq"))]
    log(f"12c: the union of the stores stitches to phase 6's FASTA byte for byte: {same}; "
        f"stitch --fastq's sequences are its: {fq == polished6}")
    if not same or fq != polished6:
        fail("12c: the resumed stores stitch to another FASTA or FASTQ")

    # 12d: polish --fast --pack, on 12a's cache
    stamp = os.stat(cache).st_mtime_ns
    path, wall, timer_d, launches = io_polish(img_dir, out, pack=True, backend="pallas_fast")
    want_d = {**OFF_PATH_ZERO, **fast_counts(batches * n_win, batches * n_win),
              **{k: 0 for k in parity_counts(0, 0)}}
    preds = sorted(glob.glob(os.path.join(out, "predictions_*")))[-1]
    label_flips(store_labels(preds),
                store_labels(glob.glob(os.path.join(work, "out_full_fast", "predictions_*"))[0]),
                "12d polish --fast --pack against phase 10e's fast labels")
    log(f"12d: wall {wall:.2f} s, consensus {timer_d.stages['call_consensus']:.2f} s = "
        f"{n_images * n_win / timer_d.stages['call_consensus']:,.0f} windows/s; "
        f"launches {launches}, expected {want_d}")
    if launches != want_d:
        fail("12d: launch counts differ from batches x windows x layers")
    fast_fasta = os.path.join(work, "out_full_fast", "HELEN_prediction.fa")
    if (os.stat(cache).st_mtime_ns != stamp
            or open(path, "rb").read() != open(fast_fasta, "rb").read()):
        fail("12d: the cache was rebuilt, or the FASTA is not phase 10e's")

    # 12e: train --pack through the CLI, phase 7c's command for one epoch
    from helen_tpu_torch.io.checkpoint import load_checkpoint
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_wgrad as gwg

    mods = (gw, gb, gwg)
    for mod in mods:
        mod.reset_launch_counts()
    tout = os.path.join(work, "io_train")
    t0 = time.perf_counter()
    if cli(["train", "--train_image_dir", img_dir, "--test_image_dir",
            os.path.join(work, "train_test"), "-b", str(TB), "-e", "1", "-w", "8", "-o", tout,
            "--lr", "3e-3", "--seed", "11", "--pack"]) != 0:
        fail("12e: train --pack returned non-zero")
    wall = time.perf_counter() - t0
    launches = {k: v for mod in mods for k, v in mod.launch_counts.items()}
    n_test = len(MarginPolishDataset([os.path.join(work, "train_test", "held_out.h5")]))
    train_batches = -(-n_images // TB)
    want_e = train_counts((train_batches + -(-n_test // TB)) * n_win, train_batches * n_win)
    ckpt = "HELEN_epoch_1_checkpoint.npz"
    got = load_checkpoint(glob.glob(os.path.join(tout, "trained_models_*", "models", ckpt))[0])[0]
    ref = load_checkpoint(glob.glob(os.path.join(work, "train_out", "trained_models_*",
                                                 "models", ckpt))[0])[0]

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            yield from (leaves(v, f"{prefix}{k}/") if isinstance(v, dict)
                        else [(prefix + k, np.asarray(v))])

    diff = max(float(np.abs(a[1] - b[1]).max()) for a, b in zip(leaves(got), leaves(ref)))
    with open(glob.glob(os.path.join(tout, "trained_models_*", "stats", "epochs.jsonl"))[0]) as f:
        epoch = json.loads(f.readline())
    log(f"12e train --pack: 1 epoch of {n_images} images at -b {TB} from "
        f"{os.path.join('io_train', 'train_images_cache.h5')}: wall {wall:.2f} s, training "
        f"{epoch['train_seconds']:.2f} s = {epoch['train_windows'] / epoch['train_seconds']:,.0f} "
        f"train windows/s, base acc {epoch['base_accuracy']:.3f}%; the epoch's parameters "
        f"against phase 7c's first epoch (unpacked): max abs diff {diff!r}; launches "
        f"{'as expected' if launches == want_e else launches}")
    if launches != want_e:
        fail("12e: train --pack launch counts differ from batches x windows x layers")
    if not os.path.exists(os.path.join(tout, "train_images_cache.h5")) or diff != 0.0:
        fail("12e: no training cache, or its epoch differs from the unpacked one")


# ---------------------------------------------------------------------------
# phase 14: multi-process jobs on the one card
# ---------------------------------------------------------------------------

# the job's process count, 14b's batch (the held-out images split into the
# same batches in one process and in two), 14c's global batch (it divides
# phase 6's image count: no wrap padding in the job, no masked tail in one
# process), and 14d's barrier timeout
JOB_PROCS = 2
JOB_TEST_B = 32
JOB_TRAIN_B = 258
JOB_BARRIER_S = 3.0


def job_worker(argv) -> int:
    """One process of a phase-14 job, run as ``chip_smoke.py`` with the
    port's job flags and a command line:
    ``python -m helen_tpu_torch`` with it, every kernel's launches counted
    from 0. Prints ``JOB {json}``: the process's rank, exit code, seconds,
    launches and the sha256 of its parameters after every training batch
    (``train``). ``--barrier <rank> <port>``: process 0 waits at a barrier
    of JOB_BARRIER_S its peer never reaches and prints the seconds until it
    raised."""
    import hashlib

    sys.path.insert(0, ROOT)
    import numpy as np

    from helen_tpu_torch.parallel import multihost

    if argv[0] == "--barrier":
        rank, port = int(argv[1]), argv[2]
        multihost.initialize(f"127.0.0.1:{port}", JOB_PROCS, rank)
        if rank:
            time.sleep(600)  # killed once process 0 has reported
            return 1
        t0 = time.perf_counter()
        try:
            multihost.barrier("never-met", timeout_s=JOB_BARRIER_S)
        except TimeoutError as exc:
            multihost.shutdown()
            print("JOB " + json.dumps({"rank": 0, "raised_after": time.perf_counter() - t0,
                                       "error": str(exc)[:200]}), flush=True)
            return 0
        return 1

    from helen_tpu_torch.cli import main as cli
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_wgrad as gwg
    from helen_tpu_torch.train import train_loop

    digests = []
    step = train_loop.tbptt_step

    def step_and_digest(params, *a, **k):
        out = step(params, *a, **k)
        h = hashlib.sha256()
        for leaf in train_loop.param_leaves(params):
            h.update(np.ascontiguousarray(leaf.detach().cpu().numpy()).tobytes())
        digests.append(h.hexdigest())
        return out

    train_loop.tbptt_step = step_and_digest
    mods = (gw, gb, gwg)
    for m in mods:
        m.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli(argv)
    print("JOB " + json.dumps({
        "rank": int(argv[argv.index("--process_id") + 1]), "rc": rc,
        "seconds": time.perf_counter() - t0,
        "launches": {k: v for m in mods for k, v in m.launch_counts.items()},
        "digests": digests}), flush=True)
    return rc


def run_job(argv, what: str, timeout: float = 300) -> list:
    """Run ``argv`` as JOB_PROCS processes of ``chip_smoke.py`` on the one
    card, gloo over a loopback port; returns each rank's JOB record (with
    the wall seconds this process saw). A process that fails fails the
    phase."""
    from helen_tpu_torch.parallel.multihost import free_port

    addr = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--coordinator_address", addr,
         "--num_processes", str(JOB_PROCS), "--process_id", str(r), *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(JOB_PROCS)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        fail(f"{what}: the job did not finish in {timeout:.0f} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t0
    records = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        jobs = [json.loads(line[4:]) for line in out.splitlines() if line.startswith("JOB ")]
        if p.returncode or not jobs or jobs[0]["rc"]:
            fail(f"{what}: process {r} failed (exit code {p.returncode}):\n{err[-3000:]}")
        records.append({**jobs[0], "wall": wall})
    return records


def job_records(text: str) -> list:
    return sorted((json.loads(line[4:]) for line in text.splitlines()
                   if line.startswith("JOB ")), key=lambda j: j["rank"])


def check_job_polish(records, img_dir: str, out: str, n_images: int, shards, what: str,
                     wall6: float, smi: str) -> None:
    """14a/14e: phase 6's FASTA byte for byte, 0+0 flips against its labels,
    and each rank's K1/K2 launches those of its own images' batches."""
    from helen_tpu_torch.config import IMAGE, WINDOW

    n_win = WINDOW.num_windows(IMAGE.seq_length)
    preds = [d for d in os.listdir(out) if d.startswith("predictions_")]
    if len(preds) != 1:
        fail(f"{what}: {len(preds)} predictions directories")
    files = sorted(f for f in os.listdir(os.path.join(out, preds[0])) if f.endswith(".hdf"))
    if files != [f"helen_predictions_{r}.hdf" for r in range(JOB_PROCS)]:
        fail(f"{what}: shard files {files}")
    label_flips(store_labels(os.path.join(out, preds[0])),
                store_labels(glob_one(os.path.join(os.path.dirname(out), "out_full",
                                                   "predictions_*"))),
                f"{what} against phase 6's labels")
    if not same_bytes(os.path.join(out, "HELEN_prediction.fa"),
                      os.path.join(os.path.dirname(out), "out_full", "HELEN_prediction.fa")):
        fail(f"{what}: the FASTA is not phase 6's")
    total = {}
    for rec, n in zip(records, shards):
        batches = -(-n // B)
        want = parity_counts(batches * n_win, batches * n_win)
        got = {k: v for k, v in rec["launches"].items() if v}  # every other kernel: 0
        log(f"{what}: process {rec['rank']}: {n} images, {batches} batches; launches "
            f"{'as expected' if got == want else got} (bigru_window_in1 "
            f"{got.get('bigru_window_in1')}, bigru_window_in2 {got.get('bigru_window_in2')}); "
            f"its polish {rec['seconds']:.2f} s")
        if got != want:
            fail(f"{what}: process {rec['rank']}'s launches differ from its batches x "
                 "windows x layers")
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
    if sum(shards) != n_images:
        fail(f"{what}: the shards hold {sum(shards)} of {n_images} images")
    log(f"{what}: K1/K2 launches summed over the processes {total['bigru_window_in1']} / "
        f"{total['bigru_window_in2']}; job wall {records[0]['wall']:.2f} s (startup "
        f"included) beside phase 6's polish {wall6:.2f} s ({smi})")


def glob_one(pattern: str) -> str:
    import glob

    found = glob.glob(pattern)
    if len(found) != 1:
        fail(f"{len(found)} matches of {pattern}")
    return found[0]


def run_jobs(img_dir: str, n_images: int, work: str, timer6, smi: str) -> None:
    """Phase 14, two processes on the one card (gloo over a loopback port;
    NCCL refuses two ranks on one device), each running the flagship's
    kernels in its own CUDA context:
    14a ``polish`` with default flags on phase 6's images under
    ``--host_shard image`` and ``file``: phase 6's FASTA byte for byte, 0+0
    flips against its labels, each rank's K1/K2 launches its images'
    batches x 19 x layers;
    14b ``test`` of phase 7c's latest checkpoint on its held-out images at
    -b JOB_TEST_B against one process at the same batch (each process's
    block is whole batches of the one-process run): the confusion matrices
    exactly (and phase 7c's), the loss within 1e-5;
    14c ``train`` one epoch, phase 7c's command at -b JOB_TRAIN_B (2064 /
    258 = 8 batches: the job's wrap padding and one process's masked tail
    train other rows than each other where the batch does not divide the
    images, in helen_tpu too) against one process: within rtol 2e-4 / atol
    2e-5, the two processes bit for bit after every batch;
    14d a barrier its peer never reaches raises within its timeout;
    14e 14a's image shards through the local launcher, devices
    ["cuda:0", "cuda:0"].
    Each job's wall is printed beside phase 6's; readings, not a metric."""
    import numpy as np

    from helen_tpu_torch.cli import main as cli
    from helen_tpu_torch.io.checkpoint import load_checkpoint
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.parallel import multihost

    model = os.path.join(GOLDEN, "trained_synth30mb.npz")
    wall6 = timer6.stages["call_consensus"] + timer6.stages.get("stitch", 0.0)
    files = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
    counts = {f: len(MarginPolishDataset([f])) for f in files}
    image_shards = [len(multihost.host_image_shard(n_images, r, JOB_PROCS))
                    for r in range(JOB_PROCS)]
    file_shards = [sum(counts[f] for f in multihost.host_file_shard(files, r, JOB_PROCS))
                   for r in range(JOB_PROCS)]
    for mode, shards in (("image", image_shards), ("file", file_shards)):
        out = os.path.join(work, f"job_polish_{mode}")
        records = run_job(["polish", "-i", img_dir, "-m", model, "-o", out,
                           "--host_shard", mode], f"14a --host_shard {mode}")
        check_job_polish(records, img_dir, out, n_images, shards,
                         f"14a --host_shard {mode}", wall6, smi)

    # 14b
    run7 = glob_one(os.path.join(work, "train_out", "trained_models_*"))
    latest = os.path.join(run7, "models", "HELEN_latest_checkpoint.npz")
    held_out = os.path.join(work, "train_test")
    with open(os.path.join(run7, "stats", "epochs.jsonl")) as f:
        last7 = [json.loads(line) for line in f][-1]
    one_out, two_out = os.path.join(work, "job_test_one"), os.path.join(work, "job_test_two")
    if cli(["test", "--test_image_dir", held_out, "-m", latest, "-b", str(JOB_TEST_B),
            "-o", one_out]) != 0:
        fail("14b: the one-process test returned non-zero")
    records = run_job(["test", "--test_image_dir", held_out, "-m", latest, "-b",
                       str(JOB_TEST_B), "-o", two_out], "14b test")
    one, two = (json.load(open(os.path.join(d, "test_stats.json"))) for d in (one_out, two_out))
    same = all(two[k] == one[k] == last7[k]
               for k in ("base_confusion_matrix", "rle_confusion_matrix"))
    rel = abs(two["loss"] - one["loss"]) / abs(one["loss"])
    log(f"14b test on {JOB_PROCS} processes at -b {JOB_TEST_B}: loss {two['loss']!r}, one "
        f"process {one['loss']!r} (relative difference {rel:.3g}); both confusion matrices "
        f"equal to one process's and phase 7c's last epoch's: {same}; job wall "
        f"{records[0]['wall']:.2f} s")
    if not same or rel > 1e-5:
        fail("14b: the job's confusion matrices or loss differ from one process's")

    # 14c
    args = ["train", "--train_image_dir", img_dir, "--test_image_dir", held_out, "-b",
            str(JOB_TRAIN_B), "-e", "1", "-w", "8", "--lr", "3e-3", "--seed", "11"]
    one_out, two_out = os.path.join(work, "job_train_one"), os.path.join(work, "job_train_two")
    t0 = time.perf_counter()
    if cli([*args, "-o", one_out]) != 0:
        fail("14c: the one-process train returned non-zero")
    wall_one = time.perf_counter() - t0
    records = run_job([*args, "-o", two_out], "14c train")
    ckpt = os.path.join("models", "HELEN_epoch_1_checkpoint.npz")
    got, want = (load_checkpoint(os.path.join(glob_one(os.path.join(d, "trained_models_*")),
                                              ckpt))[0] for d in (two_out, one_out))

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            yield from (leaves(v, f"{prefix}{k}/") if isinstance(v, dict)
                        else [(prefix + k, np.asarray(v))])

    diff, close = 0.0, True
    for (k, a), (_, b) in zip(leaves(got), leaves(want)):
        diff = max(diff, float(np.abs(a - b).max()))
        close &= bool(np.allclose(a, b, rtol=2e-4, atol=2e-5))
    batches = -(-n_images // JOB_TRAIN_B)
    alike = (records[0]["digests"] == records[1]["digests"]
             and len(records[0]["digests"]) == batches)
    log(f"14c train 1 epoch on {JOB_PROCS} processes at -b {JOB_TRAIN_B} ({batches} batches): "
        f"parameters against one process: max abs diff {diff!r}, within rtol 2e-4 / atol "
        f"2e-5: {close}; the processes' parameters equal bit for bit after each of "
        f"{len(records[0]['digests'])} batches: {alike}; job wall {records[0]['wall']:.2f} s "
        f"(its train {records[0]['seconds']:.2f} s), one process {wall_one:.2f} s")
    if not (close and alike):
        fail("14c: the job's parameters are not within tolerance of one process's, or the "
             "processes differ")

    # 14d
    port = str(multihost.free_port())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--barrier", str(r),
                               port], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(JOB_PROCS)]
    try:
        out, err = procs[0].communicate(timeout=120)
    except subprocess.TimeoutExpired:
        fail("14d: process 0 hung at a barrier its peer never reaches")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.communicate()
    rec = job_records(out)
    if procs[0].returncode or not rec:
        fail(f"14d: the barrier did not raise:\n{err[-2000:]}")
    log(f"14d barrier {JOB_BARRIER_S:g} s, peer absent: raised after "
        f"{rec[0]['raised_after']:.2f} s ({rec[0]['error']})")
    if not JOB_BARRIER_S <= rec[0]["raised_after"] < 10 * JOB_BARRIER_S:
        fail("14d: the barrier did not raise within its timeout")

    # 14e
    out = os.path.join(work, "job_polish_launcher")
    hook = os.path.join(work, "job_hook")
    os.makedirs(hook, exist_ok=True)
    with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
        f.write(JOB_HOOK)
    env_path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([hook, ROOT] + ([env_path] if env_path
                                                                       else [])))
    launcher = ("import sys\nfrom helen_tpu_torch.parallel.multihost import launch_local\n"
                f"sys.exit(launch_local(sys.argv[1:], ['cuda:0'] * {JOB_PROCS}, "
                "timeout_s=300))")
    t0 = time.perf_counter()
    try:
        done = subprocess.run([sys.executable, "-c", launcher, "polish", "-i", img_dir, "-m",
                               model, "-o", out], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, timeout=360)
    except subprocess.TimeoutExpired:
        fail("14e: the local launcher's job did not finish in 360 s")
    wall = time.perf_counter() - t0
    records = job_records(done.stdout)
    if done.returncode or len(records) != JOB_PROCS:
        fail(f"14e: the local launcher's job failed (exit code {done.returncode}):\n"
             f"{done.stderr[-3000:]}")
    check_job_polish([{**r, "wall": wall} for r in records], img_dir, out, n_images,
                     image_shards, "14e the local launcher", wall6, smi)


# 14e's workers are the launcher's own (python -m helen_tpu_torch); this
# sitecustomize, on their PYTHONPATH only, makes each print its JOB record
# (rank, seconds from its start, launches) at exit, in one write to the
# shared pipe. A sitecustomize it shadows still runs.
JOB_HOOK = """import atexit, importlib.machinery, importlib.util, json, os, sys, time

_here, _t0 = os.path.dirname(os.path.abspath(__file__)), time.perf_counter()
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))


def _report():
    import multiprocessing

    # the worker itself, not the launcher or a pool process it started
    if "--process_id" not in sys.argv or multiprocessing.parent_process() is not None:
        return
    counts = {}
    for name in ("gru_window", "gru_window_bwd", "gru_window_wgrad"):
        mod = sys.modules.get("helen_tpu_torch.ops." + name)
        counts.update(mod.launch_counts if mod else {})
    rank = int(sys.argv[sys.argv.index("--process_id") + 1])
    line = json.dumps({"rank": rank, "rc": 0, "seconds": time.perf_counter() - _t0,
                       "launches": counts})
    os.write(1, ("JOB " + line + "\\n").encode())


atexit.register(_report)
"""


# ---------------------------------------------------------------------------
# phase 13: the HDF5 inputs helen_tpu reads through h5py
# ---------------------------------------------------------------------------

# the golden images written again by h5py (tests/torch_hdf5_variants/
# make_variants.py): the earliest format chunked under shuffle+gzip
# (fletcher32 on position, contig a variable-length string),
# libver="latest" (a dense images/ group, the same datasets), and the
# earliest format after a 512-byte user block under shuffle+lzf
VARIANT_DIR = os.path.join(ROOT, "tests", "torch_hdf5_variants")
VARIANTS = ("images_v1_chunked.h5", "images_latest.h5", "images_ub512_lzf.h5")


def cli_timed(argv, module: str):
    """Run ``python -m helen_tpu_torch <argv>`` (its main, in this process);
    returns the stage timer the command made in ``module`` (the name of its
    polish or call_consensus module), which reports the stages it logs."""
    import importlib

    from helen_tpu_torch.cli import main

    module = importlib.import_module(module)
    made = []
    real = module.StageTimer

    class Recorded(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    module.StageTimer = Recorded
    try:
        if main(list(argv)) != 0:
            fail(f"{' '.join(argv[:1])} of {argv[2]} returned non-zero")
    finally:
        module.StageTimer = real
    if not made:
        fail(f"{argv[0]} made no stage timer")
    return made[0]


def check_hdf5_variants(work: str) -> None:
    """Phase 13: ``polish`` of phase 4's contiguous golden file and of each
    variant through the CLI with the flagship golden checkpoint (H=128) on
    the default parity route, then ``call_consensus --pack`` over the
    chunked variant and ``stitch`` of its store: each FASTA byte for byte
    the golden one, 0+0 label flips against golden_labels.npz, launches one
    batch x 19 windows of K1 and K2. Each run's ``image_read`` seconds per
    image is a smoke reading (11 images), not a rate."""
    from helen_tpu_torch.config import IMAGE, WINDOW
    from helen_tpu_torch.ops import gru_window as gw

    model = os.path.join(GOLDEN, "golden_model.pkl")
    fasta_want = os.path.join(GOLDEN, "golden.fa")
    n_win = WINDOW.num_windows(IMAGE.seq_length)
    want = {**OFF_PATH_ZERO, **parity_counts(n_win, n_win)}  # 11 images: one batch
    n_images = 11

    def verify(what, fasta, preds, timer, launches):
        flips_b, flips_r, n = golden_label_flips(preds)
        same = same_bytes(fasta, fasta_want)
        read = timer.stages.get("image_read", 0.0)
        log(f"{what}: {flips_b}+{flips_r} base+rle label flips of {n} per head, FASTA "
            f"byte-identical: {same}; image_read {read:.4f} s = "
            f"{1e3 * read / n_images:.3f} ms per image; launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if flips_b or flips_r or not same:
            fail(f"{what}: not the golden labels and FASTA")
        if launches != want:
            fail(f"{what}: launches differ from {want}")
        return read

    reads = {}
    for name in ("golden_images.h5",) + VARIANTS:
        src = (os.path.join(work, "golden_images", name) if name == "golden_images.h5"
               else os.path.join(VARIANT_DIR, name))
        img_dir = os.path.join(work, "h5_" + name[:-3])
        os.makedirs(img_dir)
        shutil.copy(src, img_dir)
        out = os.path.join(work, "out_h5_" + name[:-3])
        gw.reset_launch_counts()
        timer = cli_timed(["polish", "-i", img_dir, "-m", model, "-o", out, "-t", "2"],
                          "helen_tpu_torch.infer.polish")
        preds = [d for d in os.listdir(out) if d.startswith("predictions_")][0]
        what = "13 polish of " + ("phase 4's contiguous file" if name == "golden_images.h5"
                                  else name)
        reads[name] = verify(what, os.path.join(out, "HELEN_prediction.fa"),
                             os.path.join(out, preds), timer, dict(gw.launch_counts))

    # call_consensus --pack over the chunked variant, then stitch its store
    img_dir = os.path.join(work, "h5_images_v1_chunked")
    out = os.path.join(work, "out_h5_pack")
    gw.reset_launch_counts()
    timer = cli_timed(["call_consensus", "-i", img_dir, "-m", model, "-o", out, "--pack"],
                      "helen_tpu_torch.infer.consensus")
    launches = dict(gw.launch_counts)
    if "pack_tee" not in timer.stages or not os.path.exists(
            os.path.join(out, "images_cache.h5")):
        fail("13 call_consensus --pack: the cache was not built write-through")
    from helen_tpu_torch.cli import main as cli

    if cli(["stitch", "-i", out, "-o", os.path.join(out, "fasta"), "-t", "2"]) != 0:
        fail("13 stitch of the --pack store returned non-zero")
    reads["--pack"] = verify("13 call_consensus --pack of images_v1_chunked.h5, then stitch",
                             os.path.join(out, "fasta", "HELEN_prediction.fa"), out,
                             timer, launches)
    base = reads["golden_images.h5"]
    log("13 image_read per image (ms), 11 images: " + "; ".join(
        f"{k} {1e3 * v / n_images:.3f} ({v / base:.2f}x contiguous)" if base else
        f"{k} {1e3 * v / n_images:.3f}" for k, v in reads.items()))


# ---------------------------------------------------------------------------
# phase 15: the xp route past H=1024 (the chain designs at 8, 4, 2 or 1 rows
# per block), hyperband, test --debug_mismatches, train --model_parallel,
# convert, download_models and assess
# ---------------------------------------------------------------------------

# 15a: the widths past 1024, the batch and window of the kernel checks, the
# H=1056 polish's images and the other paths' images
C3_WIDTHS = (1056, 1152, 2048)
C3_B, C3_POLISH, C3_FEW = 64, 64, 16
# 15b/15d: labeled full-width images made as phase 6's, hyperband's batch,
# the model-parallel epoch's batch
HB_IMAGES, HB_BATCH, MP_BATCH = 256, 256, 128
# the chain designs' kernels: (wrapper's counter, source's kernel, replaces)
K3_REPLACES = ("helen_tpu/ops/gru_pallas.py:231 (_kernel); "
               "helen_tpu/ops/gru_pallas_train.py:119 (_fwd_kernel)")
CHAIN_KERNELS = {
    "bigru_window_xp": ("xp_window_kernel<false, R>", K3_REPLACES),
    "bigru_window_xp_fast": ("xp_window_kernel<true, R>",
                             "helen_tpu/ops/gru_pallas.py:231 (_kernel, fast=True)"),
    "bigru_window_xp_bwd_rec": ("xp_bwd_rec_kernel<R>",
                                "helen_tpu/ops/gru_pallas_train.py:166 (_bwd_kernel)"),
}


def xp_bwd_cost(bsz: int, h: int) -> tuple:
    """(FLOP, bytes) of one K4 pass 1 at batch ``bsz``, T=100, hidden size
    ``h`` (phase 9b's count): the gate recompute and the carry product of
    both directions; xp, out, dout, h0, dh and the weights in, dxp, dhp_n
    and dh0 out."""
    n = bsz * T
    stream, stream3, vec = 4 * n * h, 4 * n * 3 * h, 4 * bsz * h
    w_bytes = 2 * 4 * (h * 3 * h + 3 * h)
    return (2 * 2 * 2.0 * n * 3 * h * h,
            2 * (stream3 + 2 * stream) + 4 * vec + w_bytes + 2 * (stream3 + stream) + 2 * vec)


def chain_record(entries: dict, kernel: str, rows: int, h: int, err: float, ms: float,
                 plain_ms: float, lib_ms: float, cost: tuple, peak: float, per: str) -> None:
    """Enter one width's numbers under the chain kernel at ``rows`` rows per
    block; the first width it ran at gives the entry's headline numbers."""
    name = f"{kernel}_chain_r{rows}"
    bound_ms, bound_by = bound(*cost, peak)
    width = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": lib_ms}
    if name not in entries:
        src, replaces = CHAIN_KERNELS[kernel]
        file = "gru_window_xp_bwd.cu" if kernel.endswith("bwd_rec") else "gru_window_xp.cu"
        entries[name] = {
            "name": name, "route": "cuda",
            "source": f"helen_tpu_torch/ops/csrc/{file} ({src.replace('R', str(rows))})",
            "replaces": replaces, "launches": 0, **width, "rows_per_block": rows,
            "per": f"one launch at B={C3_B}, T={T}, H={h}; {per}", "widths": {}}
    e = entries[name]
    e["widths"][str(h)] = width
    e["max_abs_err"] = max(e["max_abs_err"], err)


def check_wide_kernels(results) -> dict:
    """Phase 15a, the kernels: K3, K3f and K4 (pass 1, then pass 2) at H =
    1056, 1152 and 2048, B=64, T=100, each in the design the rule picks
    (ops.gru_window_xp.xp_fwd_design, gru_window_xp_bwd.xp_bwd_design;
    the chain at gx.chain_rows / gxb.bwd_chain_rows rows per block) against
    its plain version: K3 within TOL, K3f bit for bit against its plain
    version in the order of the design that ran, K4 within TOL x the largest
    output magnitude; each timed beside its plain version, its bound and
    cuDNN's GRU at the same shape (forward in fp32, in bf16, backward).
    Returns the chain designs' entries by rows per block, their launches
    still 0 (the paths of 15a set them)."""
    import numpy as np
    import torch

    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb
    from helen_tpu_torch.ops import gru_window_xp_grid as xg
    from helen_tpu_torch.ops.library import card_limits

    dev = torch.device("cuda")
    sms, budget = card_limits()
    entries = {}
    flat = lambda res: list(res[:4]) + [res[4][d][k] for d in ("fwd", "bwd")  # noqa: E731
                                        for k in ("w_hh", "b_hh")]
    for h in C3_WIDTHS:
        rng = np.random.default_rng(h)
        r = lambda *s: torch.from_numpy(rng.uniform(-1, 1, s).astype("float32")).to(dev)  # noqa: E731
        layer = random_layer(rng, 2 * h, h, dev)
        x, h0f, h0b = r(T, C3_B, 2 * h), r(C3_B, h), r(C3_B, h)
        hx = torch.stack([h0f, h0b])
        d3, d3f, d4 = (gx.xp_fwd_design(h, C3_B), gx.xp_fwd_design(h, C3_B, fast=True),
                       gxb.xp_bwd_design(h, C3_B))
        rows3, rows3f, rows4 = (gx.chain_rows(h, budget), gx.chain_rows(h, budget, True),
                                gxb.bwd_chain_rows(h, budget))
        log(f"H={h}, B={C3_B}: K3 {d3!r}" + (f" at {rows3} rows per block" if d3 == "chain"
                                             else "")
            + f", K3f {d3f!r}" + (f" at {rows3f} rows" if d3f == "chain" else
                                  f" ({xg.grid_units(h, sms, budget, True)} units per block, "
                                  f"{xg.grid_smem_bytes(h, xg.grid_units(h, sms, budget, True), True)} "
                                  "bytes)")
            + f", K4 pass 1 {d4!r}" + (f" at {rows4} rows" if d4 == "chain" else "")
            + f" (card: {sms} SMs, {budget} bytes of opt-in shared memory per block)")
        with torch.no_grad():
            xp_f, xp_b = project(x, layer)
            got = gx.bigru_window_xp(xp_f, xp_b, h0f, h0b, layer)
            want, plain3 = timed_once(lambda: gx.bigru_window_xp_plain(xp_f, xp_b, h0f, h0b,
                                                                       layer))
            e3 = max_err(got, want)
            ms3 = cuda_ms(lambda: gx.bigru_window_xp(xp_f, xp_b, h0f, h0b, layer), iters=3,
                          warmup=1)
            gru = cudnn_gru(layer, 2 * h, h, dev)
            lib3 = cuda_ms(lambda: gru(x, hx), iters=3, warmup=1)
            fl = {d: {"w_hh": layer[d]["w_hh"].to(torch.bfloat16), "b_hh": layer[d]["b_hh"]}
                  for d in layer}
            bf, bb = xp_f.to(torch.bfloat16), xp_b.to(torch.bfloat16)
            fgot = gx.bigru_window_xp_fast(bf, bb, h0f, h0b, fl)
            fwant, plain3f = timed_once(lambda: gx.bigru_window_xp_fast_plain(bf, bb, h0f, h0b,
                                                                              fl))
            e3f = max_err(fgot, fwant)
            ms3f = cuda_ms(lambda: gx.bigru_window_xp_fast(bf, bb, h0f, h0b, fl), iters=3,
                           warmup=1)
            gru16 = cudnn_gru(layer, 2 * h, h, dev, dtype=torch.bfloat16)
            x16, hx16 = x.to(torch.bfloat16), hx.to(torch.bfloat16)
            lib3f = cuda_ms(lambda: gru16(x16, hx16), iters=3, warmup=1)
        of, ob = got[0].contiguous(), got[1].contiguous()
        dof, dob, dhf, dhb = r(T, C3_B, h), r(T, C3_B, h), r(C3_B, h), r(C3_B, h)
        args = (xp_f, xp_b, h0f, h0b, of, ob, dof, dob, dhf, dhb, layer)
        g4 = gxb.bigru_window_xp_bwd(*args)
        w4, plain4 = timed_once(lambda: gxb.bigru_window_xp_bwd_plain(*args))
        e4 = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                 for a, b in zip(flat(g4), flat(w4)))
        ms4 = cuda_ms(lambda: gxb.bigru_window_xp_bwd_rec(*args), iters=3, warmup=1)
        plain4_rec = timed_once(lambda: gxb.bigru_window_xp_bwd_rec_plain(*args))[1]
        xq = x.clone().requires_grad_(True)
        hq = hx.clone().requires_grad_(True)
        dcat, dh = torch.cat([dof, dob], -1), torch.stack([dhf, dhb])

        def fwd_bwd():
            out, hn = gru(xq, hq)
            torch.autograd.backward([out, hn], [dcat, dh])

        lib4 = cuda_ms(fwd_bwd, iters=3, warmup=1) - cuda_ms(lambda: gru(xq, hq), iters=3,
                                                               warmup=1)
        log(f"H={h}: K3 max |kernel - plain| {e3:.3g} (limit {TOL:g}), {ms3:.3f} ms (plain "
            f"{plain3:.1f}, cuDNN GRU forward {lib3:.3f}); K3f {e3f!r} against its plain "
            f"version in the {d3f} design's order (limit 0.0), {ms3f:.3f} ms (plain "
            f"{plain3f:.1f}, cuDNN bf16 {lib3f:.3f}); K4 pass 1 + pass 2 max scaled "
            f"|kernel - plain| {e4:.3g} (limit {TOL:g}), pass 1 {ms4:.3f} ms (plain "
            f"{plain4_rec:.1f}; pass 1 + 2 plain {plain4:.1f}), cuDNN GRU backward "
            f"{lib4:.3f} ms")
        if not e3 <= TOL:
            fail(f"K3 at H={h} disagrees with its plain version")
        if e3f != 0.0:
            fail(f"K3f at H={h} differs from its plain version in its design's order")
        if not e4 <= TOL:
            fail(f"K4 at H={h} disagrees with its plain version")
        per3 = "library: cuDNN's GRU forward at D=2H, projection included"
        if d3 == "chain":
            chain_record(entries, "bigru_window_xp", rows3, h, e3, ms3, plain3, lib3,
                         xp_cost(C3_B, 4, 4, h), PEAK_FP32, per3)
        if d3f == "chain":
            chain_record(entries, "bigru_window_xp_fast", rows3f, h, e3f, ms3f, plain3f, lib3f,
                         xp_cost(C3_B, 2, 2, h), PEAK_BF16,
                         "bound at the bf16 peak; library: cuDNN's GRU in bf16")
        else:
            bms, bby = bound(*xp_cost(C3_B, 2, 2, h), PEAK_BF16)
            if "bigru_window_xp_fast" in results:
                results["bigru_window_xp_fast"][f"h{h}"] = {
                    "design": "grid", "ms": ms3f, "plain_ms": plain3f, "max_abs_err": e3f,
                    "bound_ms": bms, "bound_by": bby, "library_ms": lib3f, "batch": C3_B}
            log(f"K3f's grid design at H={h}, B={C3_B}: {ms3f:.4f} ms, bound {bms:.4f} ms "
                f"({bby})")
        if d4 == "chain":
            chain_record(entries, "bigru_window_xp_bwd_rec", rows4, h, e4, ms4, plain4_rec,
                         lib4, xp_bwd_cost(C3_B, h), PEAK_FP32,
                         "pass 1 alone; max_abs_err: pass 1 + pass 2, scaled; library: "
                         "cuDNN's GRU backward (both passes' work) at D=2H")
        del layer, x, xp_f, xp_b, got, want, fgot, fwant, g4, w4, gru, gru16
        torch.cuda.empty_cache()
    return entries


def wide_checkpoint(work: str, h: int) -> str:
    """A random flagship-geometry checkpoint at hidden size ``h`` (one
    bi-GRU layer each in encoder and decoder), from a seed."""
    import dataclasses

    import torch

    from helen_tpu_torch.config import MODEL
    from helen_tpu_torch.io.checkpoint import save_checkpoint
    from helen_tpu_torch.models.transducer import init_params

    path = os.path.join(work, f"h{h}.npz")
    if not os.path.exists(path):
        save_checkpoint(path, init_params(torch.Generator().manual_seed(h),
                                          dataclasses.replace(MODEL, hidden_size=h)),
                        meta={"epochs": 0})
    return path


def tbptt_pair(params0, images, yb, yr, label: str, mods, want_cuda: dict) -> None:
    """One TBPTT batch through the kernels and through the plain route on
    the card from the same params (phase 7b's bars), the kernels' launches
    counted from 0 against ``want_cuda``."""
    import torch

    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import param_leaves
    from helen_tpu_torch.train.train_loop import Adam, tbptt_step

    runs = {}
    for backend in ("cuda", "torch"):
        p = params_to_torch(params0, images.device)
        for t in param_leaves(p):
            t.requires_grad_(True)
        adam = Adam(0.0)
        state = adam.init(p)
        for m in mods:
            m.reset_launch_counts()
        t0 = time.perf_counter()
        sums = [float(v) for v in tbptt_step(p, adam, state, 1e-4, images, yb, yr,
                                             images.shape[0], backend)]
        torch.cuda.synchronize()
        launches = {k: v for m in mods for k, v in m.launch_counts.items()}
        log(f"{label} via {backend}: loss sums {sums} in {time.perf_counter() - t0:.2f} s; "
            f"launches { {k: v for k, v in launches.items() if v} }")
        want = ({**dict.fromkeys(launches, 0), **want_cuda} if backend == "cuda"
                else dict.fromkeys(launches, 0))
        if launches != want:
            fail(f"{label} via {backend} launched other kernels than {want}")
        runs[backend] = (sums, [t.detach() for t in param_leaves(p)])
    (ks, kp), (ps, pp) = runs["cuda"], runs["torch"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ks, ps))
    perr = max(float((a - b).abs().max()) for a, b in zip(kp, pp))
    log(f"{label}, kernels vs plain: loss sums rel diff {rel:.3g} (limit 1e-5), params max "
        f"abs diff {perr:.3g} (limit 2e-5)")
    if rel > 1e-5 or perr > 2e-5:
        fail(f"{label}: the kernel path disagrees with the plain path")


def run_wide_paths(work: str, entries: dict, results) -> None:
    """Phase 15a, the paths, each with the launches counted from 0 just
    before it: ``polish`` with default flags of 64 images with an H=1056
    checkpoint (engaged kernel ``cuda_xp``, K3 in the chain design at 8
    rows; exactly batches x 19 x layers launches; at most 1 flip per
    10,000 labels per head against ``--backend torch`` on the card); one
    TBPTT batch at H=1056, B=64 (K3 and K4 pass 1 chains at 8 rows) against
    the plain route; ``polish --fast`` of 16 images at H=1152 (K3f's chain
    at 8 rows) and H=2048 (at 4 rows); one TBPTT batch of one window at
    H=2048, B=32 (K4 pass 1 at 4 rows) against the plain route."""
    import torch

    from helen_tpu_torch.config import IMAGE, WINDOW
    from helen_tpu_torch.io.checkpoint import load_model_any
    from helen_tpu_torch.models.transducer import engaged_kernel, resolve_backend
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_proj as gp
    from helen_tpu_torch.ops import gru_window_wgrad as gwg
    from helen_tpu_torch.ops import gru_window_xp as gx
    from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

    mods = (gw, gb, gwg, gx, gxb, gp)
    n_win = WINDOW.num_windows(IMAGE.seq_length)
    img_dir = os.path.join(work, "c3_images")
    os.makedirs(img_dir)
    write_exact(os.path.join(img_dir, "c3.h5"), "c3", C3_POLISH, 1501)

    def add(name, n):
        if name in entries:
            entries[name]["launches"] += n

    # polish with default flags at H=1056
    model = wide_checkpoint(work, 1056)
    params, _ = load_model_any(model)
    engaged = engaged_kernel(params, resolve_backend(None, torch.device("cuda"), params))
    for m in mods:
        m.reset_launch_counts()
    t0 = time.perf_counter()
    fasta, preds = polish_cli(img_dir, model, os.path.join(work, "c3_out"))
    wall = time.perf_counter() - t0
    launches = {k: v for m in mods for k, v in m.launch_counts.items()}
    k3 = n_win * 2  # one batch at the default -b 512, two layers
    want = {**dict.fromkeys(launches, 0), "bigru_window_xp": k3, "bigru_window_xp_chain": k3,
            "bigru_window_xp_chain_r8": k3, "bigru_window_xp_proj": k3,
            "bigru_window_xp_proj_split": 2}
    log(f"15a polish (default flags) of {C3_POLISH} images at H=1056: engaged kernel "
        f"{engaged!r}, wall {wall:.2f} s, launches { {k: v for k, v in launches.items() if v} }")
    if engaged != "cuda_xp":
        fail(f"polish at H=1056 engages {engaged!r}, not the xp kernels")
    if launches != want:
        fail(f"polish at H=1056 launched other kernels than {want}")
    add("bigru_window_xp_chain_r8", k3)
    _, plain_preds = polish_cli(img_dir, model, os.path.join(work, "c3_out_torch"),
                                ["--backend", "torch"])
    got, ref = store_labels(preds), store_labels(plain_preds)
    if sorted(got) != sorted(ref):
        fail("15a: the two polishes stored other images")
    n = sum(v[0].size for v in ref.values())
    fb = sum(int((got[k][0] != ref[k][0]).sum()) for k in ref)
    fr = sum(int((got[k][1] != ref[k][1]).sum()) for k in ref)
    log(f"15a polish at H=1056, kernels vs --backend torch on the card: {fb}+{fr} base+rle "
        f"flips of {n} per head (limit {FLIPS_PER_LABEL * n:g})")
    if max(fb, fr) > FLIPS_PER_LABEL * n:
        fail("15a: the H=1056 kernels' labels disagree with the plain route")

    # one TBPTT batch at H=1056, B=64
    images, yb, yr = load_labeled(img_dir, C3_B)
    tbptt_pair(params, images, yb, yr, f"15a one TBPTT batch at H=1056, B={C3_B}", mods,
               {"bigru_window_xp": k3, "bigru_window_xp_chain": k3,
                "bigru_window_xp_chain_r8": k3, XP_PASSES[0]: k3, XP_PASSES[1]: k3,
                "bigru_window_xp_bwd_rec_chain": k3, "bigru_window_xp_bwd_rec_chain_r8": k3,
                **wgrad_counts(k3), "bigru_window_xp_proj": k3,
                "bigru_window_xp_proj_split": k3})
    add("bigru_window_xp_chain_r8", k3)
    add("bigru_window_xp_bwd_rec_chain_r8", k3)

    # polish --fast at H=1152 (K3f's chain at 8 rows) and H=2048 (at 4)
    few = os.path.join(work, "c3_few")
    os.makedirs(few)
    write_exact(os.path.join(few, "few.h5"), "few", C3_FEW, 1503)
    for h, rows in ((1152, 8), (2048, 4)):
        model = wide_checkpoint(work, h)
        for m in mods:
            m.reset_launch_counts()
        t0 = time.perf_counter()
        polish_cli(few, model, os.path.join(work, f"c3_fast_{h}"), ["--fast"])
        launches = {k: v for m in mods for k, v in m.launch_counts.items()}
        name = f"bigru_window_xp_fast_chain_r{rows}"
        want = {**dict.fromkeys(launches, 0), "bigru_window_xp_fast": k3,
                "bigru_window_xp_fast_chain": k3, name: k3}
        log(f"15a polish --fast of {C3_FEW} images at H={h}: "
            f"{time.perf_counter() - t0:.2f} s, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
        if launches != want:
            fail(f"polish --fast at H={h} launched other kernels than {want}")
        add(name, k3)

    # one TBPTT batch of one window at H=2048, B=32 (two slices of pass 2's
    # rows, as every training shape here): K4 pass 1 at 4 rows
    p2048, _ = load_model_any(wide_checkpoint(work, 2048))
    tbptt_pair(p2048, images[:32, :T].contiguous(), yb[:32, :T].contiguous(),
               yr[:32, :T].contiguous(), "15a one TBPTT batch of one window at H=2048, B=32",
               mods, {"bigru_window_xp": 2, "bigru_window_xp_chain": 2,
                      "bigru_window_xp_chain_r8": 2, XP_PASSES[0]: 2, XP_PASSES[1]: 2,
                      "bigru_window_xp_bwd_rec_chain": 2,
                      "bigru_window_xp_bwd_rec_chain_r4": 2, **wgrad_counts(2),
                      "bigru_window_xp_proj": 2, "bigru_window_xp_proj_split": 2})
    add("bigru_window_xp_chain_r8", 2)
    add("bigru_window_xp_bwd_rec_chain_r4", 2)
    for name, e in entries.items():
        if not e["launches"]:
            fail(f"15a: no path launched {name}")
        results[name] = e


def run_hyperband(work: str, test_dir: str, results) -> str:
    """Phase 15b: ``hyperband --max_epochs 2 --eta 2 -b 256 --seed 0`` on
    256 labeled full-width images, held out on phase 7c's test images, at
    the flagship's width. Its trials (hyperband_results.json) replay through
    ``Hyperband`` for seed 0 to the same configs, rung epochs, survivors and
    best; each trial's training kernel launches (counted around its
    ``Trainer.run``) equal its epochs' batches x 19 x layers; ``test`` of the
    best trial's checkpoint gives its recorded loss within 1e-5. Returns
    the training images' directory."""
    import glob

    from helen_tpu_torch.cli import main as cli
    from helen_tpu_torch.config import IMAGE, WINDOW
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import gru_window_bwd as gb
    from helen_tpu_torch.ops import gru_window_wgrad as gwg
    from helen_tpu_torch.train import train_loop
    from helen_tpu_torch.train.hyperband import Hyperband

    train_dir = os.path.join(work, "hb_train")
    os.makedirs(train_dir)
    write_exact(os.path.join(train_dir, "hb.h5"), "hb", HB_IMAGES, 1601)
    n_test = len(MarginPolishDataset(glob.glob(os.path.join(test_dir, "*.h5"))))
    mods = (gw, gb, gwg)
    per_trial = []
    real_run = train_loop.Trainer.run

    def counted_run(self, epochs):
        for m in mods:
            m.reset_launch_counts()
        out = real_run(self, epochs)
        per_trial.append((epochs, {k: v for m in mods for k, v in m.launch_counts.items()}))
        return out

    out = os.path.join(work, "hb_out")
    train_loop.Trainer.run = counted_run
    t0 = time.perf_counter()
    try:
        rc = cli(["hyperband", "--train_image_dir", train_dir, "--test_image_dir", test_dir,
                  "--max_epochs", "2", "--eta", "2", "-b", str(HB_BATCH), "--seed", "0",
                  "-o", out])
    finally:
        train_loop.Trainer.run = real_run
    wall = time.perf_counter() - t0
    if rc != 0:
        fail("hyperband returned non-zero")
    with open(os.path.join(out, "hyperband_results.json")) as f:
        rec = json.load(f)
    trials = rec["trials"]
    losses = iter([t["loss"] for t in trials])
    replay = []

    def run_trial(cfg, epochs, state):
        replay.append((cfg, epochs, state))
        return next(losses), trials[len(replay) - 1]["checkpoint"]

    best = Hyperband(run_trial, max_epochs=2, eta=2, seed=0).run()
    same = ([(c, e, s) for c, e, s in replay]
            == [(t["params"], t["added_epochs"], t["resumed_from"]) for t in trials]
            and (best.params, best.loss) == (rec["best"]["params"], rec["best"]["loss"]))
    log(f"15b hyperband: {len(trials)} trials in {wall:.1f} s: "
        + "; ".join(f"{t['trial']} lr {t['params']['learning_rate']:.3g} decay "
                    f"{t['params']['weight_decay']:.3g} +{t['added_epochs']} -> epoch "
                    f"{t['epochs']} loss {t['loss']:.6f}" for t in trials)
        + f"; best {rec['best']['trial']}; the schedule for seed 0 replays: {same}")
    if not same:
        fail("hyperband's trials differ from the schedule Hyperband gives for seed 0")
    n_win = WINDOW.num_windows(IMAGE.seq_length)
    train_b, test_b = -(-HB_IMAGES // HB_BATCH), -(-n_test // HB_BATCH)
    if len(per_trial) != len(trials):
        fail("hyperband ran another number of trials than it recorded")
    for t, (epochs, launches) in zip(trials, per_trial):
        want = train_counts(epochs * (train_b + test_b) * n_win, epochs * train_b * n_win)
        if epochs != t["added_epochs"] or launches != want:
            fail(f"hyperband {t['trial']}: launches {launches}, expected {want}")
    log(f"15b every trial's launches = its epochs x ({train_b} train + {test_b} test "
        f"batches) x {n_win} windows x layers, the backward on the train batches only")
    if "bigru_window_in1" in results:
        results["bigru_window_in1"]["launches_hyperband"] = sum(
            launches["bigru_window_in1"] for _, launches in per_trial)
    best_ckpt = rec["best"]["checkpoint"]
    tout = os.path.join(work, "hb_test")
    if cli(["test", "--test_image_dir", test_dir, "-m", best_ckpt, "-b", str(HB_BATCH),
            "-o", tout]) != 0:
        fail("test of hyperband's best checkpoint returned non-zero")
    with open(os.path.join(tout, "test_stats.json")) as f:
        loss = json.load(f)["loss"]
    log(f"15b test of the best trial's checkpoint: loss {loss!r}, recorded "
        f"{rec['best']['loss']!r}")
    if abs(loss - rec["best"]["loss"]) > 1e-5:
        fail("test of hyperband's best checkpoint does not give its recorded loss")
    return train_dir


def dump_and_recount(ckpt: str, test_dir: str, out: str, batch: int) -> tuple:
    """``test --debug_mismatches`` of ``ckpt`` on ``test_dir`` at ``-b
    batch``, and the mismatches of the consensus labels counted apart on
    the card (models.transducer.consensus_labels, the vote over the
    windows, on batches padded as the test's are). Returns (test_stats,
    dump lines, (records, base, rle) of the dump, (either, base, rle) of
    the recount)."""
    import glob

    import numpy as np
    import torch

    from helen_tpu_torch.cli import main as cli
    from helen_tpu_torch.io.checkpoint import load_model_any, params_to_torch
    from helen_tpu_torch.io.images import MarginPolishDataset
    from helen_tpu_torch.models.transducer import consensus_labels

    if cli(["test", "--test_image_dir", test_dir, "-m", ckpt, "-b", str(batch),
            "--debug_mismatches", "-o", out]) != 0:
        fail("test --debug_mismatches returned non-zero")
    with open(os.path.join(out, "test_stats.json")) as f:
        stats = json.load(f)
    with open(os.path.join(out, "mismatches.txt")) as f:
        lines = f.read().splitlines()
    # "<contig>:<pos> true=<base>x<rle> pred=<base>x<rle> | <features>"
    pairs = [[tok.split("=")[1].rsplit("x", 1) for tok in ln.split(" | ")[0].split()[1:3]]
             for ln in lines]
    dump = (len(lines), sum(t[0] != p[0] for t, p in pairs),
            sum(t[1] != p[1] for t, p in pairs))
    params, _ = load_model_any(ckpt)
    tp = params_to_torch(params, torch.device("cuda"))
    ds = MarginPolishDataset(sorted(glob.glob(os.path.join(test_dir, "*.h5"))),
                             with_labels=True)
    either = base_n = rle_n = 0
    for s in range(0, len(ds), batch):
        recs = [ds.load(i) for i in range(s, min(s + batch, len(ds)))]
        images = np.zeros((batch,) + recs[0].image.shape, dtype=np.uint8)
        images[:len(recs)] = np.stack([r.image for r in recs])
        with torch.no_grad():
            pb, pr = consensus_labels(tp, torch.from_numpy(images).cuda(), backend="cuda")
        pb, pr = pb.cpu().numpy(), pr.cpu().numpy()
        for j, r in enumerate(recs):
            real = r.position[:, 0] >= 0
            mb, mr = (pb[j] != r.label_base) & real, (pr[j] != r.label_rle) & real
            either += int((mb | mr).sum())
            base_n += int(mb.sum())
            rle_n += int(mr.sum())
    return stats, lines, dump, (either, base_n, rle_n)


def run_debug_mismatches(work: str, test_dir: str) -> None:
    """Phase 15c: ``test --debug_mismatches`` with phase 7c's checkpoint on
    its test images: the loss and both confusion matrices equal phase 7c's
    ``test``, and the dump's records (and its base and rle mismatches each)
    equal the columns whose consensus labels differ from the truth, counted
    apart (:func:`dump_and_recount`); then on 8 noisier labeled images
    (noise 0.45), where the checkpoint gets columns wrong, the same count
    on a dump that is not empty. The matrices count each window's argmax, a
    column once per window that covers it, so their off-diagonal sums are
    logged, not compared."""
    import glob

    import numpy as np

    ckpt = glob.glob(os.path.join(work, "train_out", "trained_models_*", "models",
                                  "HELEN_latest_checkpoint.npz"))[0]
    t0 = time.perf_counter()
    stats, lines, dump, recount = dump_and_recount(ckpt, test_dir,
                                                   os.path.join(work, "debug_out"), TB)
    with open(os.path.join(work, "test_out", "test_stats.json")) as f:
        ref = json.load(f)
    same = all(stats[k] == ref[k] for k in ("loss", "base_confusion_matrix",
                                            "rle_confusion_matrix"))
    off = [float(np.sum(m) - np.trace(m)) for m in
           (np.asarray(stats["base_confusion_matrix"]), np.asarray(stats["rle_confusion_matrix"]))]
    log(f"15c test --debug_mismatches on phase 7c's test images: loss and both confusion "
        f"matrices equal phase 7c's test: {same}; (records, base, rle) of the dump {dump}, "
        f"of the consensus labels counted apart {recount}; the matrices' off-diagonal sums "
        f"(per window) {off[0]:.0f} + {off[1]:.0f}")
    if not same:
        fail("test --debug_mismatches changed the test's loss or matrices")
    if dump != recount:
        fail("the mismatch dump differs from the consensus labels' mismatches")
    noisy = os.path.join(work, "debug_noisy")
    os.makedirs(noisy)
    from helen_tpu_torch.io.synthetic import random_sequence, rle_encode, write_image_file

    # 8 images: fewer columns than the dump's 10,000-record cap
    seq = random_sequence(4000 * 8, seed=1801)
    seq = seq[:int(rle_encode(seq)[1][:1000 + 7 * 920].sum())]
    write_image_file(os.path.join(noisy, "noisy.h5"), {"noisy": seq}, region_cols=1000,
                     overlap_cols=80, noise=0.45, seed=1802)
    _, lines, dump, recount = dump_and_recount(ckpt, noisy, os.path.join(work, "debug_noisy_out"),
                                               TB)
    log(f"15c on 8 images at noise 0.45: (records, base, rle) of the dump {dump}, of the "
        f"consensus labels counted apart {recount}; first record: "
        f"{lines[0] if lines else '(none)'}; {time.perf_counter() - t0:.1f} s")
    if dump != recount or not dump[0]:
        fail("the mismatch dump of the noisy images is empty or differs from the consensus "
             "labels' mismatches")


def run_model_parallel(work: str, train_dir: str, test_dir: str) -> None:
    """Phase 15d: ``train --model_parallel 2`` through the CLI on the one
    card (helen_tpu's clamp warning; the data x tensor step on a 1 x 1
    mesh, the plain recurrence), one epoch at -b 128, against the
    data-parallel trainer (``train`` without the flag: the kernels) within
    rtol/atol 1e-4; then the library's Trainer on ``["cuda:0", "cuda:0"]``
    (a 1 x 2 mesh: each GRU layer's units and the heads' inputs split over
    two shards on the one card, h gathered every step), one epoch within
    the same bars."""
    import dataclasses
    import glob
    import logging

    import numpy as np

    from helen_tpu_torch.cli import main as cli
    from helen_tpu_torch.config import TRAIN
    from helen_tpu_torch.io.checkpoint import flatten_tree, load_checkpoint
    from helen_tpu_torch.train.train_loop import Trainer
    from helen_tpu_torch.utils.filesystem import list_image_files

    warnings = []

    class Keep(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    logger = logging.getLogger("helen_tpu_torch.train")
    handler = Keep(logging.WARNING)
    logger.addHandler(handler)
    common = ["--train_image_dir", train_dir, "--test_image_dir", test_dir, "-b",
              str(MP_BATCH), "-e", "1", "--seed", "5"]
    t0 = time.perf_counter()
    try:
        rc = cli(["train", *common, "--model_parallel", "2", "-o",
                  os.path.join(work, "mp_out")])
    finally:
        logger.removeHandler(handler)
    t_mp = time.perf_counter() - t0
    if rc != 0:
        fail("train --model_parallel 2 returned non-zero")
    t0 = time.perf_counter()
    if cli(["train", *common, "-o", os.path.join(work, "dp_out")]) != 0:
        fail("train returned non-zero")
    t_dp = time.perf_counter() - t0

    def epoch1(out):
        path = glob.glob(os.path.join(out, "trained_models_*", "models",
                                      "HELEN_epoch_1_checkpoint.npz"))[0]
        return {k: np.asarray(v) for k, v in flatten_tree(load_checkpoint(path)[0]).items()}

    def worst(a, b):
        return max(float(np.max(np.abs(a[k] - b[k]) - 1e-4 * np.abs(b[k]))) for k in b)

    dp = epoch1(os.path.join(work, "dp_out"))
    clamp = [w for w in warnings if "does not divide" in w]
    err = worst(epoch1(os.path.join(work, "mp_out")), dp)
    log(f"15d train --model_parallel 2 on one card: {t_mp:.1f} s (data-parallel trainer "
        f"{t_dp:.1f} s); warnings {warnings}; params: max(|mp - dp| - 1e-4 |dp|) {err:.3g} "
        "(limit 1e-4)")
    if clamp != ["model_parallel=2 does not divide 1 devices; using 1"]:
        fail("train --model_parallel 2 did not warn of the clamp to one device")
    if err > 1e-4:
        fail("train --model_parallel 2 disagrees with the data-parallel trainer")
    t0 = time.perf_counter()
    cfg = dataclasses.replace(TRAIN, batch_size=MP_BATCH, learning_rate=1e-4, seed=5)
    lib = Trainer(list_image_files(train_dir), list_image_files(test_dir), cfg,
                  model_dir=os.path.join(work, "mp_lib", "models"),
                  stats_dir=os.path.join(work, "mp_lib", "stats"), device="cuda",
                  model_parallel=2, devices=["cuda:0", "cuda:0"])
    mesh = lib.mesh.shape
    lib.run(1)
    got = {k: np.asarray(v) for k, v in flatten_tree(load_checkpoint(os.path.join(
        work, "mp_lib", "models", "HELEN_epoch_1_checkpoint.npz"))[0]).items()}
    err = worst(got, dp)
    log(f"15d the library's Trainer on ['cuda:0', 'cuda:0']: mesh {mesh}, "
        f"{len(lib.sharded)} shards, one epoch in {time.perf_counter() - t0:.1f} s; params: "
        f"max(|mp - dp| - 1e-4 |dp|) {err:.3g} (limit 1e-4)")
    if mesh != {"data": 1, "model": 2} or err > 1e-4:
        fail("the two-shard trainer on one card disagrees with the data-parallel trainer")


def run_convert(work: str) -> None:
    """Phase 15e: ``convert`` of phase 5's trained checkpoint .npz -> .pkl
    -> .npz (bit for bit) and -> .onnx (its self-check against the port's
    forward, on the card through the kernels, passes); ``download_models``
    from a ``file://`` manifest listing the golden model, then ``polish`` of
    the golden images with the downloaded file: the golden FASTA byte for
    byte."""
    import numpy as np

    from helen_tpu_torch.cli import main as cli
    from helen_tpu_torch.io.checkpoint import flatten_tree, load_model_any
    from helen_tpu_torch.io.onnx_export import parse_onnx

    src = os.path.join(GOLDEN, "trained_synth30mb.npz")
    pkl, npz, onnx = (os.path.join(work, f"converted.{x}") for x in ("pkl", "npz", "onnx"))
    t0 = time.perf_counter()
    for a, b in ((src, pkl), (pkl, npz)):
        if cli(["convert", "-i", a, "-o", b]) != 0:
            fail(f"convert {a} -> {b} returned non-zero")
    want, got = (flatten_tree(load_model_any(p)[0]) for p in (src, npz))
    exact = sorted(want) == sorted(got) and all(
        np.array_equal(np.asarray(want[k]), np.asarray(got[k])) for k in want)
    if cli(["convert", "-i", src, "-o", onnx]) != 0:
        fail("convert to .onnx (its self-check on the card) returned non-zero")
    model = parse_onnx(open(onnx, "rb").read())
    log(f"15e convert .npz -> .pkl -> .npz bit for bit: {exact}; .onnx ({os.path.getsize(onnx)} "
        f"bytes, {[n['op'] for n in model['nodes']].count('GRU')} GRU nodes) self-checked "
        f"against the kernels on the card within 1e-4; {time.perf_counter() - t0:.1f} s")
    if not exact:
        fail("convert .npz -> .pkl -> .npz changed the params")
    manifest = os.path.join(work, "manifest.csv")
    with open(manifest, "w") as f:
        f.write(f"golden_model.pkl,file://{os.path.join(GOLDEN, 'golden_model.pkl')}\n")
    dl = os.path.join(work, "downloaded")
    if cli(["download_models", "-o", dl, "--manifest_url", f"file://{manifest}"]) != 0:
        fail("download_models returned non-zero")
    img_dir = os.path.join(work, "golden_images")
    if not os.path.isdir(img_dir):
        os.makedirs(img_dir)
        with gzip.open(os.path.join(GOLDEN, "golden_images.h5.gz"), "rb") as s, \
                open(os.path.join(img_dir, "golden_images.h5"), "wb") as d:
            shutil.copyfileobj(s, d)
    fasta, _ = polish_cli(img_dir, os.path.join(dl, "golden_model.pkl"),
                          os.path.join(work, "out_downloaded"))
    same = same_bytes(fasta, os.path.join(GOLDEN, "golden.fa"))
    log(f"15e download_models over file://, then polish of the golden images with the "
        f"downloaded model: FASTA byte-identical to golden.fa: {same}")
    if not same:
        fail("the downloaded model did not polish the golden images to golden.fa")


def run_assess(work: str, truth: dict) -> None:
    """Phase 15f: ``assess --json`` of phase 6's FASTA against its truth: 0
    edits; with ``--bed`` over two intervals of one contig, the masked truth
    and polished counts each equal the intervals' length (the polished
    contigs are the truth)."""
    import contextlib
    import io

    from helen_tpu_torch.cli import main as cli
    from helen_tpu_torch.io.fasta import write_fasta

    truth_fa = os.path.join(work, "truth_full.fa")
    write_fasta(truth_fa, sorted(truth.items()))
    fasta = os.path.join(work, "out_full", "HELEN_prediction.fa")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli(["assess", "-t", truth_fa, "-p", fasta, "--json"])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    contig = sorted(truth)[0]
    bed = os.path.join(work, "two.bed")
    with open(bed, "w") as f:
        f.write(f"{contig}\t10000\t10500\n{contig}\t200000\t201000\n")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_bed = cli(["assess", "-t", truth_fa, "-p", fasta, "--json", "-b", bed])
    bed_report = json.loads(buf.getvalue().strip().splitlines()[-1])
    masked = bed_report.get("masking", {})
    log(f"15f assess of phase 6's FASTA: rc {rc}, {report['total_edits']} edits over "
        f"{report['total_truth_bases']} truth bases; with a BED of two intervals (1,500 "
        f"bases of {contig}): rc {rc_bed}, masking {masked}, {bed_report['total_edits']} "
        f"edits; {time.perf_counter() - t0:.1f} s")
    if rc or report["total_edits"] != 0 or rc_bed or bed_report["total_edits"] != 0:
        fail("assess of phase 6's FASTA found edits")
    if (masked.get("masked_truth"), masked.get("masked_polished")) != (1500, 1500):
        fail("assess --bed masked other counts than the BED's 1,500 bases")


# ---------------------------------------------------------------------------
# phase 16: helen_tpu's last three tools, written for the card
# ---------------------------------------------------------------------------

# 16b: scaling_bench at its defaults, on one and two processes of the card;
# 16c: sharding_overhead at helen_tpu's CI sizes (ci/run_checks.sh: -b 2
# --steps 3), two processes sharing the card as helen_tpu's CI shares cores
SCALING_B, SCALING_STEPS = 256, 6
SHARDING_B, SHARDING_STEPS = 2, 3
TOOL_DEVICES = ["cuda:0", "cuda:0"]
TOOL_JOB_S = 300


def run_tools(smi: str) -> None:
    """Phase 16. 16a ``gpu_validation.run(64)``: every check passes (each
    printed with its numbers and kernel family). 16b ``scaling_bench`` on
    ["cuda:0"] and ["cuda:0", "cuda:0"]: the rows; the two-process job's
    label sums equal this process's ``consensus_labels`` over the same
    global batch exactly, and each process's K1/K2 launches are its
    batches x 19 x layers. 16c ``sharding_overhead`` on ["cuda:0",
    "cuda:0"]: the row, the job's loss within 1e-5 relative of one
    process's; the overheads are readings with no bar."""
    import numpy as np
    import torch

    from helen_tpu_torch.config import IMAGE, WINDOW
    from helen_tpu_torch.io.checkpoint import params_to_torch
    from helen_tpu_torch.models.transducer import consensus_labels, init_params
    from helen_tpu_torch.tools import gpu_validation, scaling_bench, sharding_overhead

    # the card's memory for the jobs' processes, not this one's cached blocks
    torch.cuda.empty_cache()
    phase("16a. gpu_validation --batch 64")
    t0 = time.perf_counter()
    results = gpu_validation.run(64)
    log(f"16a: {results['device_kind']}, power limit {results['power_limit']}; all passed: "
        f"{results['all_passed']} ({time.perf_counter() - t0:.1f} s)")
    if not results["all_passed"]:
        fail("16a: gpu_validation: " + ", ".join(
            n for n, c in results["checks"].items() if not c["passed"]))

    phase(f"16b. scaling_bench -b {SCALING_B} --steps {SCALING_STEPS} on {TOOL_DEVICES[:1]} "
          f"and {TOOL_DEVICES}")
    t0 = time.perf_counter()
    records = {}
    rows = scaling_bench.measure([1, 2], SCALING_B, SCALING_STEPS, devices=TOOL_DEVICES,
                                 records=records, timeout_s=TOOL_JOB_S)
    log(f"16b: {len(rows)} rows in {time.perf_counter() - t0:.1f} s, start-up included "
        f"({smi})")
    n_win = WINDOW.num_windows(IMAGE.seq_length)
    for k, procs in records.items():
        for p in procs:
            want = parity_counts(p["batches"] * n_win, p["batches"] * n_win)
            log(f"16b: {k} process(es), rank {p['rank']}: {p['seconds']:.4f} s for "
                f"{SCALING_STEPS} batches of {SCALING_B} ({p['kernel']}); launches "
                f"{'as expected' if p['launches'] == want else p['launches']}")
            if p["launches"] != want:
                fail(f"16b: rank {p['rank']} of the {k}-process job launched other than its "
                     f"{p['batches']} batches x {n_win} windows x 1 layer of K1 and K2")
    device = torch.device("cuda", 0)
    params = params_to_torch(init_params(torch.Generator().manual_seed(0)), device)
    with torch.no_grad():
        base, rle = consensus_labels(params, torch.from_numpy(scaling_bench.batch_images(
            2 * SCALING_B)).to(device), backend="cuda")
    want = [SCALING_STEPS * int(base.sum(dtype=torch.int64)),
            SCALING_STEPS * int(rle.sum(dtype=torch.int64))]
    got = [p["label_sums"] for p in records[2]]
    log(f"16b: the two-process job's label sums {got[0]} over {SCALING_STEPS} batches; one "
        f"process over the same {2 * SCALING_B} images x {SCALING_STEPS}: {want}")
    if got != [want, want]:
        fail("16b: the job's label sums differ from one process's consensus_labels")

    phase(f"16c. sharding_overhead -b {SHARDING_B} --steps {SHARDING_STEPS} on {TOOL_DEVICES}")
    t0 = time.perf_counter()
    records = {}
    rows = sharding_overhead.measure([2], SHARDING_B, SHARDING_STEPS, devices=TOOL_DEVICES,
                                     records=records, timeout_s=TOOL_JOB_S)
    solo, shard = records[2]["unsharded"][0], records[2]["sharded"]
    rel = max(abs(p["loss"] - solo["loss"]) / abs(solo["loss"]) for p in shard)
    log(f"16c: train overhead {rows[0]['train_overhead']}, consensus overhead "
        f"{rows[0]['consensus_overhead']} (readings: two processes share the card); loss "
        f"{shard[0]['loss']!r} against one process's {solo['loss']!r} (relative {rel:.3g}); "
        f"training on {solo['kernel']}, launches of one process {solo['launches']}; "
        f"{time.perf_counter() - t0:.1f} s, start-up included ({smi})")
    if not np.isfinite(solo["loss"]) or rel > 1e-5:
        fail("16c: the sharded loss is not within 1e-5 of the unsharded one")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "helen_tpu_torch")):
        print("chip_smoke: run from the root of a helen_tpu checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from helen_tpu_torch.models.transducer import set_fp32_precision

    set_fp32_precision()
    phase("1. card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    from helen_tpu_torch.ops import gru_window as gw
    from helen_tpu_torch.ops import library

    nvcc = subprocess.run([library.nvcc(), "--version"], capture_output=True, text=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    log(f"device: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    phase("2. build")
    t0 = time.perf_counter()
    so = library.build_kernels()
    gw.get_lib()
    log(f"built and loaded {os.path.relpath(so, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    if os.path.exists(so + ".log"):
        log(open(so + ".log").read().strip())

    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        phase("set-up: synthetic full-width images")
        t0 = time.perf_counter()
        img_dir = os.path.join(work, "full")
        truth, n_images = make_full_width(img_dir)
        log(f"{n_images} synthetic images in {time.perf_counter() - t0:.1f} s")
        from helen_tpu_torch.io.images import MarginPolishDataset

        ds = MarginPolishDataset(sorted(os.path.join(img_dir, f)
                                        for f in os.listdir(img_dir)))
        batch = np.stack([ds.load(i).image for i in range(B)])
        images_u8 = torch.from_numpy(batch).cuda()

        phase(f"3. K1 and K2, both designs, against their plain versions (B={B} and {TB}, "
              f"T={T}, H={H}, F={F}; then H=136 and H=160)")
        check_kernels(images_u8, results)

        phase("4. golden fixtures")
        check_golden(work)

        phase("5. trained checkpoint, unseen sequence")
        unseen = check_trained(work)

        phase("6. full-width polish")
        timer6 = run_full_width(img_dir, truth, n_images, work, results)

        phase("7a. backward kernels against their plain versions (B=256, T=100, H=128; "
              "pass 2 also at B=512)")
        check_backward(images_u8, results)
        check_wgrad(results)

        phase("7b. one TBPTT batch: kernels against the plain route")
        check_tbptt(img_dir)

        phase("7c. train and test through the CLI")
        run_train(img_dir, n_images, work, results)

        t9 = time.perf_counter()
        phase(f"9a. K3 against its plain version (B={B}, T={T}, H={WH})")
        check_xp_kernel(images_u8, results)

        phase(f"9f. the xp route's projection, 3xTF32 (B={B} and {WB_TRAIN}, T={T}, H={WH})")
        check_xp_proj(images_u8, results)

        phase(f"9b. K4 against its plain version (B={WB_TRAIN}, T={T}, H={WH})")
        check_xp_backward(results)

        phase("9c. golden fixtures through the xp route")
        check_golden_xp()

        phase("9d. both routes at H=512")
        check_routes_h512(images_u8[:WB_POLISH])

        phase(f"9e. the wide model through the CLI (H={WH})")
        wide = run_wide_cli(work, results)
        log(f"phase 9: {time.perf_counter() - t9:.1f} s")

        t10 = time.perf_counter()
        phase(f"10a. K1f and K2f against their plain versions (B={B}, T={T}, H={H}, F={F})")
        check_fast_inproj(images_u8, results)

        phase(f"10b. K3f against its plain version (B={B}, T={T}, H={WH})")
        check_fast_xp(images_u8, results)

        phase(f"10c. label flip audit of the fast tier ({N_AUDIT} images, random weights, "
              f"H={H} and H={WH})")
        audit_fast_flips(images_u8[:N_AUDIT])

        phase("10d. the trained checkpoint under polish --fast")
        check_trained_fast(work, *unseen)

        phase("10e. polish --fast: the flagship and the wide model")
        run_fast_polish(img_dir, truth, n_images, work, *wide, results)
        log(f"phase 10: {time.perf_counter() - t10:.1f} s")

        t11 = time.perf_counter()
        phase(f"11a. K5 and K5f, both designs, against the chained kernels (B={B} and {TB}, "
              f"T={T}, H={H}, F={F})")
        check_encdec(images_u8, results)

        phase("11b. the full-width images through route 'encdec', both tiers")
        run_encdec_route(img_dir, results)

        phase("11c. golden fixtures through route 'encdec'")
        check_golden_encdec(results)
        log(f"phase 11: {time.perf_counter() - t11:.1f} s")

        t12 = time.perf_counter()
        phase("12. the I/O flags at full width: --pack, --writers, --fastq, --resume, "
              "train --pack")
        run_io_flags(img_dir, truth, n_images, work, timer6)
        log(f"phase 12: {time.perf_counter() - t12:.1f} s")

        t13 = time.perf_counter()
        phase("13. HDF5 inputs helen_tpu reads through h5py: chunked, compressed, "
              "variable-length strings, the newest file format, a user block, lzf")
        check_hdf5_variants(work)
        log(f"phase 13: {time.perf_counter() - t13:.1f} s")

        t14 = time.perf_counter()
        phase(f"14. multi-process jobs on the one card: {JOB_PROCS} processes, gloo")
        run_jobs(img_dir, n_images, work, timer6, smi)
        log(f"phase 14: {time.perf_counter() - t14:.1f} s")

        t15 = time.perf_counter()
        test_dir = os.path.join(work, "train_test")
        phase(f"15a. the xp route past H=1024: K3, K3f and K4 at H={C3_WIDTHS}, "
              f"B={C3_B}, T={T}, against their plain versions")
        wide_entries = check_wide_kernels(results)
        phase("15a. the paths past H=1024: polish at H=1056, TBPTT batches, polish --fast")
        run_wide_paths(work, wide_entries, results)
        phase("15b. hyperband --max_epochs 2 --eta 2 -b 256 --seed 0")
        hb_train = run_hyperband(work, test_dir, results)
        phase("15c. test --debug_mismatches")
        run_debug_mismatches(work, test_dir)
        phase("15d. train --model_parallel 2")
        run_model_parallel(work, hb_train, test_dir)
        phase("15e. convert (.npz, .pkl, .onnx) and download_models")
        run_convert(work)
        phase("15f. assess")
        run_assess(work, truth)
        log(f"phase 15: {time.perf_counter() - t15:.1f} s")

        t16 = time.perf_counter()
        phase("16. helen_tpu's tools on the card: gpu_validation, scaling_bench, "
              "sharding_overhead")
        run_tools(smi)
        log(f"phase 16: {time.perf_counter() - t16:.1f} s")

    phase("8. result")
    log(smi)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] in (["--coordinator_address"], ["--barrier"]):
        sys.exit(job_worker(sys.argv[1:]))  # a process of a phase-14 job
    sys.exit(main())
