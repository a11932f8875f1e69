"""The bi-GRU window kernels of the consensus path: build, binding, launch
counters and plain versions.

Hand-written CUDA kernels (``ops/csrc/*.cu``, compiled with nvcc for
``sm_90a`` into a shared library with a C ABI and loaded with ctypes) carry
every bi-GRU window; two wrappers carry the main path's:

* :func:`bigru_window_in1` (K1, replaces helen_tpu's ``_kernel_inproj1``,
  ``helen_tpu/ops/gru_pallas.py:426``): one bi-GRU layer over one window
  of the ``(B, L, F)`` uint8 image, read in place at column ``start``;
* :func:`bigru_window_in2` (K2, replaces ``_kernel_inproj2``, ``:474``):
  the same over the previous layer's ``(out_f, out_b)`` halves, no concat.

Each runs in one of two designs, by a fixed rule of the shape
(:func:`window_design`): where one direction's ``W_hh`` and the state fit
one block's shared memory (the parity tier up to H=136 at B=512; the main
path), as two launches of ops.gru_window_smem, a projection pass over the
whole window and a recurrence with ``W_hh`` in shared memory; elsewhere as
one launch of ``bigru_window_kernel``, the projection inside the
recurrence's FMA chains. Both take every sum in the same order, so they
give the same bits.

The fast tier (``polish --fast``) has its own pair: :func:`bigru_window_in1_fast`
(K1f) and :func:`bigru_window_in2_fast` (K2f) replace the same two Pallas
bodies run with ``fast=True``. They take the layer's bf16 ``w_ih``/``w_hh``
(float32 biases; io.checkpoint.fast_weights makes the copies once per run),
round K2f's float32 input halves and the operand copy of h to bf16, and keep
the gates, the carried state and every output in float32. They run in the
same two designs: up to H=160, any batch, the projection pass and a
recurrence on bf16 tensor cores (ops.gru_window_smem, ``gru_window_fast.cu``;
within 1e-3 of the one-launch kernel, another order of sums); elsewhere
``bigru_window_kernel`` with ``FAST = true``. They are inference only: no
autograd Function wraps them.

Each wrapper takes the layer's ``{"fwd", "bwd"}`` params (``w_ih (D, 3H)``,
``w_hh (H, 3H)``, ``b_ih``/``b_hh (3H,)`` float32) and returns
``(out_f (T, B, H), out_b (T, B, H), h_f (B, H), h_b (B, H))``. On a CPU
tensor it computes its plain version (``*_plain``, explicit torch ops
mirroring helen_tpu's ``gru_scan``); on a CUDA tensor it launches the kernel
or raises — there is no fall-back from kernel to plain. Each K1/K2 adds one
to :data:`launch_counts` under its own name, whichever design ran, and each
launch of the two-launch design adds one under the kernel's name.

The same library holds the backward kernels (ops.gru_window_bwd), the
xp-stream kernels (ops.gru_window_xp, ops.gru_window_xp_bwd), the xp
route's projection (ops.gru_window_proj) and the fused
encoder+decoder window (ops.gru_window_encdec, K5/K5f, counted in
:data:`launch_counts` beside K1/K2, whose cell step it shares).

The library builds at first use, from the sources in ``ops/csrc``, into
``utils.build.build_dir("kernels")`` under a name keyed on a hash of the
sources and flags, so a fresh checkout builds it by itself. A failed build
raises with nvcc's stderr.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Tuple

import torch

from helen_tpu_torch.models.gru import bf16_round, gru_scan, ordered_product

Layer = Dict[str, Dict[str, torch.Tensor]]
Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: launches of each kernel since the last reset_launch_counts() — counted
#: where the kernel is launched and nowhere else
launch_counts: Dict[str, int] = {"bigru_window_in1": 0, "bigru_window_in2": 0,
                                 # the two-launch design of K1/K2 (ops.gru_window_smem)
                                 "bigru_window_proj_in1": 0, "bigru_window_proj_in2": 0,
                                 "bigru_window_rec_smem": 0,
                                 "bigru_window_in1_fast": 0, "bigru_window_in2_fast": 0,
                                 # the two-launch design of K1f/K2f (ops.gru_window_smem)
                                 "bigru_window_proj_in1_fast": 0,
                                 "bigru_window_proj_in2_fast": 0, "bigru_window_rec_fast": 0,
                                 # the fused encoder+decoder window (ops.gru_window_encdec):
                                 # K5/K5f per call, then the kernel of its design
                                 "transducer_window_encdec": 0,
                                 "transducer_window_encdec_fast": 0,
                                 "transducer_window_encdec_cluster": 0,
                                 "transducer_window_encdec_cluster_fast": 0,
                                 "transducer_window_encdec_onepass": 0,
                                 "transducer_window_encdec_onepass_fast": 0}

#: the largest hidden size the in-projection kernels take (K1/K2 and their
#: backward: one thread per hidden unit, csrc/gru_window_common.cuh MAX_H)
MAX_H = 512
#: K1/K2's designs: "smem", the projection pass plus the recurrence with
#: W_hh in shared memory (ops.gru_window_smem); "chain", bigru_window_kernel
DESIGNS = ("smem", "chain")

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
#: nvcc flags of each source's object; the library links them with -shared
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA window "
                       "kernels build from source at first use")


def build_kernels() -> str:
    """Compile ``ops/csrc/*.cu`` into the kernel library unless a build of
    these exact sources exists; returns its path. Each source compiles in
    its own nvcc process, all started together, then one nvcc links the
    objects. nvcc's ``-Xptxas -v`` reports (registers, shared memory,
    spills) are kept beside the library as ``<library>.log``."""
    from helen_tpu_torch.utils.build import build_dir

    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                     + glob.glob(os.path.join(_CSRC, "*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        with open(path, "rb") as f:
            digest.update(f.read())
    so = os.path.join(build_dir("kernels"),
                      f"libgru_window-{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.tmp{os.getpid()}"
    nvcc = _nvcc()
    objs, procs = [], []
    for src in (s for s in sources if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
    log, failed = [], None
    for cmd, proc in procs:
        out, err = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}{err}")
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}"
    if failed is None:
        cmd = [nvcc, *_ARCH, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            failed = (f"nvcc link failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                      f"{proc.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed is not None:
        raise RuntimeError(failed)
    with open(so + ".log", "w") as f:
        f.write("\n".join(log))
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_kernels())
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.bigru_window_in1.restype = i
            lib.bigru_window_in1.argtypes = (
                [p, ll, ll, i, i, p, p] + [p] * 8 + [p] * 4 + [i, i, i, p])
            lib.bigru_window_in2.restype = i
            lib.bigru_window_in2.argtypes = [p] * 4 + [p] * 8 + [p] * 4 + [i, i, i, p]
            # the fast tier's instantiations: the same arguments, bf16 weights
            lib.bigru_window_in1_fast.restype = i
            lib.bigru_window_in1_fast.argtypes = lib.bigru_window_in1.argtypes
            lib.bigru_window_in2_fast.restype = i
            lib.bigru_window_in2_fast.argtypes = lib.bigru_window_in2.argtypes
            # the backward (csrc/gru_window_bwd.cu; wrapper in gru_window_bwd.py)
            lib.bigru_window_bwd_rec.restype = i
            lib.bigru_window_bwd_rec.argtypes = (
                [p, ll, ll, i, p, p, i] + [p] * 8 + [p] * 12 + [p] * 6 + [i, i, i, p])
            lib.bigru_window_bwd_wgrad.restype = i
            lib.bigru_window_bwd_wgrad.argtypes = (
                [p, ll, ll, i, p, p, i] + [p] * 6 + [p] * 8 + [i, i, i, p])
            lib.gru_window_bwd_max_h.restype = i
            # the xp-stream kernels (csrc/gru_window_xp*.cu; wrappers in
            # gru_window_xp.py and gru_window_xp_bwd.py)
            lib.bigru_window_xp.restype = i
            lib.bigru_window_xp.argtypes = [p] * 12 + [i, i, i, i, p]
            lib.bigru_window_xp_fast.restype = i
            lib.bigru_window_xp_fast.argtypes = lib.bigru_window_xp.argtypes
            lib.bigru_window_xp_bwd_rec.restype = i
            lib.bigru_window_xp_bwd_rec.argtypes = [p] * 20 + [i, i, i, i, p]
            lib.bigru_window_xp_bwd_wgrad.restype = i
            lib.bigru_window_xp_bwd_wgrad.argtypes = [p] * 10 + [i, i, i, p]
            # the xp route's projection (csrc/gru_window_proj.cu; wrapper in
            # gru_window_proj.py): the source, the split weights, the biases,
            # the output; and the split itself
            lib.bigru_window_xp_proj.restype = i
            lib.bigru_window_xp_proj.argtypes = (
                [i, p, p, ll, ll, i, ll, p, i] + [p] * 3 + [i] * 4 + [p])
            lib.bigru_window_xp_proj_split.restype = i
            lib.bigru_window_xp_proj_split.argtypes = [p, p] + [i] * 4 + [p, p]
            lib.bigru_window_xp_proj_chunk.restype = i
            lib.bigru_window_xp_chain_smem_bytes.restype = ll
            lib.bigru_window_xp_chain_smem_bytes.argtypes = [i, i, i]
            lib.bigru_window_xp_bwd_chain_smem_bytes.restype = ll
            lib.bigru_window_xp_bwd_chain_smem_bytes.argtypes = [i, i]
            # pass 2's split design (csrc/gru_window_wgrad.cu; wrappers in
            # gru_window_wgrad.py): the in-projection form takes pass 2's
            # arguments above, the xp form the xp pass 2's, each plus the
            # partials' scratch; the slice sum the scratch and all outputs
            lib.bigru_window_wgrad_split_in.restype = i
            lib.bigru_window_wgrad_split_in.argtypes = (
                [p, ll, ll, i, p, p, i] + [p] * 6 + [p] * 8 + [p] + [i, i, i, p])
            lib.bigru_window_wgrad_split_xp.restype = i
            lib.bigru_window_wgrad_split_xp.argtypes = [p] * 10 + [p] + [i, i, i, p]
            lib.bigru_window_wgrad_sum.restype = i
            lib.bigru_window_wgrad_sum.argtypes = [p] + [i] * 5 + [p] * 8 + [p]
            lib.bigru_window_wgrad_slice_rows.restype = i
            lib.bigru_window_wgrad_scratch_bytes.restype = ll
            lib.bigru_window_wgrad_scratch_bytes.argtypes = [i] * 5
            # the fused encoder+decoder window (csrc/gru_window_encdec.cu;
            # wrapper in gru_window_encdec.py): K1's arguments, both layers'
            # weights, the outputs, T, B, H and the block's batch rows
            lib.transducer_window_encdec.restype = i
            lib.transducer_window_encdec.argtypes = (
                [p, ll, ll, i, i, p, p] + [p] * 16 + [p] * 4 + [i, i, i, i, p])
            lib.transducer_window_encdec_fast.restype = i
            lib.transducer_window_encdec_fast.argtypes = lib.transducer_window_encdec.argtypes
            lib.transducer_window_encdec_smem.restype = ll
            lib.transducer_window_encdec_smem.argtypes = [i] * 5
            lib.transducer_window_encdec_max_threads.restype = i
            lib.transducer_window_encdec_max_threads.argtypes = [i]
            # K5/K5f's cluster design (csrc/gru_window_smem.cu, gru_window_fast.cu):
            # K5's arguments, then the scratch, before the stream
            for name in ("transducer_window_encdec_cluster",
                         "transducer_window_encdec_cluster_fast"):
                getattr(lib, name).restype = i
                getattr(lib, name).argtypes = (
                    [p, ll, ll, i, i, p, p] + [p] * 16 + [p] * 4 + [i, i, i, i, p, p])
            lib.transducer_window_encdec_cluster_smem.restype = ll
            lib.transducer_window_encdec_cluster_smem.argtypes = [i, i]
            lib.transducer_window_encdec_cluster_threads.restype = i
            lib.transducer_window_encdec_cluster_threads.argtypes = [i, i]
            lib.transducer_window_encdec_cluster_active.restype = i
            lib.transducer_window_encdec_cluster_active.argtypes = [i, i]
            lib.transducer_window_encdec_cluster_fast_smem.restype = ll
            lib.transducer_window_encdec_cluster_fast_smem.argtypes = [i]
            lib.transducer_window_encdec_cluster_fast_threads.restype = i
            lib.transducer_window_encdec_cluster_fast_threads.argtypes = [i]
            lib.transducer_window_encdec_cluster_fast_active.restype = i
            lib.transducer_window_encdec_cluster_fast_active.argtypes = [i]
            lib.transducer_window_encdec_cluster_fast_max_h.restype = i
            for name in ("transducer_window_encdec_cluster_scratch",
                         "transducer_window_encdec_cluster_fast_scratch"):
                getattr(lib, name).restype = ll
                getattr(lib, name).argtypes = [i] * 4
            # the two-launch design of K1/K2 (csrc/gru_window_smem.cu;
            # wrappers in gru_window_smem.py)
            lib.bigru_window_proj_in1.restype = i
            lib.bigru_window_proj_in1.argtypes = [p, ll, ll, i, i] + [p] * 5 + [i, i, i, p]
            lib.bigru_window_proj_in2.restype = i
            lib.bigru_window_proj_in2.argtypes = [p] * 7 + [i, i, i, p]
            lib.bigru_window_rec_smem.restype = i
            lib.bigru_window_rec_smem.argtypes = [p] * 11 + [i, i, i, i, p]
            lib.bigru_window_rec_smem_bytes.restype = ll
            lib.bigru_window_rec_smem_bytes.argtypes = [i, i]
            lib.bigru_window_rec_max_threads.restype = i
            # the two-launch design of K1f/K2f (csrc/gru_window_fast.cu): the
            # same arguments, bf16 weights
            for name in ("proj_in1", "proj_in2"):
                getattr(lib, f"bigru_window_{name}_fast").restype = i
                getattr(lib, f"bigru_window_{name}_fast").argtypes = getattr(
                    lib, f"bigru_window_{name}").argtypes
            lib.bigru_window_rec_fast.restype = i
            lib.bigru_window_rec_fast.argtypes = lib.bigru_window_rec_smem.argtypes
            lib.bigru_window_rec_fast_smem_bytes.restype = ll
            lib.bigru_window_rec_fast_smem_bytes.argtypes = [i]
            lib.bigru_window_rec_fast_max_h.restype = i
            lib.gru_window_smem_optin.restype = i
            lib.gru_window_error_string.restype = ctypes.c_char_p
            lib.gru_window_error_string.argtypes = [i]
            lib.gru_window_max_h.restype = i
            if lib.gru_window_max_h() != MAX_H or lib.gru_window_bwd_max_h() != MAX_H:
                raise RuntimeError("MAX_H disagrees with csrc/gru_window*.cu")
            from helen_tpu_torch.ops import gru_window_xp as gx
            from helen_tpu_torch.ops import gru_window_xp_bwd as gxb

            if any(lib.bigru_window_xp_chain_smem_bytes(h, r, f)
                   != gx.chain_smem_bytes(h, r, bool(f))
                   or lib.bigru_window_xp_bwd_chain_smem_bytes(h, r)
                   != gxb.bwd_chain_smem_bytes(h, r)
                   for h in (640, 1056, 2048) for r in gx.CHAIN_ROWS for f in (0, 1)):
                raise RuntimeError("chain_smem_bytes disagrees with csrc/gru_window_xp*.cu")
            from helen_tpu_torch.ops import gru_window_smem as gs
            from helen_tpu_torch.ops.gru_window_proj import CHUNK
            from helen_tpu_torch.ops.gru_window_wgrad import SLICE_ROWS

            if lib.bigru_window_xp_proj_chunk() != CHUNK:
                raise RuntimeError("CHUNK disagrees with csrc/gru_window_proj.cu")

            if lib.bigru_window_wgrad_slice_rows() != SLICE_ROWS:
                raise RuntimeError("SLICE_ROWS disagrees with csrc/gru_window_wgrad.cu")

            if (lib.bigru_window_rec_max_threads() != gs.REC_MAX_THREADS
                    or any(lib.bigru_window_rec_smem_bytes(h, r) != gs.rec_smem_bytes(h, r)
                           for h in (1, 127, 128, 136, 137) for r in gs.BLOCK_ROWS)):
                raise RuntimeError("the recurrence's fit disagrees with "
                                   "csrc/gru_window_smem.cu")
            if (lib.bigru_window_rec_fast_max_h() != gs.FAST_REC_MAX_H
                    or any(lib.bigru_window_rec_fast_smem_bytes(h) != gs.fast_rec_smem_bytes(h)
                           for h in (1, 16, 37, 128, 136, 160))):
                raise RuntimeError("the fast recurrence's fit disagrees with "
                                   "csrc/gru_window_fast.cu")
            from helen_tpu_torch.ops import gru_window_encdec as ge

            if (lib.transducer_window_encdec_cluster_fast_max_h() != ge.CLUSTER_FAST_MAX_H
                    or any(lib.transducer_window_encdec_cluster_smem(h, r)
                           != ge.cluster_smem_bytes(h, r, False)
                           or lib.transducer_window_encdec_cluster_threads(h, r)
                           != ge.cluster_threads(h, r, False)
                           or lib.transducer_window_encdec_cluster_fast_smem(h)
                           != ge.cluster_smem_bytes(h, r, True)
                           or lib.transducer_window_encdec_cluster_fast_threads(h)
                           != ge.cluster_threads(h, r, True)
                           or lib.transducer_window_encdec_cluster_scratch(h, 300, 100, r)
                           != ge.cluster_scratch_bytes(h, 300, 100, r, False)
                           or lib.transducer_window_encdec_cluster_fast_scratch(h, 300, 100, r)
                           != ge.cluster_scratch_bytes(h, 300, 100, r, True)
                           for h in (1, 37, 64, 100, 128) for r in gs.BLOCK_ROWS)):
                raise RuntimeError("K5's cluster fit disagrees with csrc/gru_window_smem.cu "
                                   "or gru_window_fast.cu")
            _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# plain versions (CPU path, tests, and the on-card comparison)
# ---------------------------------------------------------------------------

def _bidir(xp_f, xp_b, h0_f, h0_b, layer, product=None) -> Outputs:
    f, b = layer["fwd"], layer["bwd"]
    out_f, hf = gru_scan(xp_f, h0_f, f["w_hh"], f["b_hh"], product=product)
    out_b, hb = gru_scan(xp_b, h0_b, b["w_hh"], b["b_hh"], reverse=True, product=product)
    return out_f, out_b, hf, hb


def bigru_window_in1_plain(image: torch.Tensor, start: int, T: int,
                           h0_f: torch.Tensor, h0_b: torch.Tensor,
                           layer: Layer) -> Outputs:
    """K1's plain version: the window ``image[:, start:start+T]`` (uint8 or
    float) projected per direction, then the two ``gru_scan`` recurrences.
    It computes in the dtype of ``h0_f`` (float32 on every path; float64
    for the gradient checks)."""
    x = image[:, start:start + T].to(h0_f.dtype).transpose(0, 1)  # (T, B, F)
    f, b = layer["fwd"], layer["bwd"]
    return _bidir(x @ f["w_ih"] + f["b_ih"], x @ b["w_ih"] + b["b_ih"],
                  h0_f, h0_b, layer)


def bigru_window_in2_plain(xa: torch.Tensor, xb: torch.Tensor,
                           h0_f: torch.Tensor, h0_b: torch.Tensor,
                           layer: Layer) -> Outputs:
    """K2's plain version: ``W_ih (2H, 3H)`` split into the rows that take
    ``xa`` and those that take ``xb``; the half-projections summed in f32."""
    H = xa.shape[-1]
    f, b = layer["fwd"], layer["bwd"]

    def proj(p):
        return (xa @ p["w_ih"][:H] + xb @ p["w_ih"][H:]) + p["b_ih"]

    return _bidir(proj(f), proj(b), h0_f, h0_b, layer)


def bigru_window_in1_fast_plain(image: torch.Tensor, start: int, T: int,
                                h0_f: torch.Tensor, h0_b: torch.Tensor,
                                layer: Layer) -> Outputs:
    """K1f's plain version: the window rounded to bf16 (a uint8 image is
    exact), ``x @ W_ih`` of bf16 values summed in float32 in K1f's order
    (``ordered_product``), ``+ b_ih``, then the two fast ``gru_scan``
    recurrences (bf16 ``w_hh``). No bf16 matmul: the products run in
    float32 on bf16-valued operands."""
    x = bf16_round(image[:, start:start + T].to(h0_f.dtype)).transpose(0, 1)
    f, b = layer["fwd"], layer["bwd"]
    return _bidir(ordered_product(x, f["w_ih"].to(x.dtype)) + f["b_ih"],
                  ordered_product(x, b["w_ih"].to(x.dtype)) + b["b_ih"],
                  h0_f, h0_b, layer)


def bigru_window_in2_fast_plain(xa: torch.Tensor, xb: torch.Tensor,
                                h0_f: torch.Tensor, h0_b: torch.Tensor,
                                layer: Layer) -> Outputs:
    """K2f's plain version: the halves rounded to bf16, projected in K2f's
    order (one sum over the rows ``[xa | xb]``; helen_tpu sums the two
    half-projections apart, another order of the same sum), ``+ b_ih``,
    then the fast recurrences."""
    x = torch.cat([bf16_round(xa), bf16_round(xb)], dim=-1)
    f, b = layer["fwd"], layer["bwd"]
    return _bidir(ordered_product(x, f["w_ih"].to(x.dtype)) + f["b_ih"],
                  ordered_product(x, b["w_ih"].to(x.dtype)) + b["b_ih"],
                  h0_f, h0_b, layer)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _layer_args(layer: Layer, D: int, H: int, device, wdtype=torch.float32) -> list:
    """Checked pointers of both directions' ``[w_ih, w_hh, b_ih, b_hh]``:
    weights of ``wdtype`` (float32, or bf16 for the fast tier), biases
    float32."""
    args = []
    for d in ("fwd", "bwd"):
        p = layer[d]
        _check(f"{d}.w_ih", p["w_ih"], (D, 3 * H), wdtype, device)
        _check(f"{d}.w_hh", p["w_hh"], (H, 3 * H), wdtype, device)
        _check(f"{d}.b_ih", p["b_ih"], (3 * H,), torch.float32, device)
        _check(f"{d}.b_hh", p["b_hh"], (3 * H,), torch.float32, device)
        args += [p["w_ih"].data_ptr(), p["w_hh"].data_ptr(),
                 p["b_ih"].data_ptr(), p["b_hh"].data_ptr()]
    return args


def _outputs(T: int, B: int, H: int, device) -> Outputs:
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=device)  # noqa: E731
    return e(T, B, H), e(T, B, H), e(B, H), e(B, H)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = get_lib().gru_window_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _cuda_device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {t.device}")
    return t.device


def window_design(H: int, B: int, fast: bool = False, design=None) -> str:
    """K1/K2's design at hidden size ``H`` and batch ``B``: ``"smem"`` where
    ``gru_window_smem.takes_smem_design`` holds, else ``"chain"``. ``design``
    forces one (tests, chip_smoke.py's comparison of the two); ``"smem"``
    raises where that rule does not hold."""
    from helen_tpu_torch.ops import gru_window_smem as gs

    fits = gs.takes_smem_design(H, B, fast)
    if design is None:
        return "smem" if fits else "chain"
    if design not in DESIGNS:
        raise ValueError(f"design {design!r} is not one of {DESIGNS}")
    if design == "smem" and not fits:
        raise ValueError(f"design 'smem' does not take H={H}, B={B}"
                         + (" in the fast tier" if fast else ""))
    return design


def _launch_in1(name: str, wdtype, image, start, T, h0_f, h0_b, layer,
                design=None) -> Outputs:
    dev = _cuda_device(image, name)
    if image.dtype != torch.uint8 or image.dim() != 3 or image.stride(2) != 1:
        raise ValueError(f"{name} takes a (B, L, F) uint8 image with unit feature stride")
    B, L, F = image.shape
    H = h0_f.shape[-1]
    if not (0 <= start and start + T <= L and 0 < H <= MAX_H):
        raise ValueError(f"window [{start}, {start + T}) of {L} columns, "
                         f"H={H} (max {MAX_H})")
    _check("h0_f", h0_f, (B, H), torch.float32, dev)
    _check("h0_b", h0_b, (B, H), torch.float32, dev)
    weights = _layer_args(layer, F, H, dev, wdtype)
    fast = wdtype != torch.float32
    if window_design(H, B, fast, design) == "smem":
        from helen_tpu_torch.ops import gru_window_smem as gs

        outs = gs.launch_rec(gs.launch_proj_in1(image, start, T, F, H, weights, dev, fast),
                             h0_f, h0_b, weights, dev, fast)
        launch_counts[name] += 1
        return outs
    outs = _outputs(T, B, H, dev)
    with torch.cuda.device(dev):
        err = getattr(get_lib(), name)(
            image.data_ptr(), image.stride(0), image.stride(1), start, F,
            h0_f.data_ptr(), h0_b.data_ptr(), *weights,
            *[o.data_ptr() for o in outs], T, B, H,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, name)
    launch_counts[name] += 1
    return outs


def _launch_in2(name: str, wdtype, xa, xb, h0_f, h0_b, layer, design=None) -> Outputs:
    dev = _cuda_device(xa, name)
    T, B, H = xa.shape
    if not 0 < H <= MAX_H:
        raise ValueError(f"H={H} exceeds the kernel's maximum {MAX_H}")
    _check("xa", xa, (T, B, H), torch.float32, dev)
    _check("xb", xb, (T, B, H), torch.float32, dev)
    _check("h0_f", h0_f, (B, H), torch.float32, dev)
    _check("h0_b", h0_b, (B, H), torch.float32, dev)
    weights = _layer_args(layer, 2 * H, H, dev, wdtype)
    fast = wdtype != torch.float32
    if window_design(H, B, fast, design) == "smem":
        from helen_tpu_torch.ops import gru_window_smem as gs

        outs = gs.launch_rec(gs.launch_proj_in2(xa, xb, weights, dev, fast), h0_f, h0_b,
                             weights, dev, fast)
        launch_counts[name] += 1
        return outs
    outs = _outputs(T, B, H, dev)
    with torch.cuda.device(dev):
        err = getattr(get_lib(), name)(
            xa.data_ptr(), xb.data_ptr(), h0_f.data_ptr(), h0_b.data_ptr(),
            *weights, *[o.data_ptr() for o in outs], T, B, H,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, name)
    launch_counts[name] += 1
    return outs


def bigru_window_in1(image: torch.Tensor, start: int, T: int,
                     h0_f: torch.Tensor, h0_b: torch.Tensor,
                     layer: Layer, design=None) -> Outputs:
    """K1: one bi-GRU layer over the window ``image[:, start:start+T]`` of a
    ``(B, L, F)`` uint8 image, in the design :func:`window_design` picks
    (``design`` forces one). See the module docstring."""
    if image.device.type == "cpu":
        return bigru_window_in1_plain(image, start, T, h0_f, h0_b, layer)
    return _launch_in1("bigru_window_in1", torch.float32, image, start, T, h0_f, h0_b,
                       layer, design)


def bigru_window_in2(xa: torch.Tensor, xb: torch.Tensor,
                     h0_f: torch.Tensor, h0_b: torch.Tensor,
                     layer: Layer, design=None) -> Outputs:
    """K2: one bi-GRU layer over the previous layer's halves ``xa``, ``xb``
    ``(T, B, H)``, in the design :func:`window_design` picks (``design``
    forces one). See the module docstring."""
    if xa.device.type == "cpu":
        return bigru_window_in2_plain(xa, xb, h0_f, h0_b, layer)
    return _launch_in2("bigru_window_in2", torch.float32, xa, xb, h0_f, h0_b, layer, design)


def bigru_window_in1_fast(image: torch.Tensor, start: int, T: int,
                          h0_f: torch.Tensor, h0_b: torch.Tensor,
                          layer: Layer, design=None) -> Outputs:
    """K1f: K1 in the fast tier, with the layer's bf16 ``w_ih``/``w_hh``, in
    the design :func:`window_design` picks (``design`` forces one). See the
    module docstring."""
    if image.device.type == "cpu":
        return bigru_window_in1_fast_plain(image, start, T, h0_f, h0_b, layer)
    return _launch_in1("bigru_window_in1_fast", torch.bfloat16, image, start, T, h0_f,
                       h0_b, layer, design)


def bigru_window_in2_fast(xa: torch.Tensor, xb: torch.Tensor,
                          h0_f: torch.Tensor, h0_b: torch.Tensor,
                          layer: Layer, design=None) -> Outputs:
    """K2f: K2 in the fast tier, with the layer's bf16 ``w_ih``/``w_hh``;
    the float32 halves are rounded to bf16 in the kernel. ``design`` as
    :func:`bigru_window_in1_fast`."""
    if xa.device.type == "cpu":
        return bigru_window_in2_fast_plain(xa, xb, h0_f, h0_b, layer)
    return _launch_in2("bigru_window_in2_fast", torch.bfloat16, xa, xb, h0_f, h0_b,
                       layer, design)
