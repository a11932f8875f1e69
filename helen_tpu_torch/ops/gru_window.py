"""The bi-GRU window kernels of the consensus path: binding, launch counters
and plain versions.

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

The kernels are in the one kernel library (ops.library, which builds and
loads it); :func:`get_lib` is that module's, kept here for callers that
build the library before they run it.
"""
from __future__ import annotations

from ctypes import c_int as i, c_longlong as ll, c_void_p as p

import torch

from helen_tpu_torch.models.gru import bf16_round, ordered_product
from helen_tpu_torch.ops import gru_window_smem as gs
from helen_tpu_torch.ops import library
from helen_tpu_torch.ops.gru_window_smem import bidir, launch_counts
from helen_tpu_torch.ops.library import (
    Layer,
    Outputs,
    check,
    cuda_device,
    get_lib,
    layer_args,
    outputs,
    raise_on,
    stream,
)

#: the largest hidden size the in-projection kernels take (K1/K2 and their
#: backward: one thread per hidden unit, csrc/gru_window_common.cuh MAX_H)
MAX_H = 512
#: K1/K2's designs: "smem", the projection pass plus the recurrence with
#: W_hh in shared memory (ops.gru_window_smem); "chain", bigru_window_kernel
DESIGNS = ("smem", "chain")

_IN1 = (i, [p, ll, ll, i, i, p, p] + [p] * 8 + [p] * 4 + [i, i, i, p])
_IN2 = (i, [p] * 4 + [p] * 8 + [p] * 4 + [i, i, i, p])
#: the C entries of csrc/gru_window.cu: K1, K2 and their fast-tier
#: instantiations (the same arguments, bf16 weights)
ENTRIES = {"bigru_window_in1": _IN1, "bigru_window_in2": _IN2,
           "bigru_window_in1_fast": _IN1, "bigru_window_in2_fast": _IN2,
           "gru_window_max_h": (i, [])}


def check_fit(lib) -> None:
    """Raise where :data:`MAX_H` disagrees with the source's."""
    if lib.gru_window_max_h() != MAX_H:
        raise RuntimeError("MAX_H disagrees with csrc/gru_window.cu")


library.register(ENTRIES, check_fit)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU path, tests, and the on-card comparison)
# ---------------------------------------------------------------------------

def bigru_window_in1_plain(image: torch.Tensor, start: int, T: int,
                           h0_f: torch.Tensor, h0_b: torch.Tensor,
                           layer: Layer) -> Outputs:
    """K1's plain version: the window ``image[:, start:start+T]`` (uint8 or
    float) projected per direction, then the two ``gru_scan`` recurrences.
    It computes in the dtype of ``h0_f`` (float32 on every path; float64
    for the gradient checks)."""
    x = image[:, start:start + T].to(h0_f.dtype).transpose(0, 1)  # (T, B, F)
    f, b = layer["fwd"], layer["bwd"]
    return bidir(x @ f["w_ih"] + f["b_ih"], x @ b["w_ih"] + b["b_ih"],
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

    return bidir(proj(f), proj(b), h0_f, h0_b, layer)


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
    return bidir(ordered_product(x, f["w_ih"].to(x.dtype)) + f["b_ih"],
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
    return bidir(ordered_product(x, f["w_ih"].to(x.dtype)) + f["b_ih"],
                 ordered_product(x, b["w_ih"].to(x.dtype)) + b["b_ih"],
                 h0_f, h0_b, layer)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def window_design(H: int, B: int, fast: bool = False, design=None) -> str:
    """K1/K2's design at hidden size ``H`` and batch ``B``: ``"smem"`` where
    ``gru_window_smem.takes_smem_design`` holds, else ``"chain"``. ``design``
    forces one (tests, chip_smoke.py's comparison of the two); ``"smem"``
    raises where that rule does not hold."""
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
    dev = cuda_device(image, name)
    if image.dtype != torch.uint8 or image.dim() != 3 or image.stride(2) != 1:
        raise ValueError(f"{name} takes a (B, L, F) uint8 image with unit feature stride")
    B, L, F = image.shape
    H = h0_f.shape[-1]
    if not (0 <= start and start + T <= L and 0 < H <= MAX_H):
        raise ValueError(f"window [{start}, {start + T}) of {L} columns, "
                         f"H={H} (max {MAX_H})")
    check("h0_f", h0_f, (B, H), torch.float32, dev)
    check("h0_b", h0_b, (B, H), torch.float32, dev)
    weights = layer_args(layer, F, H, dev, wdtype)
    fast = wdtype != torch.float32
    if window_design(H, B, fast, design) == "smem":
        outs = gs.launch_rec(gs.launch_proj_in1(image, start, T, F, H, weights, dev, fast),
                             h0_f, h0_b, weights, dev, fast)
        launch_counts[name] += 1
        return outs
    outs = outputs(T, B, H, dev)
    with torch.cuda.device(dev):
        err = getattr(get_lib(), name)(
            image.data_ptr(), image.stride(0), image.stride(1), start, F,
            h0_f.data_ptr(), h0_b.data_ptr(), *weights,
            *[o.data_ptr() for o in outs], T, B, H, stream(dev))
    raise_on(err, name)
    launch_counts[name] += 1
    return outs


def _launch_in2(name: str, wdtype, xa, xb, h0_f, h0_b, layer, design=None) -> Outputs:
    dev = cuda_device(xa, name)
    T, B, H = xa.shape
    if not 0 < H <= MAX_H:
        raise ValueError(f"H={H} exceeds the kernel's maximum {MAX_H}")
    check("xa", xa, (T, B, H), torch.float32, dev)
    check("xb", xb, (T, B, H), torch.float32, dev)
    check("h0_f", h0_f, (B, H), torch.float32, dev)
    check("h0_b", h0_b, (B, H), torch.float32, dev)
    weights = layer_args(layer, 2 * H, H, dev, wdtype)
    fast = wdtype != torch.float32
    if window_design(H, B, fast, design) == "smem":
        outs = gs.launch_rec(gs.launch_proj_in2(xa, xb, weights, dev, fast), h0_f, h0_b,
                             weights, dev, fast)
        launch_counts[name] += 1
        return outs
    outs = outputs(T, B, H, dev)
    with torch.cuda.device(dev):
        err = getattr(get_lib(), name)(
            xa.data_ptr(), xb.data_ptr(), h0_f.data_ptr(), h0_b.data_ptr(),
            *weights, *[o.data_ptr() for o in outs], T, B, H, stream(dev))
    raise_on(err, name)
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
