"""Pass 2 of both training backwards, the weight cotangents of one window:
the hand-written CUDA kernels, their shape rule, their plain emulation and
their launch counters.

For each direction, over the window's N = T*B rows:

* ``[dW_ih; db_ih] = [x | 1]^T dxp`` (the in-projection route only;
  :func:`bigru_window_wgrad`, called by ``gru_window_bwd.bigru_window_bwd``,
  the port of helen_tpu's ``_bwd_kernel_ip``,
  ``helen_tpu/ops/gru_pallas_train.py:321``);
* ``[dW_hh; db_hh] = [h_prev | 1]^T [dxp_r | dxp_z | dhp_n]`` (both routes;
  :func:`bigru_window_xp_wgrad` alone is pass 2 of
  ``gru_window_xp_bwd.bigru_window_xp_bwd``, the port of ``_bwd_kernel``,
  ``:166``).

Two designs (:data:`DESIGNS`):

* ``"split"``, every default path: ``bigru_window_wgrad_split`` cuts N into
  slices of :data:`SLICE_ROWS` rows, a constant, and sums each (64 x 64
  output tile, slice, direction) on 3xTF32 tensor cores
  (``csrc/gru_window_wgrad.cu``); at more than one slice
  ``bigru_window_wgrad_sum`` adds the slices' partials, in slice order,
  from a scratch that the wrapper takes from torch's caching allocator on
  the current stream. The partition follows from the shape alone
  (:func:`wgrad_design`), so two launches, on any card, give the same bits;
* ``"tile32"``, forced only (``chip_smoke.py`` times the two in turns): the
  earlier ``bwd_wgrad_kernel`` (``csrc/gru_window_common.cuh``), one block
  per 32 x 32 tile summing all N rows in one order.

:func:`wgrad_split_plain` emulates the split design's partition in torch
ops (each slice's product, then the slices added in order); tests use it,
no path does. The plain versions the kernels are held to are
``gru_window_bwd.bigru_window_bwd_wgrad_plain`` and
``gru_window_xp_bwd.bigru_window_xp_bwd_wgrad_plain``. On a CPU tensor the
wrappers compute those and count nothing; on a CUDA tensor they launch the
kernels or raise.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from helen_tpu_torch.ops.gru_window import (
    MAX_H,
    Layer,
    _check,
    _cuda_device,
    _raise_on,
    get_lib,
)
from helen_tpu_torch.ops.gru_window_bwd import (
    KEYS,
    Source,
    _empty,
    _h_prev,
    bigru_window_bwd_wgrad_plain,
    source_args,
    window_input,
)

#: launches of each kernel since the last reset_launch_counts() — counted
#: where the kernel is launched and nowhere else
launch_counts: Dict[str, int] = {"bigru_window_wgrad_split": 0,
                                 "bigru_window_wgrad_sum": 0,
                                 # the forced earlier design
                                 "bigru_window_wgrad_tile32": 0}
DESIGNS = ("split", "tile32")
#: rows per slice (csrc/gru_window_wgrad.cu WS_SLICE_ROWS): 16 slices at the
#: flagship's B=256, 32 at B=512, 4 at the wide model's B=64
SLICE_ROWS = 1600
#: output rows x columns per block of the split kernel (WS_BM, WS_BN)
TILE = (64, 128)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


class WgradDesign(NamedTuple):
    """The split design at one shape."""
    tile: Tuple[int, int]   # output rows x columns per block
    slice_rows: int         # rows per slice
    slices: int             # S = ceil(T*B / slice_rows)
    rows: int               # output rows per direction: (D + 1 with_ih) + H + 1
    blocks: int             # tiles x slices x 2 directions
    scratch_bytes: int      # the (S, 2, rows, 3H) float32 partials, 0 at S = 1


def wgrad_design(D: int, H: int, T: int, B: int, with_ih: bool) -> WgradDesign:
    """The split design's partition at a shape, a fixed rule of the shape
    alone (no card property enters it): its tile, slices, blocks and
    scratch, as ``csrc/gru_window_wgrad.cu`` computes them."""
    bm, bn = TILE
    slices = -(-T * B // SLICE_ROWS)
    rows = (D + 1 if with_ih else 0) + H + 1
    col_tiles = -(-3 * H // bn)
    tiles = ((-(-(D + 1) // bm) if with_ih else 0) + -(-(H + 1) // bm)) * col_tiles
    scratch = 4 * slices * 2 * rows * 3 * H if slices > 1 else 0
    return WgradDesign(TILE, SLICE_ROWS, slices, rows, tiles * slices * 2, scratch)


# ---------------------------------------------------------------------------
# plain emulation of the partition (tests)
# ---------------------------------------------------------------------------

def _sliced(a: torch.Tensor, g: torch.Tensor, slice_rows: int):
    """``[a | 1]^T g`` as each slice's product added in slice order:
    (weight rows, bias row)."""
    a1 = torch.cat([a, torch.ones(a.shape[0], 1, dtype=a.dtype)], dim=1)
    total = None
    for n0 in range(0, a.shape[0], slice_rows):
        part = a1[n0:n0 + slice_rows].T @ g[n0:n0 + slice_rows]
        total = part if total is None else total + part
    return total[:-1], total[-1]


def wgrad_split_plain(src: Optional[Source], start: int, h0_f, h0_b, out_f, out_b,
                      dxp: torch.Tensor, dhpn: torch.Tensor,
                      slice_rows: int = SLICE_ROWS) -> Layer:
    """The split design's sums in torch ops: per direction each slice of
    ``slice_rows`` rows multiplied on its own, the slices added in order.
    ``src`` None is the xp form (``w_hh``, ``b_hh`` only)."""
    T, B, H = out_f.shape
    N = T * B
    grads: Layer = {}
    for i, (d, out, h0, rev) in enumerate((("fwd", out_f, h0_f, False),
                                           ("bwd", out_b, h0_b, True))):
        g_x = dxp[i].reshape(N, 3 * H)
        g_h = torch.cat([g_x[:, :2 * H], dhpn[i].reshape(N, H)], dim=-1)
        w_hh, b_hh = _sliced(_h_prev(out, h0, rev).reshape(N, H), g_h, slice_rows)
        grads[d] = {"w_hh": w_hh, "b_hh": b_hh}
        if src is not None:
            x = window_input(src, start, T, out_f.dtype).reshape(N, -1)
            grads[d]["w_ih"], grads[d]["b_ih"] = _sliced(x, g_x, slice_rows)
    return grads


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_design(design) -> str:
    if design is None:
        return "split"
    if design not in DESIGNS:
        raise ValueError(f"design {design!r} is not one of {DESIGNS}")
    return design


def _stream_args(h0_f, h0_b, out_f, out_b, dxp, dhpn, T, B, H, dev) -> list:
    for n, t, shape in (("h0_f", h0_f, (B, H)), ("h0_b", h0_b, (B, H)),
                        ("out_f", out_f, (T, B, H)), ("out_b", out_b, (T, B, H)),
                        ("dxp", dxp, (2, T, B, 3 * H)), ("dhpn", dhpn, (2, T, B, H))):
        _check(n, t, shape, torch.float32, dev)
    return [t.data_ptr() for t in (h0_f, h0_b, out_f, out_b, dxp, dhpn)]


def _split(entry, args: list, outs: list, D: int, with_ih: bool, T: int, B: int, H: int,
           dev) -> None:
    """The split kernel, then at more than one slice the slice sum; ``outs``
    are the eight output pointers (None where the form has none) in the
    library's order."""
    plan = wgrad_design(D, H, T, B, with_ih)
    part = (torch.empty(plan.scratch_bytes // 4, dtype=torch.float32, device=dev)
            if plan.slices > 1 else None)
    ptr = None if part is None else part.data_ptr()
    lib = get_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    mine = outs if with_ih else [outs[1], outs[3], outs[5], outs[7]]
    _raise_on(entry(*args, *mine, ptr, T, B, H, stream), "bigru_window_wgrad_split")
    launch_counts["bigru_window_wgrad_split"] += 1
    if part is not None:
        _raise_on(lib.bigru_window_wgrad_sum(ptr, D, int(with_ih), T, B, H, *outs, stream),
                  "bigru_window_wgrad_sum")
        launch_counts["bigru_window_wgrad_sum"] += 1


def bigru_window_wgrad(src: Source, start: int, h0_f, h0_b, out_f, out_b, dxp: torch.Tensor,
                       dhpn: torch.Tensor, design=None) -> Layer:
    """Pass 2 of the in-projection backward: ``{"fwd", "bwd"}`` of
    ``{"w_ih", "w_hh", "b_ih", "b_hh"}`` cotangents from the layer input
    ``src`` (the uint8 image read at column ``start``, or the pair), the
    forward's outputs and h0, and pass 1's ``dxp (2, T, B, 3H)`` and ``dhpn
    (2, T, B, H)``. ``design`` forces one of :data:`DESIGNS`."""
    design = _check_design(design)
    pair = isinstance(src, tuple)
    lead = src[0] if pair else src
    if lead.device.type == "cpu":
        return bigru_window_bwd_wgrad_plain(src, start, h0_f, h0_b, out_f, out_b, dxp, dhpn)
    dev = _cuda_device(lead, "bigru_window_wgrad")
    T, B, H = out_f.shape
    if not 0 < H <= MAX_H:
        raise ValueError(f"H={H} exceeds the in-projection backward's maximum {MAX_H}")
    img_args = source_args("bigru_window_wgrad", src, start, T, B, H, dev)
    D = img_args[-1]
    streams = _stream_args(h0_f, h0_b, out_f, out_b, dxp, dhpn, T, B, H, dev)
    grads = {d: {"w_ih": _empty(dev, D, 3 * H), "w_hh": _empty(dev, H, 3 * H),
                 "b_ih": _empty(dev, 3 * H), "b_hh": _empty(dev, 3 * H)}
             for d in ("fwd", "bwd")}
    outs = [grads[d][k].data_ptr() for d in ("fwd", "bwd") for k in KEYS]
    lib = get_lib()
    with torch.cuda.device(dev):
        if design == "tile32":
            _raise_on(lib.bigru_window_bwd_wgrad(
                *img_args, *streams, *outs, T, B, H, torch.cuda.current_stream(dev).cuda_stream),
                "bigru_window_wgrad_tile32")
            launch_counts["bigru_window_wgrad_tile32"] += 1
        else:
            _split(lib.bigru_window_wgrad_split_in, [*img_args, *streams], outs, D, True,
                   T, B, H, dev)
    return grads


def bigru_window_xp_wgrad(h0_f, h0_b, out_f, out_b, dxp: torch.Tensor, dhpn: torch.Tensor,
                          design=None) -> Layer:
    """Pass 2 of K4 (the xp route's backward): ``{"fwd", "bwd"}`` of
    ``{"w_hh", "b_hh"}`` cotangents. ``design`` forces one of
    :data:`DESIGNS`."""
    design = _check_design(design)
    if out_f.device.type == "cpu":
        from helen_tpu_torch.ops.gru_window_xp_bwd import bigru_window_xp_bwd_wgrad_plain

        return bigru_window_xp_bwd_wgrad_plain(h0_f, h0_b, out_f, out_b, dxp, dhpn)
    dev = _cuda_device(out_f, "bigru_window_xp_wgrad")
    if out_f.dim() != 3:
        raise ValueError(f"out_f must be (T, B, H), got {tuple(out_f.shape)}")
    T, B, H = out_f.shape
    streams = _stream_args(h0_f, h0_b, out_f, out_b, dxp, dhpn, T, B, H, dev)
    grads = {d: {"w_hh": _empty(dev, H, 3 * H), "b_hh": _empty(dev, 3 * H)}
             for d in ("fwd", "bwd")}
    hh = [grads[d][k].data_ptr() for d in ("fwd", "bwd") for k in ("w_hh", "b_hh")]
    lib = get_lib()
    with torch.cuda.device(dev):
        if design == "tile32":
            _raise_on(lib.bigru_window_xp_bwd_wgrad(
                *streams, *hh, T, B, H, torch.cuda.current_stream(dev).cuda_stream),
                "bigru_window_wgrad_tile32")
            launch_counts["bigru_window_wgrad_tile32"] += 1
        else:
            outs = [None, hh[0], None, hh[1], None, hh[2], None, hh[3]]
            _split(lib.bigru_window_wgrad_split_xp, streams, outs, 0, False, T, B, H, dev)
    return grads

