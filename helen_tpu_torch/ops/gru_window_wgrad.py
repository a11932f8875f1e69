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

``bigru_window_wgrad_split`` cuts N into slices of :data:`SLICE_ROWS`
rows, a constant, and sums each (64 x 128 output tile, slice, direction) on
3xTF32 tensor cores (``csrc/gru_window_wgrad.cu``); at more than one slice
``bigru_window_wgrad_sum`` adds the slices' partials, in slice order, from
a scratch that the wrapper takes from torch's caching allocator on the
current stream. The partition follows from the shape alone
(:func:`wgrad_design`), so two launches, on any card, give the same bits.

:func:`wgrad_split_plain` emulates that partition in torch ops (each
slice's product, then the slices added in order); tests use it, no path
does. The plain versions the kernels are held to are
:func:`bigru_window_bwd_wgrad_plain` and
:func:`bigru_window_xp_bwd_wgrad_plain`, the plain pass 2 of each backward.
On a CPU tensor the wrappers compute those and count nothing; on a CUDA
tensor they launch the kernels or raise.
"""
from __future__ import annotations

from ctypes import c_int as i, c_longlong as ll, c_void_p as p
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from helen_tpu_torch.ops import library
from helen_tpu_torch.ops.gru_window import MAX_H
from helen_tpu_torch.ops.gru_window_bwd_smem import h_prev_of
from helen_tpu_torch.ops.gru_window_proj import Source, window_input
from helen_tpu_torch.ops.library import (
    KEYS,
    Layer,
    check,
    cuda_device,
    empty,
    get_lib,
    raise_on,
    stream,
)

#: launches of each kernel since the last reset_launch_counts() — counted
#: where the kernel is launched and nowhere else
launch_counts: Dict[str, int] = {"bigru_window_wgrad_split": 0,
                                 "bigru_window_wgrad_sum": 0}
#: rows per slice (csrc/gru_window_wgrad.cu WS_SLICE_ROWS): 16 slices at the
#: flagship's B=256, 32 at B=512, 4 at the wide model's B=64
SLICE_ROWS = 1600
#: output rows x columns per block of the split kernel (WS_BM, WS_BN)
TILE = (64, 128)
#: the C entries of csrc/gru_window_wgrad.cu: the split kernel in the
#: in-projection form (the layer input, the streams, the eight outputs) and
#: the xp form (the streams, dW_hh and db_hh), each with the partials'
#: scratch; the slice sum (the scratch, the shape, all outputs); the rule's
#: constants
ENTRIES = {"bigru_window_wgrad_split_in": (i, [p, ll, ll, i, p, p, i] + [p] * 6 + [p] * 8
                                           + [p] + [i, i, i, p]),
           "bigru_window_wgrad_split_xp": (i, [p] * 10 + [p] + [i, i, i, p]),
           "bigru_window_wgrad_sum": (i, [p] + [i] * 5 + [p] * 8 + [p]),
           "bigru_window_wgrad_slice_rows": (i, []),
           "bigru_window_wgrad_scratch_bytes": (ll, [i] * 5)}


def check_fit(lib) -> None:
    """Raise where :data:`SLICE_ROWS` disagrees with the source's."""
    if lib.bigru_window_wgrad_slice_rows() != SLICE_ROWS:
        raise RuntimeError("SLICE_ROWS disagrees with csrc/gru_window_wgrad.cu")


library.register(ENTRIES, check_fit)


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
# plain versions (CPU path, tests, and the on-card comparison)
# ---------------------------------------------------------------------------

def hh_grads_plain(dxp: torch.Tensor, dhpn: torch.Tensor,
                   h_prev: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One direction's ``dW_hh = h_prev^T dhp`` and ``db_hh = sum dhp`` over
    the window's T*B rows, ``dhp = [dxp_r | dxp_z | dhp_n]``."""
    H = dhpn.shape[-1]
    g_x = dxp.reshape(-1, 3 * H)
    g_h = torch.cat([g_x[:, :2 * H], dhpn.reshape(-1, H)], dim=-1)
    return {"w_hh": h_prev.reshape(-1, H).T @ g_h, "b_hh": g_h.sum(dim=0)}


def bigru_window_bwd_wgrad_plain(src: Source, start: int, h0_f, h0_b, out_f, out_b,
                                 dxp: torch.Tensor, dhpn: torch.Tensor) -> Layer:
    """Pass 2's plain version in the in-projection backward
    (ops.gru_window_bwd): the weight cotangents as sums over all T*B rows,
    ``dW_ih = x^T dxp``, ``db_ih = sum dxp`` and :func:`hh_grads_plain`."""
    T, B, H = out_f.shape
    x = window_input(src, start, T, out_f.dtype).reshape(T * B, -1)
    grads: Layer = {}
    for k, (d, out, h0, rev) in enumerate((("fwd", out_f, h0_f, False),
                                           ("bwd", out_b, h0_b, True))):
        g_x = dxp[k].reshape(T * B, 3 * H)
        grads[d] = {"w_ih": x.T @ g_x, "b_ih": g_x.sum(dim=0),
                    **hh_grads_plain(dxp[k], dhpn[k], h_prev_of(out, h0, rev))}
    return grads


def bigru_window_xp_bwd_wgrad_plain(h0_f, h0_b, out_f, out_b, dxp: torch.Tensor,
                                    dhpn: torch.Tensor) -> Layer:
    """Pass 2's plain version in the xp route's backward
    (ops.gru_window_xp_bwd): ``dW_hh`` and ``db_hh`` per direction as sums
    over all T*B rows."""
    return {d: hh_grads_plain(dxp[k], dhpn[k], h_prev_of(out, h0, rev))
            for k, (d, out, h0, rev) in enumerate((("fwd", out_f, h0_f, False),
                                                   ("bwd", out_b, h0_b, True)))}


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
    for k, (d, out, h0, rev) in enumerate((("fwd", out_f, h0_f, False),
                                           ("bwd", out_b, h0_b, True))):
        g_x = dxp[k].reshape(N, 3 * H)
        g_h = torch.cat([g_x[:, :2 * H], dhpn[k].reshape(N, H)], dim=-1)
        w_hh, b_hh = _sliced(h_prev_of(out, h0, rev).reshape(N, H), g_h, slice_rows)
        grads[d] = {"w_hh": w_hh, "b_hh": b_hh}
        if src is not None:
            x = window_input(src, start, T, out_f.dtype).reshape(N, -1)
            grads[d]["w_ih"], grads[d]["b_ih"] = _sliced(x, g_x, slice_rows)
    return grads


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def source_args(name: str, src: Source, start: int, T: int, B: int, H: int, dev) -> list:
    """The checked layer input as the kernel library takes it: ``[img, sb,
    sl, start, xa, xb, D]`` (the image's pointer and element strides, or the
    pair's pointers, and the input width)."""
    if isinstance(src, tuple):
        xa, xb = src
        check("xa", xa, (T, B, H), torch.float32, dev)
        check("xb", xb, (T, B, H), torch.float32, dev)
        return [None, 0, 0, 0, xa.data_ptr(), xb.data_ptr(), 2 * H]
    if src.dtype != torch.uint8 or src.dim() != 3 or src.stride(2) != 1:
        raise ValueError(f"{name} takes a (B, L, F) uint8 image with unit feature "
                         "stride, or an (xa, xb) pair")
    Bi, L, D = src.shape
    if Bi != B or not (0 <= start and start + T <= L):
        raise ValueError(f"window [{start}, {start + T}) of a {tuple(src.shape)} "
                         f"image for outputs of {(T, B, H)}")
    return [src.data_ptr(), src.stride(0), src.stride(1), start, None, None, D]


def _stream_args(h0_f, h0_b, out_f, out_b, dxp, dhpn, T, B, H, dev) -> list:
    for n, t, shape in (("h0_f", h0_f, (B, H)), ("h0_b", h0_b, (B, H)),
                        ("out_f", out_f, (T, B, H)), ("out_b", out_b, (T, B, H)),
                        ("dxp", dxp, (2, T, B, 3 * H)), ("dhpn", dhpn, (2, T, B, H))):
        check(n, t, shape, torch.float32, dev)
    return [t.data_ptr() for t in (h0_f, h0_b, out_f, out_b, dxp, dhpn)]


def _split(entry: str, args: list, outs: list, D: int, with_ih: bool, T: int, B: int, H: int,
           dev) -> None:
    """The split kernel ``entry``, then at more than one slice the slice sum;
    ``outs`` are the eight output pointers (None where the form has none) in the
    library's order."""
    plan = wgrad_design(D, H, T, B, with_ih)
    part = empty(dev, plan.scratch_bytes // 4) if plan.slices > 1 else None
    ptr = None if part is None else part.data_ptr()
    lib = get_lib()
    handle = stream(dev)
    mine = outs if with_ih else [outs[1], outs[3], outs[5], outs[7]]
    raise_on(getattr(lib, entry)(*args, *mine, ptr, T, B, H, handle),
             "bigru_window_wgrad_split")
    launch_counts["bigru_window_wgrad_split"] += 1
    if part is not None:
        raise_on(lib.bigru_window_wgrad_sum(ptr, D, int(with_ih), T, B, H, *outs, handle),
                 "bigru_window_wgrad_sum")
        launch_counts["bigru_window_wgrad_sum"] += 1


def bigru_window_wgrad(src: Source, start: int, h0_f, h0_b, out_f, out_b, dxp: torch.Tensor,
                       dhpn: torch.Tensor) -> Layer:
    """Pass 2 of the in-projection backward: ``{"fwd", "bwd"}`` of
    ``{"w_ih", "w_hh", "b_ih", "b_hh"}`` cotangents from the layer input
    ``src`` (the uint8 image read at column ``start``, or the pair), the
    forward's outputs and h0, and pass 1's ``dxp (2, T, B, 3H)`` and ``dhpn
    (2, T, B, H)``."""
    pair = isinstance(src, tuple)
    lead = src[0] if pair else src
    if lead.device.type == "cpu":
        return bigru_window_bwd_wgrad_plain(src, start, h0_f, h0_b, out_f, out_b, dxp, dhpn)
    dev = cuda_device(lead, "bigru_window_wgrad")
    T, B, H = out_f.shape
    if not 0 < H <= MAX_H:
        raise ValueError(f"H={H} exceeds the in-projection backward's maximum {MAX_H}")
    img_args = source_args("bigru_window_wgrad", src, start, T, B, H, dev)
    D = img_args[-1]
    streams = _stream_args(h0_f, h0_b, out_f, out_b, dxp, dhpn, T, B, H, dev)
    grads = {d: {"w_ih": empty(dev, D, 3 * H), "w_hh": empty(dev, H, 3 * H),
                 "b_ih": empty(dev, 3 * H), "b_hh": empty(dev, 3 * H)}
             for d in ("fwd", "bwd")}
    outs = [grads[d][k].data_ptr() for d in ("fwd", "bwd") for k in KEYS]
    with torch.cuda.device(dev):
        _split("bigru_window_wgrad_split_in", [*img_args, *streams], outs, D, True, T, B, H,
               dev)
    return grads


def bigru_window_xp_wgrad(h0_f, h0_b, out_f, out_b, dxp: torch.Tensor,
                          dhpn: torch.Tensor) -> Layer:
    """Pass 2 of K4 (the xp route's backward): ``{"fwd", "bwd"}`` of
    ``{"w_hh", "b_hh"}`` cotangents."""
    if out_f.device.type == "cpu":
        return bigru_window_xp_bwd_wgrad_plain(h0_f, h0_b, out_f, out_b, dxp, dhpn)
    dev = cuda_device(out_f, "bigru_window_xp_wgrad")
    if out_f.dim() != 3:
        raise ValueError(f"out_f must be (T, B, H), got {tuple(out_f.shape)}")
    T, B, H = out_f.shape
    streams = _stream_args(h0_f, h0_b, out_f, out_b, dxp, dhpn, T, B, H, dev)
    grads = {d: {"w_hh": empty(dev, H, 3 * H), "b_hh": empty(dev, 3 * H)}
             for d in ("fwd", "bwd")}
    hh = [grads[d][k].data_ptr() for d in ("fwd", "bwd") for k in ("w_hh", "b_hh")]
    outs = [None, hh[0], None, hh[1], None, hh[2], None, hh[3]]
    with torch.cuda.device(dev):
        _split("bigru_window_wgrad_split_xp", streams, outs, 0, False, T, B, H, dev)
    return grads
