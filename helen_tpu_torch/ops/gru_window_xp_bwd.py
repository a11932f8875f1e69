"""The backward of the xp-stream bi-GRU window (K4): the hand-written CUDA
kernels, their plain version and their launch counters.

:func:`bigru_window_xp_bwd` is the port of helen_tpu's ``_bwd_kernel``
(``helen_tpu/ops/gru_pallas_train.py:166``), the backward of the training
window whose forward is K3 (``ops.gru_window_xp``). It returns the
cotangents of the projected streams, ``dxp`` ``(T, B, 3H)`` per direction,
of ``h0`` and of ``w_hh``/``b_hh``; the projection ``xp = x @ W_ih + b_ih``
and its cotangents stay outside it (ops.gru_window_autograd
``_XpProjection``: ops.gru_window_proj forward, torch.matmul backward). It runs as two
passes, each counted once per layer-window in :data:`launch_counts`:

* ``bigru_window_xp_bwd_rec`` (pass 1, :func:`bigru_window_xp_bwd_rec`):
  the recurrence, unwound in reverse per direction; recomputes the gates
  from xp and h_prev, carries dh, and writes ``dxp`` and the n block of
  ``dhp`` (scratch) and dh0. It has two designs, picked by a fixed rule of
  the shape and the card (:func:`xp_bwd_design`):

  - ``"grid"`` (ops.gru_window_xp_bwd_grid), where ``W_hh`` spread over the
    card's SMs fits their shared memory (every width of the xp route on the
    H100): the gate pass ``bigru_window_bwd_hp`` (``h_prev @ W_hh`` over the
    whole window, ``csrc/gru_window_bwd_smem.cu``; counted here as
    ``bigru_window_xp_bwd_hp``), then the grid-wide recurrence
    ``bigru_window_xp_bwd_rec_grid`` (``csrc/gru_window_xp_bwd_grid.cu``,
    counted under its tile too, ``_grid_r2`` or ``_grid_r4``);
  - ``"chain"``, elsewhere: one launch of ``xp_bwd_rec_kernel``
    (``csrc/gru_window_xp_bwd.cu``, counted as
    ``bigru_window_xp_bwd_rec_chain``, and under its rows per block,
    ``_chain_r8`` ... ``_r1``), the gate recompute inside
    the serial loop,
    at the largest of 8, 4, 2 and 1 batch rows per block whose state fits
    the card's opt-in shared memory (:func:`bwd_chain_rows`).

  Both take every sum in the same order and the same cotangent lines, so
  they give the same bits;
* ``bigru_window_xp_bwd_wgrad`` (pass 2, ops.gru_window_wgrad): dW_hh and
  db_hh as a split-N reduction on 3xTF32 tensor cores, then the slices
  added in a fixed order (the in-projection backward's pass 2 without its
  W_ih half; no atomics: bit-identical across launches).

On a CPU tensor the wrapper computes the plain version (helen_tpu's
backward equations in torch ops); on a CUDA tensor it launches the kernels
or raises.
"""
from __future__ import annotations

from ctypes import c_int as i, c_longlong as ll, c_void_p as p
from typing import Dict, Optional, Tuple

import torch

from helen_tpu_torch.ops import gru_window_bwd_smem as gbs
from helen_tpu_torch.ops import gru_window_xp_bwd_grid as gg
from helen_tpu_torch.ops import library
from helen_tpu_torch.ops.gru_window_bwd import unwind_plain
from helen_tpu_torch.ops.gru_window_bwd_smem import RecOutputs, h_prev_of
from helen_tpu_torch.ops.gru_window_wgrad import (
    bigru_window_xp_bwd_wgrad_plain,
    bigru_window_xp_wgrad,
)
from helen_tpu_torch.ops.gru_window_xp import CHAIN_ROWS, recurrent_args
from helen_tpu_torch.ops.library import (
    Layer,
    card_limits,
    check,
    cuda_device,
    empty,
    get_lib,
    raise_on,
    stream,
)

#: (dxp_f (T, B, 3H), dxp_b (T, B, 3H), dh0_f, dh0_b,
#:  {"fwd", "bwd"} of {"w_hh", "b_hh"} cotangents)
XpGrads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Layer]

#: launches of each pass since the last reset_launch_counts() — counted
#: where the kernel is launched and nowhere else
launch_counts: Dict[str, int] = {"bigru_window_xp_bwd_rec": 0,
                                 "bigru_window_xp_bwd_wgrad": 0,
                                 # pass 1's kernels: the grid design's two
                                 "bigru_window_xp_bwd_hp": 0,
                                 "bigru_window_xp_bwd_rec_grid": 0,
                                 # its launches by rows per thread
                                 **{f"bigru_window_xp_bwd_rec_grid_r{r}": 0
                                    for r in gg.GRID_TILES},
                                 # and the one-launch design
                                 "bigru_window_xp_bwd_rec_chain": 0,
                                 # its launches by rows per block
                                 **{f"bigru_window_xp_bwd_rec_chain_r{r}": 0
                                    for r in CHAIN_ROWS}}
#: pass 1's designs (see xp_bwd_design)
DESIGNS = ("grid", "chain")


def bwd_chain_smem_bytes(h: int, rows: int) -> int:
    """Dynamic shared memory of one block of ``xp_bwd_rec_kernel`` at hidden
    size ``h`` and ``rows`` batch rows per block: the step's h_prev rows,
    its dhp rows (3h) and the dh carry, float32;
    csrc/gru_window_xp_bwd.cu ``xp_bwd_chain_smem``."""
    return 4 * 5 * rows * h


def bwd_chain_rows(h: int, budget: int) -> Optional[int]:
    """Pass 1's chain rows per block at hidden size ``h`` under ``budget``
    bytes of opt-in shared memory per block: the largest of ``CHAIN_ROWS``
    whose :func:`bwd_chain_smem_bytes` fits, else None. On the H100
    (232,448 bytes): 8 up to H=1,452, 4 at H=2048."""
    return next((r for r in CHAIN_ROWS if bwd_chain_smem_bytes(h, r) <= budget), None)


#: the C entries of csrc/gru_window_xp_bwd.cu: pass 1's one-launch design
#: (the streams, h0, the forward's outputs, the cotangents, W_hh, W_hh^T and
#: b_hh per direction, the outputs) and its shared memory
ENTRIES = {"bigru_window_xp_bwd_rec": (i, [p] * 20 + [i, i, i, i, p]),
           "bigru_window_xp_bwd_chain_smem_bytes": (ll, [i, i])}


def check_fit(lib) -> None:
    """Raise where :func:`bwd_chain_smem_bytes` disagrees with the source's."""
    if any(lib.bigru_window_xp_bwd_chain_smem_bytes(h, r) != bwd_chain_smem_bytes(h, r)
           for h in (640, 1056, 2048) for r in CHAIN_ROWS):
        raise RuntimeError("bwd_chain_smem_bytes disagrees with csrc/gru_window_xp_bwd.cu")


library.register(ENTRIES, check_fit)


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# ---------------------------------------------------------------------------
# plain version (CPU path, tests, and the on-card comparison)
# ---------------------------------------------------------------------------

def bigru_window_xp_bwd_rec_plain(xp_f, xp_b, h0_f, h0_b, out_f, out_b,
                                  dout_f, dout_b, dh_f, dh_b, layer: Layer):
    """Pass 1's plain version: :func:`~gru_window_bwd.unwind_plain` per
    direction.

    :returns: (dxp (2, T, B, 3H), dhp_n (2, T, B, H), dh0_f, dh0_b)"""
    res = [unwind_plain(xp, h_prev_of(out, h0, rev), dout, dh, layer[d]["w_hh"],
                        layer[d]["b_hh"], rev)
           for d, xp, out, h0, dout, dh, rev in (
               ("fwd", xp_f, out_f, h0_f, dout_f, dh_f, False),
               ("bwd", xp_b, out_b, h0_b, dout_b, dh_b, True))]
    return (torch.stack([res[0][0], res[1][0]]), torch.stack([res[0][1], res[1][1]]),
            res[0][2], res[1][2])


def bigru_window_xp_bwd_plain(xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f, dout_b,
                              dh_f, dh_b, layer: Layer) -> XpGrads:
    """The backward in explicit torch ops: pass 1's then pass 2's plain
    version, with the kernel's outputs."""
    dxp, dhpn, dh0_f, dh0_b = bigru_window_xp_bwd_rec_plain(
        xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b, layer)
    grads = bigru_window_xp_bwd_wgrad_plain(h0_f, h0_b, out_f, out_b, dxp, dhpn)
    return dxp[0], dxp[1], dh0_f, dh0_b, grads


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def xp_bwd_design(H: int, B: int, design=None, device=None) -> str:
    """Pass 1's design at hidden size ``H`` and batch ``B``: ``"grid"`` where
    ``gru_window_xp_bwd_grid.grid_units`` finds a slice of ``W_hh`` per SM
    that fits (co-residency of the ``2 ceil(H / U)`` blocks at the card's
    SM count, the shared memory at its opt-in limit, both read once per
    device: ``device``, default the current one), else ``"chain"``,
    ``xp_bwd_rec_kernel``. The grid takes
    any B (its blocks loop over rows); the chain runs :func:`bwd_chain_rows`
    rows per block. A fixed rule of the shape and the card, not a fallback.
    ``design`` forces one (tests, chip_smoke.py's comparison of the two); a
    design the card cannot hold raises, and so does a width whose chain
    state does not fit the card at one row."""
    if design is not None and design not in DESIGNS:
        raise ValueError(f"design {design!r} is not one of {DESIGNS}")
    sms, budget = card_limits(device)
    fits = gg.grid_units(H, sms, budget) is not None
    if design is None:
        design = "grid" if fits else "chain"
    if design == "grid" and not fits:
        raise ValueError(f"design 'grid' does not take H={H}, B={B}: W_hh spread over {sms} "
                         f"SMs does not fit {budget} bytes of shared memory per block")
    if design == "chain" and bwd_chain_rows(H, budget) is None:
        raise ValueError(f"hidden_size {H} exceeds the xp backward kernel's maximum on this "
                         f"card: one row of its state does not fit {budget} bytes of shared "
                         "memory per block; use --backend torch")
    return design


class _Window:
    """The checked arguments of one layer-window's K4 launches."""

    def __init__(self, name: str, xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f, dout_b,
                 dh_f, dh_b, layer: Layer):
        dev = self.dev = cuda_device(xp_f, name)
        if out_f.dim() != 3:
            raise ValueError(f"out_f must be (T, B, H), got {tuple(out_f.shape)}")
        T, B, H = self.T, self.B, self.H = out_f.shape
        for n, t, shape in (("xp_f", xp_f, (T, B, 3 * H)), ("xp_b", xp_b, (T, B, 3 * H)),
                            ("h0_f", h0_f, (B, H)), ("h0_b", h0_b, (B, H)),
                            ("out_f", out_f, (T, B, H)), ("out_b", out_b, (T, B, H)),
                            ("dout_f", dout_f, (T, B, H)), ("dout_b", dout_b, (T, B, H)),
                            ("dh_f", dh_f, (B, H)), ("dh_b", dh_b, (B, H))):
            check(n, t, shape, torch.float32, dev)
        self.w = recurrent_args(layer, H, dev)  # checks, and [w_hh_f, b_hh_f, w_hh_b, b_hh_b]


def _rec_chain(a: _Window, xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f,
               dh_b, layer: Layer) -> RecOutputs:
    """Pass 1 as one launch of xp_bwd_rec_kernel (gru_window_xp_bwd.cu)."""
    T, B, H, dev = a.T, a.B, a.H, a.dev
    wh_f, bh_f, wh_b, bh_b = a.w
    # W_hh^T, read coalesced by the carry product (helen_tpu's wrapper makes
    # the same swapaxes copies, gru_pallas_train.py:542)
    whT = {d: layer[d]["w_hh"].T.contiguous() for d in ("fwd", "bwd")}
    dxp, dhpn = empty(dev, 2, T, B, 3 * H), empty(dev, 2, T, B, H)
    dh0_f, dh0_b = empty(dev, B, H), empty(dev, B, H)
    rows = bwd_chain_rows(H, card_limits(dev)[1])
    with torch.cuda.device(dev):
        err = get_lib().bigru_window_xp_bwd_rec(
            *(t.data_ptr() for t in (xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f,
                                     dout_b, dh_f, dh_b)),
            wh_f, whT["fwd"].data_ptr(), bh_f, wh_b, whT["bwd"].data_ptr(), bh_b,
            dxp.data_ptr(), dhpn.data_ptr(), dh0_f.data_ptr(), dh0_b.data_ptr(),
            T, B, H, rows, stream(dev))
    raise_on(err, "bigru_window_xp_bwd_rec")
    launch_counts["bigru_window_xp_bwd_rec_chain"] += 1
    launch_counts[f"bigru_window_xp_bwd_rec_chain_r{rows}"] += 1
    return dxp, dhpn, dh0_f, dh0_b


def _rec_grid(a: _Window, xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f,
              dh_b, layer: Layer) -> RecOutputs:
    """Pass 1 as the gate pass (the hp product) and the grid-wide recurrence
    (ops.gru_window_xp_bwd_grid)."""
    hp = gbs.launch_hp(h0_f, h0_b, out_f, out_b, layer["fwd"]["w_hh"], layer["bwd"]["w_hh"],
                       a.dev, launch_counts, "bigru_window_xp_bwd_hp")
    res = gg.launch_rec_grid(xp_f, xp_b, hp, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f,
                             dh_b, layer, gg.grid_units(a.H, *card_limits(a.dev)),
                             launch_counts, a.dev)
    del hp  # 2 x 78.6 MB at B=64, H=1024 back to the allocator
    return res


def _rec(a: _Window, design, *args) -> RecOutputs:
    """Pass 1 in the design :func:`xp_bwd_design` picks, counted once."""
    if xp_bwd_design(a.H, a.B, design, a.dev) == "grid":
        res = _rec_grid(a, *args)
    else:
        res = _rec_chain(a, *args)
    launch_counts["bigru_window_xp_bwd_rec"] += 1
    return res


def bigru_window_xp_bwd_rec(xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f, dout_b,
                            dh_f, dh_b, layer: Layer, design=None) -> RecOutputs:
    """Pass 1 alone, in the design :func:`xp_bwd_design` picks (``design``
    forces one): the outputs of :func:`bigru_window_xp_bwd_rec_plain`,
    ``(dxp, dhp_n, dh0_f, dh0_b)``."""
    args = (xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b, layer)
    if xp_f.device.type == "cpu":
        return bigru_window_xp_bwd_rec_plain(*args)
    return _rec(_Window("bigru_window_xp_bwd_rec", *args), design, *args)


def bigru_window_xp_bwd_rec_grid(xp_f, xp_b, hp, h0_f, h0_b, out_f, out_b, dout_f, dout_b,
                                 dh_f, dh_b, layer: Layer) -> RecOutputs:
    """The grid recurrence alone (ops.gru_window_xp_bwd_grid), over ``xp``
    per direction and the gate pass's ``hp`` ``(2, T, B, 3H)``: ``(dxp,
    dhp_n, dh0_f, dh0_b)``, counted in :data:`launch_counts`. Raises where
    ``gru_window_xp_bwd_grid.grid_units`` finds no fit on the card."""
    args = (h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b)
    if xp_f.device.type == "cpu":
        return gg.xp_bwd_rec_grid_plain(xp_f, xp_b, hp, *args, layer)
    a = _Window("bigru_window_xp_bwd_rec_grid", xp_f, xp_b, *args, layer)
    check("hp", hp, (2, a.T, a.B, 3 * a.H), torch.float32, a.dev)
    xp_bwd_design(a.H, a.B, "grid", a.dev)  # raises where the rule does not hold
    return gg.launch_rec_grid(xp_f, xp_b, hp, *args, layer,
                              gg.grid_units(a.H, *card_limits(a.dev)), launch_counts, a.dev)


def bigru_window_xp_bwd(xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f, dout_b,
                        dh_f, dh_b, layer: Layer, design=None) -> XpGrads:
    """The backward of one xp-stream bi-GRU window layer (see the module
    docstring): pass 1, in the design :func:`xp_bwd_design` picks
    (``design`` forces one), then pass 2,
    ``gru_window_wgrad.bigru_window_xp_wgrad``, on the current stream."""
    args = (xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b, layer)
    if xp_f.device.type == "cpu":
        return bigru_window_xp_bwd_plain(*args)
    a = _Window("bigru_window_xp_bwd", *args)
    dxp, dhpn, dh0_f, dh0_b = _rec(a, design, *args)
    grads = bigru_window_xp_wgrad(h0_f, h0_b, out_f, out_b, dxp, dhpn)
    launch_counts["bigru_window_xp_bwd_wgrad"] += 1
    return dxp[0], dxp[1], dh0_f, dh0_b, grads
