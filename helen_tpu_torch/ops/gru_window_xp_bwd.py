"""The backward of the xp-stream bi-GRU window (K4): the hand-written CUDA
kernel, its plain version and its launch counters.

:func:`bigru_window_xp_bwd` is the port of helen_tpu's ``_bwd_kernel``
(``helen_tpu/ops/gru_pallas_train.py:166``), the backward of the training
window whose forward is K3 (``ops.gru_window_xp``). It returns the
cotangents of the projected streams, ``dxp`` ``(T, B, 3H)`` per direction,
of ``h0`` and of ``w_hh``/``b_hh``; the projection ``xp = x @ W_ih + b_ih``
and its cotangents stay in torch autograd around it. Its source is
``ops/csrc/gru_window_xp_bwd.cu``; it runs as two launches, each counted in
:data:`launch_counts`:

* ``bigru_window_xp_bwd_rec`` (pass 1): the recurrence, unwound in reverse
  per direction; recomputes the gates from xp and h_prev, carries dh, and
  writes ``dxp`` and the n block of ``dhp`` (scratch) and dh0;
* ``bigru_window_xp_bwd_wgrad`` (pass 2): dW_hh and db_hh as a tiled
  reduction over the window's T*B rows in one fixed order (the kernel of
  the in-projection backward's pass 2, without its W_ih half; no atomics:
  bit-identical across launches).

On a CPU tensor the wrapper computes the plain version (helen_tpu's
backward equations in torch ops); on a CUDA tensor it launches the kernels
or raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from helen_tpu_torch.ops.gru_window import (
    XP_MAX_H,
    Layer,
    _check,
    _cuda_device,
    _raise_on,
    get_lib,
)
from helen_tpu_torch.ops.gru_window_bwd import _h_prev, hh_grads_plain, unwind_plain
from helen_tpu_torch.ops.gru_window_xp import recurrent_args

#: (dxp_f (T, B, 3H), dxp_b (T, B, 3H), dh0_f, dh0_b,
#:  {"fwd", "bwd"} of {"w_hh", "b_hh"} cotangents)
XpGrads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Layer]

#: launches of each pass since the last reset_launch_counts() — counted
#: where the kernel is launched and nowhere else
launch_counts: Dict[str, int] = {"bigru_window_xp_bwd_rec": 0,
                                 "bigru_window_xp_bwd_wgrad": 0}


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
    res = [unwind_plain(xp, _h_prev(out, h0, rev), dout, dh, layer[d]["w_hh"],
                        layer[d]["b_hh"], rev)
           for d, xp, out, h0, dout, dh, rev in (
               ("fwd", xp_f, out_f, h0_f, dout_f, dh_f, False),
               ("bwd", xp_b, out_b, h0_b, dout_b, dh_b, True))]
    return (torch.stack([res[0][0], res[1][0]]), torch.stack([res[0][1], res[1][1]]),
            res[0][2], res[1][2])


def bigru_window_xp_bwd_wgrad_plain(h0_f, h0_b, out_f, out_b, dxp: torch.Tensor,
                                    dhpn: torch.Tensor) -> Layer:
    """Pass 2's plain version: ``dW_hh`` and ``db_hh`` per direction as
    sums over all T*B rows."""
    return {d: hh_grads_plain(dxp[i], dhpn[i], _h_prev(out, h0, rev))
            for i, (d, out, h0, rev) in enumerate((("fwd", out_f, h0_f, False),
                                                   ("bwd", out_b, h0_b, True)))}


def bigru_window_xp_bwd_plain(xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f, dout_b,
                              dh_f, dh_b, layer: Layer) -> XpGrads:
    """The backward in explicit torch ops: pass 1's then pass 2's plain
    version, with the kernel's outputs."""
    dxp, dhpn, dh0_f, dh0_b = bigru_window_xp_bwd_rec_plain(
        xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f, dout_b, dh_f, dh_b, layer)
    grads = bigru_window_xp_bwd_wgrad_plain(h0_f, h0_b, out_f, out_b, dxp, dhpn)
    return dxp[0], dxp[1], dh0_f, dh0_b, grads


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def bigru_window_xp_bwd(xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f, dout_b,
                        dh_f, dh_b, layer: Layer) -> XpGrads:
    """The backward of one xp-stream bi-GRU window layer (see the module
    docstring): pass 1 then pass 2 on the current stream."""
    if xp_f.device.type == "cpu":
        return bigru_window_xp_bwd_plain(xp_f, xp_b, h0_f, h0_b, out_f, out_b,
                                         dout_f, dout_b, dh_f, dh_b, layer)
    dev = _cuda_device(xp_f, "bigru_window_xp_bwd")
    if out_f.dim() != 3:
        raise ValueError(f"out_f must be (T, B, H), got {tuple(out_f.shape)}")
    T, B, H = out_f.shape
    if not 0 < H <= XP_MAX_H:
        raise ValueError(f"H={H} exceeds the xp-stream backward's maximum {XP_MAX_H}")
    for name, t, shape in (("xp_f", xp_f, (T, B, 3 * H)), ("xp_b", xp_b, (T, B, 3 * H)),
                           ("h0_f", h0_f, (B, H)), ("h0_b", h0_b, (B, H)),
                           ("out_f", out_f, (T, B, H)), ("out_b", out_b, (T, B, H)),
                           ("dout_f", dout_f, (T, B, H)), ("dout_b", dout_b, (T, B, H)),
                           ("dh_f", dh_f, (B, H)), ("dh_b", dh_b, (B, H))):
        _check(name, t, shape, torch.float32, dev)
    wh_f, bh_f, wh_b, bh_b = recurrent_args(layer, H, dev)
    # W_hh^T, read coalesced by the carry product (helen_tpu's wrapper makes
    # the same swapaxes copies, gru_pallas_train.py:542)
    whT = {d: layer[d]["w_hh"].T.contiguous() for d in ("fwd", "bwd")}
    e = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    dxp, dhpn = e(2, T, B, 3 * H), e(2, T, B, H)
    dh0_f, dh0_b = e(B, H), e(B, H)
    grads = {d: {"w_hh": e(H, 3 * H), "b_hh": e(3 * H)} for d in ("fwd", "bwd")}
    lib = get_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bigru_window_xp_bwd_rec(
            *(t.data_ptr() for t in (xp_f, xp_b, h0_f, h0_b, out_f, out_b, dout_f,
                                     dout_b, dh_f, dh_b)),
            wh_f, whT["fwd"].data_ptr(), bh_f, wh_b, whT["bwd"].data_ptr(), bh_b,
            dxp.data_ptr(), dhpn.data_ptr(), dh0_f.data_ptr(), dh0_b.data_ptr(),
            T, B, H, stream)
        _raise_on(err, "bigru_window_xp_bwd_rec")
        launch_counts["bigru_window_xp_bwd_rec"] += 1
        err = lib.bigru_window_xp_bwd_wgrad(
            *(t.data_ptr() for t in (h0_f, h0_b, out_f, out_b, dxp, dhpn)),
            *(grads[d][k].data_ptr() for d in ("fwd", "bwd") for k in ("w_hh", "b_hh")),
            T, B, H, stream)
        _raise_on(err, "bigru_window_xp_bwd_wgrad")
        launch_counts["bigru_window_xp_bwd_wgrad"] += 1
    return dxp[0], dxp[1], dh0_f, dh0_b, grads
