"""The xp-stream bi-GRU window kernel (K3): binding, launch counter and
plain version.

:func:`bigru_window_xp` runs the recurrence of one bi-GRU layer over one
window whose input projection ``xp = x @ W_ih + b_ih`` was computed outside
(one large matrix product per direction). It is the port of helen_tpu's
``_kernel`` (``helen_tpu/ops/gru_pallas.py:231``, the inference form) and
``_fwd_kernel`` (``helen_tpu/ops/gru_pallas_train.py:119``, the training
forward), which compute the same function; its source is
``ops/csrc/gru_window_xp.cu``, built into the one kernel library with the
other window kernels (``gru_window.build_kernels``). It serves the wide
models, ``MAX_H < H <= XP_MAX_H``, whose weights the in-projection kernels
K1/K2 do not take.

The wrapper takes ``xp_f``, ``xp_b`` ``(T, B, 3H)`` float32, ``h0_f``,
``h0_b`` ``(B, H)`` and the layer's ``{"fwd", "bwd"}`` params (``w_hh
(H, 3H)``, ``b_hh (3H,)``; ``b_hh`` goes inside the reset product, the other
keys are not read) and returns ``(out_f (T, B, H), out_b (T, B, H), h_f
(B, H), h_b (B, H))``, outputs in original time order. On a CPU tensor it
computes its plain version (the two ``gru_scan`` recurrences); on a CUDA
tensor it launches the kernel or raises. Each launch adds one to
:data:`launch_counts`.
"""
from __future__ import annotations

from typing import Dict

import torch

from helen_tpu_torch.ops.gru_window import (
    XP_MAX_H,
    Layer,
    Outputs,
    _bidir,
    _check,
    _cuda_device,
    _outputs,
    _raise_on,
    get_lib,
)

#: launches since the last reset_launch_counts() — counted where the kernel
#: is launched and nowhere else
launch_counts: Dict[str, int] = {"bigru_window_xp": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def bigru_window_xp_plain(xp_f: torch.Tensor, xp_b: torch.Tensor,
                          h0_f: torch.Tensor, h0_b: torch.Tensor,
                          layer: Layer) -> Outputs:
    """K3's plain version: ``gru_scan`` forward over ``xp_f`` and reversed
    over ``xp_b``."""
    return _bidir(xp_f, xp_b, h0_f, h0_b, layer)


def recurrent_args(layer: Layer, H: int, device) -> list:
    """Checked pointers of ``[w_hh_f, b_hh_f, w_hh_b, b_hh_b]``."""
    args = []
    for d in ("fwd", "bwd"):
        p = layer[d]
        _check(f"{d}.w_hh", p["w_hh"], (H, 3 * H), torch.float32, device)
        _check(f"{d}.b_hh", p["b_hh"], (3 * H,), torch.float32, device)
        args += [p["w_hh"].data_ptr(), p["b_hh"].data_ptr()]
    return args


def bigru_window_xp(xp_f: torch.Tensor, xp_b: torch.Tensor,
                    h0_f: torch.Tensor, h0_b: torch.Tensor,
                    layer: Layer) -> Outputs:
    """K3: the bi-GRU recurrence over the projected streams. See the
    module docstring."""
    if xp_f.device.type == "cpu":
        return bigru_window_xp_plain(xp_f, xp_b, h0_f, h0_b, layer)
    dev = _cuda_device(xp_f, "bigru_window_xp")
    if xp_f.dim() != 3 or xp_f.shape[-1] % 3:
        raise ValueError(f"xp_f must be (T, B, 3H), got {tuple(xp_f.shape)}")
    T, B, H3 = xp_f.shape
    H = H3 // 3
    if not 0 < H <= XP_MAX_H:
        raise ValueError(f"H={H} exceeds the xp-stream kernel's maximum {XP_MAX_H}")
    _check("xp_f", xp_f, (T, B, H3), torch.float32, dev)
    _check("xp_b", xp_b, (T, B, H3), torch.float32, dev)
    _check("h0_f", h0_f, (B, H), torch.float32, dev)
    _check("h0_b", h0_b, (B, H), torch.float32, dev)
    weights = recurrent_args(layer, H, dev)
    outs = _outputs(T, B, H, dev)
    lib = get_lib()
    with torch.cuda.device(dev):
        err = lib.bigru_window_xp(
            xp_f.data_ptr(), xp_b.data_ptr(), h0_f.data_ptr(), h0_b.data_ptr(),
            *weights, *[o.data_ptr() for o in outs], T, B, H,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "bigru_window_xp")
    launch_counts["bigru_window_xp"] += 1
    return outs
