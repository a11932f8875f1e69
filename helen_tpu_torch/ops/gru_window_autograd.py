"""Differentiable bi-GRU window layers: the ports of helen_tpu's
``_window_core_ip`` and ``_window_core``
(``helen_tpu/ops/gru_pallas_train.py:663`` and ``:698``, the
``jax.custom_vjp``s around its two families of training kernels).

The in-projection route (H <= MAX_H), one ``torch.autograd.Function`` per
layer kind:

* :func:`window_in1` — layer 0 of the encoder: forward K1
  (``gru_window.bigru_window_in1``) on the uint8 image window, read in
  place; backward :func:`gru_window_bwd.bigru_window_bwd` with dx off (the
  image is data);
* :func:`window_in2` — every later layer: forward K2 on the previous
  layer's ``(out_f, out_b)`` halves; the backward returns their cotangents.

The xp route (the wide models, H > MAX_H), :func:`window_xp` for both
layer kinds: ``_XpProjection``, the projection ``xp = x @ W_ih + b_ih`` of
both directions (forward ``gru_window_proj.bigru_window_xp_proj``, one
launch reading the layer's input where it lies; backward dx, dW_ih and
db_ih on ``torch.matmul``, the ops torch's autograd of ``x @ w + b`` runs),
then ``_XpWindow``: forward K3 (``gru_window_xp.bigru_window_xp``), backward
K4 (``gru_window_xp_bwd.bigru_window_xp_bwd``).

Each Function saves its inputs, the forward's ``out_f``/``out_b`` and the
weights, and nothing else: the backward recomputes the gates. On CPU
tensors the wrappers compute the plain versions, forward and backward; on
CUDA tensors they launch the kernels or raise. Under ``torch.no_grad()``
(evaluation, consensus) only the forward runs.
"""
from __future__ import annotations

from typing import List

import torch

from helen_tpu_torch.ops.gru_window import bigru_window_in1, bigru_window_in2
from helen_tpu_torch.ops.gru_window_bwd import bigru_window_bwd
from helen_tpu_torch.ops.gru_window_proj import Source, bigru_window_xp_proj, window_input
from helen_tpu_torch.ops.gru_window_xp import bigru_window_xp
from helen_tpu_torch.ops.gru_window_xp_bwd import bigru_window_xp_bwd
from helen_tpu_torch.ops.library import KEYS, Layer, Outputs


def flat_layer(layer: Layer) -> List[torch.Tensor]:
    return [layer[d][k] for d in ("fwd", "bwd") for k in KEYS]


def tree_layer(ws) -> Layer:
    return {d: dict(zip(KEYS, ws[4 * i:4 * i + 4]))
            for i, d in enumerate(("fwd", "bwd"))}


def _cotangents(outs, grads):
    """Output cotangents, contiguous, with zeros where an output got none
    (the carried final state of the decoder, whose use is detached)."""
    return [torch.zeros_like(o) if g is None else g.contiguous()
            for o, g in zip(outs, grads)]


class _ImageWindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, image, start, T, h0_f, h0_b, *ws):
        outs = bigru_window_in1(image, start, T, h0_f, h0_b, tree_layer(ws))
        ctx.start = start
        ctx.save_for_backward(image, h0_f, h0_b, outs[0], outs[1], *ws)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        image, h0_f, h0_b, out_f, out_b, *ws = ctx.saved_tensors
        cts = _cotangents((out_f, out_b, h0_f, h0_b), grads)
        _, dh0_f, dh0_b, g = bigru_window_bwd(
            image, ctx.start, h0_f, h0_b, out_f, out_b, *cts, tree_layer(ws),
            need_dx=False)
        return (None, None, None, dh0_f, dh0_b, *flat_layer(g))


class _PairWindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xa, xb, h0_f, h0_b, *ws):
        outs = bigru_window_in2(xa, xb, h0_f, h0_b, tree_layer(ws))
        ctx.save_for_backward(xa, xb, h0_f, h0_b, outs[0], outs[1], *ws)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        xa, xb, h0_f, h0_b, out_f, out_b, *ws = ctx.saved_tensors
        cts = _cotangents((out_f, out_b, h0_f, h0_b), grads)
        dx, dh0_f, dh0_b, g = bigru_window_bwd(
            (xa, xb), 0, h0_f, h0_b, out_f, out_b, *cts, tree_layer(ws),
            need_dx=True)
        H = xa.shape[-1]
        return (dx[..., :H], dx[..., H:], dh0_f, dh0_b, *flat_layer(g))


def window_in1(image: torch.Tensor, start: int, T: int, h0_f: torch.Tensor,
               h0_b: torch.Tensor, layer: Layer) -> Outputs:
    """Differentiable K1: ``bigru_window_in1``'s arguments and outputs."""
    return _ImageWindow.apply(image, start, T, h0_f, h0_b, *flat_layer(layer))


def window_in2(xa: torch.Tensor, xb: torch.Tensor, h0_f: torch.Tensor,
               h0_b: torch.Tensor, layer: Layer) -> Outputs:
    """Differentiable K2: ``bigru_window_in2``'s arguments and outputs."""
    return _PairWindow.apply(xa, xb, h0_f, h0_b, *flat_layer(layer))


def _recurrent(w_hh_f, b_hh_f, w_hh_b, b_hh_b) -> Layer:
    return {"fwd": {"w_hh": w_hh_f, "b_hh": b_hh_f},
            "bwd": {"w_hh": w_hh_b, "b_hh": b_hh_b}}


class _XpWindow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp_f, xp_b, h0_f, h0_b, w_hh_f, b_hh_f, w_hh_b, b_hh_b):
        ws = (w_hh_f, b_hh_f, w_hh_b, b_hh_b)
        outs = bigru_window_xp(xp_f, xp_b, h0_f, h0_b, _recurrent(*ws))
        ctx.save_for_backward(xp_f, xp_b, h0_f, h0_b, outs[0], outs[1], *ws)
        return outs

    @staticmethod
    def backward(ctx, *grads):
        xp_f, xp_b, h0_f, h0_b, out_f, out_b, *ws = ctx.saved_tensors
        cts = _cotangents((out_f, out_b, h0_f, h0_b), grads)
        dxp_f, dxp_b, dh0_f, dh0_b, g = bigru_window_xp_bwd(
            xp_f, xp_b, h0_f, h0_b, out_f, out_b, *cts, _recurrent(*ws))
        return (dxp_f, dxp_b, dh0_f, dh0_b, g["fwd"]["w_hh"], g["fwd"]["b_hh"],
                g["bwd"]["w_hh"], g["bwd"]["b_hh"])


class _XpProjection(torch.autograd.Function):
    """Both directions' ``x @ w_ih + b_ih`` of the layer's input ``src``
    (the image, or the pair ``(xa, xb)``). The backward takes the steps
    torch's autograd takes for that expression, so on the CPU it gives its
    bits: ``dW = x2.t().mm(g)``, ``dx2 = g.mm(w.t())`` per direction (``x2``,
    ``g``: the input and the cotangent folded to 2-D), the two dx added,
    ``db = g.sum_to_size(b)``; the pair's x made again by
    ``gru_window_proj.window_input``'s cat."""

    @staticmethod
    def forward(ctx, start, T, dtype, xa, xb, w_f, b_f, w_b, b_b):
        src = xa if xb is None else (xa, xb)
        layer = {"fwd": {"w_ih": w_f, "b_ih": b_f}, "bwd": {"w_ih": w_b, "b_ih": b_b}}
        ctx.start, ctx.T, ctx.dtype, ctx.pair = start, T, dtype, xb is not None
        ctx.save_for_backward(xa, xb, w_f, w_b)
        return bigru_window_xp_proj(src, start, T, layer, dtype)

    @staticmethod
    def backward(ctx, dxp_f, dxp_b):
        xa, xb, w_f, w_b = ctx.saved_tensors
        x = window_input((xa, xb) if ctx.pair else xa, ctx.start, ctx.T, ctx.dtype)
        x2 = x.reshape(-1, x.shape[-1])
        g_f = dxp_f.reshape(-1, dxp_f.shape[-1])
        g_b = dxp_b.reshape(-1, dxp_b.shape[-1])
        need = ctx.needs_input_grad
        dxa = dxb = None
        if need[3] or need[4]:
            dx = g_f.mm(w_f.t()).reshape(x.shape) + g_b.mm(w_b.t()).reshape(x.shape)
            if ctx.pair:
                H = xa.shape[-1]
                dxa, dxb = dx[..., :H], dx[..., H:]
            else:  # a float image read at columns [start, start + T)
                dxa = torch.zeros_like(xa)
                dxa[:, ctx.start:ctx.start + ctx.T] = dx.transpose(0, 1).to(xa.dtype)
        dims = dxp_f.shape[-1:]
        return (None, None, None, dxa, dxb,
                x2.t().mm(g_f) if need[5] else None,
                dxp_f.sum_to_size(dims) if need[6] else None,
                x2.t().mm(g_b) if need[7] else None,
                dxp_b.sum_to_size(dims) if need[8] else None)


def window_xp(src: Source, start: int, T: int, h0_f: torch.Tensor,
              h0_b: torch.Tensor, layer: Layer) -> Outputs:
    """One bi-GRU layer over one window on the xp route, differentiable:
    ``_XpProjection`` of the layer's input (the uint8 image window, exact in
    float32, or the previous layer's halves), then K3 (backward K4).
    ``src``, ``start``, ``T`` as in :func:`gru_window_bwd.bigru_window_bwd`;
    returns ``(out_f, out_b, h_f, h_b)``."""
    f, b = layer["fwd"], layer["bwd"]
    xa, xb = src if isinstance(src, tuple) else (src, None)
    xp_f, xp_b = _XpProjection.apply(start, T, h0_f.dtype, xa, xb, f["w_ih"], f["b_ih"],
                                     b["w_ih"], b["b_ih"])
    return _XpWindow.apply(xp_f, xp_b, h0_f, h0_b, f["w_hh"], f["b_hh"], b["w_hh"],
                           b["b_hh"])
