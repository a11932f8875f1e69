"""The GRU cell and its scan over time, in plain torch ops.

Port of helen_tpu/models/gru.py:54-79 — the standard (cuDNN/torch-compatible)
GRU cell with separate input and hidden biases and the reset gate applied to
the *projected* hidden state:

    r = sigmoid(W_ir x + b_ir + W_hr h + b_hr)
    z = sigmoid(W_iz x + b_iz + W_hz h + b_hz)
    n = tanh  (W_in x + b_in + r * (W_hn h + b_hn))
    h' = (1 - z) * n + z * h

Gate blocks are ordered [r, z, n] along the 3H axis, as in torch ``nn.GRU``
weights (stored here transposed, ``w_ih (D, 3H)``, ``w_hh (H, 3H)``, for
right-multiplication). The input projections are hoisted out of the scan;
only ``h @ w_hh`` stays inside it.

A bfloat16 ``w_hh`` selects the fast tier's cell, the plain counterpart of
helen_tpu's ``_gru_gates`` with ``w_lo is None`` (``ops/gru_pallas.py:190``):
the operand copy of h is rounded to bf16 (round-to-nearest-even), the
product of two bf16 values is exact in float32 and is summed there, and the
gates and the carried state stay float32 (``z * h`` reads the unrounded h).
No product here runs in bf16: a bf16 matmul would round its result. The
fast cell takes its sums in the order of the fast CUDA kernels' FMA chains
(:func:`ordered_product`) and spells out their gate arithmetic, so that on
the card kernel and plain version round h to bf16 alike: a sum taken in
another order can land an h one bf16 ulp (2^-8 relative) apart, which a
near-tie vote turns into a label flip.
"""
from __future__ import annotations

from typing import Tuple

import torch


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 (nearest even) and held in its own dtype: the
    fast tier's operand copy, as ``astype(jnp.bfloat16)`` makes it."""
    return x.to(torch.bfloat16).to(x.dtype)


def ordered_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the sum over k taken in order, k = 0, 1, ..., from 0:
    the order of the fast kernels' FMA chains. For bf16-valued operands each
    product ``x[..., k] * w[k]`` is exact in float32, so FMA, ``addcmul`` and
    multiply-then-add give the same bits and only the order of the sums
    matters. One launch per k: a plain version, not a fast one."""
    acc = x.new_zeros(x.shape[:-1] + (w.shape[-1],))
    for k in range(x.shape[-1]):
        acc.addcmul_(x[..., k:k + 1], w[k])
    return acc


def gru_cell(xp: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor,
             b_hh: torch.Tensor) -> torch.Tensor:
    """One step. ``xp`` (B, 3H) is ``x @ w_ih + b_ih``; returns h' (B, H).
    A bf16 ``w_hh`` runs the fast tier's cell (module docstring)."""
    H = h.shape[-1]
    if w_hh.dtype == torch.bfloat16:
        # the fast kernels' arithmetic, op for op: sigmoid as 1 / (1 + exp(-v)),
        # no fused multiply-add in the n gate or the blend
        hp = ordered_product(bf16_round(h), w_hh.to(h.dtype)) + b_hh
        r = torch.reciprocal(1.0 + torch.exp(-(xp[:, :H] + hp[:, :H])))
        z = torch.reciprocal(1.0 + torch.exp(-(xp[:, H:2 * H] + hp[:, H:2 * H])))
    else:
        hp = h @ w_hh + b_hh
        r = torch.sigmoid(xp[:, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, H:2 * H] + hp[:, H:2 * H])
    n = torch.tanh(xp[:, 2 * H:] + r * hp[:, 2 * H:])
    return (1.0 - z) * n + z * h


def gru_scan(xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor,
             b_hh: torch.Tensor, reverse: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan the recurrence over ``xp`` (T, B, 3H).

    :returns: (outputs (T, B, H) in original time order, final hidden
        (B, H)); ``reverse`` runs from t=T-1 down to 0, as
        ``lax.scan(reverse=True)`` does, so its final hidden is the state
        after time 0."""
    T = xp.shape[0]
    outs = [None] * T
    h = h0
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h = gru_cell(xp[t], h, w_hh, b_hh)
        outs[t] = h
    return torch.stack(outs), h

