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
near-tie vote turns into a label flip. K3f's grid design takes its sums on
bf16 tensor cores instead; :func:`mma_product` is that order and rounding.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


#: bf16 mma.sync.m16n8k16 on the H100: k per instruction, and the bits kept
#: below the largest term's 24 when the terms are aligned
MMA_K = 16
MMA_EXTRA_BITS = 3


def mma_product(x: torch.Tensor, w: torch.Tensor,
                acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w`` for bf16-valued float32 operands (``w`` (K, N), or
    batched (..., K, N)) in the order and rounding of a chain of bf16
    ``mma.sync.m16n8k16`` instructions with float32 accumulators, as K3f's
    grid design issues them: k in chunks of :data:`MMA_K` from k = 0, the
    accumulator from ``acc`` (default 0.0, as in the kernel). Each
    instruction adds its 16 exact products to the accumulator in one fused
    sum: every term is aligned to the largest term's scale, truncated
    toward zero to a multiple of 2^-(24 + MMA_EXTRA_BITS) of it, the
    truncated terms summed exactly and the sum truncated toward zero to
    float32. A product ``a * b`` counts at the scale ``2^(ea + eb)`` (``ea``,
    ``eb`` the exponents of ``torch.frexp``), the accumulator ``c`` at
    ``2^(ec + 1)``; a zero term takes no part. This model matched the
    H100's results bit for bit on random operands, chains of 1024 included
    (``python -m helen_tpu_torch.obs.mma_probe``). Scales below 2^-100 are
    taken as 2^-100 (float32 holds the unit 2^127 at most); a chunk of
    zeros adds 0. One pass per chunk: a plain version, not a fast one."""
    K = x.shape[-1]
    bits = 24 + MMA_EXTRA_BITS
    # a zero operand's product takes no part: its scale below any other
    xe = torch.where(x == 0, -1000, torch.frexp(x)[1])
    we = torch.where(w == 0, -1000, torch.frexp(w)[1])
    if acc is None:
        acc = x.new_zeros(torch.broadcast_shapes(x.shape[:-1], w.shape[:-2] + (1,))
                          + (w.shape[-1],))
    for k0 in range(0, K, MMA_K):
        top = (xe[..., k0:k0 + MMA_K, None] + we[..., None, k0:k0 + MMA_K, :]).amax(-2)
        top = torch.maximum(top, torch.where(acc == 0, -1000, torch.frexp(acc)[1] + 1))
        unit = torch.ldexp(torch.ones_like(acc), bits - top.clamp(min=-100))
        # the products of bf16 values, exact in float32, each a whole number
        # of units below 2^27 once truncated: the cast to int32 truncates
        terms = (x[..., k0:k0 + MMA_K, None] * w[..., None, k0:k0 + MMA_K, :]
                 * unit[..., None, :]).to(torch.int32).sum(-2)
        terms += (acc * unit).to(torch.int64)
        s = terms.to(torch.float64) / unit.double()
        acc = s.to(torch.float32)
        # nearest -> toward zero: one float32 step back where it rounded away
        away = acc.double().abs() > s.abs()
        acc = torch.where(away, (acc.view(torch.int32) - 1).view(torch.float32), acc)
    return acc


def gru_cell(xp: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor,
             b_hh: torch.Tensor, product=None) -> torch.Tensor:
    """One step. ``xp`` (B, 3H) is ``x @ w_ih + b_ih``; returns h' (B, H).
    A bf16 ``w_hh`` runs the fast tier's cell (module docstring), its step
    product ``product`` (default :func:`ordered_product`)."""
    H = h.shape[-1]
    if w_hh.dtype == torch.bfloat16:
        # the fast kernels' arithmetic, op for op: sigmoid as 1 / (1 + exp(-v)),
        # no fused multiply-add in the n gate or the blend
        hp = (product or ordered_product)(bf16_round(h), w_hh.to(h.dtype)) + b_hh
        r = torch.reciprocal(1.0 + torch.exp(-(xp[:, :H] + hp[:, :H])))
        z = torch.reciprocal(1.0 + torch.exp(-(xp[:, H:2 * H] + hp[:, H:2 * H])))
    else:
        hp = h @ w_hh + b_hh
        r = torch.sigmoid(xp[:, :H] + hp[:, :H])
        z = torch.sigmoid(xp[:, H:2 * H] + hp[:, H:2 * H])
    n = torch.tanh(xp[:, 2 * H:] + r * hp[:, 2 * H:])
    return (1.0 - z) * n + z * h


def gru_scan(xp: torch.Tensor, h0: torch.Tensor, w_hh: torch.Tensor,
             b_hh: torch.Tensor, reverse: bool = False, product=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan the recurrence over ``xp`` (T, B, 3H).

    :returns: (outputs (T, B, H) in original time order, final hidden
        (B, H)); ``reverse`` runs from t=T-1 down to 0, as
        ``lax.scan(reverse=True)`` does, so its final hidden is the state
        after time 0. ``product``: the fast cell's step product
        (:func:`gru_cell`)."""
    T = xp.shape[0]
    outs = [None] * T
    h = h0
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h = gru_cell(xp[t], h, w_hh, b_hh, product)
        outs[t] = h
    return torch.stack(outs), h

