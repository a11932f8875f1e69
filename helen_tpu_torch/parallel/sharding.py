"""Data x tensor parallel training over a ("data", "model") mesh of one
process's devices (port of helen_tpu/parallel/sharding.py's train step).

Parallelism mapping for the transducer, as helen_tpu's GSPMD layout:

  * **data parallel**: each batch's rows split over the "data" axis; every
    data shard runs the same model shards, and the gradient of each shard
    is summed over the data shards by autograd (the copies of a param on
    the data shards' devices are differentiable);
  * **tensor (model) parallel**: each GRU layer's gate axis is split into
    whole hidden units per model shard (the r, z and n gates of the same
    units together: ``w_ih``/``w_hh`` columns, ``b_ih``/``b_hh``), and the
    heads on their 2H input (rows of ``w``; the bias held by shard 0). A
    shard computes its units' gates from the layer input and the WHOLE
    previous hidden state, so h is gathered across the shards at every
    step; the heads' partial products are summed.

The recurrence is the plain one (``models.gru.gru_cell``'s arithmetic, one
step at a time), as helen_tpu's runs ``lax.scan``: a whole-window kernel
cannot exchange h between shards in mid-window (helen_tpu logs "backend
%r ignored" for the same reason). For a model this small the split is for
correctness and scale testing, not speed.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from helen_tpu_torch.config import TRAIN, WINDOW
from helen_tpu_torch.models.transducer import Params, _stack_layers, param_leaves
from helen_tpu_torch.parallel.mesh import Mesh
from helen_tpu_torch.train.loss import (
    masked_cross_entropy_parts,
    masked_weighted_cross_entropy_parts,
)

_GATE_LEAVES = ("w_ih", "w_hh", "b_ih", "b_hh")
_HEADS = ("base_head", "rle_head")


def unit_slices(hidden_size: int, model_parallel: int) -> List[Tuple[int, int]]:
    """Each model shard's hidden units ``[a, b)``: ``hidden_size`` split as
    evenly as whole units allow."""
    bounds = np.linspace(0, hidden_size, model_parallel + 1).round().astype(int)
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def _gate_index(a: int, b: int, h: int) -> torch.Tensor:
    """Columns of units [a, b) in each of the r, z, n blocks of a 3H axis."""
    u = torch.arange(a, b)
    return torch.cat([u, h + u, 2 * h + u])


def _head_index(a: int, b: int, h: int) -> torch.Tensor:
    """Rows of units [a, b) in both halves of a 2H head input."""
    u = torch.arange(a, b)
    return torch.cat([u, h + u])


def _map(tree, fn, path=()):
    """``fn(path, leaf)`` over a param tree; a None result drops the leaf."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            r = _map(v, fn, path + (k,))
            if r is not None:
                out[k] = r
        return out
    return fn(path, tree)


def shard_params(mesh: Mesh, params: Params) -> Dict[str, Params]:
    """Split a param tree (or an Adam moment tree of its shape) into the
    mesh's model shards, ``{"shard<m>": tree}``, shard m's leaves on the
    device of mesh cell (0, m) as new leaf tensors."""
    h = int(params["encoder"]["fwd"]["w_hh"].shape[0])
    slices = unit_slices(h, mesh.shape["model"])

    def take(m):
        a, b = slices[m]
        dev = mesh.devices[0][m]

        def fn(path, t):
            name = path[-1]
            if name in ("w_ih", "w_hh"):
                t = t[:, _gate_index(a, b, h)]
            elif name in ("b_ih", "b_hh"):
                t = t[_gate_index(a, b, h)]
            elif path[0] in _HEADS and name == "w":
                t = t[_head_index(a, b, h)]
            elif path[0] in _HEADS and name == "b" and m:
                return None  # the heads' bias lives in shard 0
            return t.detach().to(dev).clone()

        return _map(params, fn)

    return {f"shard{m}": take(m) for m in range(len(slices))}


def unshard_params(mesh: Mesh, shards: Dict[str, Params], device) -> Params:
    """The whole tree of :func:`shard_params`' shards, on ``device``."""
    mp = mesh.shape["model"]
    parts = [shards[f"shard{m}"] for m in range(mp)]
    h = sum(int(p["encoder"]["fwd"]["w_hh"].shape[1]) for p in parts) // 3
    slices = unit_slices(h, mp)

    def fn(path, t0):
        name = path[-1]
        if path[0] in _HEADS and name == "b":
            return t0.detach().to(device).clone()
        pieces = []
        for p in parts:
            t = p
            for k in path:
                t = t[k]
            pieces.append(t.detach().to(device))
        rows = path[0] in _HEADS
        shape = ((2 * h,) + tuple(t0.shape[1:]) if rows
                 else (t0.shape[0], 3 * h) if t0.dim() == 2 else (3 * h,))
        full = torch.empty(shape, dtype=t0.dtype, device=device)
        for (a, b), piece in zip(slices, pieces):
            if rows:
                full[_head_index(a, b, h).to(device)] = piece
            elif t0.dim() == 2:
                full[:, _gate_index(a, b, h).to(device)] = piece
            else:
                full[_gate_index(a, b, h).to(device)] = piece
        return full

    return _map(parts[0], fn)


def _to(tree, device):
    """A differentiable copy of a shard's tree on ``device`` (the same
    tensors where it already lies there)."""
    return _map(tree, lambda _, t: t.to(device))


def _bigru(x: torch.Tensor, h0: Tuple[torch.Tensor, torch.Tensor], layers: Sequence[Params],
           slices, devs) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One bi-GRU layer split over the model shards: ``x`` (T, B, D) and the
    whole h0 pair on ``devs[0]``; ``layers[m]`` is shard m's ``{"fwd",
    "bwd"}`` on ``devs[m]``. Returns (out_f, out_b (T, B, H), h_f, h_b) on
    ``devs[0]``."""
    T = x.shape[0]
    res = []
    for d, h, rev in (("fwd", h0[0], False), ("bwd", h0[1], True)):
        xps = [x.to(dev) @ lp[d]["w_ih"] + lp[d]["b_ih"] for lp, dev in zip(layers, devs)]
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if rev else range(T)):
            parts = []
            for (a, b), lp, dev, xp in zip(slices, layers, devs, xps):
                u = b - a
                hm = h.to(dev)
                hp = hm @ lp[d]["w_hh"] + lp[d]["b_hh"]
                r = torch.sigmoid(xp[t][:, :u] + hp[:, :u])
                z = torch.sigmoid(xp[t][:, u:2 * u] + hp[:, u:2 * u])
                n = torch.tanh(xp[t][:, 2 * u:] + r * hp[:, 2 * u:])
                parts.append(((1.0 - z) * n + z * hm[:, a:b]).to(devs[0]))
            h = torch.cat(parts, dim=-1)  # the gather: every shard's units
            outs[t] = h
        res.append((torch.stack(outs), h))
    return res[0][0], res[1][0], res[0][1], res[1][1]


def sharded_forward(shards: Sequence[Params], slices, devs, images: torch.Tensor,
                    hidden: torch.Tensor, start: int, window: int):
    """One window of the transducer (``models.transducer.forward``) for one
    data shard over its row of the mesh: ``shards[m]`` on ``devs[m]``,
    ``images`` (B, L, F) and ``hidden`` (B, 2L, H) on ``devs[0]``. Returns
    (base logits (B, W, nb), rle logits (B, W, nr), new hidden)."""
    enc = list(zip(*[_stack_layers(s["encoder"]) for s in shards]))
    dec = list(zip(*[_stack_layers(s["decoder"]) for s in shards]))
    x = images[:, start:start + window].to(torch.float32).transpose(0, 1)
    finals = []
    for li, layer in enumerate(enc):
        of, ob, hf, hb = _bigru(x, (hidden[:, 2 * li], hidden[:, 2 * li + 1]), layer,
                                slices, devs)
        finals.append((hf, hb))
        x = torch.cat([of, ob], dim=-1)
    dec_finals = []
    for li, layer in enumerate(dec):
        of, ob, hf, hb = _bigru(x, finals[li], layer, slices, devs)
        dec_finals.append((hf, hb))
        x = torch.cat([of, ob], dim=-1)
    h = x.shape[-1] // 2
    logits = []
    for head in _HEADS:
        acc = None
        for (a, b), s, dev in zip(slices, shards, devs):
            part = (x.to(dev)[..., _head_index(a, b, h).to(dev)] @ s[head]["w"]).to(devs[0])
            acc = part if acc is None else acc + part
        logits.append((acc + shards[0][head]["b"]).transpose(0, 1))
    new_hidden = torch.stack([t for pair in dec_finals for t in pair], dim=1)
    return logits[0], logits[1], new_hidden


def sharded_tbptt_step(mesh: Mesh, sharded: Dict[str, Params], adam, opt_state: Dict,
                       lr: float, images: torch.Tensor, label_base: torch.Tensor,
                       label_rle: torch.Tensor, valid: int):
    """One batch of truncated BPTT over the mesh (``train_loop.tbptt_step``
    split as the module docstring says): ``sharded`` from
    :func:`shard_params`, updated in place with ``opt_state`` (Adam over
    its leaves, elementwise, so it equals the whole tree's step).
    ``images`` and the labels hold the whole batch, its rows a multiple of
    the data axis; each data shard takes its block of rows. Returns device
    scalars (loss sum, base loss sum, rle loss sum) over the windows."""
    dp, mp = mesh.shape["data"], mesh.shape["model"]
    B, L, _ = images.shape
    if B % dp:
        raise ValueError(f"batch of {B} rows does not split over {dp} data shards")
    W = WINDOW.window
    shards = [sharded[f"shard{m}"] for m in range(mp)]
    h = sum(int(s["encoder"]["fwd"]["w_hh"].shape[1]) for s in shards) // 3
    layers = len(_stack_layers(shards[0]["encoder"]))
    slices = unit_slices(h, mp)
    root = mesh.devices[0][0]
    leaves = param_leaves(sharded)
    rows = B // dp
    row_mask = (torch.arange(B) < valid).to(torch.float32)
    data = []
    for d in range(dp):
        dev = mesh.devices[d][0]
        sl = slice(d * rows, (d + 1) * rows)
        data.append((images[sl].to(dev), label_base[sl].to(dev), label_rle[sl].to(dev),
                     row_mask[sl].to(dev),
                     torch.tensor(TRAIN.rle_class_weights, dtype=torch.float32, device=dev)))
    hidden = [torch.zeros(rows, 2 * layers, h, device=mesh.devices[d][0]) for d in range(dp)]
    tot, tot_b, tot_r = (torch.zeros((), device=root) for _ in range(3))
    for start in WINDOW.starts(L):
        num_b = den_b = num_r = den_r = None
        new_hidden = []
        for d in range(dp):
            devs = list(mesh.devices[d])
            imgs, yb, yr, mask, rle_w = data[d]
            base, rle, hid = sharded_forward([_to(s, dev) for s, dev in zip(shards, devs)],
                                             slices, devs, imgs, hidden[d], start, W)
            nb, db = masked_cross_entropy_parts(base, yb[:, start:start + W], mask)
            nr, dr = masked_weighted_cross_entropy_parts(rle, yr[:, start:start + W], rle_w,
                                                         mask)
            parts = [v.to(root) for v in (nb, db, nr, dr)]
            if num_b is None:
                num_b, den_b, num_r, den_r = parts
            else:
                num_b, den_b, num_r, den_r = (p + q for p, q in
                                              zip((num_b, den_b, num_r, den_r), parts))
            new_hidden.append(hid)
        lb = num_b / torch.clamp(den_b, min=1.0)
        lr_ = num_r / torch.clamp(den_r, min=1e-12)
        loss = lb + lr_
        grads = torch.autograd.grad(loss, leaves)
        adam.update(leaves, grads, opt_state, lr)
        hidden = [t.detach() for t in new_hidden]
        tot = tot + loss.detach()
        tot_b = tot_b + lb.detach()
        tot_r = tot_r + lr_.detach()
    return tot, tot_b, tot_r
