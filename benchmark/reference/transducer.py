"""HELEN's transducer in plain PyTorch: the reference that decides `correct`.

HELEN v0.0.23 (`helen/modules/python/models/TransducerModel.py:43-79`,
`Options.py:24-29`, `train.py:144-250`): a bidirectional GRU encoder over
the image window, a bidirectional GRU decoder over the encoder's outputs,
seeded with the encoder's final states, and two linear heads (base, run
length) on the decoder's outputs. A 1000-column image is read as 19 windows
of 100 columns at stride 50; the decoder's final states seed the next
window's encoder; each column's class probabilities are the sum of the
softmaxes of the windows that cover it, and the label is their argmax.
Training is truncated BPTT: each window is one Adam step (b1 0.9, b2 0.999,
eps 1e-8, lr 1e-4) on mean cross-entropy (base) plus class-weighted
cross-entropy (run length), the hidden state carried detached.

The GRU cell is torch's ``nn.GRU`` cell, gates ordered [r, z, n], the reset
gate on the projected hidden state. Weights are stored transposed for
right-multiplication: ``w_ih (D, 3H)``, ``w_hh (H, 3H)``. The parameter tree
is the benchmark's own layout (``lib.data.param_specs``).

Every product runs through :func:`matmul`, in float32 with TF32 off
(``precision="fp32"``) or, for the control that must fail the comparison,
with both operands rounded to TF32's 10-bit mantissa, as TF32 tensor cores
take them, forward and backward (``precision="tf32"``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

#: the run-length head's class weights (HELEN ``Options.py:29``)
RLE_CLASS_WEIGHTS = (0.3, 0.5, 0.5, 0.5, 0.5, 0.8, 0.9, 1.0, 1.0, 1.0, 0.9)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

Tree = Dict[str, object]


def fp32_only() -> None:
    """True float32 products on the card (torch would otherwise be free to
    use TF32 for them)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest value with a 10-bit mantissa,
    ties to even: the operand TF32 tensor cores multiply."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, in both passes."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = tf32_round(g)
        return rg @ rb.transpose(-1, -2), ra.transpose(-1, -2) @ rg


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """``a @ b`` (no broadcasting between batch dimensions)."""
    if precision == "fp32":
        return a @ b
    if precision == "tf32":
        return _TF32Product.apply(a, b)
    raise ValueError(f"precision must be 'fp32' or 'tf32', got {precision!r}")


def bigru(x: torch.Tensor, h0: torch.Tensor, layer: Tree, precision: str
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One bidirectional GRU layer over ``x`` (T, B, D).

    :param h0: (2, B, H), forward direction first
    :returns: outputs (T, B, 2H) (forward half first) and final states
        (2, B, H); the backward direction's final state is its state after
        time 0
    """
    T, B, D = x.shape
    f, b = layer["fwd"], layer["bwd"]
    H = f["w_hh"].shape[0]
    flat = x.reshape(T * B, D)
    xp_f = (matmul(flat, f["w_ih"], precision) + f["b_ih"]).view(T, B, 3 * H)
    xp_b = (matmul(flat, b["w_ih"], precision) + b["b_ih"]).view(T, B, 3 * H)
    # step s takes time s forward and time T-1-s backward
    xp = torch.stack([xp_f, xp_b.flip(0)], dim=1)  # (T, 2, B, 3H)
    w_hh = torch.stack([f["w_hh"], b["w_hh"]])  # (2, H, 3H)
    b_hh = torch.stack([f["b_hh"], b["b_hh"]])[:, None]  # (2, 1, 3H)
    h = h0
    outs: List[torch.Tensor] = []
    for s in range(T):
        hp = matmul(h, w_hh, precision) + b_hh
        g = xp[s]
        r = torch.sigmoid(g[..., :H] + hp[..., :H])
        z = torch.sigmoid(g[..., H:2 * H] + hp[..., H:2 * H])
        n = torch.tanh(g[..., 2 * H:] + r * hp[..., 2 * H:])
        h = (1.0 - z) * n + z * h
        outs.append(h)
    out_f = torch.stack([o[0] for o in outs])
    out_b = torch.stack([o[1] for o in reversed(outs)])
    return torch.cat([out_f, out_b], dim=-1), h


def _layers(stack: Tree) -> List[Tree]:
    layers = [{"fwd": stack["fwd"], "bwd": stack["bwd"]}]
    while f"l{len(layers)}" in stack:
        layers.append(stack[f"l{len(layers)}"])
    return layers


def window(params: Tree, x: torch.Tensor, hidden: torch.Tensor, precision: str
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One window of the transducer.

    :param x: (B, W, F) float32 window of the image
    :param hidden: (B, 2L, H) carried state, layer-major (slot 2l is layer
        l's forward direction)
    :returns: base logits (B, W, nb), run-length logits (B, W, nr), the new
        hidden (B, 2L, H): the decoder's final states
    """
    seq = x.transpose(0, 1)
    enc_finals = []
    for li, layer in enumerate(_layers(params["encoder"])):
        seq, hn = bigru(seq, hidden[:, 2 * li:2 * li + 2].transpose(0, 1), layer, precision)
        enc_finals.append(hn)
    dec_finals = []
    for li, layer in enumerate(_layers(params["decoder"])):
        seq, hn = bigru(seq, enc_finals[li], layer, precision)
        dec_finals.append(hn)
    T, B, D2 = seq.shape
    flat = seq.reshape(T * B, D2)
    base = matmul(flat, params["base_head"]["w"], precision) + params["base_head"]["b"]
    rle = matmul(flat, params["rle_head"]["w"], precision) + params["rle_head"]["b"]
    new_hidden = torch.cat(dec_finals, dim=0).transpose(0, 1)
    return (base.view(T, B, -1).transpose(0, 1), rle.view(T, B, -1).transpose(0, 1),
            new_hidden)


def window_starts(columns: int, width: int, jump: int) -> List[int]:
    """0, jump, 2 jump, ... while the window fits (HELEN ``predict_gpu.py:114``)."""
    return [s for s in range(0, columns, jump) if s + width <= columns]


def init_hidden(params: Tree, batch: int, device) -> torch.Tensor:
    H = params["encoder"]["fwd"]["w_hh"].shape[0]
    layers = len(_layers(params["encoder"]))
    return torch.zeros((batch, 2 * layers, H), dtype=torch.float32, device=device)


@torch.no_grad()
def consensus_votes(params: Tree, images: torch.Tensor, width: int, jump: int,
                    precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The summed softmax votes (B, L, nb) and (B, L, nr) of uint8 images
    (B, L, F), windows added in order."""
    B, L, _ = images.shape
    base_acc = rle_acc = None
    hidden = init_hidden(params, B, images.device)
    for s in window_starts(L, width, jump):
        base, rle, hidden = window(params, images[:, s:s + width].float(), hidden, precision)
        if base_acc is None:
            base_acc = images.new_zeros((B, L, base.shape[-1]), dtype=torch.float32)
            rle_acc = images.new_zeros((B, L, rle.shape[-1]), dtype=torch.float32)
        base_acc[:, s:s + width] += torch.softmax(base, dim=-1)
        rle_acc[:, s:s + width] += torch.softmax(rle, dim=-1)
    return base_acc, rle_acc


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The tree's tensors in sorted key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def window_loss(base: torch.Tensor, rle: torch.Tensor, label_base: torch.Tensor,
                label_rle: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the base head plus the class-weighted mean
    cross-entropy of the run-length head (torch's weighted-mean convention:
    divided by the sum of the selected weights)."""
    lb = -torch.log_softmax(base, -1).gather(-1, label_base[..., None]).mean()
    w = torch.tensor(RLE_CLASS_WEIGHTS, dtype=torch.float32, device=rle.device)[label_rle]
    nll = -torch.log_softmax(rle, -1).gather(-1, label_rle[..., None])[..., 0]
    return lb + (w * nll).sum() / w.sum()


class Adam:
    """Adam with the raw moments kept and the bias corrections applied to
    them at each step: ``p -= lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)``."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float):
        self.lr = lr
        self.t = 0
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - ADAM_B1 ** self.t, 1.0 - ADAM_B2 ** self.t
        for p, g, mu, nu in zip(params, grads, self.mu, self.nu):
            mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            p.sub_(self.lr * (mu / c1) / (torch.sqrt(nu / c2) + ADAM_EPS))


def tbptt_batch(params: Tree, adam: Adam, images: torch.Tensor, label_base: torch.Tensor,
                label_rle: torch.Tensor, width: int, jump: int, precision: str) -> float:
    """One batch of truncated BPTT: for each window a forward, the loss, its
    gradients and one Adam step; returns the sum of the windows' losses.
    ``params``' tensors are updated in place."""
    ps = leaves(params)
    B, L, _ = images.shape
    hidden = init_hidden(params, B, images.device)
    total = torch.zeros((), device=images.device)
    for s in window_starts(L, width, jump):
        with torch.enable_grad():
            for p in ps:
                p.requires_grad_(True)
            base, rle, new_hidden = window(params, images[:, s:s + width].float(), hidden,
                                           precision)
            loss = window_loss(base, rle, label_base[:, s:s + width].long(),
                               label_rle[:, s:s + width].long())
            grads = torch.autograd.grad(loss, ps)
        adam.step(ps, grads)
        hidden = new_hidden.detach()
        total = total + loss.detach()
    for p in ps:
        p.requires_grad_(False)
    return float(total)
