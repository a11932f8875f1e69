"""The work the model needs, counted from its shapes, and the card's peaks.

Kept here, frozen, so that a change to the program cannot change the
yardstick: a kernel renamed, split or fused leaves these counts as they are.
The per-launch arithmetic follows ``chip_smoke.py``'s ``window_cost`` and
``xp_cost`` (each input read once, each output written once), taken per
layer-window instead of per launch.

FLOP count the matrix products (2 per multiply-add) and nothing else. A
layer-window is one bidirectional GRU layer over one 100-column window of a
batch; its inference FLOP are ``2 dirs * 2 * B*T * (D*3H + H*3H)``. A
training layer-window adds the weight gradients of both products and the
gradients of their inputs (the carried h's always; the layer's input x
except in the first encoder layer, whose input is the image), with no
recomputation. The heads add ``2 * B*T * 2H * (nb + nr)``, three times in
training. Adam streams each parameter, its gradient and both moments in and
the parameter and moments out.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

#: H100 SXM (NVIDIA data sheet), dense: TF32 tensor cores 495 TFLOP/s, taken
#: at a third, the rate of 3xTF32 products at float32 accuracy
PEAK_FLOPS = 495e12 / 3
#: HBM3 bandwidth
PEAK_BYTES_PER_S = 3.35e12

F32 = 4


def _layers(cfg: Dict) -> List[Tuple[int, int]]:
    """(input width D, input element bytes) of every bi-GRU layer, in order."""
    h = cfg["hidden_size"]
    first = [(cfg["input_features"], 1)]  # the uint8 image window
    rest = [(2 * h, F32)] * (2 * cfg["gru_layers"] - 1)
    return first + rest


def layer_window(batch: int, steps: int, d: int, h: int, in_bytes: int, first: bool,
                 training: bool) -> Tuple[float, float]:
    """(FLOP, bytes) of one bi-GRU layer over one window."""
    n = batch * steps
    f_ih = 2 * 2.0 * n * d * 3 * h
    f_hh = 2 * 2.0 * n * h * 3 * h
    x_bytes = n * d * in_bytes
    w_bytes = 2 * F32 * ((d + h) * 3 * h + 2 * 3 * h)
    h_bytes = 2 * F32 * batch * h  # both directions' h0, or hn
    out_bytes = 2 * F32 * n * h
    flop = f_ih + f_hh
    nbytes = x_bytes + w_bytes + h_bytes + out_bytes + h_bytes
    if training:
        flop += f_ih + 2 * f_hh + (0 if first else f_ih)
        # x, the outputs, their cotangents, the weights and h0 in; the input
        # cotangent (not for the image), the weight cotangents and dh0 out
        nbytes += (x_bytes + out_bytes + out_bytes + w_bytes + h_bytes
                   + (0 if first else n * d * F32) + w_bytes + h_bytes)
    return flop, nbytes


def heads_window(batch: int, steps: int, h: int, classes: int, training: bool
                 ) -> Tuple[float, float]:
    """(FLOP, bytes) of both heads over one window: the decoder's outputs
    and the weights in, the logits out (training: and the labels in, the
    outputs' cotangents and the weight cotangents out); inference adds each
    softmax into the vote (read and written once)."""
    n = batch * steps
    flop = 2.0 * n * 2 * h * classes
    w_bytes = F32 * (2 * h + 1) * classes
    nbytes = F32 * n * 2 * h + w_bytes + F32 * n * classes
    if training:
        flop *= 3
        nbytes += 2 * n + F32 * n * 2 * h + w_bytes
    else:
        nbytes += 2 * F32 * n * classes
    return flop, nbytes


def num_params(cfg: Dict) -> int:
    h = cfg["hidden_size"]
    gru = sum(2 * ((d + h) * 3 * h + 2 * 3 * h) for d, _ in _layers(cfg))
    classes = cfg["num_base_classes"] + cfg["num_rle_classes"]
    return gru + (2 * h + 1) * classes


def adam_window(cfg: Dict) -> Tuple[float, float]:
    """(FLOP, bytes) of one Adam step: no matrix products; p, g, mu, nu in,
    p, mu, nu out."""
    return 0.0, 7.0 * F32 * num_params(cfg)


def window_parts(cfg: Dict, batch: int, training: bool) -> List[Tuple[float, float]]:
    """(FLOP, bytes) of each part of one window of a batch."""
    steps, h = cfg["window"], cfg["hidden_size"]
    parts = [layer_window(batch, steps, d, h, b, i == 0, training)
             for i, (d, b) in enumerate(_layers(cfg))]
    parts.append(heads_window(batch, steps, h,
                              cfg["num_base_classes"] + cfg["num_rle_classes"], training))
    if training:
        parts.append(adam_window(cfg))
    return parts


def window_flop(cfg: Dict, training: bool) -> float:
    """Model FLOP of one image's window."""
    return sum(f for f, _ in window_parts(cfg, 1, training))


def least_seconds(flop: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flop / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)


def window_least_seconds(cfg: Dict, batch: int, training: bool) -> float:
    """Sum of the least times of one window's parts at ``batch``."""
    return sum(least_seconds(f, b) for f, b in window_parts(cfg, batch, training))
