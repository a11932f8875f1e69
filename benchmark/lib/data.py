"""Weights and inputs made from ``--seed``.

Weights are drawn on the device by one ``torch.rand`` call of a generator
seeded with the seed, in the distributions of torch's ``nn.GRU`` and
``nn.Linear`` (uniform in +-1/sqrt(fan)), in the tree layout the program
takes (``encoder``/``decoder`` stacks of ``{"fwd", "bwd"}`` layers, deeper
layers under ``l1``, ``l2``, ...; ``base_head``/``rle_head``).

Images are synthetic MarginPolish pileups, made on the device with the same
generator and copied to the host once: a random truth of (base, run length)
per column, encoded as ``helen_tpu_torch/io/synthetic.py:encode_features``
encodes it (base b in 1..4 and run r in 1..10 set both strand slots of
feature (b-1)*22 + 2(r-1) to 24; a gap sets features 88 and 89), plus
uniform noise in [0, NOISE * 24), rounded half to even and clipped to uint8.
The truth is the training labels. Every seed gives the same sizes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

#: the feature weight of a pileup column's evidence (encode_features' default)
FEATURE_WEIGHT = 24
#: the share of columns that are gaps, and of the others that continue a
#: homopolymer (run length 2-10 instead of 1)
GAP_SHARE = 0.05
HOMOPOLYMER_SHARE = 0.3
#: the noise's share of the feature weight
NOISE = 0.1


def param_specs(cfg: Dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], float]]:
    """(path in the tree, shape, half-width of the uniform draw) of every
    weight, in the order they are drawn."""
    h = cfg["hidden_size"]
    k_gru, k_head = 1.0 / math.sqrt(h), 1.0 / math.sqrt(2 * h)
    specs = []

    def bigru(prefix, d):
        for direction in ("fwd", "bwd"):
            for name, shape in (("w_ih", (d, 3 * h)), ("w_hh", (h, 3 * h)),
                                ("b_ih", (3 * h,)), ("b_hh", (3 * h,))):
                specs.append((prefix + (direction, name), shape, k_gru))

    for stack, d0 in (("encoder", cfg["input_features"]), ("decoder", 2 * h)):
        bigru((stack,), d0)
        for i in range(1, cfg["gru_layers"]):
            bigru((stack, f"l{i}"), 2 * h)
    for head, c in (("base_head", cfg["num_base_classes"]), ("rle_head", cfg["num_rle_classes"])):
        specs.append(((head, "w"), (2 * h, c), k_head))
        specs.append(((head, "b"), (c,), k_head))
    return specs


def make_params(cfg: Dict, gen: torch.Generator, device) -> Dict:
    """The weight tree, float32 on ``device``, from one draw of ``gen``."""
    specs = param_specs(cfg)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    tree: Dict = {}
    for (path, shape, k), part in zip(specs, flat.split(sizes)):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = part.view(shape).mul(k)
    return tree


def tree_to(tree: Dict, device) -> Dict:
    """A copy of the tree on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def make_images(cfg: Dict, traffic: Dict, gen: torch.Generator, device, batches: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``batches`` distinct batches of ``traffic["batch"]`` images, on the
    host: uint8 images (n, B, L, F) and the truth's base and run-length
    labels, uint8 (n, B, L)."""
    B, L, F = traffic["batch"], cfg["image_columns"], cfg["input_features"]
    images = np.empty((batches, B, L, F), dtype=np.uint8)
    label_base = np.empty((batches, B, L), dtype=np.uint8)
    label_rle = np.empty((batches, B, L), dtype=np.uint8)
    for i in range(batches):
        shape = (B, L)
        base = torch.randint(1, 5, shape, generator=gen, device=device)
        run = torch.where(torch.rand(shape, generator=gen, device=device) < HOMOPOLYMER_SHARE,
                          torch.randint(2, 11, shape, generator=gen, device=device), 1)
        gap = torch.rand(shape, generator=gen, device=device) < GAP_SHARE
        base = torch.where(gap, 0, base)
        run = torch.where(gap, 0, run)
        slot = torch.where(gap, 88, (base - 1) * 22 + 2 * (run - 1))
        img = torch.rand((B, L, F), generator=gen, device=device).mul_(NOISE * FEATURE_WEIGHT)
        evidence = torch.full((B, L, 1), float(FEATURE_WEIGHT), device=device)
        img.scatter_add_(-1, slot[..., None], evidence)
        img.scatter_add_(-1, slot[..., None] + 1, evidence)
        images[i] = torch.round(img).clamp_(0, 255).to(torch.uint8).cpu().numpy()
        label_base[i] = base.to(torch.uint8).cpu().numpy()
        label_rle[i] = run.to(torch.uint8).cpu().numpy()
    return images, label_base, label_rle
