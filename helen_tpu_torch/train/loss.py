"""Multi-task classification losses (port of helen_tpu/train/loss.py).

torch ``nn.CrossEntropyLoss`` semantics, as the reference uses them
(train.py:121-126): the base head takes the unweighted mean cross-entropy;
the RLE head the class-weighted one, whose mean is normalised by the sum of
the selected class weights (torch's weighted-mean convention), with the 11
RLE class weights of Options.py:29. The masked forms drop the padding rows
of a batch; their ``*_parts`` return (numerator, denominator) so a caller
can sum both parts before dividing, and ``masked_*denominator`` give the
denominators alone.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _log_likelihood(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy. logits (..., C), labels (...) int."""
    return -_log_likelihood(logits, labels).mean()


def weighted_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           class_weights: torch.Tensor) -> torch.Tensor:
    """Class-weighted CE with torch normalisation: sum(w_y * ce) / sum(w_y)."""
    ll = _log_likelihood(logits, labels)
    w = class_weights[labels.long()]
    return -(w * ll).sum() / w.sum()


def masked_denominator(labels: torch.Tensor, row_mask: torch.Tensor) -> torch.Tensor:
    """The denominator of :func:`masked_cross_entropy_parts`: the labels of
    the rows where ``row_mask`` (B,) is 1; labels (B, W)."""
    return row_mask.sum() * labels.shape[1]


def masked_weighted_denominator(labels: torch.Tensor, class_weights: torch.Tensor,
                                row_mask: torch.Tensor) -> torch.Tensor:
    """The denominator of :func:`masked_weighted_cross_entropy_parts`: the
    sum of the selected class weights over the unmasked rows."""
    return (class_weights[labels.long()] * row_mask[:, None]).sum()


def masked_cross_entropy_parts(logits: torch.Tensor, labels: torch.Tensor,
                               row_mask: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numerator, denominator) of the mean CE over rows where ``row_mask``
    (B,) is 1; logits (B, W, C), labels (B, W)."""
    ll = _log_likelihood(logits, labels)
    return -(ll * row_mask[:, None]).sum(), masked_denominator(labels, row_mask)


def masked_weighted_cross_entropy_parts(logits: torch.Tensor, labels: torch.Tensor,
                                        class_weights: torch.Tensor,
                                        row_mask: torch.Tensor
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(numerator, denominator) of the masked weighted CE
    (:func:`masked_weighted_denominator`)."""
    ll = _log_likelihood(logits, labels)
    w = class_weights[labels.long()] * row_mask[:, None]
    return -(w * ll).sum(), masked_weighted_denominator(labels, class_weights, row_mask)


def masked_cross_entropy(logits, labels, row_mask) -> torch.Tensor:
    n, d = masked_cross_entropy_parts(logits, labels, row_mask)
    return n / torch.clamp(d, min=1.0)


def masked_weighted_cross_entropy(logits, labels, class_weights, row_mask) -> torch.Tensor:
    n, d = masked_weighted_cross_entropy_parts(logits, labels, class_weights, row_mask)
    return n / torch.clamp(d, min=1e-12)
