"""Losses and scoring (counterpart of convnets_tpu/ops/losses.py).

The reference's CrossEntropyLoss(reduction='sum'): a per-batch SUM over
examples, always in fp32.
"""

from __future__ import annotations

import torch


def cross_entropy_sum(logits, labels, weights=None, label_smoothing: float = 0.0):
    """Sum of per-example CE. logits (N, C), labels (N,) int.

    weights: optional (N,) 0/1 mask of real examples. label_smoothing ε:
    targets (1-ε)·onehot + ε/C (torch's convention)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if label_smoothing:
        eps = float(label_smoothing)
        nll = (1.0 - eps) * nll + eps * (-logp.mean(dim=-1))
    if weights is not None:
        nll = nll * weights.float()
    return nll.sum()


def correct_count(logits, labels, weights=None):
    """Number of correct argmax predictions, as an fp32 scalar."""
    correct = (logits.argmax(dim=-1) == labels.long()).float()
    if weights is not None:
        correct = correct * weights.float()
    return correct.sum()


def mixup_cross_entropy_sum(logits, labels, mixed_labels, lam: float, weights=None,
                            label_smoothing: float = 0.0):
    """The mixup objective's sum (convnets_tpu/train/engine.py:233-237):
    λ·CE(labels) + (1 − λ)·CE(mixed_labels), λ fp32; mixed_labels are the
    labels under the batch's mixup permutation. lam: a float (a CPU scalar:
    no copy to the card) or an fp32 0-d tensor, used where it lies."""
    lam = torch.as_tensor(lam, dtype=torch.float32)
    return (lam * cross_entropy_sum(logits, labels, weights, label_smoothing)
            + (1.0 - lam) * cross_entropy_sum(logits, mixed_labels, weights, label_smoothing))
