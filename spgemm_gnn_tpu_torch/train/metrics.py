"""Evaluation metrics (counterpart of `spgemm_gnn_tpu/train/metrics.py`)."""
from __future__ import annotations

import torch


def micro_f1(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """Masked accuracy (single-label: 1-D int labels) or micro-F1
    (multilabel: pred = logits > 0, true = labels > 0.5). A 0-d tensor."""
    if labels.dim() == 1:
        correct = (logits.argmax(dim=-1) == labels) & mask
        return correct.sum() / mask.sum().clamp(min=1)
    pred = logits > 0
    true = labels > 0.5
    m = mask[:, None]
    tp = (true & pred & m).sum()
    fp = (~true & pred & m).sum()
    fn = (true & ~pred & m).sum()
    denom = 2 * tp + fp + fn
    return torch.where(denom > 0, 2 * tp / denom.clamp(min=1),
                       torch.zeros((), device=logits.device))
