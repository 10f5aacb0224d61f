"""Losses (counterpart of `spgemm_gnn_tpu/train/losses.py`): cross-entropy
for single-label datasets, BCE-with-logits for multilabel ones, each a mean
over the rows of a boolean mask.

One shard a rank (parallel/mesh.py::RankMesh), a rank holds some of the
rows: `count`, the mask's size over every rank, makes its loss its rows'
share of the global mean, so that the ranks' gradients sum to the global
gradient."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _masked_mean(per_node: torch.Tensor, mask: torch.Tensor,
                 count: torch.Tensor | None = None) -> torch.Tensor:
    """The masked rows' sum over `count` (default the mask's size)."""
    m = mask.to(per_node.dtype)
    total = m.sum() if count is None else count.to(per_node.dtype)
    return (per_node * m).sum() / total.clamp(min=1.0)


def masked_softmax_ce(logits: torch.Tensor, labels: torch.Tensor,
                      mask: torch.Tensor,
                      count: torch.Tensor | None = None) -> torch.Tensor:
    return _masked_mean(F.cross_entropy(logits, labels, reduction="none"),
                        mask, count)


def masked_bce(logits: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor,
               count: torch.Tensor | None = None) -> torch.Tensor:
    """Mean over all elements of the masked rows."""
    per_elem = F.binary_cross_entropy_with_logits(logits, labels,
                                                  reduction="none")
    return _masked_mean(per_elem.mean(dim=-1), mask, count)


def loss_fn(multilabel: bool):
    return masked_bce if multilabel else masked_softmax_ce
