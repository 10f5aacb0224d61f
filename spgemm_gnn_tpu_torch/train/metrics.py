"""Evaluation metrics (counterpart of `spgemm_gnn_tpu/train/metrics.py`).

- `micro_f1`: masked accuracy (single-label) or micro-F1 (multilabel).
- `rocauc`: per-class ROC-AUC on the host in numpy, averaged over the
  classes that have both a positive and a negative (ogb's "rocauc", the
  ogbn-proteins metric), with average ranks over ties.
- `rocauc_tensor`: the same statistic on the logits' device (the
  counterpart of `rocauc_jax`), for the Trainer's evaluation.
- `accuracy_topk`: precision@k on the host.
"""
from __future__ import annotations

import numpy as np
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


def rocauc(logits: np.ndarray, labels: np.ndarray, mask: np.ndarray) -> float:
    """Per-class ROC-AUC averaged over valid classes (host numpy).

    AUC_c = (Σ ranks of positives − P(P+1)/2) / (P·N), with average ranks
    for ties; classes with no positive or no negative are skipped.
    """
    logits = np.asarray(logits)[mask]
    labels = np.asarray(labels)[mask]
    if labels.ndim == 1:
        labels = labels[:, None]
        logits = logits[:, None]
    aucs = []
    for c in range(labels.shape[1]):
        y = labels[:, c] > 0.5
        p = int(y.sum())
        n = y.shape[0] - p
        if p == 0 or n == 0:
            continue
        s = logits[:, c]
        order = np.argsort(s, kind="mergesort")
        ranks = np.empty_like(order, dtype=np.float64)
        sorted_s = s[order]
        i = 0
        while i < len(sorted_s):
            j = i
            while j + 1 < len(sorted_s) and sorted_s[j + 1] == sorted_s[i]:
                j += 1
            ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
            i = j + 1
        auc = (ranks[y].sum() - p * (p + 1) / 2.0) / (p * n)
        aucs.append(auc)
    return float(np.mean(aucs)) if aucs else 0.0


def rocauc_tensor(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """`rocauc` on the logits' device, a 0-d float64 tensor, with no host
    sync. Excluded rows are pushed to -inf, so a row's rank among the
    masked rows is its full rank less the excluded count; tied scores take
    average ranks from a left and a right `searchsorted`, all classes in
    one batched sort over a [C, N] view. The doubled rank `left + 1 +
    right` is summed exactly in int64 and divided in float64, so each
    class's AUC is the host `rocauc`'s bit for bit (`rocauc_jax` sums f32
    ranks, one ulp of which is 256 at ogbn-proteins' rank sums)."""
    if labels.dim() == 1:
        labels, logits = labels[:, None], logits[:, None]
    n_rows = logits.shape[0]
    s = torch.where(mask[:, None], logits,
                    torch.full((), -torch.inf, dtype=logits.dtype,
                               device=logits.device)).T.contiguous()
    y = ((labels > 0.5) & mask[:, None]).T.contiguous()     # [C, N]
    srt = torch.sort(s, dim=1).values
    doubled = (torch.searchsorted(srt, s, side="left") + 1
               + torch.searchsorted(srt, s, side="right"))
    n_mask = mask.sum()
    n_excl = n_rows - n_mask
    p = y.sum(dim=1)
    n = n_mask - p
    pos_doubled = torch.where(y, doubled, 0).sum(dim=1)
    rank_sum = (pos_doubled - 2 * n_excl * p).double() / 2.0
    auc = ((rank_sum - p.double() * (p + 1).double() / 2.0)
           / (p * n).clamp(min=1).double())
    valid = (p > 0) & (n > 0)
    return (torch.where(valid, auc, 0.0).sum()
            / valid.sum().clamp(min=1).double())


def accuracy_topk(logits: np.ndarray, labels: np.ndarray,
                  topk=(1,)) -> list[float]:
    """precision@k for each k in `topk` (host numpy); multilabel labels
    count their argmax class."""
    maxk = max(topk)
    if labels.ndim > 1:
        labels = labels.argmax(1)
    pred = np.argsort(-logits, axis=1)[:, :maxk]
    correct = pred == labels[:, None]
    return [float(correct[:, :k].any(1).mean()) for k in topk]
