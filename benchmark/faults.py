"""Faults planted under the timed path, for the checks of the comparison
(`calibrate.py`, `tests/test_bench_faults.py`): each breaks a Trainer of a
cell in place, after `run.prepare`, so that its run should come out not
correct.

- `frozen`: a step that returns its state unchanged (the optimizer's
  step does nothing);
- `half_batch`: half of the training rows left out of the loss, the mean
  taken over the rest.

A cell on one card has no exchange between chips to leave out, and
training produces no token or answer to alter.
"""
from __future__ import annotations

import torch


def frozen(trainer, state) -> None:
    state["optimizer"].step = lambda *args, **kwargs: None


def half_batch(trainer, state) -> None:
    mask = trainer.masks[0]
    rows = mask.nonzero().squeeze(1)
    keep = torch.zeros_like(mask)
    keep[rows[:rows.numel() // 2]] = True
    loss = trainer._loss

    def halved(logits, labels, m, **kwargs):
        return loss(logits, labels, keep if m is mask else m, **kwargs)

    trainer._loss = halved


FAULTS = {"frozen": frozen, "half_batch": half_batch}
