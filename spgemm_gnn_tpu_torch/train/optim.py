"""Optimizers (counterpart of `spgemm_gnn_tpu/train/optim.py`): Adam with L2
folded into the gradient (`torch.optim.Adam(weight_decay=)`, not AdamW), and
Lookahead with alpha 0.5 and k 6."""
from __future__ import annotations

from collections.abc import Iterable

import torch


class Lookahead:
    """Every k inner steps the slow weights move toward the fast ones by
    alpha, and the fast weights are reset to the slow ones."""

    def __init__(self, inner: torch.optim.Optimizer, alpha: float = 0.5,
                 k: int = 6):
        self.inner = inner
        self.alpha = alpha
        self.k = k
        self.steps = 0
        self.params = [p for group in inner.param_groups
                       for p in group["params"]]
        self.slow = [p.detach().clone() for p in self.params]

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        self.inner.step()
        self.steps += 1
        if self.steps % self.k == 0:
            for p, slow in zip(self.params, self.slow):
                slow.add_(p - slow, alpha=self.alpha)
                p.copy_(slow)


def build_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                    weight_decay: float = 0.0,
                    enable_lookahead: bool = False):
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=weight_decay)
    return Lookahead(opt) if enable_lookahead else opt
