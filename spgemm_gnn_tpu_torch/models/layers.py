"""Message-passing layers (counterpart of `spgemm_gnn_tpu/models/layers.py`).

Initialisation follows the JAX package: Xavier-uniform weights (gain √2 on
the layer's `fc_*` projections, DGL SAGEConv's relu gain), zero biases, drawn
from an explicit `torch.Generator`.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from spgemm_gnn_tpu_torch.kernels.api import aggregate


def xavier_uniform_(w: torch.Tensor, gain: float,
                    generator: torch.Generator) -> None:
    """Xavier/Glorot uniform init of a [out, in] weight from `generator`."""
    fan_out, fan_in = w.shape
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-a, a, generator=generator)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with noise from `generator` (flax Dropout's rule:
    keep with probability 1 - p and scale the kept values by 1/(1 - p))."""
    if not training or p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


class SAGEConv(nn.Module):
    """GraphSAGE mean-aggregator layer (DGL SAGEConv, in == out features):
    dropout(x) → fc_self(x) + fc_neigh(mean-agg(x)) → optional LayerNorm.
    The bias lives on fc_self; fc_neigh has none."""

    def __init__(self, features: int, feat_drop: float = 0.0,
                 use_norm: bool = False, k_sparse: int | None = None,
                 impl: str = "auto"):
        super().__init__()
        self.feat_drop = feat_drop
        self.k_sparse = k_sparse
        self.impl = impl
        self.fc_neigh = nn.Linear(features, features, bias=False)
        self.fc_self = nn.Linear(features, features, bias=True)
        self.norm = nn.LayerNorm(features, eps=1e-5) if use_norm else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        xavier_uniform_(self.fc_neigh.weight, math.sqrt(2.0), generator)
        xavier_uniform_(self.fc_self.weight, math.sqrt(2.0), generator)
        nn.init.zeros_(self.fc_self.bias)
        if self.norm is not None:
            self.norm.reset_parameters()

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = dropout(x, self.feat_drop, self.training, generator)
        agg = aggregate(g, x, norm="mean", k=self.k_sparse, impl=self.impl)
        out = self.fc_self(x) + self.fc_neigh(agg)
        if self.norm is not None:
            out = self.norm(out)
        return out
