"""Model families (counterpart of `spgemm_gnn_tpu/models/models.py`).

This slice holds SAGE: lin_in → L × (MaxK or ReLU → SAGEConv) → lin_out,
with no activation after lin_in. Submodule names follow the flax ones
(`lin_in`, `layer{i}`, `lin_out`) so that `convert.params_from_flax` maps
weights across by name.
"""
from __future__ import annotations

import torch
from torch import nn

from spgemm_gnn_tpu_torch.kernels.api import maxk_op
from spgemm_gnn_tpu_torch.models.layers import SAGEConv, xavier_uniform_


class SAGE(nn.Module):
    """lin_in → [MaxK/ReLU → SAGEConv(mean, feat_drop, LayerNorm?)] × L →
    lin_out."""

    def __init__(self, in_dim: int, hidden_dim: int = 256, num_layers: int = 3,
                 out_dim: int = 1, maxk: int = 32, feat_drop: float = 0.5,
                 use_norm: bool = False, nonlinear: str = "maxk",
                 impl: str = "auto"):
        super().__init__()
        if nonlinear not in ("maxk", "relu"):
            raise ValueError(f"unknown nonlinear {nonlinear!r}")
        self.num_layers = num_layers
        self.k = maxk if nonlinear == "maxk" else None
        self.impl = impl
        self.lin_in = nn.Linear(in_dim, hidden_dim)
        for i in range(num_layers):
            self.add_module(f"layer{i}", SAGEConv(
                hidden_dim, feat_drop=feat_drop, use_norm=use_norm,
                k_sparse=self.k, impl=impl))
        self.lin_out = nn.Linear(hidden_dim, out_dim)

    def layers(self) -> list[SAGEConv]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight from `generator` (one init stream, in order:
        lin_in, the layers, lin_out)."""
        xavier_uniform_(self.lin_in.weight, 1.0, generator)
        nn.init.zeros_(self.lin_in.bias)
        for layer in self.layers():
            layer.reset_parameters(generator)
        xavier_uniform_(self.lin_out.weight, 1.0, generator)
        nn.init.zeros_(self.lin_out.bias)

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.lin_in(x)
        for layer in self.layers():
            x = (maxk_op(x, self.k, self.impl) if self.k is not None
                 else torch.relu(x))
            x = layer(g, x, generator)
        return self.lin_out(x)


MODELS = {"sage": SAGE}


def build_model(model: str, *, in_dim: int, hidden_dim: int, num_layers: int,
                out_dim: int, maxk: int = 32, feat_drop: float = 0.5,
                use_norm: bool = False, nonlinear: str = "maxk",
                impl: str = "auto", remat: bool = False,
                dtype: str | None = None) -> nn.Module:
    """Model factory with the JAX package's arguments (plus `in_dim`, which
    flax infers). Parameters are left as PyTorch makes them: call
    `reset_parameters(generator)` for the JAX package's init."""
    if model not in MODELS:
        raise NotImplementedError(
            f"model {model!r} is not ported yet (ROADMAP Queue A9); this "
            f"slice has {sorted(MODELS)}")
    if remat:
        raise NotImplementedError("--remat is not ported yet (ROADMAP Queue "
                                  "A9)")
    if dtype not in (None, "float32"):
        raise NotImplementedError(f"dtype {dtype!r} is not ported yet "
                                  f"(ROADMAP Queue A9); f32 only")
    return MODELS[model](in_dim, hidden_dim=hidden_dim, num_layers=num_layers,
                         out_dim=out_dim, maxk=maxk, feat_drop=feat_drop,
                         use_norm=use_norm, nonlinear=nonlinear, impl=impl)
