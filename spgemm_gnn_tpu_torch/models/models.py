"""Model families (counterpart of `spgemm_gnn_tpu/models/models.py`).

Every model: lin_in → L layers (a nonlinearity, MaxK or ReLU, and message
passing) → lin_out. SAGE, GCN, GIN and GNNRes wire DGL's layers as the
reference's `utils/models.py` does; MaxKSAGE, MaxKGCN and MaxKGIN are its
integrated kernel-first variants (`utils/integrated_models.py`). Each layer
passes the MaxK k to `aggregate` where the JAX model does, so a k-sparse
input can take the CBSR stream forward (kernels/planned.py).

Submodule and parameter names are the flax ones (`lin_in`, `layer{i}`,
`lin{i}`, `conv{i}`, `norm{i}`, `res{i}`, `bn{i}`, `lin1_{i}`, `lin2_{i}`,
`fc_self{i}`, `fc_neigh{i}`, `conv_w{i}`, `conv_b{i}`, `eps{i}`, `lin_out`),
so that `convert.params_from_flax` maps weights across by name.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from spgemm_gnn_tpu_torch.kernels.api import aggregate, maxk_op
from spgemm_gnn_tpu_torch.models.layers import (BatchNorm, GINAgg,
                                                GraphConvAgg, SAGEConv,
                                                dropout, xavier_uniform_)

# Linear layers initialised with DGL's relu gain (√2), as in the JAX package
_RELU_GAIN = ("fc_self", "fc_neigh", "conv_w")


class _Base(nn.Module):
    """Configuration shared by the families, the nonlinearity, and the
    initialisation: every child in the order it was added (the flax
    definition order), Xavier-uniform weights from one generator, zero
    biases, and zero scalars and vectors held by the model itself."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int,
                 out_dim: int, maxk: int, feat_drop: float, use_norm: bool,
                 nonlinear: str, impl: str):
        super().__init__()
        if nonlinear not in ("maxk", "relu"):
            raise ValueError(f"unknown nonlinear {nonlinear!r}")
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.k = maxk if nonlinear == "maxk" else None
        self.feat_drop = feat_drop
        self.use_norm = use_norm
        self.impl = impl
        self.lin_in = nn.Linear(in_dim, hidden_dim)
        self._out_dim = out_dim

    def _add_lin_out(self) -> None:
        self.lin_out = nn.Linear(self.hidden_dim, self._out_dim)

    def _add_zeros(self, name: str, shape: tuple[int, ...]) -> None:
        self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def _nl(self, x: torch.Tensor) -> torch.Tensor:
        return (maxk_op(x, self.k, self.impl) if self.k is not None
                else torch.relu(x))

    def _drop(self, x: torch.Tensor, generator) -> torch.Tensor:
        return dropout(x, self.feat_drop, self.training, generator)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight from `generator` (one init stream, in the order
        the children were added)."""
        for name, m in self.named_children():
            if isinstance(m, nn.Linear):
                gain = math.sqrt(2.0) if name.startswith(_RELU_GAIN) else 1.0
                xavier_uniform_(m.weight, gain, generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, SAGEConv):
                m.reset_parameters(generator)
            else:
                m.reset_parameters()
        for p in self._parameters.values():
            nn.init.zeros_(p)


class SAGE(_Base):
    """lin_in → [MaxK/ReLU → SAGEConv(mean, feat_drop, LayerNorm?)] × L →
    lin_out, with no activation after lin_in."""

    def __init__(self, in_dim: int, **kw):
        super().__init__(in_dim, **kw)
        for i in range(self.num_layers):
            self.add_module(f"layer{i}", SAGEConv(
                self.hidden_dim, feat_drop=self.feat_drop,
                use_norm=self.use_norm, k_sparse=self.k, impl=self.impl))
        self._add_lin_out()

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.lin_in(x)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(g, self._nl(x), generator)
        return self.lin_out(x)


class _ConvStack(_Base):
    """GCN and GIN: relu(lin_in) → [Linear → MaxK/ReLU → Dropout → conv →
    LayerNorm?] × L → lin_out; `conv` is the family's aggregation layer."""

    def __init__(self, in_dim: int, conv, **kw):
        super().__init__(in_dim, **kw)
        h = self.hidden_dim
        for i in range(self.num_layers):
            self.add_module(f"lin{i}", nn.Linear(h, h))
            self.add_module(f"conv{i}", conv(self))
            if self.use_norm:
                self.add_module(f"norm{i}", nn.LayerNorm(h, eps=1e-5))
        self._add_lin_out()

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.lin_in(x))
        for i in range(self.num_layers):
            x = self._nl(getattr(self, f"lin{i}")(x))
            x = getattr(self, f"conv{i}")(g, self._drop(x, generator))
            if self.use_norm:
                x = getattr(self, f"norm{i}")(x)
        return self.lin_out(x)


class GCN(_ConvStack):
    """The reference's GCN: GraphConv (symmetric norm, bias) per layer."""

    def __init__(self, in_dim: int, **kw):
        super().__init__(in_dim, lambda m: GraphConvAgg(
            m.hidden_dim, k_sparse=m.k, impl=m.impl), **kw)


class GIN(_ConvStack):
    """The reference's GIN: GINConv(learn_eps) sum aggregation per layer."""

    def __init__(self, in_dim: int, **kw):
        super().__init__(in_dim, lambda m: GINAgg(k_sparse=m.k, impl=m.impl),
                         **kw)


class GNNRes(_Base):
    """Residual GCN: relu(lin_in) → per layer res = Linear(x); x =
    GraphConv(x); BatchNorm?; Linear → ReLU → Dropout → Linear; ReLU(x +
    res); Dropout → lin_out. ReLU only: the reference ignores `nonlinear`."""

    def __init__(self, in_dim: int, **kw):
        super().__init__(in_dim, **kw)
        h = self.hidden_dim
        for i in range(self.num_layers):
            self.add_module(f"res{i}", nn.Linear(h, h))
            self.add_module(f"conv{i}", GraphConvAgg(h, impl=self.impl))
            if self.use_norm:
                self.add_module(f"bn{i}", BatchNorm(h, momentum=0.9, eps=1e-5))
            self.add_module(f"lin1_{i}", nn.Linear(h, h))
            self.add_module(f"lin2_{i}", nn.Linear(h, h))
        self._add_lin_out()

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.lin_in(x))
        for i in range(self.num_layers):
            res = getattr(self, f"res{i}")(x)
            x = getattr(self, f"conv{i}")(g, x)
            if self.use_norm:
                x = getattr(self, f"bn{i}")(x)
            x = self._drop(torch.relu(getattr(self, f"lin1_{i}")(x)),
                           generator)
            x = torch.relu(getattr(self, f"lin2_{i}")(x) + res)
            x = self._drop(x, generator)
        return self.lin_out(x)


class MaxKSAGE(_Base):
    """Integrated SAGE: lin_in → per layer h_self = fc_self(x); agg =
    mean-aggregate(MaxK(fc_neigh(x))); x = h_self + agg; LayerNorm?;
    Dropout → lin_out."""

    def __init__(self, in_dim: int, **kw):
        super().__init__(in_dim, **kw)
        h = self.hidden_dim
        for i in range(self.num_layers):
            self.add_module(f"fc_self{i}", nn.Linear(h, h, bias=False))
            self.add_module(f"fc_neigh{i}", nn.Linear(h, h, bias=False))
            if self.use_norm:
                self.add_module(f"norm{i}", nn.LayerNorm(h, eps=1e-5))
        self._add_lin_out()

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = self.lin_in(x)
        for i in range(self.num_layers):
            h_self = getattr(self, f"fc_self{i}")(x)
            h_neigh = self._nl(getattr(self, f"fc_neigh{i}")(x))
            x = h_self + aggregate(g, h_neigh, "mean", k=self.k,
                                   impl=self.impl)
            if self.use_norm:
                x = getattr(self, f"norm{i}")(x)
            x = self._drop(x, generator)
        return self.lin_out(x)


class MaxKGCN(_Base):
    """Integrated GCN: relu(lin_in) → per layer Linear → Dropout → conv_w →
    MaxK → sym-norm aggregate + conv_b → LayerNorm? → lin_out."""

    def __init__(self, in_dim: int, **kw):
        super().__init__(in_dim, **kw)
        h = self.hidden_dim
        for i in range(self.num_layers):
            self.add_module(f"lin{i}", nn.Linear(h, h))
            self.add_module(f"conv_w{i}", nn.Linear(h, h, bias=False))
            self._add_zeros(f"conv_b{i}", (h,))
            if self.use_norm:
                self.add_module(f"norm{i}", nn.LayerNorm(h, eps=1e-5))
        self._add_lin_out()

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.lin_in(x))
        for i in range(self.num_layers):
            x = self._drop(getattr(self, f"lin{i}")(x), generator)
            x = self._nl(getattr(self, f"conv_w{i}")(x))
            x = aggregate(g, x, "gcn", k=self.k, impl=self.impl)
            x = x + getattr(self, f"conv_b{i}").to(x.dtype)
            if self.use_norm:
                x = getattr(self, f"norm{i}")(x)
        return self.lin_out(x)


class MaxKGIN(_Base):
    """Integrated GIN: relu(lin_in) → per layer Linear → Dropout → MaxK →
    (1 + eps)·x + sum-aggregate(x) → LayerNorm? → lin_out."""

    def __init__(self, in_dim: int, **kw):
        super().__init__(in_dim, **kw)
        h = self.hidden_dim
        for i in range(self.num_layers):
            self.add_module(f"lin{i}", nn.Linear(h, h))
            self._add_zeros(f"eps{i}", ())
            if self.use_norm:
                self.add_module(f"norm{i}", nn.LayerNorm(h, eps=1e-5))
        self._add_lin_out()

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.lin_in(x))
        for i in range(self.num_layers):
            x = self._drop(getattr(self, f"lin{i}")(x), generator)
            x = self._nl(x)
            agg = aggregate(g, x, "sum", k=self.k, impl=self.impl)
            x = (1.0 + getattr(self, f"eps{i}")).to(x.dtype) * x + agg
            if self.use_norm:
                x = getattr(self, f"norm{i}")(x)
        return self.lin_out(x)


MODELS = {"sage": SAGE, "gcn": GCN, "gin": GIN, "gnn_res": GNNRes,
          "sage_integrated": MaxKSAGE, "gcn_integrated": MaxKGCN,
          "gin_integrated": MaxKGIN}


def build_model(model: str, *, in_dim: int, hidden_dim: int, num_layers: int,
                out_dim: int, maxk: int = 32, feat_drop: float = 0.5,
                use_norm: bool = False, nonlinear: str = "maxk",
                impl: str = "auto", remat: bool = False,
                dtype: str | None = None) -> nn.Module:
    """Model factory with the JAX package's arguments (plus `in_dim`, which
    flax infers). Parameters are left as PyTorch makes them: call
    `reset_parameters(generator)` for the JAX package's init."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; expected one of "
                         f"{sorted(MODELS)}")
    if remat:
        raise NotImplementedError("--remat is not ported yet (ROADMAP "
                                  "Queue A9)")
    if dtype not in (None, "float32"):
        raise NotImplementedError(f"dtype {dtype!r} is not ported yet "
                                  f"(ROADMAP Queue A9); f32 only")
    return MODELS[model](in_dim, hidden_dim=hidden_dim, num_layers=num_layers,
                         out_dim=out_dim, maxk=maxk, feat_drop=feat_drop,
                         use_norm=use_norm, nonlinear=nonlinear, impl=impl)
