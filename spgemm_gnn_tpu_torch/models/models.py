"""Model families (counterpart of `spgemm_gnn_tpu/models/models.py`).

Every model: lin_in → L layers (a nonlinearity, MaxK or ReLU, and message
passing) → lin_out. SAGE, GCN, GIN and GNNRes wire DGL's layers as the
reference's `utils/models.py` does; MaxKSAGE, MaxKGCN and MaxKGIN are its
integrated kernel-first variants (`utils/integrated_models.py`). Each layer
passes the MaxK k to `aggregate` where the JAX model does, so a k-sparse
input can take the CBSR stream forward (kernels/planned.py), and, where the
sampled backward will read them (`kernels.planned.wants_channel_ids`), the
channels its MaxK kept, so that the backward computes only those.

Submodule and parameter names are the flax ones (`lin_in`, `layer{i}`,
`lin{i}`, `conv{i}`, `norm{i}`, `res{i}`, `bn{i}`, `lin1_{i}`, `lin2_{i}`,
`fc_self{i}`, `fc_neigh{i}`, `conv_w{i}`, `conv_b{i}`, `eps{i}`, `lin_out`),
so that `convert.params_from_flax` maps weights across by name.

`dtype` is the hidden stack's compute dtype, as flax's `dtype` (None or
"float32": exact f32; "bfloat16": the 16-bit model): every hidden `Dense`
and `LayerNorm`/`BatchNorm` computes in it, the parameters stay f32, and
`lin_out` computes in f32, so the logits are f32 (models/layers.py).

`remat` (`--remat`) runs each hidden layer's body (`_layer`) under
`models/remat.py::remat`: its forward keeps the layer's input and its
aggregation outputs only, the backward reruns the rest, and the losses and
gradients are the run's without remat bit for bit.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from spgemm_gnn_tpu_torch.kernels.api import aggregate, maxk_op
from spgemm_gnn_tpu_torch.kernels.planned import wants_channel_ids
from spgemm_gnn_tpu_torch.models.layers import (BatchNorm, Dense, GINAgg,
                                                GraphConvAgg, LayerNorm,
                                                SAGEConv, compute_dtype,
                                                dropout, xavier_uniform_)
from spgemm_gnn_tpu_torch.models.remat import remat

# Linear layers initialised with DGL's relu gain (√2), as in the JAX package
_RELU_GAIN = ("fc_self", "fc_neigh", "conv_w")


class _Base(nn.Module):
    """Configuration shared by the families, the nonlinearity, and the
    initialisation: every child in the order it was added (the flax
    definition order), Xavier-uniform weights from one generator, zero
    biases, and zero scalars and vectors held by the model itself."""

    def __init__(self, in_dim: int, hidden_dim: int, num_layers: int,
                 out_dim: int, maxk: int, feat_drop: float, use_norm: bool,
                 nonlinear: str, impl: str, dtype: str | torch.dtype | None,
                 remat: bool = False):
        super().__init__()
        if nonlinear not in ("maxk", "relu"):
            raise ValueError(f"unknown nonlinear {nonlinear!r}")
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        self.k = maxk if nonlinear == "maxk" else None
        self.feat_drop = feat_drop
        self.use_norm = use_norm
        self.impl = impl
        self.remat = remat
        self.compute_dtype = compute_dtype(dtype)
        self.lin_in = self._dense(in_dim, hidden_dim)
        self._out_dim = out_dim

    def _dense(self, n_in: int, n_out: int, bias: bool = True) -> Dense:
        """A hidden Dense at the compute dtype."""
        return Dense(n_in, n_out, bias=bias, dtype=self.compute_dtype)

    def _layer_norm(self) -> LayerNorm:
        return LayerNorm(self.hidden_dim, eps=1e-5, dtype=self.compute_dtype,
                         impl=self.impl)

    def _add_lin_out(self) -> None:
        # f32 whatever the compute dtype: flax leaves lin_out's dtype unset
        self.lin_out = Dense(self.hidden_dim, self._out_dim)

    def _add_zeros(self, name: str, shape: tuple[int, ...]) -> None:
        self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def _nl(self, x: torch.Tensor) -> torch.Tensor:
        return (maxk_op(x, self.k, self.impl) if self.k is not None
                else torch.relu(x))

    def _nl_ids(self, x: torch.Tensor, g) -> tuple[torch.Tensor,
                                                   torch.Tensor | None]:
        """(the nonlinearity of x, the channels its MaxK kept where the
        aggregation over g that follows will read them, else None)."""
        if self.impl != "torch" and wants_channel_ids(g, self.k, x):
            return maxk_op(x, self.k, self.impl, with_ids=True)
        return self._nl(x), None

    def _drop(self, x: torch.Tensor, generator, g) -> torch.Tensor:
        return dropout(x, self.feat_drop, self.training, generator, g)

    def _layer(self, i: int, g, x: torch.Tensor,
               generator: torch.Generator | None) -> torch.Tensor:
        """Hidden layer i of the family on x."""
        raise NotImplementedError

    def _stack(self, g, x: torch.Tensor,
               generator: torch.Generator | None) -> torch.Tensor:
        """The hidden layers on x, each under `remat` when it is set."""
        for i in range(self.num_layers):
            if self.remat:
                x = remat(lambda h, i=i: self._layer(i, g, h, generator), x,
                          generator)
            else:
                x = self._layer(i, g, x, generator)
        return x

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
                use_norm=self.use_norm, k_sparse=self.k, impl=self.impl,
                dtype=self.compute_dtype))
        self._add_lin_out()

    def _layer(self, i, g, x, generator):
        x, ids = self._nl_ids(x, g)
        return getattr(self, f"layer{i}")(g, x, generator, ids)

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.lin_out(self._stack(g, self.lin_in(x), generator))


class _ConvStack(_Base):
    """GCN and GIN: relu(lin_in) → [Linear → MaxK/ReLU → Dropout → conv →
    LayerNorm?] × L → lin_out; `conv` is the family's aggregation layer."""

    def __init__(self, in_dim: int, conv, **kw):
        super().__init__(in_dim, **kw)
        h = self.hidden_dim
        for i in range(self.num_layers):
            self.add_module(f"lin{i}", self._dense(h, h))
            self.add_module(f"conv{i}", conv(self))
            if self.use_norm:
                self.add_module(f"norm{i}", self._layer_norm())
        self._add_lin_out()

    def _layer(self, i, g, x, generator):
        x, ids = self._nl_ids(getattr(self, f"lin{i}")(x), g)
        x = getattr(self, f"conv{i}")(g, self._drop(x, generator, g), ids)
        if self.use_norm:
            x = getattr(self, f"norm{i}")(x)
        return x

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.lin_in(x))
        return self.lin_out(self._stack(g, x, generator))


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
            self.add_module(f"res{i}", self._dense(h, h))
            self.add_module(f"conv{i}", GraphConvAgg(h, impl=self.impl))
            if self.use_norm:
                self.add_module(f"bn{i}", BatchNorm(h, momentum=0.9, eps=1e-5))
            self.add_module(f"lin1_{i}", self._dense(h, h))
            self.add_module(f"lin2_{i}", self._dense(h, h))
        self._add_lin_out()

    def _layer(self, i, g, x, generator):
        res = getattr(self, f"res{i}")(x)
        x = getattr(self, f"conv{i}")(g, x)
        if self.use_norm:
            x = getattr(self, f"bn{i}")(x, g)
        x = self._drop(torch.relu(getattr(self, f"lin1_{i}")(x)), generator,
                       g)
        x = torch.relu(getattr(self, f"lin2_{i}")(x) + res)
        return self._drop(x, generator, g)

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.lin_in(x))
        return self.lin_out(self._stack(g, x, generator))


class MaxKSAGE(_Base):
    """Integrated SAGE: lin_in → per layer h_self = fc_self(x); agg =
    mean-aggregate(MaxK(fc_neigh(x))); x = h_self + agg; LayerNorm?;
    Dropout → lin_out."""

    def __init__(self, in_dim: int, **kw):
        super().__init__(in_dim, **kw)
        h = self.hidden_dim
        for i in range(self.num_layers):
            self.add_module(f"fc_self{i}", self._dense(h, h, bias=False))
            self.add_module(f"fc_neigh{i}", self._dense(h, h, bias=False))
            if self.use_norm:
                self.add_module(f"norm{i}", self._layer_norm())
        self._add_lin_out()

    def _layer(self, i, g, x, generator):
        h_self = getattr(self, f"fc_self{i}")(x)
        h_neigh, ids = self._nl_ids(getattr(self, f"fc_neigh{i}")(x), g)
        x = h_self + aggregate(g, h_neigh, "mean", k=self.k, impl=self.impl,
                               ids=ids)
        if self.use_norm:
            x = getattr(self, f"norm{i}")(x)
        return self._drop(x, generator, g)

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.lin_out(self._stack(g, self.lin_in(x), generator))


class MaxKGCN(_Base):
    """Integrated GCN: relu(lin_in) → per layer Linear → Dropout → conv_w →
    MaxK → sym-norm aggregate + conv_b → LayerNorm? → lin_out."""

    def __init__(self, in_dim: int, **kw):
        super().__init__(in_dim, **kw)
        h = self.hidden_dim
        for i in range(self.num_layers):
            self.add_module(f"lin{i}", self._dense(h, h))
            self.add_module(f"conv_w{i}", self._dense(h, h, bias=False))
            self._add_zeros(f"conv_b{i}", (h,))
            if self.use_norm:
                self.add_module(f"norm{i}", self._layer_norm())
        self._add_lin_out()

    def _layer(self, i, g, x, generator):
        x = self._drop(getattr(self, f"lin{i}")(x), generator, g)
        x, ids = self._nl_ids(getattr(self, f"conv_w{i}")(x), g)
        x = aggregate(g, x, "gcn", k=self.k, impl=self.impl, ids=ids)
        x = x + getattr(self, f"conv_b{i}").to(x.dtype)
        if self.use_norm:
            x = getattr(self, f"norm{i}")(x)
        return x

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.lin_in(x))
        return self.lin_out(self._stack(g, x, generator))


class MaxKGIN(_Base):
    """Integrated GIN: relu(lin_in) → per layer Linear → Dropout → MaxK →
    (1 + eps)·x + sum-aggregate(x) → LayerNorm? → lin_out."""

    def __init__(self, in_dim: int, **kw):
        super().__init__(in_dim, **kw)
        h = self.hidden_dim
        for i in range(self.num_layers):
            self.add_module(f"lin{i}", self._dense(h, h))
            self._add_zeros(f"eps{i}", ())
            if self.use_norm:
                self.add_module(f"norm{i}", self._layer_norm())
        self._add_lin_out()

    def _layer(self, i, g, x, generator):
        x = self._drop(getattr(self, f"lin{i}")(x), generator, g)
        x, ids = self._nl_ids(x, g)
        agg = aggregate(g, x, "sum", k=self.k, impl=self.impl, ids=ids)
        x = (1.0 + getattr(self, f"eps{i}")).to(x.dtype) * x + agg
        if self.use_norm:
            x = getattr(self, f"norm{i}")(x)
        return x

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = torch.relu(self.lin_in(x))
        return self.lin_out(self._stack(g, x, generator))


MODELS = {"sage": SAGE, "gcn": GCN, "gin": GIN, "gnn_res": GNNRes,
          "sage_integrated": MaxKSAGE, "gcn_integrated": MaxKGCN,
          "gin_integrated": MaxKGIN}


def build_model(model: str, *, in_dim: int, hidden_dim: int, num_layers: int,
                out_dim: int, maxk: int = 32, feat_drop: float = 0.5,
                use_norm: bool = False, nonlinear: str = "maxk",
                impl: str = "auto", remat: bool = False,
                dtype: str | torch.dtype | None = None) -> nn.Module:
    """Model factory with the JAX package's arguments (plus `in_dim`, which
    flax infers). dtype: the compute dtype of the hidden stack (None or
    "float32": f32; "bfloat16": the 16-bit model; anything else raises).
    remat: each hidden layer under `models/remat.py::remat`. Parameters
    are left as PyTorch makes them: call `reset_parameters(generator)` for
    the JAX package's init."""
    if model not in MODELS:
        raise ValueError(f"unknown model {model!r}; expected one of "
                         f"{sorted(MODELS)}")
    return MODELS[model](in_dim, hidden_dim=hidden_dim, num_layers=num_layers,
                         out_dim=out_dim, maxk=maxk, feat_drop=feat_drop,
                         use_norm=use_norm, nonlinear=nonlinear, impl=impl,
                         dtype=dtype, remat=remat)
