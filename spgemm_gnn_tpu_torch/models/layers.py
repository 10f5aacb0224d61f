"""Message-passing layers (counterpart of `spgemm_gnn_tpu/models/layers.py`).

Initialisation follows the JAX package: Xavier-uniform weights (gain √2 on
the layer's `fc_*` projections, DGL SAGEConv's relu gain), zero biases, drawn
from an explicit `torch.Generator`.

Layers: `SAGEConv` (mean), `GraphConvAgg` (gcn norm plus bias), `GINAgg`
(sum plus (1 + eps)·x), and `BatchNorm` with flax's statistics for GNNRes.

The 16-bit model (`--dtype bfloat16`) is flax's mixed precision, which
`torch.autocast` is not (autocast keeps LayerNorm's output in f32 and runs
every Linear in bf16): parameters stay f32 and are cast at use. `Dense` with
dtype bf16 computes as `nn.Dense(dtype=bfloat16)` (flax `promote_dtype`):
input, weight and bias cast to bf16, the product rounded to bf16, then the
bias added in bf16 (a second rounding); with dtype f32 it computes in f32
whatever its input (the models' `lin_out`, which flax leaves in f32).
`LayerNorm` and `BatchNorm` take their statistics and normalise in f32 with
f32 parameters, in flax's association, and round once to the compute dtype
(flax `_normalize` with `force_float32_reductions`).

One shard a rank (parallel/mesh.py::RankMesh), the layers see the rank's
rows of the padded node arrays, and the graph `g` says which
(`parallel/mesh.py::rank_rows`). Dropout keeps the rows of the global
mask: the draw of [padded rows, dim] from the shared generator, sliced to
the rank's rows (one transient draw of the whole a call), so the mask does
not depend on how the graph is cut, as in the JAX package. BatchNorm sums
x and x² over the rank's rows and all-reduces the sums (differentiably:
`parallel/mesh.py::AllReduce`), the statistics of the same padded rows a
one-process mesh takes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from spgemm_gnn_tpu_torch.kernels.api import aggregate, layer_norm16
from spgemm_gnn_tpu_torch.models.remat import recomputing
from spgemm_gnn_tpu_torch.parallel.mesh import AllReduce, rank_rows

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(dtype: str | torch.dtype | None) -> torch.dtype:
    """The hidden stack's compute dtype: f32 for None or "float32", bf16
    for "bfloat16" (or the torch dtypes themselves); anything else raises."""
    if dtype is None:
        return torch.float32
    if dtype in COMPUTE_DTYPES.values():
        return dtype
    if dtype not in COMPUTE_DTYPES:
        raise ValueError(f"dtype {dtype!r} is not supported; expected one "
                         f"of {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[dtype]


class Dense(nn.Linear):
    """nn.Linear with flax Dense's dtype rule (module docstring). The f32
    `weight` and `bias` are the parameters; `compute_dtype` is not."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt == torch.float32:
            return super().forward(x.float())
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm at a compute dtype (flax LayerNorm(dtype=...)): in f32,
    `F.layer_norm`; on bf16 rows, `kernels/api.py::layer_norm16` under the
    model's `impl` (f32 arithmetic in flax's association with f32
    parameters, one rounding to bf16)."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, impl: str = "auto"):
        super().__init__(features, eps=eps)
        self.compute_dtype = dtype
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x.float())
        return layer_norm16(x.to(self.compute_dtype), self.weight,
                            self.bias, self.eps, self.impl)


def xavier_uniform_(w: torch.Tensor, gain: float,
                    generator: torch.Generator) -> None:
    """Xavier/Glorot uniform init of a [out, in] weight from `generator`."""
    fan_out, fan_in = w.shape
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-a, a, generator=generator)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: torch.Generator | None, g=None) -> torch.Tensor:
    """Inverted dropout with noise from `generator` (flax Dropout's rule:
    keep with probability 1 - p and scale the kept values by 1/(1 - p)).
    Where `g` is a rank's shard, x holds its rows of the padded nodes and
    the mask is their rows of the whole's (module docstring)."""
    if not training or p == 0.0:
        return x
    rows = rank_rows(g)
    if rows is None:
        noise = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        _, first, total = rows
        noise = torch.rand((total,) + tuple(x.shape[1:]), generator=generator,
                           device=x.device)[first:first + x.shape[0]]
    return torch.where(noise >= p, x / (1.0 - p), torch.zeros_like(x))


class SAGEConv(nn.Module):
    """GraphSAGE mean-aggregator layer (DGL SAGEConv, in == out features):
    dropout(x) → fc_self(x) + fc_neigh(mean-agg(x)) → optional LayerNorm.
    The bias lives on fc_self; fc_neigh has none."""

    def __init__(self, features: int, feat_drop: float = 0.0,
                 use_norm: bool = False, k_sparse: int | None = None,
                 impl: str = "auto", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.feat_drop = feat_drop
        self.k_sparse = k_sparse
        self.impl = impl
        self.fc_neigh = Dense(features, features, bias=False, dtype=dtype)
        self.fc_self = Dense(features, features, bias=True, dtype=dtype)
        self.norm = (LayerNorm(features, eps=1e-5, dtype=dtype, impl=impl)
                     if use_norm else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        xavier_uniform_(self.fc_neigh.weight, math.sqrt(2.0), generator)
        xavier_uniform_(self.fc_self.weight, math.sqrt(2.0), generator)
        nn.init.zeros_(self.fc_self.bias)
        if self.norm is not None:
            self.norm.reset_parameters()

    def forward(self, g, x: torch.Tensor,
                generator: torch.Generator | None = None,
                ids: torch.Tensor | None = None) -> torch.Tensor:
        """ids: the channels the MaxK that made x kept (for the sampled
        backward), or None."""
        x = dropout(x, self.feat_drop, self.training, generator, g)
        agg = aggregate(g, x, norm="mean", k=self.k_sparse, impl=self.impl,
                        ids=ids)
        out = self.fc_self(x) + self.fc_neigh(agg)
        if self.norm is not None:
            out = self.norm(out)
        return out


class GraphConvAgg(nn.Module):
    """GCN aggregation with the symmetric norm and a bias (DGL
    GraphConv(weight=None, norm='both', bias=True)):
    y = D_in^-1/2 · A · D_out^-1/2 · x + b, degrees clamped at 1."""

    def __init__(self, features: int, k_sparse: int | None = None,
                 impl: str = "auto"):
        super().__init__()
        self.k_sparse = k_sparse
        self.impl = impl
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.bias)

    def forward(self, g, x: torch.Tensor,
                ids: torch.Tensor | None = None) -> torch.Tensor:
        y = aggregate(g, x, norm="gcn", k=self.k_sparse, impl=self.impl,
                      ids=ids)
        return y + self.bias.to(y.dtype)


class GINAgg(nn.Module):
    """GIN aggregation (DGL GINConv(learn_eps=True, apply_func=None)):
    y = (1 + eps)·x + sum-agg(x), eps a learned scalar starting at 0."""

    def __init__(self, k_sparse: int | None = None, impl: str = "auto"):
        super().__init__()
        self.k_sparse = k_sparse
        self.impl = impl
        self.eps = nn.Parameter(torch.zeros(()))

    def reset_parameters(self) -> None:
        nn.init.zeros_(self.eps)

    def forward(self, g, x: torch.Tensor,
                ids: torch.Tensor | None = None) -> torch.Tensor:
        agg = aggregate(g, x, norm="sum", k=self.k_sparse, impl=self.impl,
                        ids=ids)
        return (1.0 + self.eps).to(x.dtype) * x + agg


class BatchNorm(nn.Module):
    """Batch normalisation over the nodes with flax.linen.BatchNorm's rule,
    which `torch.nn.BatchNorm1d` does not follow: the running variance takes
    the biased batch variance (BatchNorm1d's takes the unbiased one, n/(n−1)
    larger), and the running averages move as r ← momentum·r + (1 −
    momentum)·batch with momentum 0.9. The batch variance is E[x²] − E[x]²
    clipped at 0, as flax computes it. Training normalises by the batch's
    statistics and updates the running ones; eval normalises by the running
    ones. Parameters `weight` (flax `scale`) and `bias`; buffers
    `running_mean` and `running_var` (flax `batch_stats` mean and var).
    Statistics and normalisation run in f32 and the output takes x's dtype
    (flax BatchNorm(dtype=bfloat16) on bf16 activations). Where the graph
    `g` is a rank's shard, the batch statistics are all-reduced (module
    docstring)."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, g=None) -> torch.Tensor:
        out_dtype = x.dtype
        x = x.float()
        if self.training:
            mean, sq = _batch_means(x, rank_rows(g))
            var = torch.clamp(sq - mean * mean, min=0.0)
            # under --remat the backward reruns the layer: the running
            # averages move in the forward only
            if not recomputing():
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(m).add_((1.0 - m) * mean)
                    self.running_var.mul_(m).add_((1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        return ((x - mean) * (torch.rsqrt(var + self.eps) * self.weight)
                + self.bias).to(out_dtype)


def _batch_means(x: torch.Tensor, rows) -> tuple[torch.Tensor, torch.Tensor]:
    """(E[x], E[x²]) over the nodes: x's rows, or where `rows` (a rank's
    `rank_rows`) is given, every rank's rows, by one all-reduce of the
    rank's sums."""
    if rows is None:
        return x.mean(0), (x * x).mean(0)
    mesh, _, total = rows
    sums = AllReduce.apply(torch.cat([x.sum(0), (x * x).sum(0)]), mesh)
    return sums[:x.shape[1]] / total, sums[x.shape[1]:] / total
