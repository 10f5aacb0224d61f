"""MaxK-GNN's GCN (MaxK-GNN, ASPLOS'24, `utils/models.py`; DGL's
GraphConv(weight=None, norm='both', bias=True)), the port's `gcn` family.
What a model file provides: `models/sage.py`.

The model: relu(lin_in), then per layer lin{i}, MaxK, inverted dropout,
the symmetric norm D^-1/2 A D^-1/2 x (degrees clamped at 1) plus
conv{i}.bias, LayerNorm norm{i}; then lin_out. The recipes that run it add
self-loops to the graph first (`--selfloop`; the configuration's
`graph.self_loops`, `graphgen.add_self_loops`). The weights:
Xavier-uniform with gain 1 on every dense layer (the port's relu gain,
`models/models.py::_RELU_GAIN`, names no `lin{i}`), zero biases, LayerNorm
scale 1 and bias 0.

f32: y = f ⊙ A (f ⊙ x), f = rsqrt(max(deg, 1)) (the graph is symmetric, so
in- and out-degrees agree), summed in f32; its backward f ⊙ A (f ⊙ g).

bf16 rows (the port's bf16 aggregation, `kernels/planned.py`): the
messages bf16(x · bf16(f)), the factor rounded to bf16 and the product
rounded once, summed in f32, and y = bf16(bf16(sum) · bf16(f)); the
backward the same on the bf16 cotangent. The bias is added in bf16.

Counts: per layer one h x h product (lin{i}) and 2·E·k for the
aggregation over k-sparse rows, forward, and 2·E·k for its sampled
backward. A call moves SAGE's bytes (`models/sage.py`) and reads the two
per-node degree factors once.
"""
from __future__ import annotations

import torch

from benchmark import counts


class _GcnAgg(torch.autograd.Function):
    """y = F A F x over the symmetric graph A (`reference.CSR`), F the
    diagonal of `f`; on bf16 rows as the module docstring says."""

    @staticmethod
    def forward(ctx, x, adj, f):
        ctx.adj, ctx.f = adj, f
        return _scaled_product(adj, x, f)

    @staticmethod
    def backward(ctx, g):
        return _scaled_product(ctx.adj, g, ctx.f), None, None


def _scaled_product(adj, x, f):
    if x.dtype == torch.float32:
        return (adj @ (x * f[:, None])) * f[:, None]
    f16 = f.to(x.dtype)[:, None]
    return (adj @ (x * f16).float()).to(x.dtype) * f16


def weight_shapes(model: dict, num_features: int, num_classes: int
                  ) -> list[tuple[str, tuple[int, ...], str, float]]:
    h = model["hidden_dim"]
    out = [("lin_in.weight", (h, num_features), "xavier", 1.0),
           ("lin_in.bias", (h,), "zeros", 0.0)]
    for i in range(model["hidden_layers"]):
        out += [(f"lin{i}.weight", (h, h), "xavier", 1.0),
                (f"lin{i}.bias", (h,), "zeros", 0.0),
                (f"conv{i}.bias", (h,), "zeros", 0.0)]
        if model["norm"]:
            out += [(f"norm{i}.weight", (h,), "ones", 0.0),
                    (f"norm{i}.bias", (h,), "zeros", 0.0)]
    out += [("lin_out.weight", (num_classes, h), "xavier", 1.0),
            ("lin_out.bias", (num_classes,), "zeros", 0.0)]
    return out


def forward(net, features: torch.Tensor, model: dict) -> torch.Tensor:
    f = torch.rsqrt(net.deg.clamp(min=1.0))
    h = torch.relu(net.linear(features.to(net.dtype), "lin_in"))
    for i in range(model["hidden_layers"]):
        x = net.dropout(net.maxk(net.linear(h, f"lin{i}")))
        y = _GcnAgg.apply(x, net.adj, f)
        h = y + net.params[f"conv{i}.bias"].to(y.dtype)
        if model["norm"]:
            h = net.layer_norm(h, f"norm{i}")
    return net.linear(h, "lin_out", dt=torch.float32)


def epoch_flops(config: dict, num_edges: int) -> float:
    n, e, f, c, h, layers, k = counts.shape(config, num_edges)
    agg = 2.0 * e * k
    forward = 2.0 * n * f * h + layers * (2.0 * n * h * h + agg) \
        + 2.0 * n * h * c
    backward = 2.0 * n * f * h + layers * (4.0 * n * h * h + agg) \
        + 4.0 * n * h * c
    return 2.0 * forward + backward


def aggregation_calls(config: dict, num_edges: int, value_bytes: int
                      ) -> dict[str, tuple[int, float, float]]:
    """A forward a layer in the train step and in the evaluation, a
    backward a layer."""
    n, e, _, _, h, layers, k = counts.shape(config, num_edges)
    b, ch = value_bytes, counts.CHANNEL_BYTES
    fixed = counts.graph_bytes(n, e) + 2 * n * counts.FACTOR_BYTES
    fwd_bytes = fixed + n * k * (b + ch) + n * h * b
    bwd_bytes = fixed + n * h * b + n * k * ch + n * k * b
    ops = 2.0 * e * k
    return {"forward": (2 * layers, fwd_bytes, ops),
            "backward": (layers, bwd_bytes, ops)}
