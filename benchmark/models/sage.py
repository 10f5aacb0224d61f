"""MaxK-GNN's SAGE (MaxK-GNN, ASPLOS'24; DGL's SAGEConv with the mean
aggregator), the port's `sage` family.

A model file gives the harness what belongs to one model family, found by
the configuration's `model["model"]` (`cells.model_file`):

- `weight_shapes(model, num_features, num_classes)`: every parameter as
  (name, shape, init, gain), in the order `inputs.draw` draws them, named
  as the port's model names its parameters (they enter the program through
  `Trainer.init_state(weights=...)`); init is "xavier", "zeros" or "ones";
- `forward(net, features, model)`: the forward pass from the features to
  the logits, in plain torch on the pieces of `reference.Net`;
- `epoch_flops(config, num_edges)`: the operations of one epoch (a train
  step and an evaluation forward);
- `aggregation_calls(config, num_edges, value_bytes)`: {kind: (calls an
  epoch, bytes, operations)} of one aggregation call of each kind, an
  activation taking `value_bytes`; `counts.py` gives the run's shape, the
  graph's bytes and the other byte sizes, and turns each call into its
  floor.

The model: lin_in, then per layer MaxK, inverted dropout, the mean over
in-neighbours, fc_self(x) + fc_neigh(mean), LayerNorm; then lin_out. The
weights: Xavier-uniform (gain sqrt(2) on the layers' projections, 1 on
`lin_in` and `lin_out`), zero biases, LayerNorm scale 1 and bias 0.

On bf16 rows the mean sums the bf16 rows in f32 and gives
bf16(bf16(sum) * bf16(1/deg)); its backward sums the messages bf16(g /
deg) in f32 and rounds to bf16.

Counts: per layer two h x h products (fc_self and fc_neigh) and 2·E·k for
the mean over k-sparse rows, forward, and 2·E·k for its sampled backward.
A forward call reads the graph (row pointers and int32 sources) once, the
input at MaxK's k channels (a value and a one-byte channel id each) and
writes the dense output; a backward call reads the graph and the dense
cotangent and writes k channels, reading their ids.
"""
from __future__ import annotations

import math

import torch

from benchmark import counts


class _MeanAgg(torch.autograd.Function):
    """y = D^-1 A x over the symmetric graph A (`reference.CSR`), summed
    in f32; on bf16 rows as the module docstring says."""

    @staticmethod
    def forward(ctx, x, adj, inv_deg):
        ctx.adj, ctx.inv_deg = adj, inv_deg
        if x.dtype == torch.float32:
            return (adj @ x) * inv_deg[:, None]
        y = (adj @ x.float()).to(x.dtype)
        return y * inv_deg.to(x.dtype)[:, None]

    @staticmethod
    def backward(ctx, g):
        if g.dtype == torch.float32:
            return ctx.adj @ (g * ctx.inv_deg[:, None]), None, None
        m = (g.float() * ctx.inv_deg[:, None]).to(g.dtype)
        return (ctx.adj @ m.float()).to(g.dtype), None, None


def weight_shapes(model: dict, num_features: int, num_classes: int
                  ) -> list[tuple[str, tuple[int, ...], str, float]]:
    h = model["hidden_dim"]
    out = [("lin_in.weight", (h, num_features), "xavier", 1.0),
           ("lin_in.bias", (h,), "zeros", 0.0)]
    for i in range(model["hidden_layers"]):
        out += [(f"layer{i}.fc_neigh.weight", (h, h), "xavier", math.sqrt(2)),
                (f"layer{i}.fc_self.weight", (h, h), "xavier", math.sqrt(2)),
                (f"layer{i}.fc_self.bias", (h,), "zeros", 0.0)]
        if model["norm"]:
            out += [(f"layer{i}.norm.weight", (h,), "ones", 0.0),
                    (f"layer{i}.norm.bias", (h,), "zeros", 0.0)]
    out += [("lin_out.weight", (num_classes, h), "xavier", 1.0),
            ("lin_out.bias", (num_classes,), "zeros", 0.0)]
    return out


def forward(net, features: torch.Tensor, model: dict) -> torch.Tensor:
    inv_deg = 1.0 / net.deg.clamp(min=1.0)
    h = net.linear(features.to(net.dtype), "lin_in")
    for i in range(model["hidden_layers"]):
        x = net.dropout(net.maxk(h))
        agg = _MeanAgg.apply(x, net.adj, inv_deg)
        h = (net.linear(x, f"layer{i}.fc_self")
             + net.linear(agg, f"layer{i}.fc_neigh", bias=False))
        if model["norm"]:
            h = net.layer_norm(h, f"layer{i}.norm")
    return net.linear(h, "lin_out", dt=torch.float32)


def epoch_flops(config: dict, num_edges: int) -> float:
    n, e, f, c, h, layers, k = counts.shape(config, num_edges)
    agg = 2.0 * e * k
    forward = 2.0 * n * f * h + layers * (4.0 * n * h * h + agg) \
        + 2.0 * n * h * c
    backward = 2.0 * n * f * h + layers * (8.0 * n * h * h + agg) \
        + 4.0 * n * h * c
    return 2.0 * forward + backward


def aggregation_calls(config: dict, num_edges: int, value_bytes: int
                      ) -> dict[str, tuple[int, float, float]]:
    """A forward a layer in the train step and in the evaluation, a
    backward a layer."""
    n, e, _, _, h, layers, k = counts.shape(config, num_edges)
    b, ch = value_bytes, counts.CHANNEL_BYTES
    graph = counts.graph_bytes(n, e)
    fwd_bytes = graph + n * k * (b + ch) + n * h * b
    bwd_bytes = graph + n * h * b + n * k * ch + n * k * b
    ops = 2.0 * e * k
    return {"forward": (2 * layers, fwd_bytes, ops),
            "backward": (layers, bwd_bytes, ops)}
