"""The yardstick's arithmetic: the card's peaks, the model's operations per
epoch, and the aggregation's floor.

Peaks are NVIDIA's data sheet for the H100 SXM, dense: 67 TFLOP/s in f32
outside the tensor cores (the port turns TF32 off), 989 TFLOP/s in bf16,
3.35 TB/s of HBM.

An epoch is one train step (forward, loss, backward, Adam) and one
evaluation forward. Its operations are the dense products (lin_in, each
layer's fc_self and fc_neigh, lin_out; 2 per multiply-add) forward and
backward, where the backward of lin_in needs only its weight's gradient,
and the aggregations: 2·E·k for a mean over k-sparse rows, forward, and 2·E·k
for its sampled backward. Element-wise work (MaxK, dropout, LayerNorm, the
loss, Adam) is not counted.

An aggregation's floor is the larger of the bytes the function needs over
the HBM rate and its operations over the dtype's peak: the graph (row
pointers and int32 sources) read once, the input read once at MaxK's k
channels (a value and a one-byte channel id each) or, for the backward, the
dense cotangent read once, and the output written once (dense for the
forward, k channels for the backward), whatever layout the kernel uses.
"""
from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}
INDEX_BYTES = 4
CHANNEL_ID_BYTES = 1


def _shape(config: dict, num_edges: int
           ) -> tuple[int, int, int, int, int, int, int]:
    ds, m = config["dataset"], config["model"]
    return (ds["num_nodes"], num_edges,
            ds["num_features"], ds["num_classes"], m["hidden_dim"],
            m["hidden_layers"], m["maxk"])


def epoch_flops(config: dict, num_edges: int) -> float:
    """The operations of one epoch of a SAGE-MaxK configuration on a graph
    of `num_edges` edges."""
    n, e, f, c, h, layers, k = _shape(config, num_edges)
    agg = 2.0 * e * k
    forward = 2.0 * n * f * h + layers * (4.0 * n * h * h + agg) \
        + 2.0 * n * h * c
    backward = 2.0 * n * f * h + layers * (8.0 * n * h * h + agg) \
        + 4.0 * n * h * c
    return 2.0 * forward + backward


def aggregation_floor_s(config: dict, num_edges: int, dtype: str
                        ) -> dict[str, float]:
    """{"forward", "backward"}: the floor in seconds of one aggregation
    call of each kind, at the compute dtype `dtype`."""
    n, e, _, _, h, _, k = _shape(config, num_edges)
    b = DTYPE_BYTES[dtype]
    graph = (n + 1) * INDEX_BYTES + e * INDEX_BYTES
    fwd_bytes = graph + n * k * (b + CHANNEL_ID_BYTES) + n * h * b
    bwd_bytes = graph + n * h * b + n * k * CHANNEL_ID_BYTES + n * k * b
    ops = 2.0 * e * k
    t_ops = ops / PEAK_FLOPS[dtype]
    return {"forward": max(fwd_bytes / PEAK_BYTES_S, t_ops),
            "backward": max(bwd_bytes / PEAK_BYTES_S, t_ops)}


def epoch_aggregation_floor_s(config: dict, num_edges: int, dtype: str
                              ) -> float:
    """The floors of one epoch's aggregations: a forward per layer in the
    train step and in the evaluation, a backward per layer."""
    floor = aggregation_floor_s(config, num_edges, dtype)
    layers = config["model"]["hidden_layers"]
    return 2 * layers * floor["forward"] + layers * floor["backward"]
