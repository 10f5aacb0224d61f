"""The yardstick's arithmetic: the card's peaks, the byte sizes, and the
floor of a call; each model family's operations per epoch and its
aggregation calls are its model file's (`models/<model>.py`).

Peaks are NVIDIA's data sheet for the H100 SXM, dense: 67 TFLOP/s in f32
outside the tensor cores (the port turns TF32 off), 989 TFLOP/s in bf16,
3.35 TB/s of HBM.

An epoch is one train step (forward, loss, backward, Adam) and one
evaluation forward. Its operations are the dense products (2 per
multiply-add) forward and backward, where the backward of lin_in needs
only its weight's gradient, and the aggregations. Element-wise work (MaxK,
dropout, LayerNorm, the loss, Adam) is not counted.

An aggregation call's floor is the larger of the bytes the function needs
over the HBM rate and its operations over the dtype's peak, whatever
layout the kernel uses.
"""
from __future__ import annotations

from benchmark import cells

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES_S = 3.35e12
# bytes of one element of each kind an aggregation moves; an activation
# takes its compute dtype's (DTYPE_BYTES)
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}
INDEX_BYTES = 4         # a row pointer or an int32 source id
CHANNEL_BYTES = 1       # a MaxK channel id
FACTOR_BYTES = 4        # an f32 per-node factor


def shape(config: dict, num_edges: int
          ) -> tuple[int, int, int, int, int, int, int]:
    """(nodes, edges, features, classes, hidden, layers, k) of a run."""
    ds, m = config["dataset"], config["model"]
    return (ds["num_nodes"], num_edges, ds["num_features"],
            ds["num_classes"], m["hidden_dim"], m["hidden_layers"],
            m["maxk"])


def graph_bytes(num_nodes: int, num_edges: int) -> int:
    """The CSR graph read once: row pointers and int32 sources."""
    return (num_nodes + 1) * INDEX_BYTES + num_edges * INDEX_BYTES


def floor_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least time of one call: its bytes over the HBM rate or its
    operations over the dtype's peak, the larger."""
    return max(nbytes / PEAK_BYTES_S, ops / PEAK_FLOPS[dtype])


def epoch_flops(config: dict, num_edges: int) -> float:
    """The operations of one epoch of `config` on a graph of `num_edges`
    edges."""
    return cells.model_file(config).epoch_flops(config, num_edges)


def _calls(config: dict, num_edges: int, dtype: str
           ) -> dict[str, tuple[int, float, float]]:
    return cells.model_file(config).aggregation_calls(
        config, num_edges, DTYPE_BYTES[dtype])


def aggregation_floor_s(config: dict, num_edges: int, dtype: str
                        ) -> dict[str, float]:
    """{kind: the floor in seconds of one aggregation call of that kind}, at
    the compute dtype `dtype`."""
    return {kind: floor_s(nbytes, ops, dtype)
            for kind, (_, nbytes, ops) in _calls(config, num_edges,
                                                 dtype).items()}


def epoch_aggregation_floor_s(config: dict, num_edges: int, dtype: str
                              ) -> float:
    """The floors of one epoch's aggregation calls, summed."""
    return sum(calls * floor_s(nbytes, ops, dtype)
               for calls, nbytes, ops in _calls(config, num_edges,
                                                dtype).values())
