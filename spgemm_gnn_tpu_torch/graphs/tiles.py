"""Plan-sizing rules (counterpart of the sizing helpers of
`spgemm_gnn_tpu/graphs/tiles.py`) and the port's plan for the dense regime.

The JAX package's TilePlan buckets edges by (destination block, source block)
for the TPU's slab gather; its sizing rules below (with
`predicted_windowed_fill` of its `stream_tiles.py`) decide which kind of
plan a graph gets. The
numbers are the JAX package's, unchanged, so the port picks the reference's
kind on every graph. On the card the "windowed" kind is `CSRPlan`: the
`csr_spmm` kernel over the CSR itself, with no buckets and no padding.
"""
from __future__ import annotations

import dataclasses

import torch

CHUNK = 128   # the TPU kernels' lane width; the sizing rules count in it


@dataclasses.dataclass(frozen=True)
class CSRPlan:
    """The "windowed" plan kind on the card: `csr_spmm` (one warp per
    destination row) over the CSR (indptr int32 [R + 1], indices int32 [E])."""
    indptr: torch.Tensor
    indices: torch.Tensor

    kind = "windowed"


def auto_window(num_nodes: int, num_edges: int, src_block: int,
                num_src_nodes: int | None = None) -> int:
    """Density-tuned destination-row window of the TPU's windowed plan: the
    smallest 8-multiple window with λ·RW ≳ CHUNK, where λ is the expected
    number of edges per (destination row, source block)."""
    n_src = num_src_nodes if num_src_nodes is not None else num_nodes
    n_src_blocks = max(-(-n_src // src_block), 1)
    avg_deg = num_edges / max(num_nodes, 1)
    lam = avg_deg / n_src_blocks
    rw = 8
    while rw * lam < CHUNK and rw < 256:
        rw *= 2
    return rw


def predicted_windowed_fill(num_rows: int, num_edges: int, src_block: int,
                            num_src_nodes: int, window: int) -> float:
    """Expected chunk fill of the TPU's windowed plan (counterpart of
    `spgemm_gnn_tpu/graphs/stream_tiles.py::predicted_windowed_fill`): the
    input of the plan-kind rule (kernels/planned.py::plan_kind)."""
    n_src_blocks = max(-(-num_src_nodes // src_block), 1)
    deg = num_edges / max(num_rows, 1)
    lam = deg / n_src_blocks          # edges per (dst row, src block)
    return min(lam * window, CHUNK) / CHUNK

