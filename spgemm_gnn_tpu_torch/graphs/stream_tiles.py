"""The low-degree plan (counterpart of `spgemm_gnn_tpu/graphs/stream_tiles.py`).

What carries over from the JAX StreamPlan is its contract: the in-CSR's
edges, in destination order, are cut into chunks of a fixed number of edges,
whatever the row lengths, so every chunk is full at any degree and no row's
length sets the tail of a launch. The TPU layout (padded [G, Wg, S] slots, a
-1 padding sentinel, 8-aligned row windows, groups that bound an HBM message
buffer) exists for Mosaic and is not carried over.

Chunk c holds the edges [c·chunk, min((c + 1)·chunk, E)). The `stream_spmm`
kernel (kernels/stream.py) gives each chunk a warp, which walks the chunk's
rows from `chunk_row0[c]` and writes every row that starts and ends in the
chunk. The rows it cannot finish are `carry_rows`: rows with no edges (they
come out 0) and rows whose edges span two or more chunks (a second pass adds
their per-chunk partial sums in chunk order).

Built on the graph's device with tensor ops (no Python loop over chunks:
ogbn-products has about 10⁶ of them).
"""
from __future__ import annotations

import dataclasses

import torch

from spgemm_gnn_tpu_torch.graphs.tiles import CHUNK

MAX_CHUNK = 512   # a chunk's source ids are staged in the warp's shared memory


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Fixed-size edge chunks over a CSR.

    Attributes:
      indptr, indices: the CSR (int32 [R + 1], int32 [E]) the plan runs on.
      chunk_row0: int32 [n_chunks], the row that holds each chunk's first edge.
      carry_rows: int32 [n_carry], ascending: the rows with no edges, and the
                  rows whose first and last edges lie in different chunks.
      chunk: edges per chunk.
    """
    indptr: torch.Tensor
    indices: torch.Tensor
    chunk_row0: torch.Tensor
    carry_rows: torch.Tensor
    chunk: int

    kind = "stream"

    @property
    def num_rows(self) -> int:
        return self.indptr.numel() - 1

    @property
    def num_edges(self) -> int:
        return self.indices.numel()

    @property
    def num_chunks(self) -> int:
        return self.chunk_row0.numel()


def build_stream_plan(indptr: torch.Tensor, indices: torch.Tensor, *,
                      chunk: int = CHUNK) -> StreamPlan:
    """A StreamPlan over the CSR (indptr, indices), on their device. For the
    backward pass give it the transpose CSR: the plan is direction-agnostic."""
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must lie in [1, {MAX_CHUNK}]; got {chunk}")
    ip = indptr.long()
    n_chunks = -(-indices.numel() // chunk)
    starts = torch.arange(n_chunks, device=ip.device) * chunk
    # the row holding edge e is the last row r with indptr[r] <= e
    chunk_row0 = torch.searchsorted(ip, starts, right=True) - 1
    a, b = ip[:-1], ip[1:]
    carry = (a == b) | (a // chunk != (b - 1) // chunk)
    return StreamPlan(indptr=indptr, indices=indices,
                      chunk_row0=chunk_row0.int(),
                      carry_rows=torch.nonzero(carry).flatten().int(),
                      chunk=chunk)


def stream_plan_for_graph(g, *, transpose: bool = False,
                          chunk: int = CHUNK) -> StreamPlan:
    """StreamPlan for a Graph's forward (in-CSR) or transpose (out-CSR)."""
    if transpose:
        return build_stream_plan(g.t_indptr, g.t_indices, chunk=chunk)
    return build_stream_plan(g.indptr, g.indices, chunk=chunk)
