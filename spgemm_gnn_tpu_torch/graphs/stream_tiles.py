"""The low-degree plan (counterpart of `spgemm_gnn_tpu/graphs/stream_tiles.py`).

What carries over from the JAX StreamPlan is its contract: the in-CSR's
edges, in destination order, are cut into chunks of a fixed number of edges,
whatever the row lengths, so every chunk is full at any degree and no row's
length sets the tail of a launch. The TPU layout (padded [G, Wg, S] slots, a
-1 padding sentinel, 8-aligned row windows, groups that bound an HBM message
buffer) exists for Mosaic and is not carried over.

Chunk c holds the edges [c·chunk, min((c + 1)·chunk, E)). The `stream_spmm`
kernel (kernels/stream.py) gives each span of `warp_chunks` consecutive
chunks a warp, which walks the span's rows from the first chunk's
`chunk_row0` and sums each row chunk by chunk: a running sum within a chunk,
and the chunks' partial sums added in chunk order. It writes every row whose
edges lie in its span. The rows it cannot finish are `carry_rows`: rows with
no edges (they come out 0) and rows whose edges reach past the span they
start in (a second pass adds the partial sums of their chunks in later spans,
in chunk order).

Built on the graph's device with tensor ops (no Python loop over chunks:
ogbn-products has about 10⁶ of them).

The transpose positions (`StreamPlan.transpose_positions`): for a plan on
the transpose CSR, where each edge of the forward CSR lies in this plan's
edge order, int32 [E]. The sampled backward (kernels/stream.py::
stream_sspmm) walks the forward CSR once and writes each edge's terms
there, so that the walk of this plan reads them in its own order.

The hot set (`HotSet`, `StreamPlan.hot_set`): the source rows the kernels
load with an L2 evict-last hint, so that the cold stream of gathered rows
does not push them out of the card's L2. They are the rows gathered most,
chosen from the plan's own `indices` (a `bincount`), never from node ids:
the synthetic stand-ins draw sources by rank, so their hot rows happen to be
their lowest ids, which a real graph's are not. The rows are taken by count,
descending, ties by id ascending, as many as a byte budget holds at the
call's row size (dim × 4 B for `stream_spmm`, the CBSR record for
`stream_cbsr_spmm`), so the sets of every size are nested. A hot set is
built once per (row bytes, budget) and kept on the plan.
"""
from __future__ import annotations

import dataclasses

import torch

from spgemm_gnn_tpu_torch.graphs.tiles import CHUNK, max_source

MAX_CHUNK = 512   # the kernels' carry slots and row rules are tested to here
# chunks a warp of the stream kernels walks (its fetch drains only at the end
# of them), and so the span whose rows it finishes itself
WARP_CHUNKS = 8

# L2 bytes given to the hot set by default, of the H100's 50 MB (the rest
# holds the cold rows, indices and outputs streaming through): the best of
# utils/stream_sweep.py on the ogbn-products stand-in (PERF.md)
HOT_BUDGET = 20 << 20


@dataclasses.dataclass(frozen=True)
class HotSet:
    """The `rows` most-gathered source ids of a plan at one row size.

    Attributes:
      rows: hot source rows (rows × row_bytes <= budget).
      row_bytes, budget: the row size and the byte budget it was built for.
      edge_share: the share of the plan's edges that gather a hot row.
      mask: int32 [ceil(S / 32)], bit u % 32 of word u // 32 set for a hot
            source u (S covers every id in the plan's indices); None when
            no row is hot.
    """
    rows: int
    row_bytes: int
    budget: int
    edge_share: float
    mask: torch.Tensor | None


def _bitmask(ids: torch.Tensor, n: int) -> torch.Tensor:
    """int32 words of a bitmask over [0, n) with the bits of `ids` set."""
    bits = torch.zeros(-(-n // 32) * 32, dtype=torch.int64, device=ids.device)
    bits[ids.long()] = 1
    shifts = torch.arange(32, device=ids.device)
    words = (bits.view(-1, 32) << shifts).sum(1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).int()


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Fixed-size edge chunks over a CSR.

    Attributes:
      indptr, indices: the CSR (int32 [R + 1], int32 [E]) the plan runs on.
      chunk_row0: int32 [n_chunks], the row that holds each chunk's first edge.
      carry_rows: int32 [n_carry], ascending: the rows with no edges, and the
                  rows whose first and last edges lie in different spans of
                  warp_chunks chunks.
      chunk: edges per chunk.
      warp_chunks: chunks per warp span.
      num_src: the source count the plan is built for (None: R, a square
               plan; a shard's halo pair is rectangular). It sizes the
               gather order and the hot set's mask.
      max_src: the largest source id (-1 with no edges), recorded at
               construction (`tiles.max_source`).
    """
    indptr: torch.Tensor
    indices: torch.Tensor
    chunk_row0: torch.Tensor
    carry_rows: torch.Tensor
    chunk: int
    warp_chunks: int = WARP_CHUNKS
    num_src: int | None = None
    max_src: int = dataclasses.field(default=-1, init=False)
    # (row bytes, budget) -> HotSet; "order" -> (source ids by gather count
    # descending, ties by id; their counts); "positions" -> the transpose
    # positions
    _hot: dict = dataclasses.field(default_factory=dict, init=False,
                                   compare=False, repr=False)

    kind = "stream"

    def __post_init__(self):
        # frozen: both are set once, here
        if self.num_src is None:
            object.__setattr__(self, "num_src", self.num_rows)
        object.__setattr__(self, "max_src", max_source(self.indices))

    @property
    def num_rows(self) -> int:
        return self.indptr.numel() - 1

    @property
    def num_edges(self) -> int:
        return self.indices.numel()

    @property
    def num_chunks(self) -> int:
        return self.chunk_row0.numel()

    def gather_order(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(ids, counts): every source id, by how many of the plan's edges
        gather it, descending, ties by id ascending (int64 each)."""
        if "order" not in self._hot:
            counts = torch.bincount(self.indices, minlength=self.num_src)
            counts, ids = torch.sort(counts, descending=True, stable=True)
            self._hot["order"] = (ids, counts)
        return self._hot["order"]

    def hot_set(self, row_bytes: int, budget: int | None = None) -> HotSet:
        """The hot set for rows of `row_bytes` under `budget` bytes
        (HOT_BUDGET when None): the floor(budget / row_bytes) most-gathered
        source ids that are gathered at all. Built once per (row bytes,
        budget)."""
        budget = HOT_BUDGET if budget is None else budget
        if row_bytes < 1 or budget < 0:
            raise ValueError(f"need row_bytes >= 1 and budget >= 0; got "
                             f"{row_bytes}, {budget}")
        key = (row_bytes, budget)
        if key not in self._hot:
            ids, counts = self.gather_order()
            rows = min(budget // row_bytes, int((counts > 0).sum()))
            share = float(counts[:rows].sum()) / max(self.num_edges, 1)
            mask = _bitmask(ids[:rows], ids.numel()) if rows else None
            self._hot[key] = HotSet(rows=rows, row_bytes=row_bytes,
                                    budget=budget, edge_share=share,
                                    mask=mask)
        return self._hot[key]

    def transpose_positions(self, fwd: "StreamPlan") -> torch.Tensor:
        """int32 [E]: for each edge of `fwd`'s CSR, in its order, the
        position of the same edge in this plan's CSR, which must hold fwd's
        edges transposed (a symmetric graph's plan is its own transpose).
        Repeated edges of one pair of nodes are matched in order. Built
        once, on the plan's device, and kept."""
        if "positions" not in self._hot:
            self._hot["positions"] = transpose_positions(
                fwd.indptr, fwd.indices, self.indptr, self.indices)
        return self._hot["positions"]


def _edge_rows(indptr: torch.Tensor, n_edges: int) -> torch.Tensor:
    """int64 [E]: the row of each edge of a CSR."""
    rows = torch.arange(indptr.numel() - 1, device=indptr.device)
    return torch.repeat_interleave(rows, indptr.diff().long(),
                                   output_size=n_edges)


def transpose_positions(indptr: torch.Tensor, indices: torch.Tensor,
                        t_indptr: torch.Tensor,
                        t_indices: torch.Tensor) -> torch.Tensor:
    """int32 [E]: for edge e of the CSR (indptr, indices), row u and column
    v, the position in the CSR (t_indptr, t_indices) of its edge of row v
    and column u; raises unless the second CSR is the first's transpose.
    Both edge lists are sorted stably by (v, u): the i-th edge of one is
    the i-th of the other."""
    n, n_edges = indptr.numel() - 1, indices.numel()
    if t_indices.numel() != n_edges:
        raise ValueError(f"transpose_positions: {n_edges} edges against "
                         f"{t_indices.numel()} in the transpose")
    key = indices.long() * n + _edge_rows(indptr, n_edges)
    order = torch.sort(key, stable=True).indices
    t_key = _edge_rows(t_indptr, n_edges) * n + t_indices.long()
    t_order = torch.sort(t_key, stable=True).indices
    if not torch.equal(key[order], t_key[t_order]):
        raise ValueError("transpose_positions: the second CSR is not the "
                         "transpose of the first")
    del key, t_key
    pos = torch.empty(n_edges, dtype=torch.int32, device=indices.device)
    pos[order] = t_order.int()
    return pos


def build_stream_plan(indptr: torch.Tensor, indices: torch.Tensor, *,
                      chunk: int = CHUNK,
                      warp_chunks: int = WARP_CHUNKS,
                      num_src: int | None = None) -> StreamPlan:
    """A StreamPlan over the CSR (indptr, indices), on their device, for
    num_src sources (None: as many as rows). For the backward pass give it
    the transpose CSR: the plan is direction-agnostic."""
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk must lie in [1, {MAX_CHUNK}]; got {chunk}")
    if warp_chunks < 1:
        raise ValueError(f"warp_chunks must be >= 1; got {warp_chunks}")
    ip = indptr.long()
    n_chunks = -(-indices.numel() // chunk)
    starts = torch.arange(n_chunks, device=ip.device) * chunk
    # the row holding edge e is the last row r with indptr[r] <= e
    chunk_row0 = torch.searchsorted(ip, starts, right=True) - 1
    a, b = ip[:-1], ip[1:]
    span = chunk * warp_chunks
    carry = (a == b) | (a // span != (b - 1) // span)
    return StreamPlan(indptr=indptr, indices=indices,
                      chunk_row0=chunk_row0.int(),
                      carry_rows=torch.nonzero(carry).flatten().int(),
                      chunk=chunk, warp_chunks=warp_chunks, num_src=num_src)

