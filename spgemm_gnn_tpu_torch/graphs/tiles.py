"""Plan-sizing rules (counterpart of the sizing helpers of
`spgemm_gnn_tpu/graphs/tiles.py`) and the port's plan for the dense regime.

The JAX package's TilePlan buckets edges by (destination block, source block)
for the TPU's slab gather; its sizing rules below (with
`predicted_windowed_fill` of its `stream_tiles.py`) decide which kind of
plan a graph gets. The numbers are the JAX package's, unchanged, so the port
picks the reference's kind on every graph.

On the card the "windowed" kind is `CSRPlan`: the CSR, and the schedule the
`csr_spmm` kernel runs (`CSRSchedule`, built once per plan and width):
- source blocks: the source ids cut into `nb` contiguous blocks, each a slab
  of x small enough for the card's L2 (`auto_src_blocks`, the counterpart of
  the JAX package's `auto_src_block`, sized for L2 instead of VMEM, by row
  bytes: bf16 rows take half the blocks of f32 ones). The
  edges are re-bucketed by (source block, destination row), stably, so each
  row keeps its CSR order inside a block. The kernel runs one pass per block,
  in block order, and every warp of a pass gathers from that block's slab;
- row segments: each (block, row) run of edges is cut into pieces of at most
  `segment` edges, so no warp gathers more than that in a pass whatever a
  hub row's degree. A run of one piece is a "whole" segment; the pieces of a
  longer run write partial sums to scratch slots, which a fix-up entry adds
  in order. Segments are listed heaviest first within each pass.
"""
from __future__ import annotations

import dataclasses

import torch

CHUNK = 128   # the TPU kernels' lane width; the sizing rules count in it

# half of the H100's 50 MB L2: a source block's slab of x (the other half
# holds the indices, y and the scratch streaming through)
L2_BLOCK_BYTES = 24 << 20
# below this many expected edges per (destination row, source block),
# blocking's per-pass y traffic and segment count outweigh the L2 reuse it
# buys: one block. On the H100, Reddit's A at dim 256 broke even near 9
# (utils/csr_sweep.py: 40 blocks, 12.1 edges per row and block, beat one
# block by 23 %; 80 blocks, 6.1, lost to it by 16 %)
MIN_EDGES_PER_BLOCK_ROW = 10.0
# most edges a warp gathers in one segment: on the H100 the full Reddit
# product took within 2 % of the same time at 256, 512 and 1024, and the
# 1024 rows of highest degree alone (~1.3k runs of ~840 edges per pass)
# filled one wave of warps at 512 but half a wave at 1024
SEGMENT = 512

# flags of a row's last write in a pass (whole segment or fix-up entry)
FIRST = 1   # the row's first block with edges: write, do not add to y
LAST = 2    # the row's last block with edges: multiply by post


def auto_src_blocks(num_rows: int, num_edges: int, dim: int,
                    num_src_nodes: int | None = None,
                    elem_bytes: int = 4) -> int:
    """Source blocks for `csr_spmm` at width `dim` and `elem_bytes` a
    channel (4 for f32 rows, 2 for the 16-bit stream's bf16 rows): enough
    that each block's slab of x (rows × dim × elem_bytes) fits in
    L2_BLOCK_BYTES, or 1 where the expected edges per (row, block) fall
    below MIN_EDGES_PER_BLOCK_ROW."""
    n_src = num_src_nodes if num_src_nodes is not None else num_rows
    block_rows = max(L2_BLOCK_BYTES // (elem_bytes * dim), 1)
    nb = max(-(-n_src // block_rows), 1)
    if num_edges / max(num_rows, 1) / nb < MIN_EDGES_PER_BLOCK_ROW:
        return 1
    return nb


@dataclasses.dataclass(frozen=True)
class CSRSchedule:
    """What `csr_spmm` runs: the CSR re-bucketed by source block, cut into
    row segments.

    Attributes:
      nb, block_rows: source blocks, and source ids per block (the last may
                      hold fewer): block b holds ids [b·block_rows, ...).
      segment: most edges per segment.
      indices: int32 [E], the sources re-bucketed by (block, row), each row's
               CSR order kept within a block (the CSR's own tensor at nb 1).
      block_indptr: int32 [nb, R + 1]: block b's edges of row r are
               indices[block_indptr[b, r]:block_indptr[b, r + 1]].
      seg: int32 [n_seg, 4] (row, lo, hi, out), the edges indices[lo:hi];
           out >= 0 is the scratch slot of a piece of a split run, out < 0
           a whole segment with flags -1 - out (FIRST, LAST). A row with no
           edges has one empty segment (FIRST | LAST) in pass 0.
      fix: int32 [n_fix, 4] (row, slot_lo, slot_hi, flags): a split run, the
           sum of scratch slots [slot_lo, slot_hi) in order.
      pass_seg, pass_fix: int64 [nb + 1] on the host: pass b's entries are
           seg[pass_seg[b]:pass_seg[b + 1]] (heaviest first) and
           fix[pass_fix[b]:pass_fix[b + 1]].
      n_slots: scratch slots (rows of dim floats) the busiest pass needs.
    """
    nb: int
    block_rows: int
    segment: int
    indices: torch.Tensor
    block_indptr: torch.Tensor
    seg: torch.Tensor
    fix: torch.Tensor
    pass_seg: torch.Tensor
    pass_fix: torch.Tensor
    n_slots: int

    @property
    def num_segments(self) -> int:
        return self.seg.shape[0]

    @property
    def num_split_runs(self) -> int:
        return self.fix.shape[0]

    def extra_bytes(self, csr_indices: torch.Tensor) -> int:
        """Device bytes beyond the CSR (the scratch, allocated per call, not
        counted)."""
        own = sum(t.numel() * t.element_size()
                  for t in (self.block_indptr, self.seg, self.fix))
        if self.indices.data_ptr() != csr_indices.data_ptr():
            own += self.indices.numel() * self.indices.element_size()
        return own


def _segments(runs_b, runs_row, lo, cnt, flags, nb: int, segment: int):
    """Cut the runs (block, row, first edge, edge count, flags), listed
    block-major, into segments and fix-up entries."""
    dev = lo.device
    pieces = torch.clamp(-(-cnt // segment), min=1)   # an empty run: 1
    split = pieces > 1
    run = torch.repeat_interleave(torch.arange(pieces.numel(), device=dev),
                                  pieces)
    first = torch.cumsum(pieces, 0) - pieces
    j = torch.arange(run.numel(), device=dev) - first[run]
    s_lo = lo[run] + j * segment
    s_hi = torch.minimum(s_lo + segment, (lo + cnt)[run])
    s_b = runs_b[run]
    # slots count the pieces of split runs within each pass, in run order
    is_piece = split[run].long()
    before = torch.cumsum(is_piece, 0) - is_piece
    per_pass = torch.zeros(nb, dtype=torch.long, device=dev)
    per_pass.index_add_(0, s_b, is_piece)
    pass_start = torch.cumsum(per_pass, 0) - per_pass
    slot = before - pass_start[s_b]
    out = torch.where(is_piece.bool(), slot, -1 - flags[run])
    # heaviest first within a pass; stable, so equal lengths keep run order
    key = s_b * (segment + 1) + (segment - (s_hi - s_lo))
    order = torch.sort(key, stable=True).indices
    seg = torch.stack([runs_row[run], s_lo, s_hi, out], 1)[order]
    slot_lo = slot[first]
    fix = torch.stack([runs_row, slot_lo, slot_lo + pieces, flags], 1)[split]
    n_slots = int(per_pass.max())
    return seg, fix, s_b[order], runs_b[split], n_slots


def build_csr_schedule(indptr: torch.Tensor, indices: torch.Tensor,
                       num_src_nodes: int, nb: int,
                       segment: int = SEGMENT) -> CSRSchedule:
    """The schedule of `csr_spmm` over the CSR (indptr int32 [R + 1],
    indices int32 [E], sources in [0, num_src_nodes)) with nb source blocks,
    on the CSR's device. Direction-agnostic: give the transpose CSR for the
    backward."""
    if nb < 1 or segment < 1:
        raise ValueError(f"need nb >= 1 and segment >= 1; got {nb}, "
                         f"{segment}")
    dev = indptr.device
    n_rows = indptr.numel() - 1
    block_rows = max(-(-num_src_nodes // nb), 1)
    ip = indptr.long()
    if nb == 1:
        ix, bptr = indices, indptr[None]
    else:
        deg = ip.diff()
        rows = torch.repeat_interleave(torch.arange(n_rows, device=dev), deg,
                                       output_size=indices.numel())
        blk = indices.long() // block_rows
        # the CSR is row-major, so a stable sort by block keeps (row, CSR
        # order) within each block
        ix = indices[torch.sort(blk, stable=True).indices]
        cnt = torch.zeros(nb * n_rows, dtype=torch.long, device=dev)
        cnt.index_add_(0, blk * n_rows + rows, torch.ones_like(blk))
        flat = torch.zeros(nb * n_rows + 1, dtype=torch.long, device=dev)
        torch.cumsum(cnt, 0, out=flat[1:])
        at = (torch.arange(nb, device=dev)[:, None] * n_rows
              + torch.arange(n_rows + 1, device=dev))
        bptr = flat[at].int()
    b_lo = bptr.long()
    cnt = b_lo[:, 1:] - b_lo[:, :-1]                      # [nb, R]
    has = cnt > 0
    runs_b, runs_row = has.nonzero(as_tuple=True)          # block-major
    first_b = torch.where(has.any(0), has.int().argmax(0), -1)
    last_b = nb - 1 - has.flip(0).int().argmax(0)
    flags = (FIRST * (runs_b == first_b[runs_row])
             + LAST * (runs_b == last_b[runs_row]))
    lo, c = b_lo[runs_b, runs_row], cnt[runs_b, runs_row]
    # a row with no edges: one empty whole segment in pass 0, so that it is
    # written (0, as the plain version's)
    empty = (first_b < 0).nonzero().flatten()
    zeros = torch.zeros_like(empty)
    runs_b = torch.cat([zeros, runs_b])
    runs_row = torch.cat([empty, runs_row])
    lo = torch.cat([zeros, lo])
    c = torch.cat([zeros, c])
    flags = torch.cat([zeros + (FIRST | LAST), flags])
    # block-major again (the empty rows went first, in pass 0 already)
    seg, fix, seg_b, fix_b, n_slots = _segments(runs_b, runs_row, lo, c,
                                                flags, nb, segment)

    def offsets(b):
        counts = torch.bincount(b, minlength=nb).cpu()
        return torch.cat([torch.zeros(1, dtype=torch.long),
                          torch.cumsum(counts, 0)])

    return CSRSchedule(
        nb=nb, block_rows=block_rows, segment=segment, indices=ix,
        block_indptr=bptr, seg=seg.int().contiguous(),
        fix=fix.int().contiguous(), pass_seg=offsets(seg_b),
        pass_fix=offsets(fix_b), n_slots=n_slots)


def max_source(indices: torch.Tensor) -> int:
    """The largest source id of a plan's indices (-1 with no edges), read
    to the host once, when the plan is built: the wrappers check each
    call's x against it (`kernels/_build.py::require_sources`) with no
    device sync."""
    return int(indices.max()) if indices.numel() else -1


@dataclasses.dataclass(frozen=True)
class CSRPlan:
    """The "windowed" plan kind on the card: the CSR (indptr int32 [R + 1],
    indices int32 [E]) and its `csr_spmm` schedules, built at first use per
    (blocks, source count) and kept, so the schedules of two row sizes (f32
    and bf16 rows) sit side by side. `src_blocks` forces nb (None: the rule
    `auto_src_blocks` at the call's row bytes); `segment` is the segment
    size; `num_src` the source count the plan is built for (None: R, a
    square plan; a shard's halo pair is rectangular). `max_src` is the
    largest source id, recorded at construction."""
    indptr: torch.Tensor
    indices: torch.Tensor
    src_blocks: int | None = None
    segment: int = SEGMENT
    num_src: int | None = None
    max_src: int = dataclasses.field(default=-1, init=False)
    _schedules: dict = dataclasses.field(default_factory=dict, init=False,
                                         compare=False, repr=False)

    kind = "windowed"

    def __post_init__(self):
        # frozen: both are set once, here
        if self.num_src is None:
            object.__setattr__(self, "num_src", self.num_rows)
        object.__setattr__(self, "max_src", max_source(self.indices))

    @property
    def num_rows(self) -> int:
        return self.indptr.numel() - 1

    def schedule(self, num_src_nodes: int, dim: int,
                 elem_bytes: int = 4) -> CSRSchedule:
        """The schedule for an x of num_src_nodes rows of width dim, with
        elem_bytes a channel."""
        nb = self.src_blocks or auto_src_blocks(
            self.num_rows, self.indices.numel(), dim, num_src_nodes,
            elem_bytes)
        key = (nb, num_src_nodes)
        if key not in self._schedules:
            self._schedules[key] = build_csr_schedule(
                self.indptr, self.indices, num_src_nodes, nb, self.segment)
        return self._schedules[key]


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
