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

`csr_cbsr_spmm` gathers records, not dense rows, over the same schedule
(`RecordWalk`, built once per schedule and record size): its source blocks
grouped into record passes, as many whole blocks a pass as the records of
fit in L2_BLOCK_BYTES (`record_group`), and in each pass a warp per row
that walks the row's runs in block order, so that y is written once a
record pass, not once a block, with the same sums.
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
# a record walk's entry that sums one piece of a split run into its
# scratch slot
PIECE = 4


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


def record_group(block_rows: int, record_bytes: int) -> int:
    """Source blocks a record pass of `csr_cbsr_spmm` takes: as many whole
    blocks of `block_rows` sources as whose records, `record_bytes` each,
    fit in L2_BLOCK_BYTES, at least one and at most 32 (a row's runs in a
    pass, one a block, sit one a lane of its warp). At Reddit: 6 of the
    f32 schedule's 10 blocks for 160-B f32 records, 4 of the bf16
    schedule's 5 for 128-B bf16 ones."""
    return min(max(L2_BLOCK_BYTES // (record_bytes * block_rows), 1), 32)


@dataclasses.dataclass(frozen=True)
class RecordWalk:
    """What `csr_cbsr_spmm` runs over a CSRSchedule: the schedule's source
    blocks in record passes of `group` blocks (the last may hold fewer),
    and in each pass two launches, the pieces of its split runs, then its
    rows.

    Attributes:
      group, passes: source blocks a record pass, and record passes.
      entries: int32 [n, 4] (out, run_lo, run_hi, flags), a warp each, that
               sums the runs runs[run_lo:run_hi] in order. With flags PIECE
               (and FIRST): one piece of a split run, its sum to scratch
               slot `out`. Else `out` is a row and the runs are its runs in
               the pass's blocks, in block order; each run's sum is added
               to the row's (from +0 with FIRST, else from y) and the row
               written to y once (times post with LAST). A row with no
               edges has no runs and FIRST | LAST, in pass 0. Heaviest
               first in each launch.
      runs: int32 [n_runs, 2]: (lo, hi) with lo >= 0, the edges
            indices[lo:hi], in batches of 32 from lo as a segment sums
            them; or (-1 - slot_lo, slot_hi), a split run: scratch slots
            [slot_lo, slot_hi) added in order, as its fix-up entry adds
            them.
      offsets: int64 [2 passes + 1] on the host: pass p's pieces are
               entries[offsets[2p]:offsets[2p + 1]], its rows
               entries[offsets[2p + 1]:offsets[2p + 2]].
      n_slots: scratch slots (rows of dim floats) the busiest pass needs.
    """
    group: int
    passes: int
    entries: torch.Tensor
    runs: torch.Tensor
    offsets: torch.Tensor
    n_slots: int
    # the record passes with anything to launch (`record_passes` counts
    # them a call)
    launched: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        # frozen: set once, here
        object.__setattr__(self, "launched", int(
            (self.offsets[2::2] > self.offsets[:-1:2]).sum()))


def build_record_walk(s: CSRSchedule, group: int) -> RecordWalk:
    """The record walk of schedule s in passes of `group` source blocks, on
    the schedule's device: s's runs, pieces and flags, each pass's slots
    those of its blocks' passes one after another, so that every sum is
    the per-block passes' bit for bit."""
    nb, dev = s.nb, s.seg.device
    passes = -(-nb // group)
    bptr = s.block_indptr.long()
    n_rows = bptr.shape[1] - 1
    cnt = bptr[:, 1:] - bptr[:, :-1]                        # [nb, R]
    has = cnt > 0
    runs_b, runs_row = has.nonzero(as_tuple=True)           # block-major
    lo, c = bptr[runs_b, runs_row], cnt[runs_b, runs_row]
    split = c > s.segment

    def owner(offsets):   # the block of each entry of a block pass
        return torch.repeat_interleave(torch.arange(nb), offsets.diff()).to(
            dev)

    seg = s.seg.long()
    seg_b = owner(s.pass_seg)
    is_piece = seg[:, 3] >= 0
    per_block = torch.zeros(nb, dtype=torch.long, device=dev)
    per_block.index_add_(0, seg_b, is_piece.long())
    before = torch.cumsum(per_block, 0) - per_block
    first_block = torch.arange(nb, device=dev) // group * group
    shift = before - before[first_block]   # slots of the pass's earlier blocks
    # the fix-up entries are the split runs, in the same block-major order
    fix = s.fix.long()
    fix_shift = shift[owner(s.pass_fix)]
    run_a, run_z = lo.clone(), lo + c
    run_a[split] = -1 - (fix[:, 1] + fix_shift)
    run_z[split] = fix[:, 2] + fix_shift
    weight = torch.where(split, -(-c // s.segment), c)

    # a row's runs in a pass: sorted by (pass, row), stably, so in block order
    row_key = runs_b // group * n_rows + runs_row
    order = torch.sort(row_key, stable=True).indices
    keys, counts = torch.unique_consecutive(row_key[order],
                                            return_counts=True)
    run_hi = torch.cumsum(counts, 0)
    entry = torch.repeat_interleave(torch.arange(keys.numel(), device=dev),
                                    counts)
    row_w = torch.zeros(keys.numel(), dtype=torch.long, device=dev)
    row_w.index_add_(0, entry, weight[order])
    rows, row_pass = keys % n_rows, keys // n_rows
    first_b = torch.where(has.any(0), has.int().argmax(0), 0)
    last_b = nb - 1 - has.flip(0).int().argmax(0)
    flags = (FIRST * (first_b[rows] // group == row_pass)
             + LAST * (last_b[rows] // group == row_pass))
    empty = (~has.any(0)).nonzero().flatten()
    none = torch.zeros_like(empty)
    n_row_runs = order.numel()
    row_entries = torch.stack([
        torch.cat([empty, rows]), torch.cat([none, run_hi - counts]),
        torch.cat([none, run_hi]),
        torch.cat([none + (FIRST | LAST), flags])], 1)

    pieces = seg[is_piece]
    piece_b = seg_b[is_piece]
    n_pieces = pieces.shape[0]
    at = n_row_runs + torch.arange(n_pieces, device=dev)
    piece_entries = torch.stack([pieces[:, 3] + shift[piece_b], at, at + 1,
                                 torch.full_like(at, PIECE | FIRST)], 1)
    runs = torch.cat([torch.stack([run_a[order], run_z[order]], 1),
                      pieces[:, 1:3]])

    # launch l = 2 pass + (0: pieces, 1: rows); heaviest first within each
    launch = torch.cat([piece_b // group * 2,
                        torch.cat([none, row_pass]) * 2 + 1])
    w = torch.cat([pieces[:, 2] - pieces[:, 1], none, row_w])
    top = int(w.max()) + 1 if w.numel() else 1
    by = torch.sort(launch * top + (top - 1 - w), stable=True).indices
    entries = torch.cat([piece_entries, row_entries])[by]
    per_launch = torch.bincount(launch, minlength=2 * passes).cpu()
    slots = torch.bincount(piece_b // group, minlength=passes)
    return RecordWalk(
        group=group, passes=passes, entries=entries.int().contiguous(),
        runs=runs.int().contiguous(),
        offsets=torch.cat([torch.zeros(1, dtype=torch.long),
                           torch.cumsum(per_launch, 0)]),
        n_slots=int(slots.max()) if passes else 0)


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
    The record walks built over it (`record_walk`) are kept by group.
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
    _walks: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    def record_walk(self, record_bytes: int) -> RecordWalk:
        """The record walk for records of `record_bytes` a source, in
        passes of `record_group` blocks (built at the first call with that
        group, then kept)."""
        group = min(record_group(self.block_rows, record_bytes), self.nb)
        if group not in self._walks:
            self._walks[group] = build_record_walk(self, group)
        return self._walks[group]

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
