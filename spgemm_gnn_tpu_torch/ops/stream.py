"""Plain PyTorch versions of the stream CUDA kernels (kernels/stream.py;
counterpart of `spgemm_gnn_tpu/kernels/stream_pallas.py::stream_spmm`).

It follows the StreamPlan as the kernel does, so that a fault in the
chunk → row mapping shows on the CPU and not first on the card:
  1. the row of each edge is found from its chunk's `chunk_row0`;
  2. every (chunk, row) segment gets its partial sum (`scatter_add_`, in edge
     chunks bounded in bytes, as ops/spmm.py);
  3. a row's segments in the span of `warp_chunks` chunks where it starts
     are added in chunk order (a warp's walk); a row that ends in that span
     is written whole, times post, one that goes on past it unscaled; a
     segment of a later span goes to its chunk's carry slot;
  4. the carry pass walks `carry_rows`: a row with no edges comes out 0, a
     row across spans adds the carry slots of its chunks past its first
     span in chunk order, then takes its post factor.
Rows that no step writes stay NaN, so a plan that misses a row fails the
comparison instead of passing on a zero.

`stream_cbsr_spmm_plain` is the plain version of the `stream_cbsr_spmm`
kernel (counterpart of `stream_pallas.py::stream_spmm_cbsr`): the same
product with the input given as one CBSR record per node (values and packed
channel ids, `ops/maxk.py::cbsr_records`).
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.ops.maxk import cbsr_to_dense, split_records
from spgemm_gnn_tpu_torch.ops.spmm import _gather_add, _scale


def stream_spmm_plain(plan, x: torch.Tensor, pre: torch.Tensor | None = None,
                      post: torch.Tensor | None = None) -> torch.Tensor:
    """y[v] = post[v] · Σ_{u ∈ in(v)} pre[u] · x[u] over the plan's CSR (a
    None factor is 1); y has plan.num_rows rows and x's dtype."""
    ip = plan.indptr.long()
    n, n_edges, c = plan.num_rows, plan.num_edges, plan.chunk
    dev = x.device
    y = x.new_full((n, x.shape[1]), float("nan"))

    # 1. row of edge e in chunk q: chunk_row0[q] plus the rows that start in
    # (q·c, e]; cnt[e] = #{r : indptr[r] <= e}
    e = torch.arange(n_edges, device=dev)
    q = e // c
    cnt = torch.bincount(ip[:-1], minlength=n_edges + 1)[:n_edges].cumsum(0)
    row = plan.chunk_row0.long()[q] + cnt - cnt[q * c]

    # 2. segments: maximal runs of edges of one row inside one chunk
    new_seg = e % c == 0
    new_seg[1:] |= row[1:] != row[:-1]
    first = torch.nonzero(new_seg).flatten()
    seg_row, seg_chunk = row[first], first // c
    seg = new_seg.cumsum(0) - 1
    partial = _gather_add(plan.indices, seg, _scale(x, pre), first.numel())

    # 3. the segments of a row's first span, added in chunk order; the
    # others to their chunks' carry slots
    wc = plan.warp_chunks
    in_first = seg_chunk // wc == ip[seg_row] // c // wc
    has = ip[:-1] < ip[1:]
    y[has] = 0.0
    y.index_add_(0, seg_row[in_first], partial[in_first])
    carry = x.new_zeros((plan.num_chunks, x.shape[1]))
    carry[seg_chunk[~in_first]] = partial[~in_first]
    done = has.clone()
    done[plan.carry_rows.long()] = False
    y[done] = _scale(y[done], None if post is None else post[done])

    # 4. carry pass: y[r] = post[r] · (y[r] + Σ carry[q], q = the first
    # chunk past r's first span .. r's last chunk), in chunk order
    r = plan.carry_rows.long()
    a, b = ip[r], ip[r + 1]
    full = a < b
    acc = torch.where(full[:, None], y[r], 0.0)
    q0 = (a // c // wc + 1) * wc
    count = torch.where(full, torch.clamp((b - 1) // c - q0 + 1, min=0), 0)
    pos = torch.repeat_interleave(torch.arange(r.numel(), device=dev), count)
    step = (torch.arange(pos.numel(), device=dev)
            - torch.repeat_interleave(count.cumsum(0) - count, count))
    acc.index_add_(0, pos, carry[q0[pos] + step])
    y[r] = _scale(acc, None if post is None else post[r])
    return y


def stream_cbsr_spmm_plain(plan, records: torch.Tensor, k: int, dim: int,
                           pre: torch.Tensor | None = None,
                           post: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the `stream_cbsr_spmm` kernel (kernels/stream.py):
    y = post ⊙ A (pre ⊙ cbsr(values, channels)) with (values, channels)
    split from the records (ops/maxk.py::cbsr_records at this `k` and
    `dim`), densified, and summed over the plan as `stream_spmm_plain`
    does."""
    values, ch = split_records(records, k, dim)
    return stream_spmm_plain(plan, cbsr_to_dense(values, ch, dim), pre, post)
