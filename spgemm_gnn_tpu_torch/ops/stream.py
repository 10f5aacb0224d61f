"""Plain PyTorch versions of the stream CUDA kernels (kernels/stream.py;
counterpart of `spgemm_gnn_tpu/kernels/stream_pallas.py::stream_spmm`).

It follows the StreamPlan as the kernel does, so that a fault in the
chunk → row mapping shows on the CPU and not first on the card:
  1. the row of each edge is found from its chunk's `chunk_row0`;
  2. every (chunk, row) segment gets its partial sum (`scatter_add_`, in edge
     chunks bounded in bytes, as ops/spmm.py);
  3. a row that starts and ends inside one chunk is written from its one
     segment; a row's first segment, where the row goes on into later
     chunks, is written unscaled; a chunk's first segment, where its row
     began in an earlier chunk, goes to the chunk's carry slot;
  4. the carry pass walks `carry_rows`: a row with no edges comes out 0, a
     row across chunks adds the carry slots of its later chunks in chunk
     order, then takes its post factor.
Rows that no step writes stay NaN, so a plan that misses a row fails the
comparison instead of passing on a zero.

`stream_cbsr_spmm_plain` is the plain version of the `stream_cbsr_spmm`
kernel (counterpart of `stream_pallas.py::stream_spmm_cbsr`): the same
product with the input given as CBSR values and packed channel ids.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.ops.maxk import cbsr_to_dense, unpack_channels
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

    # 3. direct writes, and the carry slots
    lo = seg_chunk * c
    head = ip[seg_row] < lo
    cont = ~head & (ip[seg_row + 1] > torch.clamp(lo + c, max=n_edges))
    done = ~head & ~cont
    rows = seg_row[done]
    y[rows] = _scale(partial[done], None if post is None else post[rows])
    y[seg_row[cont]] = partial[cont]
    carry = x.new_zeros((plan.num_chunks, x.shape[1]))
    carry[seg_chunk[head]] = partial[head]

    # 4. carry pass: y[r] = post[r] · (y[r] + Σ carry[q], q = first + 1 ..
    # last chunk of r), in chunk order
    r = plan.carry_rows.long()
    a, b = ip[r], ip[r + 1]
    full = a < b
    acc = torch.where(full[:, None], y[r], 0.0)
    count = torch.where(full, (b - 1) // c - a // c, 0)
    pos = torch.repeat_interleave(torch.arange(r.numel(), device=dev), count)
    step = (torch.arange(pos.numel(), device=dev)
            - torch.repeat_interleave(count.cumsum(0) - count, count))
    acc.index_add_(0, pos, carry[(a // c)[pos] + 1 + step])
    y[r] = _scale(acc, None if post is None else post[r])
    return y


def stream_cbsr_spmm_plain(plan, values: torch.Tensor, pchannels: torch.Tensor,
                           dim: int, pre: torch.Tensor | None = None,
                           post: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the `stream_cbsr_spmm` kernel (kernels/stream.py):
    y = post ⊙ A (pre ⊙ cbsr(values, channels)) with the channels unpacked
    from `pchannels` (ops/maxk.py::pack_channels at this `dim`), densified,
    and summed over the plan as `stream_spmm_plain` does."""
    ch = unpack_channels(pchannels, values.shape[1], dim)
    return stream_spmm_plain(plan, cbsr_to_dense(values, ch, dim), pre, post)
