"""The `stream_spmm` CUDA kernel: y = A_w x over a StreamPlan's edge chunks
(counterpart of `spgemm_gnn_tpu/kernels/stream_pallas.py::stream_spmm`;
source in `csrc/stream.cu`, plain version in `ops/stream.py`).
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels.spmm import MAX_DIM
from spgemm_gnn_tpu_torch.ops.stream import stream_spmm_plain


def stream_spmm(plan, x: torch.Tensor, pre: torch.Tensor | None = None,
                post: torch.Tensor | None = None) -> torch.Tensor:
    """y[v] = post[v] · Σ_{u ∈ in(v)} pre[u] · x[u] over the StreamPlan's
    CSR (a None factor is 1); x f32 [S, dim] → y f32 [plan.num_rows, dim].
    Indices are trusted to lie in [0, S): graphs come from `from_edges`."""
    if _build.on_cpu(x):
        return stream_spmm_plain(plan, x, pre, post)
    dev = x.device
    _build.require(x, "x", torch.float32, dev, (None, None))
    n_src, dim = x.shape
    if dim % 4 or not 4 <= dim <= MAX_DIM:
        raise ValueError(f"stream_spmm needs dim % 4 == 0 and 4 <= dim <= "
                         f"{MAX_DIM}; got {dim}")
    n_rows, n_chunks = plan.num_rows, plan.num_chunks
    _build.require(plan.indptr, "indptr", torch.int32, dev, (n_rows + 1,))
    _build.require(plan.indices, "indices", torch.int32, dev, (None,))
    _build.require(plan.chunk_row0, "chunk_row0", torch.int32, dev,
                   (n_chunks,))
    _build.require(plan.carry_rows, "carry_rows", torch.int32, dev, (None,))
    if pre is not None:
        _build.require(pre, "pre", torch.float32, dev, (n_src,))
    if post is not None:
        _build.require(post, "post", torch.float32, dev, (n_rows,))
    _build.require_aligned(x, "x")
    y = torch.empty((n_rows, dim), dtype=torch.float32, device=dev)
    # per chunk, the partial sum of a row that began in an earlier chunk
    carry = torch.empty((n_chunks, dim), dtype=torch.float32, device=dev)
    if n_rows:
        with torch.cuda.device(dev):
            status = _build.library("stream").stream_spmm(
                plan.indptr.data_ptr(), plan.indices.data_ptr(),
                x.data_ptr(), None if pre is None else pre.data_ptr(),
                None if post is None else post.data_ptr(),
                plan.chunk_row0.data_ptr(), plan.carry_rows.data_ptr(),
                y.data_ptr(), carry.data_ptr(), n_chunks,
                plan.carry_rows.numel(), plan.num_edges, plan.chunk, dim,
                _build.stream_of(x))
        _build.check(status, "stream_spmm")
        _build.launches["stream_spmm"] += 1
    return y
