"""The `csr_spmm` CUDA kernel: y = A_w x over a CSR, one warp per
destination row (counterpart of `spgemm_gnn_tpu/kernels/spgemm_pallas.py::
planned_spmm`, the windowed regime; source in `csrc/spmm.cu`, plain version
in `ops/spmm.py`). The autograd pair around it is
`kernels/planned.py::Aggregate`.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.ops.spmm import csr_spmm_plain

MAX_DIM = 1024   # a row's accumulators live in one warp's registers


def csr_spmm(indptr: torch.Tensor, indices: torch.Tensor, x: torch.Tensor,
             pre: torch.Tensor | None = None,
             post: torch.Tensor | None = None) -> torch.Tensor:
    """y[v] = post[v] · Σ_{u ∈ in(v)} pre[u] · x[u] (a None factor is 1).

    indptr int32 [R + 1], indices int32 [E], x f32 [S, dim] → y f32 [R, dim].
    Indices are trusted to lie in [0, S): graphs come from `from_edges`.
    """
    if _build.on_cpu(x):
        return csr_spmm_plain(indptr, indices, x, pre, post)
    dev = x.device
    _build.require(x, "x", torch.float32, dev, (None, None))
    n_src, dim = x.shape
    if dim % 4 or not 4 <= dim <= MAX_DIM:
        raise ValueError(f"csr_spmm needs dim % 4 == 0 and 4 <= dim <= "
                         f"{MAX_DIM}; got {dim}")
    _build.require(indptr, "indptr", torch.int32, dev, (None,))
    n_rows = indptr.numel() - 1
    _build.require(indices, "indices", torch.int32, dev, (None,))
    if pre is not None:
        _build.require(pre, "pre", torch.float32, dev, (n_src,))
    if post is not None:
        _build.require(post, "post", torch.float32, dev, (n_rows,))
    _build.require_aligned(x, "x")
    y = torch.empty((n_rows, dim), dtype=torch.float32, device=dev)
    if n_rows:
        with torch.cuda.device(dev):
            status = _build.library("spmm").csr_spmm(
                indptr.data_ptr(), indices.data_ptr(), x.data_ptr(),
                None if pre is None else pre.data_ptr(),
                None if post is None else post.data_ptr(),
                y.data_ptr(), n_rows, dim, _build.stream_of(x))
        _build.check(status, "csr_spmm")
        _build.launches["csr_spmm"] += 1
    return y
