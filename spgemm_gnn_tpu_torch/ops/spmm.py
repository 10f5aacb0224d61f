"""Plain PyTorch sparse aggregation (counterpart of `spgemm_gnn_tpu/ops/
spmm.py`): a row gather over edges followed by `scatter_add_` into the
destinations. Not `index_add_`: autograd keeps index_add's source for its
backward, so the differentiated oracle would hold every gathered message
(E·dim·4 B, 127 GB at ogbn-products' width 256); scatter_add keeps only its
index, here an expanded view of the edge rows.

`csr_spmm_plain` is the plain version of the `csr_spmm` CUDA kernel
(kernels/spmm.py) and the reference the kernel is held to on the card;
`csr_blocked_plain` takes it block by block over the kernel's schedule (one
block is the whole CSR), and is the wrapper's CPU path. `spmm` is the
differentiable oracle the tests compare the autograd pair with; its gradient
comes from autograd, not from the transpose CSR.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.ops.norms import node_factors

# cap on one chunk of gathered [edges, dim] messages: at Reddit scale the
# whole message array would be E·dim·4 B ≈ 117 GB, so edges go in chunks
_MSG_BYTES_CAP = 1 << 30


def _scale(x: torch.Tensor, f: torch.Tensor | None) -> torch.Tensor:
    return x if f is None else x * f[:, None].to(x.dtype)


def _gather_add(indices: torch.Tensor, rows: torch.Tensor,
                      x: torch.Tensor, num_out: int) -> torch.Tensor:
    """out[rows[e]] += x[indices[e]] over all edges e, chunked by bytes."""
    dim = x.shape[-1]
    out = x.new_zeros((num_out, dim))
    chunk = max(_MSG_BYTES_CAP // max(dim * x.element_size(), 1), 1)
    for lo in range(0, indices.numel(), chunk):
        index = rows[lo:lo + chunk].long()[:, None].expand(-1, dim)
        out.scatter_add_(0, index, x.index_select(0, indices[lo:lo + chunk]))
    return out


def csr_spmm_plain(indptr: torch.Tensor, indices: torch.Tensor,
                   x: torch.Tensor, pre: torch.Tensor | None = None,
                   post: torch.Tensor | None = None) -> torch.Tensor:
    """y[v] = post[v] · Σ_{u ∈ in(v)} pre[u] · x[u] over the CSR
    (indptr, indices); a None factor is 1. Output rows = len(indptr) - 1."""
    n_out = indptr.numel() - 1
    rows = torch.repeat_interleave(
        torch.arange(n_out, dtype=torch.int32, device=indptr.device),
        indptr.diff(), output_size=indices.numel())
    return _scale(_gather_add(indices, rows, _scale(x, pre), n_out),
                  post)


def csr_blocked_plain(block_indptr: torch.Tensor, indices: torch.Tensor,
                      x: torch.Tensor, pre: torch.Tensor | None = None,
                      post: torch.Tensor | None = None) -> torch.Tensor:
    """`csr_spmm_plain` block by block over a CSR re-bucketed by source
    block (graphs/tiles.py::CSRSchedule: block b's edges of row r are
    indices[block_indptr[b, r]:block_indptr[b, r + 1]]), the blocks' sums
    added in block order, then the post factor: the order of the `csr_spmm`
    kernel's passes. One block is `csr_spmm_plain` itself."""
    y = None
    for bptr in block_indptr:
        lo, hi = int(bptr[0]), int(bptr[-1])
        part = csr_spmm_plain(bptr - lo, indices[lo:hi], x, pre)
        y = part if y is None else y + part
    return _scale(y, post)


def spmm(g, x: torch.Tensor, norm: str = "sum") -> torch.Tensor:
    """y[v] = Σ_{in-edges u→v} w_e · x[u] with w from `norm`, differentiated
    by autograd."""
    src_f, dst_f = node_factors(g, norm)
    y = _gather_add(g.indices, g.edge_dst, _scale(x, src_f),
                          g.num_nodes)
    return _scale(y, dst_f)
