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
comes from autograd, not from the transpose CSR. `spmm_transpose` is its
adjoint over the transpose CSR.

The 16-bit feature stream: `round_rows_plain` makes its messages, bf16(pre ⊙
x) (the plain version of the `round_rows` kernel, kernels/round.py); the
plain sums take bf16 rows by widening them exactly to f32 first, so that
they sum what the bf16 kernels gather.

`csr_cbsr_plain` is the plain version of the `csr_cbsr_spmm` CUDA kernels
(kernels/spmm.py): the same blocked sum on a k-sparse input given as one
f32 or bf16 CBSR record per node (`ops/maxk.py::cbsr_records`), densified
first. `csr_sspmm_plain` is the plain version of the `csr_sspmm` kernels
(MaxK's backward on a windowed plan): the blocked sum kept at each row's k
channels, zeros elsewhere.

The 16-bit model (`--dtype bfloat16`): with `out_dtype=torch.bfloat16` the
f32 sum is rounded once to bf16 and then scaled by the post factor in bf16
arithmetic, `_scale(bf16(Σ), post)` = bf16(bf16(Σ) · bf16(post)): the
reference's two roundings (`spgemm_gnn_tpu/kernels/planned.py:300, :323`)
and the epilogue of the kernels' bf16-output forms.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.ops.maxk import cbsr_to_dense, split_records
from spgemm_gnn_tpu_torch.ops.norms import node_factors

# cap on one chunk of gathered [edges, dim] messages: at Reddit scale the
# whole message array would be E·dim·4 B ≈ 117 GB, so edges go in chunks
_MSG_BYTES_CAP = 1 << 30


def _scale(x: torch.Tensor, f: torch.Tensor | None) -> torch.Tensor:
    return x if f is None else x * f[:, None].to(x.dtype)


def _widen(x: torch.Tensor) -> torch.Tensor:
    """bf16 rows as f32 (exact); any other dtype as it is."""
    return x.float() if x.dtype == torch.bfloat16 else x


def finish(y: torch.Tensor, post: torch.Tensor | None,
           out_dtype: torch.dtype | None) -> torch.Tensor:
    """The post factor on a whole sum y: in y's dtype, or (out_dtype bf16)
    bf16(bf16(y) · bf16(post))."""
    if out_dtype == torch.bfloat16:
        y = y.to(torch.bfloat16)
    return _scale(y, post)


def round_rows_plain(x: torch.Tensor, pre: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """bf16(pre ⊙ x): the f32 product rounded once to nearest even."""
    return _scale(x, pre).to(torch.bfloat16)


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
                   post: torch.Tensor | None = None,
                   out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y[v] = post[v] · Σ_{u ∈ in(v)} pre[u] · x[u] over the CSR
    (indptr, indices); a None factor is 1. Output rows = len(indptr) - 1.
    bf16 x is summed in f32; out_dtype bf16 rounds as `finish` does."""
    x = _widen(x)
    n_out = indptr.numel() - 1
    rows = torch.repeat_interleave(
        torch.arange(n_out, dtype=torch.int32, device=indptr.device),
        indptr.diff(), output_size=indices.numel())
    return finish(_gather_add(indices, rows, _scale(x, pre), n_out), post,
                  out_dtype)


def csr_blocked_plain(block_indptr: torch.Tensor, indices: torch.Tensor,
                      x: torch.Tensor, pre: torch.Tensor | None = None,
                      post: torch.Tensor | None = None,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """`csr_spmm_plain` block by block over a CSR re-bucketed by source
    block (graphs/tiles.py::CSRSchedule: block b's edges of row r are
    indices[block_indptr[b, r]:block_indptr[b, r + 1]]), the blocks' sums
    added in block order, then the post factor (`finish`): the order of the
    `csr_spmm` kernel's passes. One block is `csr_spmm_plain` itself."""
    x = _widen(x)
    y = None
    for bptr in block_indptr:
        lo, hi = int(bptr[0]), int(bptr[-1])
        part = csr_spmm_plain(bptr - lo, indices[lo:hi], x, pre)
        y = part if y is None else y + part
    return finish(y, post, out_dtype)


def csr_cbsr_plain(block_indptr: torch.Tensor, indices: torch.Tensor,
                   records: torch.Tensor, k: int, dim: int,
                   post: torch.Tensor | None = None,
                   out_dtype: torch.dtype | None = None, *,
                   pre: torch.Tensor | None = None,
                   value_dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """`csr_blocked_plain` on the rows the records (`cbsr_records` of k
    values of `value_dtype`) densify to, f32 [S, dim]: split, densified,
    then summed block by block with the pre factor (f32 values; bf16
    values carry it already, and take none)."""
    values, ch = split_records(records, k, dim, value_dtype)
    return csr_blocked_plain(block_indptr, indices,
                             cbsr_to_dense(_widen(values), ch, dim), pre,
                             post, out_dtype)


def csr_sspmm_plain(block_indptr: torch.Tensor, indices: torch.Tensor,
                    m: torch.Tensor, ch: torch.Tensor,
                    post: torch.Tensor | None = None,
                    out_dtype: torch.dtype | None = None, *,
                    pre: torch.Tensor | None = None) -> torch.Tensor:
    """`csr_blocked_plain(block_indptr, indices, m, pre, post, out_dtype)`
    with each row r kept at its channels ch[r] (uint8 [R, k]) and 0
    elsewhere."""
    y = csr_blocked_plain(block_indptr, indices, m, pre, post, out_dtype)
    keep = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    keep.scatter_(1, ch.long(), True)
    return torch.where(keep, y, torch.zeros((), dtype=y.dtype,
                                            device=y.device))


def spmm(g, x: torch.Tensor, norm: str = "sum") -> torch.Tensor:
    """y[v] = Σ_{in-edges u→v} w_e · x[u] with w from `norm`, differentiated
    by autograd."""
    src_f, dst_f = node_factors(g, norm)
    y = _gather_add(g.indices, g.edge_dst, _scale(x, src_f),
                          g.num_nodes)
    return _scale(y, dst_f)


def spmm_transpose(g, y: torch.Tensor, norm: str = "sum") -> torch.Tensor:
    """z[u] = Σ_{out-edges u→v} w_e · y[v]: the adjoint of `spmm` (the same
    edge weights), over the transpose CSR."""
    src_f, dst_f = node_factors(g, norm)
    z = _gather_add(g.t_indices, g.t_edge_dst, _scale(y, dst_f),
                    g.num_nodes)
    return _scale(z, src_f)
