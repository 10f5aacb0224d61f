"""Neighbor-group (ELL) SpMM, the GNNAdvisor-role baseline (counterpart of
`spgemm_gnn_tpu/ops/ell.py`).

GNNAdvisor's scheduling idea is neighbor grouping: every destination row's
in-edges are cut into groups of `width` sources, the last group of a row
padded with a sentinel that points at an all-zero feature row. That turns
the ragged CSR into a regular table:

- host side, once per graph: `grp_src` int32 [G, width] and the group→row
  map `grp_dst` int32 [G] (numpy, bit for bit the JAX package's table);
- device side: one gather `x[grp_src]`, a sum over the width, and
  `index_add_` of the groups into their rows.

It is plain PyTorch on any device, a baseline independent of the port's
kernels (other preprocessing, another reduction order) and of the plain
gather/scatter oracle (ops/spmm.py). The gather goes in chunks of groups
(`_MSG_BYTES_CAP` bytes of gathered rows at a time), so a large graph needs
no G × width × dim buffer. `index_add_` on a CUDA tensor adds with atomics,
in no fixed order.

Gradients: `ell_aggregate` (dense x) and the CBSR pair `spgemm_forward` /
`sspmm_backward` (kernels/api.py, impl "ell") are `torch.autograd.Function`s
whose backward is the same product on the transpose table. The dense form's
dx is unmasked, as the planned path's is (MaxK's own backward masks it).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spgemm_gnn_tpu_torch.graphs.csr import Graph
from spgemm_gnn_tpu_torch.ops.maxk import cbsr_to_dense
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.ops.spmm import _MSG_BYTES_CAP, _scale
from spgemm_gnn_tpu_torch.utils import spans


@dataclasses.dataclass(frozen=True)
class ELLTable:
    """Padded neighbor-group table for one aggregation direction.

    grp_src[g, j] = j-th source node of group g (sentinel `num_src` pads);
    grp_dst[g]    = destination row of group g (0 for all-sentinel pad
                    groups, which add exact zeros). Groups are ordered by
                    destination row.
    """
    grp_src: torch.Tensor          # int32 [G, width]
    grp_dst: torch.Tensor          # int32 [G]
    num_src: int                   # the sentinel
    num_dst: int
    width: int


@dataclasses.dataclass(frozen=True)
class ELLGraph:
    """Graph + neighbor-group tables for the forward and the transpose
    aggregation. Quacks like Graph for the norms' degrees."""
    graph: Graph
    fwd: ELLTable
    bwd: ELLTable          # the transpose table; fwd itself when symmetric

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    @property
    def in_degrees(self) -> torch.Tensor:
        return self.graph.in_degrees

    @property
    def out_degrees(self) -> torch.Tensor:
        return self.graph.out_degrees


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_ell_table(indptr, indices, num_src: int, *,
                    width: int = 32) -> ELLTable:
    """Cut a CSR structure (tensors or arrays) into fixed-width neighbor
    groups on the host, with numpy; the table lands on indptr's device (the
    CPU for arrays). The group count is padded to a multiple of 8, as the
    JAX package pads it."""
    device = (indptr.device if isinstance(indptr, torch.Tensor)
              else torch.device("cpu"))
    indptr = _host(indptr).astype(np.int64)
    indices = _host(indices).astype(np.int64)
    num_dst = len(indptr) - 1
    deg = np.diff(indptr)
    grp_per_row = -(-deg // width)                       # ceil, 0 for empty
    row_base = np.concatenate([[0], np.cumsum(grp_per_row)])
    num_groups = int(row_base[-1])
    g_pad = max(-(-max(num_groups, 1) // 8) * 8, 8)

    grp_src = np.full((g_pad, width), num_src, dtype=np.int32)
    grp_dst = np.zeros(g_pad, dtype=np.int32)
    if len(indices):
        edge_row = np.repeat(np.arange(num_dst, dtype=np.int64), deg)
        offset = np.arange(len(indices), dtype=np.int64) - indptr[edge_row]
        gid = row_base[edge_row] + offset // width
        grp_src[gid, offset % width] = indices
    if num_groups:
        grp_dst[:num_groups] = np.repeat(
            np.arange(num_dst, dtype=np.int64), grp_per_row)
    return ELLTable(grp_src=torch.from_numpy(grp_src).to(device),
                    grp_dst=torch.from_numpy(grp_dst).to(device),
                    num_src=int(num_src), num_dst=int(num_dst),
                    width=int(width))


def ell_graph(g: Graph, *, width: int = 32) -> ELLGraph:
    """Both direction tables on g's device (the transpose is the forward
    table on a symmetric graph)."""
    fwd = build_ell_table(g.indptr, g.indices, g.num_nodes, width=width)
    bwd = fwd if g.symmetric else build_ell_table(
        g.t_indptr, g.t_indices, g.num_nodes, width=width)
    return ELLGraph(graph=g, fwd=fwd, bwd=bwd)


def ell_spmm_raw(t: ELLTable, x: torch.Tensor) -> torch.Tensor:
    """y[v] = Σ_{groups g of v} Σ_j x[grp_src[g, j]]: the unweighted A · x
    in x's dtype. The sentinel gathers an appended zero row, so padded
    slots add exact zeros without a mask."""
    dim = x.shape[1]
    xp = torch.cat([x, x.new_zeros((1, dim))])
    y = x.new_zeros((t.num_dst, dim))
    chunk = max(_MSG_BYTES_CAP // max(t.width * dim * x.element_size(), 1),
                1)
    for lo in range(0, t.grp_src.shape[0], chunk):
        src = t.grp_src[lo:lo + chunk]
        rows = xp.index_select(0, src.reshape(-1)).view(*src.shape, dim)
        y.index_add_(0, t.grp_dst[lo:lo + chunk], rows.sum(dim=1))
    return y


class _ELLAggregate(torch.autograd.Function):
    """y = dst_f ⊙ A (src_f ⊙ x) on the forward table; dx = src_f ⊙ Aᵀ
    (dst_f ⊙ g) on the transpose table."""

    @staticmethod
    def forward(ctx, x, eg, src_f, dst_f):
        ctx.save_for_backward(src_f, dst_f)
        ctx.eg = eg
        return _scale(ell_spmm_raw(eg.fwd, _scale(x, src_f)), dst_f)

    @staticmethod
    def backward(ctx, g):
        src_f, dst_f = ctx.saved_tensors
        with spans.span("aggregate.backward"):
            dx = _scale(ell_spmm_raw(ctx.eg.bwd, _scale(g, dst_f)), src_f)
        return dx, None, None, None


def ell_aggregate(eg: ELLGraph, x: torch.Tensor,
                  norm: str = "sum") -> torch.Tensor:
    """y = A_w · x with separable norm weights (dense features),
    differentiable in x."""
    src_f, dst_f = node_factors(eg, norm)
    return _ELLAggregate.apply(x, eg, src_f, dst_f)


def spgemm_forward(dim, values, channels, src_f, dst_f, tables
                   ) -> torch.Tensor:
    """CBSR forward through the group table (kernels/api.py impl "ell"):
    y = dst_f ⊙ A densify(src_f ⊙ values)."""
    fwd, _ = tables
    x = _scale(cbsr_to_dense(values, channels, dim), src_f)
    return _scale(ell_spmm_raw(fwd, x), dst_f)


def sspmm_backward(g_ct, channels, src_f, dst_f, tables) -> torch.Tensor:
    """Sampled backward: the transpose table's product, then the k kept
    channels of each node. Returns dvalues [N, k]."""
    _, bwd = tables
    z = _scale(ell_spmm_raw(bwd, _scale(g_ct, dst_f)), src_f)
    return torch.gather(z, 1, channels.long())
