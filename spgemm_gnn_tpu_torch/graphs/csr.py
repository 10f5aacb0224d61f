"""CSR graph container (counterpart of `spgemm_gnn_tpu/graphs/csr.py`).

Orientation: aggregation gathers over in-edges (destination v aggregates its
in-neighbours u over edges u→v), so `indptr`/`indices` is the in-CSR: row =
destination, `indices[e]` = source. The transpose (out-CSR) drives the
backward pass; for symmetric graphs it aliases the forward tensors.

Built once on the host, then moved to the device with `.to()`. The two
sorts of a build (the CSR, and the transpose of a graph that is not
symmetric) take the native graph core where it is built (graphs/native.py,
`gc_build_csr`: a bucket pass by destination, then each row's sources
sorted), else numpy's stable argsort; both give the same arrays bit for
bit (`use_native=False` forces numpy). Edges already in CSR order, as the
stand-ins' `to_undirected` gives them, are not sorted again, and edges in
a few sorted runs (`add_self_loops`) are merged by numpy's stable sort,
faster there than the native bucket sort.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from spgemm_gnn_tpu_torch.graphs import native

if TYPE_CHECKING:
    from spgemm_gnn_tpu_torch.kernels.planned import PlannedGraph


@dataclasses.dataclass(frozen=True)
class Graph:
    """Static CSR graph of int32 tensors.

    Attributes:
      indptr:   int32[N+1]  in-CSR row pointers (row = destination node).
      indices:  int32[E]    source node of each in-edge, grouped by destination.
      edge_dst: int32[E]    destination of each in-edge (sorted ascending).
      t_indptr/t_indices/t_edge_dst: the transpose (out-CSR); the same tensor
                            objects as the forward ones when `symmetric`.
      in_degrees / out_degrees: int32[N] raw degrees.
      num_nodes / num_edges: Python ints.
      symmetric: True if the edge set equals its transpose.
      plans:    the windowed plans of this plain graph, made at its first
                planned aggregation (kernels/planned.py::graph_plans) and
                kept; None until then, and on a moved copy.
      host:     numpy copies of the CSR pair and the degrees, made at the
                first `host_arrays()` call and kept (the k-hop extraction of
                train/infer.py reads them per request); None until then,
                and on a moved copy.
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    edge_dst: torch.Tensor
    t_indptr: torch.Tensor
    t_indices: torch.Tensor
    t_edge_dst: torch.Tensor
    in_degrees: torch.Tensor
    out_degrees: torch.Tensor
    num_nodes: int
    num_edges: int
    symmetric: bool = False
    plans: PlannedGraph | None = dataclasses.field(default=None, init=False,
                                                   compare=False, repr=False)
    host: dict[str, np.ndarray] | None = dataclasses.field(
        default=None, init=False, compare=False, repr=False)

    def host_arrays(self) -> dict[str, np.ndarray]:
        """{indptr, indices, t_indptr, t_indices, in_degrees, out_degrees}
        as numpy arrays on the host, copied from the device once and kept
        (`host`)."""
        if self.host is None:
            fields = ("indptr", "indices", "t_indptr", "t_indices",
                      "in_degrees", "out_degrees")
            if self.symmetric:     # the transpose aliases the forward CSR
                arrays = {f: getattr(self, f).cpu().numpy()
                          for f in fields if not f.startswith("t_")}
                arrays.update(t_indptr=arrays["indptr"],
                              t_indices=arrays["indices"])
            else:
                arrays = {f: getattr(self, f).cpu().numpy() for f in fields}
            # Graph is frozen; `host` is set once, after construction
            object.__setattr__(self, "host", arrays)
        return self.host

    @property
    def edge_src(self) -> torch.Tensor:
        """Source node of each in-edge (alias of indices)."""
        return self.indices

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def to(self, device) -> "Graph":
        """The same graph on `device`; symmetric graphs keep their aliasing."""
        tensors = ("indptr", "indices", "edge_dst", "in_degrees",
                   "out_degrees")
        moved = {f: getattr(self, f).to(device) for f in tensors}
        if self.symmetric:
            moved.update(t_indptr=moved["indptr"], t_indices=moved["indices"],
                         t_edge_dst=moved["edge_dst"])
        else:
            for f in ("t_indptr", "t_indices", "t_edge_dst"):
                moved[f] = getattr(self, f).to(device)
        return dataclasses.replace(self, **moved)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Graph(N={self.num_nodes}, E={self.num_edges}, "
                f"symmetric={self.symmetric}, device={self.device})")


def _indptr(rows_sorted: np.ndarray, num_nodes: int) -> np.ndarray:
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows_sorted, minlength=num_nodes), out=indptr[1:])
    return indptr.astype(np.int32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


# at most this many sorted runs of edges: numpy's stable sort (a merge of
# the runs) rather than the native graph core's bucket sort
FEW_RUNS = 16


def _sorted_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int,
                use_native: bool
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(indptr int32 [N+1], sources int64 [E], destinations int64 [E]) of
    the edges src[e] → dst[e] sorted by (dst, src): no sort for edges in
    that order already, numpy's for a few sorted runs of them, else the
    native graph core's where it is built and `use_native`, else numpy's
    (the same arrays each way)."""
    key = dst * num_nodes + src
    runs = 1 + int(np.count_nonzero(key[1:] < key[:-1]))
    if runs == 1:                        # already in CSR order: no sort
        return _indptr(dst, num_nodes), src, dst
    # a few sorted runs (add_self_loops' two) numpy's stable sort merges
    # in a pass or two, faster than the native bucket sort
    built = (native.build_csr(src, dst, num_nodes)
             if use_native and runs > FEW_RUNS else None)
    if built is not None:
        indptr, indices, rows = built
        return indptr, indices.astype(np.int64), rows.astype(np.int64)
    order = np.argsort(key, kind="stable")
    dst_s = dst[order]
    return _indptr(dst_s, num_nodes), src[order], dst_s


def from_edges(src, dst, num_nodes: int, *,
               symmetric: bool | None = None,
               use_native: bool = True) -> Graph:
    """Build a Graph from a directed edge list (host-side).

    Args:
      src, dst: int arrays [E]; edge e goes src[e] → dst[e].
      num_nodes: number of nodes N.
      symmetric: if None, detected by comparing the sorted edge pairs.
      use_native: sort with the native graph core where it is built (the
        same arrays; False: numpy).
    Sources are sorted within each CSR row (the canonical form).
    """
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    if src.shape != dst.shape:
        raise ValueError("src/dst length mismatch")
    n_edges = src.shape[0]

    indptr, src_s, dst_s = _sorted_csr(src, dst, num_nodes, use_native)
    in_deg = np.diff(indptr).astype(np.int32)
    out_deg = np.bincount(src, minlength=num_nodes).astype(np.int32)

    if symmetric is None:
        fwd = np.sort(dst_s * num_nodes + src_s, kind="stable")
        rev = np.sort(src_s * num_nodes + dst_s, kind="stable")
        symmetric = bool(np.array_equal(fwd, rev))

    indptr_t, indices_t, edge_dst_t = _t(indptr), _t(src_s), _t(dst_s)
    if symmetric:
        t_indptr, t_indices, t_edge_dst = indptr_t, indices_t, edge_dst_t
    else:
        # transpose (out-CSR): the same edges sorted by (src, dst)
        t_ptr, t_idx, t_rows = _sorted_csr(dst_s, src_s, num_nodes,
                                           use_native)
        t_indptr, t_indices, t_edge_dst = _t(t_ptr), _t(t_idx), _t(t_rows)

    return Graph(
        indptr=indptr_t, indices=indices_t, edge_dst=edge_dst_t,
        t_indptr=t_indptr, t_indices=t_indices, t_edge_dst=t_edge_dst,
        in_degrees=_t(in_deg), out_degrees=_t(out_deg),
        num_nodes=int(num_nodes), num_edges=int(n_edges),
        symmetric=symmetric,
    )


def add_self_loops(g: Graph) -> Graph:
    """Remove existing self-loops, then add one per node (DGL's AddSelfLoop:
    remove-then-add, so no loop is doubled)."""
    src = g.indices.cpu().numpy()
    dst = g.edge_dst.cpu().numpy()
    keep = src != dst
    loops = np.arange(g.num_nodes, dtype=src.dtype)
    out = from_edges(np.concatenate([src[keep], loops]),
                     np.concatenate([dst[keep], loops]), g.num_nodes,
                     symmetric=g.symmetric or None)
    return out.to(g.device)


def to_undirected(src, dst, num_nodes: int) -> Graph:
    """Build a symmetric graph from a directed edge list (add reverse edges,
    dedupe)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    # sort, then drop repeats: np.unique's result, but numpy 2.3's np.unique
    # takes minutes at Reddit scale (229M keys) where the sort takes seconds
    # (numpy's vectorised sort also beats the native graph core's bucket
    # sort here); from_edges then finds the pairs in CSR order
    key = np.sort(np.concatenate([dst, src]) * num_nodes
                  + np.concatenate([src, dst]))
    key = np.concatenate([key[:1], key[1:][key[1:] != key[:-1]]])
    return from_edges(key % num_nodes, key // num_nodes, num_nodes,
                      symmetric=True)
