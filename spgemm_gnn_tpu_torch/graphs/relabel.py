"""Locality-restoring node relabelling (counterpart of
`spgemm_gnn_tpu/graphs/relabel.py`): host-side permutations of a graph's
node ids, computed once at load time, bit for bit the JAX package's.

A random node order spreads each destination row's sources over the whole
id range, so a windowed plan's source blocks are reused little; an order
that places neighbours close together concentrates them. Node-row payloads
(features, labels, masks) ride the same permutation.

Orders (`ORDERS`):
- "degree": descending in-degree (hubs first);
- "bfs": breadth-first from the highest-degree node, components entered
  in descending degree;
- "rcm": reverse Cuthill–McKee (BFS entered at ascending degree, each level
  sorted by ascending degree, the whole order reversed);
- "degree-bfs": BFS with each level sorted by descending degree;
- "labelprop": communities by synchronous label propagation, ordered by
  community size (largest first), then label, then descending degree.
"""
from __future__ import annotations

import numpy as np

from spgemm_gnn_tpu_torch.graphs import native
from spgemm_gnn_tpu_torch.graphs.csr import Graph, from_edges

ORDERS = ("degree", "bfs", "rcm", "degree-bfs", "labelprop")


def _labelprop_labels(indptr: np.ndarray, indices: np.ndarray,
                      num_nodes: int, iters: int = 8,
                      use_native: bool = True) -> np.ndarray:
    """Synchronous label propagation: in each sweep every node adopts the
    most frequent label among its in-neighbours, ties broken by the least
    per-sweep keyed hash of the label, (label · 2654435761 + sweep ·
    0x9E3779B9) & 0x7FFFFFFF (a min-label tie-break floods one label over a
    dense graph); stops early when no label changes. The native graph
    core's `gc_labelprop` where it is built and `use_native` (the same
    labels), else a lexsort over (destination, label) per sweep and its
    run-length mode."""
    if use_native:
        labels = native.labelprop(indptr, indices, num_nodes, iters)
        if labels is not None:
            return labels
    dst = np.repeat(np.arange(num_nodes, dtype=np.int64), np.diff(indptr))
    src = np.asarray(indices, np.int64)
    labels = np.arange(num_nodes, dtype=np.int64)
    for it in range(iters):
        lab = labels[src]
        order = np.lexsort((lab, dst))
        d_o, l_o = dst[order], lab[order]
        # run starts of equal (dst, label) pairs
        new_run = np.r_[True, (d_o[1:] != d_o[:-1]) | (l_o[1:] != l_o[:-1])]
        run_id = np.cumsum(new_run) - 1
        counts = np.bincount(run_id)
        run_dst = d_o[new_run]
        run_lab = l_o[new_run]
        # per dst: the largest count, then the least keyed hash among the
        # runs of that count
        best_cnt = np.zeros(num_nodes, np.int64)
        np.maximum.at(best_cnt, run_dst, counts)
        is_best = counts == best_cnt[run_dst]
        key = (run_lab[is_best] * np.int64(2654435761)
               + np.int64(it) * np.int64(0x9E3779B9)) & np.int64(0x7FFFFFFF)
        best_key = np.full(num_nodes, np.iinfo(np.int64).max, np.int64)
        np.minimum.at(best_key, run_dst[is_best], key)
        win = key == best_key[run_dst[is_best]]
        best = np.full(num_nodes, -1, np.int64)
        best[run_dst[is_best][win]] = run_lab[is_best][win]
        new_labels = np.where(best >= 0, best, labels)
        if np.array_equal(new_labels, labels):
            break
        labels = new_labels
    return labels


def _bfs_order(indptr: np.ndarray, indices: np.ndarray, num_nodes: int,
               seed_order: np.ndarray, *, level_sort: str = "none"
               ) -> np.ndarray:
    """Whole-graph BFS visit order. Components are entered in `seed_order`.
    A level comes out in ascending old id (the expansion is vectorised and
    keeps no per-edge discovery order); level_sort "asc" / "desc" sorts
    each level by in-degree, old id breaking ties."""
    deg = np.diff(indptr)
    visited = np.zeros(num_nodes, bool)
    out = np.empty(num_nodes, np.int64)
    pos = 0
    seed_ptr = 0
    while pos < num_nodes:
        while seed_ptr < num_nodes and visited[seed_order[seed_ptr]]:
            seed_ptr += 1
        frontier = seed_order[seed_ptr:seed_ptr + 1]
        visited[frontier] = True
        while len(frontier):
            out[pos:pos + len(frontier)] = frontier
            pos += len(frontier)
            # every frontier row's neighbours at once
            lens = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)
            total = int(lens.sum())
            if not total:
                break
            first = np.r_[0, np.cumsum(lens)[:-1]]
            idx = np.arange(total, dtype=np.int64) + np.repeat(
                indptr[frontier].astype(np.int64) - first, lens)
            neigh = indices[idx]
            fresh = neigh[~visited[neigh]]
            if not len(fresh):
                break
            prev = visited.copy()
            visited[fresh] = True
            nxt = np.flatnonzero(visited & ~prev)
            if level_sort == "asc":
                nxt = nxt[np.argsort(deg[nxt], kind="stable")]
            elif level_sort == "desc":
                nxt = nxt[np.argsort(-deg[nxt], kind="stable")]
            frontier = nxt
    return out


def relabel_order(g: Graph, order: str = "degree-bfs") -> np.ndarray:
    """The permutation `perm` with perm[new_id] = old_id (a visit order)."""
    host = g.host_arrays()
    indptr = np.asarray(host["indptr"], np.int64)
    indices = np.asarray(host["indices"], np.int64)
    n = g.num_nodes
    deg = np.diff(indptr)
    by_deg_desc = np.argsort(-deg, kind="stable")
    if order == "degree":
        return by_deg_desc
    if order == "bfs":
        return _bfs_order(indptr, indices, n, by_deg_desc)
    if order == "rcm":
        by_deg_asc = np.argsort(deg, kind="stable")
        return _bfs_order(indptr, indices, n, by_deg_asc,
                          level_sort="asc")[::-1].copy()
    if order == "degree-bfs":
        return _bfs_order(indptr, indices, n, by_deg_desc, level_sort="desc")
    if order == "labelprop":
        labels = _labelprop_labels(indptr, indices, n)
        sizes = np.bincount(labels, minlength=n)
        # lexsort's last key is the primary one: (-community size, label,
        # -degree, old id)
        return np.lexsort((np.arange(n), -deg, labels, -sizes[labels]))
    raise ValueError(f"unknown relabel order {order!r}; expected {ORDERS}")


def relabel_graph(g: Graph, order: str = "degree-bfs"
                  ) -> tuple[Graph, np.ndarray]:
    """The relabelled copy of `g` (on the host) and its permutation
    (perm[new] = old).

    Node rows move with it: x_new = x_old[perm]; results map back by
    y_old[perm] = y_new.
    """
    perm = relabel_order(g, order)
    inv = np.empty(g.num_nodes, np.int64)
    inv[perm] = np.arange(g.num_nodes, dtype=np.int64)
    src = inv[g.indices.cpu().numpy().astype(np.int64)]
    dst = inv[g.edge_dst.cpu().numpy().astype(np.int64)]
    return from_edges(src, dst, g.num_nodes, symmetric=g.symmetric), perm
