"""Minibatch inference: the L-hop in-closure of a batch of seed nodes, its
feature rows through a feature store, and the model on the induced subgraph
(counterpart of `spgemm_gnn_tpu/train/infer.py`).

`predict_nodes`:
1. takes the L-hop in-neighbourhood closure of the seeds on the host, from
   numpy copies of the CSR made once per graph (`Graph.host_arrays`);
2. fetches exactly those feature rows through a FeatureStore
   (graphs/features.py), so rows in a device cache never cross from the host;
3. runs the model on the induced subgraph, a plain `Graph` on the device with
   the GLOBAL degrees, so its aggregation is `csr_spmm` on a schedule built
   for that subgraph (kernels/planned.py::graph_plans).

Exactness: layer l only reads aggregations of nodes in the (L - l)-hop
closure, whose in-neighbourhoods are complete by construction, and the degree
norms are the full graph's, so the logits equal the full-graph forward's at
the seed rows up to the summation order of the two products.
"""
from __future__ import annotations

import numpy as np
import torch

from spgemm_gnn_tpu_torch.graphs.csr import Graph, _t


def _multi_slice(values: np.ndarray, starts: np.ndarray,
                 ends: np.ndarray) -> np.ndarray:
    """values[s:e] for each (s, e) pair, concatenated, with no per-row
    Python loop (np.repeat / cumsum)."""
    lens = (ends - starts).astype(np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, values.dtype)
    first_out = np.r_[0, np.cumsum(lens)[:-1]]
    idx = np.arange(total, dtype=np.int64) + np.repeat(starts - first_out,
                                                       lens)
    return values[idx]


def khop_in_subgraph(g: Graph, seeds, hops: int
                     ) -> tuple[Graph, np.ndarray, np.ndarray]:
    """The induced in-neighbourhood subgraph of `seeds` with exact L-layer
    semantics, on g's device: (subgraph, global node ids, seed positions in
    the subgraph). A closure that saturates (every node reached, every row's
    in-edges kept) returns g itself."""
    h = g.host_arrays()
    indptr, indices = h["indptr"], h["indices"]
    seeds = np.unique(np.asarray(seeds, np.int64))
    # a boolean-mask BFS that expands only the nodes found in the last hop:
    # O(E) over all hops
    mask = np.zeros(g.num_nodes, bool)
    mask[seeds] = True
    new = seeds
    inner_mask = mask.copy()                       # (L-1)-hop closure mask
    for _ in range(hops):
        inner_mask = mask.copy()
        neigh = _multi_slice(indices, indptr[new], indptr[new + 1])
        prev = mask.copy()
        mask[neigh] = True
        new = np.flatnonzero(mask & ~prev)
        if not len(new):                           # the closure converged
            break
    nodes = np.flatnonzero(mask).astype(np.int64)  # L-hop closure (sorted)
    if not hops:
        # zero layers read no aggregation: the exact subgraph has no edges
        inner_mask = np.zeros(g.num_nodes, bool)
    inner = np.flatnonzero(inner_mask).astype(np.int64)

    if len(nodes) == g.num_nodes and len(inner) == g.num_nodes:
        # saturated: every row keeps its in-edges and local ids are global
        # ones, so the subgraph is the graph
        return g, nodes, seeds.copy()

    # every in-edge whose destination lies in the (L-1)-hop closure; local
    # ids from an O(N) inverse table (identity when every node is reached)
    saturated = len(nodes) == g.num_nodes
    if saturated:
        lut = np.arange(g.num_nodes, dtype=np.int64)
    else:
        lut = np.empty(g.num_nodes, np.int64)
        lut[nodes] = np.arange(len(nodes), dtype=np.int64)
    lens = (indptr[inner + 1] - indptr[inner]).astype(np.int64)
    src = _multi_slice(indices, indptr[inner], indptr[inner + 1])
    dst = np.repeat(inner, lens)
    src_l = src if saturated else lut[src]
    dst_l = dst if saturated else lut[dst]

    # the extraction order is the sub in-CSR's order (inner sorted, sources
    # sorted within each row)
    n_sub, e_sub = len(nodes), len(src_l)
    sub_ptr = np.zeros(n_sub + 1, np.int64)
    np.add.at(sub_ptr, dst_l + 1, 1)
    np.cumsum(sub_ptr, out=sub_ptr)
    # the transpose, in one of two regimes: (a) filter the global out-CSR's
    # rows of `nodes` down to destinations in `inner` (a scan, order
    # preserved, no sort), while the scanned volume is within 3x of the kept
    # edges; (b) else an argsort of the forward source column
    g_t_indptr = h["t_indptr"].astype(np.int64)
    t_starts, t_ends = g_t_indptr[nodes], g_t_indptr[nodes + 1]
    t_scan = int((t_ends - t_starts).sum())
    if t_scan <= 3 * e_sub:
        if saturated:          # every t-row survives: scan the array as is
            t_v = h["t_indices"].astype(np.int64)
        else:
            t_v = _multi_slice(h["t_indices"], t_starts,
                               t_ends).astype(np.int64)
        keep = inner_mask[t_v]
        t_v = t_v[keep]
        # kept count per row: the prefix sum of `keep` at row boundaries
        kc = np.r_[0, np.cumsum(keep)]
        row_ends = np.cumsum((t_ends - t_starts).astype(np.int64))
        t_counts = np.diff(np.r_[0, kc[row_ends]])
        t_ptr = np.r_[0, np.cumsum(t_counts)]
        t_indices_sub = t_v if saturated else lut[t_v]
        t_edge_dst_sub = np.repeat(np.arange(n_sub, dtype=np.int64), t_counts)
    else:
        order = np.argsort(src_l, kind="stable")
        t_ptr = np.zeros(n_sub + 1, np.int64)
        np.add.at(t_ptr, src_l + 1, 1)
        np.cumsum(t_ptr, out=t_ptr)
        t_indices_sub = dst_l[order]
        t_edge_dst_sub = src_l[order]
    sub = Graph(
        indptr=_t(sub_ptr), indices=_t(src_l), edge_dst=_t(dst_l),
        t_indptr=_t(t_ptr), t_indices=_t(t_indices_sub),
        t_edge_dst=_t(t_edge_dst_sub),
        # the degree norms read the GLOBAL degrees, not the induced ones
        in_degrees=_t(h["in_degrees"][nodes]),
        out_degrees=_t(h["out_degrees"][nodes]),
        num_nodes=n_sub, num_edges=e_sub, symmetric=False)
    return sub.to(g.device), nodes, lut[seeds]


@torch.no_grad()
def predict_nodes(model: torch.nn.Module, params, g: Graph, store, node_ids,
                  hops: int | None = None) -> torch.Tensor:
    """Logits of `node_ids` (in sorted unique order) by minibatch inference.

    params: a state_dict for `model` (applied with `torch.func.
    functional_call`, the module's own tensors untouched), or None for the
    module's own. store: a FeatureStore; only the subgraph's rows are
    fetched. The model runs in eval mode (no dropout)."""
    if hops is None:
        hops = getattr(model, "num_layers", 2)
    sub, nodes, pos = khop_in_subgraph(g, node_ids, hops)
    x = store.fetch(nodes)
    was_training = model.training
    model.eval()
    try:
        if params is None:
            logits = model(sub, x)
        else:
            logits = torch.func.functional_call(model, dict(params), (sub, x))
    finally:
        model.train(was_training)
    return logits[torch.from_numpy(pos).to(logits.device)]
