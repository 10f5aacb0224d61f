"""Synthetic graph generators (counterpart of `spgemm_gnn_tpu/graphs/
synthetic.py`): the same arguments and seed give the JAX package's
`indptr` and `indices` bit for bit.

`powerlaw_graph` has uniform hub skew and no latent locality; `sbm_graph`
(a degree-skewed stochastic block model) and `rmat_graph` (R-MAT) carry
community structure, hidden by a random relabelling unless `shuffle` is
False. `intra_block_fraction` measures how much of that structure the ids
show.
"""
from __future__ import annotations

import numpy as np

from spgemm_gnn_tpu_torch.graphs.csr import Graph, from_edges, to_undirected


def random_graph(num_nodes: int, num_edges: int, *, seed: int = 0,
                 symmetric: bool = True) -> Graph:
    """Uniform Erdős–Rényi-style random graph without self-loops."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, num_edges, dtype=np.int64)
    dst = rng.integers(0, num_nodes, num_edges, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if symmetric:
        return to_undirected(src, dst, num_nodes)
    return from_edges(src, dst, num_nodes, symmetric=False)


def powerlaw_graph(num_nodes: int, num_edges: int, *, alpha: float = 1.5,
                   seed: int = 0) -> Graph:
    """Power-law degree-skewed symmetric graph (hub-heavy, Reddit-like).

    Sources are drawn with probability ∝ rank^(-1/alpha), destinations
    uniformly; duplicates are deduped before symmetrisation.
    """
    rng = np.random.default_rng(seed)
    p = (np.arange(1, num_nodes + 1, dtype=np.float64)) ** (-1.0 / alpha)
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    u = rng.random(num_edges)
    src = np.searchsorted(cdf, u).astype(np.int64)
    dst = rng.integers(0, num_nodes, num_edges, dtype=np.int64)
    keep = src != dst
    return to_undirected(src[keep], dst[keep], num_nodes)


def sbm_graph(num_nodes: int, num_edges: int, *, communities: int = 64,
              p_in: float = 0.7, alpha: float = 1.5, seed: int = 0,
              shuffle: bool = True) -> Graph:
    """Degree-skewed stochastic block model: power-law sources (as in
    `powerlaw_graph`, their degree rank decoupled from their community by a
    random map) whose destinations stay inside the source's community with
    probability p_in. Community sizes are power-law too. With shuffle
    (default) node ids are randomly permuted, so the communities are
    invisible to id-contiguous blocks."""
    if communities > num_nodes:
        raise ValueError("communities cannot exceed num_nodes")
    rng = np.random.default_rng(seed)
    # power-law community sizes; a deficit is spread over the largest ones,
    # so that no size goes to 0 or below
    w = np.arange(1, communities + 1, dtype=np.float64) ** -0.8
    sizes = np.maximum((w / w.sum() * num_nodes).astype(np.int64), 1)
    diff = num_nodes - int(sizes.sum())
    i = 0
    while diff != 0:
        if diff > 0:
            sizes[i] += diff
            diff = 0
        else:
            take = min(int(sizes[i]) - 1, -diff)
            sizes[i] -= take
            diff += take
            i += 1
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    p = (np.arange(1, num_nodes + 1, dtype=np.float64)) ** (-1.0 / alpha)
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    rank_to_node = rng.permutation(num_nodes).astype(np.int64)
    src = rank_to_node[np.searchsorted(cdf, rng.random(num_edges))]
    comm = np.searchsorted(bounds, src, side="right") - 1
    lo, hi = bounds[comm], bounds[comm + 1]
    intra = rng.random(num_edges) < p_in
    dst_in = lo + (rng.random(num_edges) * (hi - lo)).astype(np.int64)
    dst_out = rng.integers(0, num_nodes, num_edges, dtype=np.int64)
    dst = np.where(intra, dst_in, dst_out)
    if shuffle:
        perm = rng.permutation(num_nodes).astype(np.int64)
        src, dst = perm[src], perm[dst]
    keep = src != dst
    return to_undirected(src[keep], dst[keep], num_nodes)


def rmat_graph(num_nodes: int, num_edges: int, *, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, seed: int = 0,
               shuffle: bool = True) -> Graph:
    """R-MAT (recursive matrix, Graph500's family): self-similar community
    structure and power-law degrees. Edges that land outside num_nodes, and
    self-loops, are dropped. Ids are shuffled by default, as in
    `sbm_graph`."""
    rng = np.random.default_rng(seed)
    d = 1.0 - a - b - c
    if d < 0:
        raise ValueError("a + b + c must be <= 1")
    levels = max(int(np.ceil(np.log2(max(num_nodes, 2)))), 1)
    src = np.zeros(num_edges, np.int64)
    dst = np.zeros(num_edges, np.int64)
    for _ in range(levels):
        r1 = rng.random(num_edges)
        r2 = rng.random(num_edges)
        sbit = r1 >= a + b                        # P = c + d
        p_hi = np.where(sbit, d / max(c + d, 1e-12), b / max(a + b, 1e-12))
        dbit = r2 < p_hi
        src = src * 2 + sbit
        dst = dst * 2 + dbit
    keep = (src < num_nodes) & (dst < num_nodes) & (src != dst)
    src, dst = src[keep], dst[keep]
    if shuffle:
        perm = rng.permutation(num_nodes).astype(np.int64)
        src, dst = perm[src], perm[dst]
    return to_undirected(src, dst, num_nodes)


def intra_block_fraction(g: Graph, block: int) -> float:
    """Fraction of edges whose endpoints share an id block of `block`
    rows: the locality a windowed plan's source blocks can use."""
    src = g.indices.cpu().numpy().astype(np.int64)
    dst = g.edge_dst.cpu().numpy().astype(np.int64)
    return float(np.mean(src // block == dst // block))
