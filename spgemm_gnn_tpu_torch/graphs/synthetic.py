"""Synthetic graph generators (counterpart of `spgemm_gnn_tpu/graphs/
synthetic.py`): the same seed gives the same edges as the JAX package."""
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
