"""The benchmark's graph: a frozen numpy copy of the power-law stand-in.

A configuration names its dataset's node count N and edge count E and a
graph seed. The stand-in draws E // 2 directed edges, sources with
probability proportional to rank^(-1/alpha) and destinations uniformly,
drops self-loops, adds the reverse of every edge and removes repeats. The
result is one symmetric graph per configuration, as a real dataset is one
fixed graph: `--seed` never changes it.

The first run of a configuration in a checkout draws the graph and keeps
its CSR (row = destination, sources sorted within a row) under
`benchmark/cache/graphs/`; later runs load it. The file name carries a hash
of everything the draw depends on, so a changed configuration draws anew.

A configuration whose `graph.self_loops` is true (default false) runs the
graph with self-loops, as the recipes' `--selfloop` does: `load_graph`
removes every self-loop of the cached CSR and adds one per node, keeping
rows sorted (`add_self_loops`); the cache keeps the drawn graph.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

CACHE = Path(__file__).resolve().parent / "cache" / "graphs"
VERSION = 1


def powerlaw_csr(num_nodes: int, num_drawn: int, alpha: float, seed: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """(indptr int64 [N+1], indices int32 [E]) of the symmetric power-law
    graph drawn from `seed`."""
    n = int(num_nodes)
    rng = np.random.default_rng(seed)
    p = np.arange(1, n + 1, dtype=np.float64) ** (-1.0 / alpha)
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    src = np.searchsorted(cdf, rng.random(num_drawn)).astype(np.int64)
    dst = rng.integers(0, n, num_drawn, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    # key = destination * N + source over both directions, sorted, repeats
    # dropped: the rows in CSR order with sorted sources
    key = np.concatenate([dst, src])
    key *= n
    key += np.concatenate([src, dst])
    del src, dst
    key.sort()
    key = key[np.concatenate([[True], key[1:] != key[:-1]])]
    rows = key // n
    indices = (key - rows * n).astype(np.int32)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, indices


def graph_spec(config: dict) -> dict:
    """What the draw depends on, from a configuration's file."""
    ds, gr = config["dataset"], config["graph"]
    return {"generator": gr["generator"], "num_nodes": ds["num_nodes"],
            "num_drawn": ds["num_edges"] // 2, "alpha": gr["alpha"],
            "seed": gr["seed"], "version": VERSION}


def load_csr(config: dict, cache: Path | None = None
             ) -> tuple[np.ndarray, np.ndarray, bool]:
    """(indptr, indices, drawn): the configuration's graph from the cache
    (default `CACHE`), drawn and stored first where it is not there (drawn
    True)."""
    cache = CACHE if cache is None else cache
    spec = graph_spec(config)
    if spec["generator"] != "powerlaw":
        raise ValueError(f"unknown graph generator {spec['generator']!r}")
    tag = hashlib.sha256(json.dumps(spec, sort_keys=True).encode()
                         ).hexdigest()[:16]
    path = cache / f"{config['name']}-{tag}.npz"
    if path.exists():
        with np.load(path) as z:
            return z["indptr"], z["indices"], False
    indptr, indices = powerlaw_csr(spec["num_nodes"], spec["num_drawn"],
                                   spec["alpha"], spec["seed"])
    cache.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".part")
    with open(tmp, "wb") as f:
        np.savez(f, indptr=indptr, indices=indices)
    os.replace(tmp, path)
    return indptr, indices, True


def add_self_loops(indptr: np.ndarray, indices: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """(indptr int64, indices) of the CSR with every self-loop removed and
    one added per node (DGL's AddSelfLoop: remove, then add), each row's
    sources still sorted."""
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keep = indices != rows
    rows, src = rows[keep], indices[keep]
    counts = np.bincount(rows, minlength=n) + 1
    out_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=out_ptr[1:])
    # node v's loop goes after the sources of row v below v
    loop_at = out_ptr[:-1] + np.bincount(rows[src < rows], minlength=n)
    del rows
    out = np.empty(out_ptr[-1], indices.dtype)
    rest = np.ones(out.shape[0], bool)
    rest[loop_at] = False
    out[loop_at] = np.arange(n, dtype=indices.dtype)
    out[rest] = src
    return out_ptr, out


def load_graph(config: dict, cache: Path | None = None
               ) -> tuple[np.ndarray, np.ndarray, bool]:
    """`load_csr`, with the self-loops of `graph.self_loops` added: the
    graph as the cell runs it."""
    indptr, indices, drawn = load_csr(config, cache)
    if config["graph"].get("self_loops", False):
        indptr, indices = add_self_loops(indptr, indices)
    return indptr, indices, drawn
