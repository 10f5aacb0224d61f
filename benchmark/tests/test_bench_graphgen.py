"""The frozen generator: the same seed gives the same graph, the graph is
symmetric with sorted rows, it equals the port's stand-in of the same
arguments, and the cache gives back what was drawn."""
import numpy as np
import pytest

from benchmark import graphgen


def test_reproducible_from_its_seed():
    a = graphgen.powerlaw_csr(700, 5000, 1.5, 97)
    b = graphgen.powerlaw_csr(700, 5000, 1.5, 97)
    c = graphgen.powerlaw_csr(700, 5000, 1.5, 98)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])


def test_symmetric_sorted_no_loops():
    indptr, indices = graphgen.powerlaw_csr(500, 4000, 1.5, 3)
    rows = np.repeat(np.arange(500), np.diff(indptr))
    assert np.all(rows != indices)
    fwd = rows * 500 + indices
    assert np.all(np.diff(fwd) > 0)                  # sorted, no repeats
    assert np.array_equal(np.sort(indices * 500 + rows), fwd)


@pytest.mark.parametrize("seed", [0, 97])
def test_equals_the_ports_stand_in(seed):
    from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph
    g = powerlaw_graph(900, 6000, seed=seed)
    indptr, indices = graphgen.powerlaw_csr(900, 6000, 1.5, seed)
    assert np.array_equal(g.indptr.numpy(), indptr)
    assert np.array_equal(g.indices.numpy(), indices)


def test_cache_round_trip(tiny_config):
    a, b, drawn = graphgen.load_csr(tiny_config)
    c, d, again = graphgen.load_csr(tiny_config)
    assert drawn and not again
    assert np.array_equal(a, c) and np.array_equal(b, d)
    assert a[-1] == b.shape[0] and a.shape[0] == 1501


def _csr(indptr, indices):
    n = indptr.shape[0] - 1
    return np.repeat(np.arange(n), np.diff(indptr)), indices


@pytest.mark.parametrize("loops", [False, True])
def test_self_loops_are_the_ports(tiny_config, loops):
    """The recipes' `--selfloop` on the tiny graph, and on it with a loop
    on every third node already there: exactly the CSR of the port's
    `graphs/csr.py::add_self_loops`."""
    from spgemm_gnn_tpu_torch.graphs.csr import add_self_loops, from_edges
    indptr, indices, _ = graphgen.load_csr(tiny_config)
    n = indptr.shape[0] - 1
    dst, src = _csr(indptr, indices)
    if loops:
        third = np.arange(0, n, 3)
        g = from_edges(np.concatenate([src, third]),
                       np.concatenate([dst, third]), n, symmetric=True)
        indptr, indices = g.indptr.numpy(), g.indices.numpy()
        dst, src = _csr(indptr, indices)
    want = add_self_loops(from_edges(src, dst, n, symmetric=True))
    got_ptr, got_idx = graphgen.add_self_loops(indptr, indices)
    assert np.array_equal(got_ptr, want.indptr.numpy())
    assert np.array_equal(got_idx, want.indices.numpy())
    assert got_idx.dtype == indices.dtype and got_idx.shape[0] == (
        indices.shape[0] - (n + 2) // 3 * loops + n)


def test_load_graph_adds_self_loops_after_the_cache(tiny_gcn_config):
    indptr, indices, drawn = graphgen.load_graph(tiny_gcn_config)
    raw_ptr, raw_idx, again = graphgen.load_csr(tiny_gcn_config)
    assert drawn and not again
    assert indices.shape[0] == raw_idx.shape[0] + 1500
    rows, src = _csr(indptr, indices)
    assert np.count_nonzero(rows == src) == 1500
    assert np.all(np.diff(rows * 1500 + src) > 0)       # rows still sorted
    plain = dict(tiny_gcn_config, graph=dict(tiny_gcn_config["graph"],
                                             self_loops=False))
    assert np.array_equal(graphgen.load_graph(plain)[1], raw_idx)
