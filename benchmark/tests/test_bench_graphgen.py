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
