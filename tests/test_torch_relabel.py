"""The port's node relabelling (`graphs/relabel.py`) against the JAX
package's: the permutation of every order in ORDERS and the relabelled
graph, bit for bit."""
import numpy as np
import pytest

from spgemm_gnn_tpu.graphs import relabel as jrelabel
from spgemm_gnn_tpu.graphs.csr import from_edges as jfrom_edges
from spgemm_gnn_tpu_torch.graphs import relabel as trelabel
from spgemm_gnn_tpu_torch.graphs.csr import from_edges as tfrom_edges
from spgemm_gnn_tpu_torch.graphs.synthetic import (powerlaw_graph,
                                                   sbm_graph)


def _graphs():
    """(name, port graph, JAX graph) over the same edges: a power-law and
    a block-model stand-in, and a directed graph with isolated nodes (so
    BFS enters several components)."""
    rng = np.random.default_rng(11)
    out = []
    for name, g in (("powerlaw", powerlaw_graph(400, 3000, seed=2)),
                    ("sbm", sbm_graph(500, 5000, communities=6, seed=4))):
        out.append((name, g))
    src, dst = rng.integers(0, 250, 900), rng.integers(0, 250, 900)
    out.append(("directed", tfrom_edges(src, dst, 260, symmetric=False)))
    return [(name, g, jfrom_edges(g.indices.numpy(), g.edge_dst.numpy(),
                                  g.num_nodes, symmetric=g.symmetric))
            for name, g in out]


GRAPHS = _graphs()


def test_orders_are_the_jax_packages():
    assert trelabel.ORDERS == jrelabel.ORDERS


@pytest.mark.parametrize("order", trelabel.ORDERS)
@pytest.mark.parametrize("which", range(len(GRAPHS)))
def test_relabel_order_bitwise(order, which):
    name, tg, jg = GRAPHS[which]
    perm = trelabel.relabel_order(tg, order)
    np.testing.assert_array_equal(perm, jrelabel.relabel_order(jg, order),
                                  err_msg=f"{name} {order}")
    assert np.array_equal(np.sort(perm), np.arange(tg.num_nodes))


@pytest.mark.parametrize("order", ["degree-bfs", "labelprop"])
def test_relabel_graph_bitwise(order):
    for name, tg, jg in GRAPHS:
        rg, perm = trelabel.relabel_graph(tg, order)
        jrg, jperm = jrelabel.relabel_graph(jg, order)
        np.testing.assert_array_equal(perm, jperm)
        for f in ("indptr", "indices", "edge_dst", "t_indptr", "t_indices",
                  "t_edge_dst", "in_degrees", "out_degrees"):
            np.testing.assert_array_equal(getattr(rg, f).numpy(),
                                          np.asarray(getattr(jrg, f)),
                                          err_msg=f"{name} {order} {f}")
        assert rg.symmetric == tg.symmetric


def test_relabel_unknown_order_raises():
    with pytest.raises(ValueError, match="unknown relabel order"):
        trelabel.relabel_order(GRAPHS[0][1], "random")
