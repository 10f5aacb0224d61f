"""The port's ELL baseline (ops/ell.py), its routing in kernels/api.py, the
synthetic generators of graphs/synthetic.py and the small API leftovers
(`Graph.edge_src`, `edge_weights`, `spmm_transpose`) against the JAX package
on the CPU: the host-side tables and graphs bit for bit, the products within
1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu.graphs import synthetic as jsyn
from spgemm_gnn_tpu.kernels.api import aggregate_cbsr as jaggregate_cbsr
from spgemm_gnn_tpu.ops import ell as jell
from spgemm_gnn_tpu.ops import norms as jnorms
from spgemm_gnn_tpu.ops.spmm import spmm_transpose as jspmm_transpose
from spgemm_gnn_tpu.ops.maxk import maxk_cbsr as jmaxk_cbsr
from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.kernels import api as tapi
from spgemm_gnn_tpu_torch.ops import ell as tell
from spgemm_gnn_tpu_torch.ops import norms as tnorms
from spgemm_gnn_tpu_torch.ops import spmm as tspmm

DIM, K = 16, 4
NORMS = ["sum", "mean", "gcn"]


def port_graph(jg):
    return from_edges(np.asarray(jg.indices), np.asarray(jg.edge_dst),
                      jg.num_nodes)


def assert_same_csr(tg, jg):
    for f in ("indptr", "indices", "edge_dst", "t_indptr", "t_indices",
              "in_degrees", "out_degrees"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    assert (tg.num_nodes, tg.num_edges, tg.symmetric) == (
        jg.num_nodes, jg.num_edges, jg.symmetric)


GRAPHS = {
    "random": lambda: jsyn.random_graph(64, 512, seed=1),
    "skewed": lambda: jsyn.powerlaw_graph(200, 2000, seed=2),
    "directed": lambda: jsyn.random_graph(90, 700, seed=5, symmetric=False),
    "empty_rows": lambda: __import__(
        "spgemm_gnn_tpu.graphs.csr", fromlist=["from_edges"]).from_edges(
            np.array([0, 1, 2, 5]), np.array([1, 2, 0, 6]), 10),
}


# ---------------------------------------------------------------------------
# synthetic generators: bit for bit the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args,kw", [
    ((300, 3000), {}), ((1000, 20000), {"communities": 16, "p_in": 0.9}),
    ((500, 4000), {"alpha": 1.1, "shuffle": False}),
    ((70, 900), {"communities": 64}), ((2000, 5000), {"seed": 7})])
def test_sbm_graph_bitwise(args, kw):
    assert_same_csr(tsyn.sbm_graph(*args, **kw), jsyn.sbm_graph(*args, **kw))


@pytest.mark.parametrize("args,kw", [
    ((300, 3000), {}), ((1024, 20000), {"a": 0.45, "b": 0.15, "c": 0.15}),
    ((777, 6000), {"shuffle": False}), ((5000, 8000), {"seed": 3})])
def test_rmat_graph_bitwise(args, kw):
    assert_same_csr(tsyn.rmat_graph(*args, **kw),
                    jsyn.rmat_graph(*args, **kw))


@pytest.mark.parametrize("args,kw", [
    ((300, 3000), {}), ((2000, 20000), {"alpha": 2.0, "seed": 4})])
def test_powerlaw_graph_bitwise(args, kw):
    assert_same_csr(tsyn.powerlaw_graph(*args, **kw),
                    jsyn.powerlaw_graph(*args, **kw))


def test_generator_argument_checks():
    with pytest.raises(ValueError, match="communities"):
        tsyn.sbm_graph(10, 100, communities=11)
    with pytest.raises(ValueError, match="a \\+ b \\+ c"):
        tsyn.rmat_graph(10, 100, a=0.5, b=0.3, c=0.3)


@pytest.mark.parametrize("gen,block", [("sbm", 64), ("rmat", 128),
                                       ("powerlaw", 32)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_intra_block_fraction(gen, block, shuffle):
    kw = {} if gen == "powerlaw" else {"shuffle": shuffle}
    jg = getattr(jsyn, f"{gen}_graph")(1200, 9000, seed=1, **kw)
    tg = getattr(tsyn, f"{gen}_graph")(1200, 9000, seed=1, **kw)
    assert tsyn.intra_block_fraction(tg, block) == \
        jsyn.intra_block_fraction(jg, block)


# ---------------------------------------------------------------------------
# the small API leftovers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_edge_src(name):
    jg = GRAPHS[name]()
    tg = port_graph(jg)
    np.testing.assert_array_equal(tg.edge_src.numpy(),
                                  np.asarray(jg.edge_src))
    assert tg.edge_src is tg.indices


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("transpose", [False, True])
def test_edge_weights(name, norm, transpose):
    jg = GRAPHS[name]()
    tg = port_graph(jg)
    w = tnorms.edge_weights(tg, norm, transpose=transpose)
    jw = jnorms.edge_weights(jg, norm, transpose=transpose)
    if norm == "sum":
        assert w is None and jw is None
        return
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("norm", NORMS)
def test_spmm_transpose(name, norm):
    """Against JAX's spmm_transpose, and the adjoint of the port's spmm
    (<A x, y> = <x, Aᵀ y>)."""
    jg = GRAPHS[name]()
    tg = port_graph(jg)
    rng = np.random.default_rng(11)
    y = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)
    x = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)
    z = tspmm.spmm_transpose(tg, torch.from_numpy(y), norm)
    np.testing.assert_allclose(
        z.numpy(), np.asarray(jspmm_transpose(jg, jnp.asarray(y), norm)),
        rtol=0, atol=1e-5)
    ax = tspmm.spmm(tg, torch.from_numpy(x).double(), norm)
    zt = tspmm.spmm_transpose(tg, torch.from_numpy(y).double(), norm)
    np.testing.assert_allclose(float((ax * torch.from_numpy(y)).sum()),
                               float((torch.from_numpy(x) * zt).sum()),
                               rtol=1e-10)


# ---------------------------------------------------------------------------
# the ELL table and products against ops/ell.py of the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("width", [4, 8, 32])
def test_ell_table_bitwise(name, width):
    jg = GRAPHS[name]()
    tg = port_graph(jg)
    eg = tell.ell_graph(tg, width=width)
    jeg = jell.ell_graph(jg, width=width)
    for t, jt in ((eg.fwd, jeg.fwd), (eg.bwd, jeg.bwd)):
        np.testing.assert_array_equal(t.grp_src.numpy(),
                                      np.asarray(jt.grp_src))
        np.testing.assert_array_equal(t.grp_dst.numpy(),
                                      np.asarray(jt.grp_dst))
        assert t.grp_src.dtype == t.grp_dst.dtype == torch.int32
        assert (t.num_src, t.num_dst, t.width) == (jt.num_src, jt.num_dst,
                                                    jt.width)
    assert (eg.bwd is eg.fwd) == tg.symmetric
    # the table from numpy arrays and from tensors is the same
    t2 = tell.build_ell_table(np.asarray(jg.indptr), np.asarray(jg.indices),
                              tg.num_nodes, width=width)
    assert torch.equal(t2.grp_src, eg.fwd.grp_src)


def test_ell_table_covers_every_edge_once():
    tg = port_graph(GRAPHS["skewed"]())
    t = tell.build_ell_table(tg.indptr, tg.indices, tg.num_nodes, width=8)
    grp_src, grp_dst = t.grp_src.numpy(), t.grp_dst.numpy()
    valid = grp_src != tg.num_nodes
    pairs = np.stack([np.repeat(grp_dst, 8)[valid.ravel()], grp_src[valid]],
                     axis=1).astype(np.int64)
    ref = np.stack([tg.edge_dst.numpy(), tg.indices.numpy()],
                   axis=1).astype(np.int64)
    key = lambda p: np.sort(p[:, 0] * tg.num_nodes + p[:, 1])  # noqa: E731
    np.testing.assert_array_equal(key(pairs), key(ref))
    assert grp_src.shape[0] % 8 == 0


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("norm", NORMS)
def test_ell_aggregate_matches_jax(name, norm):
    """Forward and gradient (a random cotangent) of the dense ELL product
    against JAX's `ell_aggregate` differentiated by JAX."""
    jg = GRAPHS[name]()
    tg = port_graph(jg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)
    ct = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)
    jeg = jell.ell_graph(jg, width=8)
    jy, jvjp = jax.vjp(lambda v: jell.ell_aggregate(jeg, v, norm),
                       jnp.asarray(x))
    (jdx,) = jvjp(jnp.asarray(ct))
    eg = tell.ell_graph(tg, width=8)
    xv = torch.from_numpy(x).requires_grad_()
    y = tell.ell_aggregate(eg, xv, norm)
    (dx,) = torch.autograd.grad(y, xv, torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0,
                               atol=1e-5)
    # and through the dispatch: impl "ell", and "auto" on an ELLGraph
    for impl in ("ell", "auto"):
        y2 = tapi.aggregate(eg, torch.from_numpy(x), norm, impl=impl)
        assert torch.equal(y2, y.detach())


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("norm", NORMS)
def test_ell_cbsr_pair_matches_jax(name, norm):
    """aggregate_cbsr on an ELLGraph (spgemm_forward / sspmm_backward)
    against JAX's aggregate_cbsr(impl="ell"), forward and dvalues."""
    jg = GRAPHS[name]()
    tg = port_graph(jg)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)
    ct = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)
    jv, jch = jmaxk_cbsr(jnp.asarray(x), K)
    jeg = jell.ell_graph(jg)
    jy, jvjp = jax.vjp(
        lambda v: jaggregate_cbsr(jeg, v, jch, DIM, norm, "ell"), jv)
    (jdv,) = jvjp(jnp.asarray(ct))
    eg = tell.ell_graph(tg)
    vals = torch.from_numpy(np.array(jv)).requires_grad_()
    ch = torch.from_numpy(np.asarray(jch).astype(np.int32))
    y = tapi.aggregate_cbsr(eg, vals, ch, DIM, norm, "ell")
    (dv,) = torch.autograd.grad(y, vals, torch.from_numpy(ct))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), rtol=0,
                               atol=1e-5)
    # "auto" on an ELLGraph is "ell"
    y_auto = tapi.aggregate_cbsr(eg, vals.detach(), ch, DIM, norm, "auto")
    assert torch.equal(y_auto, y.detach())
    # and the plain oracle agrees
    y_t = tapi.aggregate_cbsr(tg, vals.detach(), ch, DIM, norm, "torch")
    np.testing.assert_allclose(y.detach().numpy(), y_t.numpy(), rtol=0,
                               atol=1e-5)


def test_ell_empty_rows_are_zero():
    jg = GRAPHS["empty_rows"]()
    tg = port_graph(jg)
    eg = tell.ell_graph(tg, width=4)
    x = torch.randn((10, DIM), generator=torch.Generator().manual_seed(0))
    y = tapi.aggregate(eg, x, "sum")
    dst = tg.edge_dst.numpy()
    assert y[np.setdiff1d(np.arange(10), dst)].abs().max() == 0.0
    np.testing.assert_allclose(y.numpy(), tspmm.spmm(tg, x, "sum").numpy(),
                               rtol=0, atol=1e-6)


def test_ell_impl_routing():
    """JAX's rule: impl "ell" needs an ELLGraph (ValueError otherwise), an
    ELLGraph takes only "ell" or "auto", and "ell" is an aggregation impl
    only."""
    tg = port_graph(GRAPHS["random"]())
    eg = tell.ell_graph(tg)
    x = torch.zeros((tg.num_nodes, DIM))
    vals = torch.zeros((tg.num_nodes, K))
    ch = torch.zeros((tg.num_nodes, K), dtype=torch.int32)
    with pytest.raises(ValueError, match="requires an ELLGraph"):
        tapi.aggregate(tg, x, "mean", impl="ell")
    with pytest.raises(ValueError, match="requires an ELLGraph"):
        tapi.aggregate_cbsr(tg, vals, ch, DIM, "mean", impl="ell")
    with pytest.raises(ValueError, match="not an ELLGraph"):
        tapi.aggregate(eg, x, "mean", impl="torch")
    with pytest.raises(ValueError, match="not an ELLGraph"):
        tapi.aggregate_cbsr(eg, vals, ch, DIM, "mean", "torch")
    with pytest.raises(ValueError, match="unknown impl"):
        tapi.cbsr_compact(x, 2, impl="ell")
    with pytest.raises(ValueError, match="unknown impl"):
        tapi.maxk_op(x, 2, impl="ell")
    assert "ell" in tapi.AGGREGATE_IMPLS and "ell" not in tapi.IMPLS


def test_ell_graph_quacks_like_graph():
    tg = port_graph(GRAPHS["directed"]())
    eg = tell.ell_graph(tg)
    assert (eg.num_nodes, eg.num_edges) == (tg.num_nodes, tg.num_edges)
    assert eg.in_degrees is tg.in_degrees and eg.out_degrees is tg.out_degrees
    assert eg.fwd.grp_src.device == tg.device
