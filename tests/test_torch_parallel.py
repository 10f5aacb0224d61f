"""The port's mesh and plain sharded path (parallel/mesh.py, sharded.py,
dryrun.py) against the JAX package on the CPU (its 8 virtual devices):
`shard_graph` bit for bit (D = 2, 4, 8; symmetric and directed),
`sharded_spmm` and its gradient against JAX `sharded_spmm` and `spmm`
(XLA), the dispatch of `kernels/api.py::aggregate`, the dry run, the
exchange sweep and the import of `parallel` without JAX."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu.graphs import synthetic as jsyn
from spgemm_gnn_tpu.ops.maxk import maxk as jmaxk
from spgemm_gnn_tpu.ops.spmm import spmm as jspmm
from spgemm_gnn_tpu.parallel import planned_sharded as jps
from spgemm_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from spgemm_gnn_tpu.parallel.sharded import shard_graph as jshard_graph
from spgemm_gnn_tpu.parallel.sharded import sharded_spmm as jsharded_spmm
from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.kernels.api import aggregate
from spgemm_gnn_tpu_torch.ops.maxk import maxk
from spgemm_gnn_tpu_torch.parallel import dryrun, make_mesh
from spgemm_gnn_tpu_torch.parallel.planned_sharded import (
    shard_planned_graph, sharded_planned_aggregate)
from spgemm_gnn_tpu_torch.parallel.sharded import shard_graph, sharded_spmm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM, K = 16, 4
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's many small ops: with the
    suite's parallel workers on the host's cores, a thread a core each
    makes every small op wait on the other workers' threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _graphs(kind: str):
    if kind == "symmetric":
        return (jsyn.powerlaw_graph(300, 3000, seed=4),
                tsyn.powerlaw_graph(300, 3000, seed=4))
    return (jsyn.random_graph(250, 2000, seed=8, symmetric=False),
            tsyn.random_graph(250, 2000, seed=8, symmetric=False))


@pytest.fixture(scope="module")
def setup():
    jg, tg = _graphs("symmetric")
    jsg = jshard_graph(jg, jmake_mesh(8))
    sg = shard_graph(tg, make_mesh(8, "cpu"))
    x = np.random.default_rng(0).standard_normal(
        (tg.num_nodes, DIM)).astype(np.float32)
    x_pad = np.zeros((sg.padded_nodes, DIM), np.float32)
    x_pad[:tg.num_nodes] = x
    return jg, tg, jsg, sg, x, x_pad


def test_make_mesh():
    mesh = make_mesh(4, "cpu")
    assert (mesh.num_shards, mesh.axis, mesh.device) == (
        4, "graph", torch.device("cpu"))
    assert str(mesh) == "mesh of 4 shards on cpu, one process"
    with pytest.raises(ValueError, match="at least one shard"):
        make_mesh(0, "cpu")


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_shard_graph_matches_jax(kind, d):
    """The padded per-shard edge lists (sentinel edges to the trash row)
    and the padded degrees bit for bit."""
    jg, tg = _graphs(kind)
    jsg, sg = jshard_graph(jg, jmake_mesh(d)), shard_graph(tg, make_mesh(
        d, "cpu"))
    assert (sg.nodes_per_shard, sg.edges_per_shard, sg.padded_nodes) == (
        jsg.nodes_per_shard, jsg.edges_per_shard, jsg.padded_nodes)
    assert (sg.num_nodes, sg.num_edges) == (jsg.num_nodes, jsg.num_edges)
    for f in ("edge_src", "edge_dst_local", "in_degrees", "out_degrees"):
        t, j = getattr(sg, f), np.asarray(getattr(jsg, f))
        assert t.dtype == torch.int32 and j.dtype == np.int32, f
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f)


@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
def test_sharded_spmm_matches_jax(setup, norm):
    jg, tg, jsg, sg, x, x_pad = setup
    y = sharded_spmm(sg, torch.from_numpy(x_pad), norm)
    jy = np.asarray(jax.jit(lambda v: jsharded_spmm(jsg, v, norm))(
        jax.device_put(x_pad, jsg.node_sharding())))
    np.testing.assert_allclose(y.numpy(), jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y[:tg.num_nodes].numpy(),
                               np.asarray(jspmm(jg, jnp.asarray(x), norm)),
                               rtol=RTOL, atol=ATOL)
    assert not y[tg.num_nodes:].any()


@pytest.mark.parametrize("norm", ["mean", "gcn"])
def test_sharded_cbsr_matches_jax(setup, norm):
    """k < dim: each shard gathers its edges' CBSR pairs."""
    jg, tg, jsg, sg, x, x_pad = setup
    xk = np.array(jmaxk(jnp.asarray(x_pad), K))
    xk[tg.num_nodes:] = 0
    y = sharded_spmm(sg, torch.from_numpy(xk), norm, k=K)
    jy = np.asarray(jax.jit(lambda v: jsharded_spmm(jsg, v, norm, k=K))(
        jax.device_put(xk, jsg.node_sharding())))
    np.testing.assert_allclose(y.numpy(), jy, rtol=RTOL, atol=ATOL)
    dense = sharded_spmm(sg, torch.from_numpy(xk), norm)
    np.testing.assert_allclose(y.numpy(), dense.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("k", [None, K])
def test_sharded_grad_matches_jax(setup, k):
    jg, tg, jsg, sg, x, x_pad = setup
    ct = np.random.default_rng(1).standard_normal(
        (sg.padded_nodes, DIM)).astype(np.float32)
    xp = torch.from_numpy(x_pad).requires_grad_()
    xin = maxk(xp, K) if k else xp
    (sharded_spmm(sg, xin, "mean", k=k) * torch.from_numpy(ct)).sum(
    ).backward()

    def f(v):
        v = jmaxk(v, K) if k else v
        return (jsharded_spmm(jsg, v, "mean", k=k) * ct).sum()

    jdx = np.asarray(jax.jit(jax.grad(f))(
        jax.device_put(x_pad, jsg.node_sharding())))
    np.testing.assert_allclose(xp.grad.numpy(), jdx, rtol=RTOL, atol=ATOL)


def test_aggregate_dispatches_sharded_graphs(setup):
    """`aggregate` routes a ShardedGraph to `sharded_spmm` and a
    ShardedPlannedGraph to `sharded_planned_aggregate`; impl "ell", a
    CUDA impl on CPU tensors, and the impl of the other graph ("cuda" on
    a ShardedGraph, "torch" on a ShardedPlannedGraph) raise."""
    jg, tg, jsg, sg, x, x_pad = setup
    xt = torch.from_numpy(x_pad)
    assert torch.equal(aggregate(sg, xt, "gcn", impl="torch"),
                       sharded_spmm(sg, xt, "gcn"))
    spg = shard_planned_graph(tg, make_mesh(4, "cpu"), dst_block=64)
    xq = torch.zeros(spg.padded_nodes, DIM)
    xq[:tg.num_nodes] = torch.from_numpy(x)
    assert torch.equal(aggregate(spg, xq, "mean", k=K),
                       sharded_planned_aggregate(spg, xq, "mean", k=K))
    with pytest.raises(ValueError, match="unknown impl 'ell'"):
        aggregate(spg, xq, impl="ell")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        aggregate(spg, xq, impl="cuda")
    with pytest.raises(ValueError, match="impl='torch' takes a ShardedGraph"):
        aggregate(spg, xq, impl="torch")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="impl='cuda' takes a Sharded"):
            aggregate(sg, xt.cuda(), impl="cuda")


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun(n):
    """One train step over the mesh, plain and kernel path: finite, and the
    same loss (both take it before the update from the same weights)."""
    loss = dryrun.run_dryrun(n, impl="torch", device="cpu")
    assert np.isfinite(loss) and loss > 0
    assert dryrun.run_dryrun(n, impl="auto", device="cpu") == pytest.approx(
        loss, rel=1e-5)
    with pytest.raises(ValueError, match="impl must be one of"):
        dryrun.run_dryrun(n, impl="pallas", device="cpu")


def test_dryrun_sweep_matrix():
    """Every exchange variant of SWEEP_CONFIGS within its tolerance on 4
    shards, the JAX sweep's coverage, and each config's comm_stats equal
    to those of the JAX package's build of the same graph."""
    recs = dryrun.run_sweep(4, device="cpu")
    assert [r["config"] for r in recs] == [c[0] for c in
                                           dryrun.SWEEP_CONFIGS]
    assert all(r["ok"] for r in recs)
    assert {r["norm"] for r in recs} == {"sum", "mean", "gcn"}
    assert {r["stream"] for r in recs} == {"f32", "bf16x2"}
    assert {k for r in recs for k in r["plan_kinds"]} == {"windowed",
                                                          "stream"}
    assert all(r["exchange_bytes"] <= r["full_gather_bytes"] for r in recs)
    assert any(r["dim"] > 256 and r["k"] for r in recs)
    assert all(r["compact"] == ("cbsr_compact" if r["k"] else None)
               for r in recs)
    b16 = next(r for r in recs if r["halo_dtype"] == "bf16")
    f32 = next(r for r in recs if r["config"] == "windowed_cbsr_f32_mean")
    assert f32["exchange_bytes"] / b16["exchange_bytes"] > 1.5
    jgraphs = {"dense": (jsyn.powerlaw_graph(512, 6144, seed=0),
                         dict(src_block=128, dst_block=128)),
               "sparse": (jsyn.powerlaw_graph(4096, 2048, seed=1),
                          dict(src_block=128, dst_block=128, window=16))}
    jspgs = {name: jps.shard_planned_graph(g, jmake_mesh(4), tile_slots=128,
                                           **kw)
             for name, (g, kw) in jgraphs.items()}
    for (name, regime, k, *_), r in zip(dryrun.SWEEP_CONFIGS, recs):
        want = jspgs[regime].comm_stats(r["dim"], k, 2 if r[
            "halo_dtype"] == "bf16" else 4)
        assert {key: r[key] for key in want} == want, name


def test_parallel_imports_without_jax():
    script = ("import sys\n"
              "import spgemm_gnn_tpu_torch.parallel\n"
              "import spgemm_gnn_tpu_torch.parallel.dryrun\n"
              "import spgemm_gnn_tpu_torch.parallel.planned_sharded\n"
              "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'optax', 'spgemm_gnn_tpu')]\n"
              "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
