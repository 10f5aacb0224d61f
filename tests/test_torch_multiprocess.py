"""The port across processes (parallel/multihost.py, one graph shard a
rank over gloo on the CPU): one 2-rank group and one 4-rank group for the
whole file, each rank running the checks of tests/torch_ranks.py, and the
CLI with --multihost as two processes.

2 ranks, against the in-process mesh of 2 shards on the same inputs: the
aggregation's forward (dense, CBSR, CBSR with a bf16 halo) bit for bit,
its input gradient bit for bit on integer-valued inputs and within 1e-6
of max |dx| on random ones; impl "torch"'s `sharded_spmm` and its
gradient within 1e-5 of JAX `sharded_spmm` on two virtual devices; the
Trainer (SAGE MaxK with dropout 0.5, GNNRes with BatchNorm on the
multilabel yelp stand-in, the ogbn-proteins stand-in with --remat) within
1e-6 relative of the in-process Trainer's losses, and from the JAX
Trainer's weights within 1e-4 of the JAX mesh Trainer's first losses;
ROC-AUC equal to the in-process value; checkpoint and resume bit-equal
to an uninterrupted run; --steps_per_call 2 refused. 4 ranks as dp 2 x
graph 2: `sharded_spmm` over each graph row equal to `spmm` (the
counterpart of tests/test_parallel.py::test_hybrid_mesh_trains).

    python -m pytest tests/test_torch_multiprocess.py
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

import torch_ranks as tr
from spgemm_gnn_tpu.graphs import synthetic as jsyn
from spgemm_gnn_tpu.graphs.datasets import load_dataset as jload
from spgemm_gnn_tpu.ops.maxk import maxk as jmaxk
from spgemm_gnn_tpu.ops.spmm import spmm as jspmm
from spgemm_gnn_tpu.parallel.mesh import make_mesh as jmake_mesh
from spgemm_gnn_tpu.parallel.sharded import shard_graph as jshard_graph
from spgemm_gnn_tpu.parallel.sharded import sharded_spmm as jsharded_spmm
from spgemm_gnn_tpu.train.config import TrainConfig as JConfig
from spgemm_gnn_tpu.train.loop import Trainer as JTrainer
from spgemm_gnn_tpu_torch.convert import params_from_flax
from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph
from spgemm_gnn_tpu_torch.parallel.mesh import Mesh
from spgemm_gnn_tpu_torch.parallel.planned_sharded import shard_planned_graph
from spgemm_gnn_tpu_torch.train.config import TrainConfig
from spgemm_gnn_tpu_torch.train.loop import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, as each rank has: the in-process references then
    split their sums as the ranks do."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_mesh_run() -> tuple[list[float], dict]:
    """(two train steps' losses of the JAX Trainer on a mesh of 2 virtual
    devices, impl "xla", dropout 0; its initial params as a port
    state_dict), as test_torch_trainer_parallel.py draws them."""
    common = {k: v for k, v in tr.COMMON.items() if k != "device"}
    jd = jload("flickr", "/nonexistent", allow_synthetic=True,
               synthetic_scale=common["synthetic_scale"], seed=97)
    jt0 = JTrainer(JConfig(impl="xla", **common), dataset=jd)
    params = jax.device_get(jax.jit(lambda key, g, x: jt0.model.init(
        {"params": key}, g, x, train=False)["params"])(
        jax.random.PRNGKey(jt0.config.seed), jt0.g, jt0.features))
    jt = JTrainer(JConfig(impl="xla", mesh_shape=2, **common), dataset=jd)
    state = jax.device_put(
        {"params": params, "batch_stats": {},
         "opt_state": jt.tx.init(params), "step": jnp.zeros((), jnp.int32)},
        NamedSharding(jt.mesh, PartitionSpec()))
    losses = []
    for _ in range(common["epochs"]):
        state, loss = jt.train_step(state, jax.random.PRNGKey(0))
        losses.append(float(loss))
    return losses, params_from_flax(params)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The 2-rank group's results, and the JAX mesh Trainer's losses from
    the weights the ranks start from."""
    work = tmp_path_factory.mktemp("pair")
    jlosses, weights = _jax_mesh_run()
    torch.save(weights, work / "jax_weights.pt")
    return tr.spawn("pair", 2, str(work)), jlosses, weights


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return tr.spawn("grid", 4, str(tmp_path_factory.mktemp("grid")))


@pytest.fixture(scope="module")
def agg_reference():
    """The in-process mesh of 2 shards: the forms' (y, dx) on all rows."""
    g = powerlaw_graph(tr.AGG_GRAPH["num_nodes"], tr.AGG_GRAPH["num_edges"],
                       seed=tr.AGG_GRAPH["seed"])
    spg = shard_planned_graph(g, Mesh(2, CPU), **tr.AGG_KW)
    return spg, tr.aggregate_forms(spg, tr.agg_inputs(spg.padded_nodes),
                                   slice(None))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def test_pair_runtime(pair):
    """Each rank's process_summary (the JAX function's keys, the backend,
    the device) and mesh: one shard a rank."""
    ranks, _, _ = pair
    for r, out in enumerate(ranks):
        assert out["summary"] == {"process_index": r, "process_count": 2,
                                  "local_devices": 1, "global_devices": 2,
                                  "backend": "gloo", "device": "cpu"}
        text, shards, shard, shape = out["mesh"]
        assert (shards, shard, shape) == (2, r, {"dp": 1, "graph": 2})
        assert text == (f"mesh of 2 shards, one a rank (shard {r} on cpu, "
                        f"gloo)")


@pytest.mark.parametrize("form", [f[0] for f in tr.AGG_FORMS])
def test_pair_aggregation_matches_in_process_mesh(pair, agg_reference,
                                                  form):
    """Each rank's block of `sharded_planned_aggregate`, through the point
    to point rounds, is the in-process mesh's block bit for bit; dx is bit
    for bit on integer-valued inputs (exact sums) and within 1e-6 of max
    |dx| on random ones."""
    ranks, _, _ = pair
    spg, ref = agg_reference
    nps = spg.nodes_per_shard
    y_ref, dx_ref = ref[form]
    for r, out in enumerate(ranks):
        y, dx = out["agg"][form]
        rows = slice(r * nps, (r + 1) * nps)
        np.testing.assert_array_equal(_bits(y), _bits(y_ref[rows]))
        if form.endswith("_int"):
            np.testing.assert_array_equal(_bits(dx), _bits(dx_ref[rows]))
        else:
            err = (dx - dx_ref[rows]).abs().max().item()
            assert err <= 1e-6 * dx_ref.abs().max().item(), (form, r, err)
    stats = ranks[0]["agg_stats"]
    assert stats["exchange_calls"] == stats["exchange_bwd_calls"] == len(
        tr.AGG_FORMS)
    assert stats["exchange_staged_bytes"] == 0      # gloo on the CPU


def test_pair_exchange_bytes(pair, agg_reference):
    """A rank sends, a form, the bytes `comm_stats` gives a rank (dense
    rows, or the CBSR values in f32 or bf16 and the packed ids); the
    backward sends the values' cotangent only (the ids carry no
    gradient)."""
    ranks, _, _ = pair
    spg, _ = agg_reference
    rows = sum(m for _, m in spg.live_rounds)
    fwd = sum(spg.comm_stats(tr.AGG_DIM, k, 2 if halo else 4)
              ["exchange_bytes"] // 2 for *_, k, halo in tr.AGG_FORMS)
    bwd = sum(rows * (tr.AGG_DIM if k is None else k) * (2 if halo else 4)
              for *_, k, halo in tr.AGG_FORMS)
    for out in ranks:
        assert out["agg_stats"]["exchange_bytes"] == fwd
        assert out["agg_stats"]["exchange_bwd_bytes"] == bwd


@pytest.mark.parametrize("k", [None, tr.AGG_K])
def test_pair_sharded_spmm_matches_jax(pair, k):
    """impl "torch" across ranks (the all-gather of the dense rows or of
    the CBSR pair): the ranks' blocks and input gradients within 1e-5 of
    JAX `sharded_spmm` on a mesh of 2 virtual devices."""
    ranks, _, _ = pair
    jg = jsyn.powerlaw_graph(tr.AGG_GRAPH["num_nodes"],
                             tr.AGG_GRAPH["num_edges"],
                             seed=tr.AGG_GRAPH["seed"])
    jsg = jshard_graph(jg, jmake_mesh(2))
    x, ct = tr.spmm_inputs(jsg.padded_nodes)

    def f(v):
        v = jmaxk(v, k) if k else v
        return jsharded_spmm(jsg, v, "mean", k=k)

    xs = jax.device_put(x, jsg.node_sharding())
    jy = np.asarray(jax.jit(f)(xs))
    jdx = np.asarray(jax.jit(jax.grad(lambda v: (f(v) * ct).sum()))(xs))
    y = torch.cat([out["spmm"][k][0] for out in ranks]).numpy()
    dx = torch.cat([out["spmm"][k][1] for out in ranks]).numpy()
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx, jdx, rtol=1e-5, atol=1e-5)


def test_pair_gradients_are_the_global_ones(pair):
    """After one step (dropout 0.5), every rank holds the gradients of the
    in-process mesh Trainer's step: the ranks' sums all-reduced, within
    1e-6 of each parameter's max |grad| (the sums' order differs)."""
    ranks, _, _ = pair
    want = tr.first_step_grads(tr.TRAINERS["sage"])
    for out in ranks:
        assert out["grads"].keys() == want.keys()
        for n, w in want.items():
            err = (out["grads"][n] - w).abs().max().item()
            assert err <= 1e-6 * w.abs().max().item(), (n, err)


@pytest.mark.parametrize("name", list(tr.TRAINERS))
def test_pair_trainer_matches_in_process_mesh(pair, name):
    """The 2-rank Trainer (dropout 0.5: the mask is the global draw's
    rows) against the in-process mesh Trainer, the same on both ranks:
    the first loss within 1e-6 relative (the same logits; the ranks' loss
    sums added in another order), every loss within 1e-5 (the gradient
    sums' order moves a weight's gradient that cancels to near Adam's eps
    of 1e-8, and so its update: 5.0e-6 measured at SAGE's second epoch).
    Accuracies and ROC-AUC are equal; GNNRes's micro-F1 counts logits > 0,
    where BatchNorm's all-reduced statistics (summed in another order)
    move a few logits across 0: within 1e-3."""
    ranks, _, _ = pair
    got = ranks[0][name]
    assert ranks[1][name] == got
    want = tr.history(tr.trainer(tr.TRAINERS[name])[1])
    assert len(got) == len(want) == tr.TRAINERS[name]["epochs"]
    assert abs(got[0][0] - want[0][0]) <= 1e-6 * abs(want[0][0])
    for g, w in zip(got, want):
        assert abs(g[0] - w[0]) <= 1e-5 * abs(w[0]), (g, w)
        if name == "gnn_res":
            np.testing.assert_allclose(g[1:], w[1:], rtol=0, atol=1e-3)
        else:
            assert g[1:] == w[1:]
    coll = ranks[0][f"{name}_collectives"]
    epochs = tr.TRAINERS[name]["epochs"]
    assert coll["grad_all_reduce_calls"] == epochs
    # a forward a layer a step and an eval, a backward a layer a step;
    # remat reruns each layer's forward in the backward
    layers = tr.COMMON["hidden_layers"]
    reruns = epochs * layers if tr.TRAINERS[name].get("remat") else 0
    assert coll["exchange_calls"] == 2 * epochs * layers + reruns
    assert coll["exchange_bwd_calls"] == epochs * layers


def test_pair_predict_reads_the_whole_graph(pair):
    """`Trainer.predict` on a rank (whose features are its rows) serves
    from the whole graph: the final SAGE state's logits, the same on both
    ranks, equal to the in-process mesh Trainer's predict with those
    weights."""
    ranks, _, _ = pair
    ref = Trainer(TrainConfig(**{**tr.COMMON, "mesh_shape": 2,
                                 **tr.TRAINERS["sage"]}), logger=tr.QUIET)
    state = ref.init_state(weights=ranks[0]["sage_weights"])
    want = ref.predict(state, tr.PREDICT_IDS)
    assert want.shape == (len(tr.PREDICT_IDS), ref.dataset.num_classes)
    for out in ranks:
        torch.testing.assert_close(out["sage_predict"], want, rtol=0,
                                   atol=0)


def test_pair_rocauc_equals_in_process(pair):
    """ROC-AUC (ogbn-proteins) of the initial state across ranks (the
    gathered logits) equals the in-process mesh's."""
    ranks, _, _ = pair
    ref = Trainer(TrainConfig(**{**tr.COMMON, "mesh_shape": 2,
                                 **tr.TRAINERS["proteins"]}),
                  logger=tr.QUIET)
    want = [float(m) for m in ref.eval_step(ref.init_state())]
    assert 0.0 < want[0] < 1.0
    for out in ranks:
        assert out["proteins_init_eval"] == want


def test_pair_trainer_matches_jax_mesh_trainer(pair):
    """From the JAX Trainer's initial weights (dropout 0), the 2-rank
    Trainer's two losses within 1e-4 relative of the JAX Trainer's on a
    mesh of 2 virtual devices (test_torch_trainer_parallel's tolerance),
    and within 1e-6 of the in-process mesh Trainer's (dropout 0: no
    gradient element near Adam's eps moves)."""
    ranks, jlosses, weights = pair
    losses = [h[0] for h in ranks[0]["sage_jax"]]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    ref = [h[0] for h in tr.history(tr.trainer({}, weights=weights)[1])]
    np.testing.assert_allclose(losses, ref, rtol=1e-6)


def test_pair_checkpoint_and_resume(pair):
    """4 epochs checkpointed every 2 (shard 0 writes), resumed to 6 on
    every rank: epochs 4 and 5 bit for bit the uninterrupted run's, and
    the best checkpoint's evaluation that of its epoch."""
    ranks, _, _ = pair
    for out in ranks:
        assert out["resumed"] == out["uninterrupted"][4:]
        best = max(out["resumed"], key=lambda h: h[2])
        assert tuple(out["best_eval"]) == best[1:]


def test_pair_steps_per_call_refused(pair):
    for out in pair[0]:
        assert out["steps_per_call"].startswith(
            "--steps_per_call > 1 with more than one process")


def test_grid_hybrid_mesh(grid):
    """dp 2 x graph 2: each rank's row and column, the shape inferred
    from one factor, the ValueError of a shape that is not the world, and
    a sum over each dp column."""
    for r, out in enumerate(grid):
        assert out["shape"] == {"dp": 2, "graph": 2}
        assert out["inferred"] == {"dp": 1, "graph": 4}
        assert out["shard"] == r % 2
        assert out["ranks"] == ((0, 1) if r < 2 else (2, 3))
        assert out["dp_ranks"] == (r % 2, r % 2 + 2)
        assert out["bad_shape"] == "mesh 3x3 != 4 ranks"
        assert out["dp_sum"] == 2.0 * (r % 2) + 2.0


def test_grid_sharded_spmm_matches_spmm(grid):
    """`sharded_spmm` over each graph row of the hybrid mesh: both rows'
    blocks equal the single-device `spmm` (JAX) within 1e-4."""
    jg = jsyn.powerlaw_graph(tr.GRID_GRAPH["num_nodes"],
                             tr.GRID_GRAPH["num_edges"],
                             seed=tr.GRID_GRAPH["seed"])
    x = np.random.default_rng(0).standard_normal(
        (jg.num_nodes, 32)).astype(np.float32)
    want = np.asarray(jspmm(jg, jnp.asarray(x), "mean"))
    for row in (grid[:2], grid[2:]):
        y = torch.cat([out["y"] for out in row]).numpy()[:jg.num_nodes]
        np.testing.assert_allclose(y, want, rtol=1e-4, atol=1e-5)


def test_cli_multihost(tmp_path):
    """`python -m spgemm_gnn_tpu_torch.train --multihost` as two processes
    on an npz dataset: shard 0 stores the sharded host build once, each
    rank logs to its own file (rank 0 the epoch lines), rank 0 writes
    results.json, and the logged losses are the in-process mesh's."""
    ds = load_dataset("flickr", "/nonexistent", allow_synthetic=True,
                      synthetic_scale=tr.COMMON["synthetic_scale"], seed=97)
    g = ds.graph
    np.savez(tmp_path / "flickr.npz", edge_src=g.indices.numpy().astype(
        np.int64), edge_dst=g.edge_dst.numpy().astype(np.int64),
        feat=ds.features, label=ds.labels, train_mask=ds.train_mask,
        val_mask=ds.val_mask, test_mask=ds.test_mask,
        num_classes=ds.num_classes)
    run = tmp_path / "run"
    flags = ["--dataset", "flickr", "--data_path", str(tmp_path),
             "--epochs", "3", "--hidden_dim", "16", "--hidden_layers", "2",
             "--maxk", "4", "--device", "cpu", "--mesh_shape", "2",
             "--path", str(run)]
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": ROOT}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "spgemm_gnn_tpu_torch.train", *flags,
         "--multihost", "--coordinator", f"file://{tmp_path}/rdzv",
         "--num_processes", "2", "--process_id", str(r)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    assert len(list((tmp_path / "plans").glob("shard_*"))) == 1
    log0 = (run / "flickr.log").read_text()
    log1 = (run / "flickr.rank1.log").read_text()
    assert "'backend': 'gloo'" in log0 and "'process_index': 1" in log1
    assert "Epoch 0002/0003" in log0 and "Epoch" not in log1
    assert json.loads((run / "results.json").read_text())["best_epoch"] >= 0

    def losses(text):
        return [line.split("| Loss ")[1].split(" |")[0]
                for line in text.splitlines() if "| Loss " in line]

    ref = Trainer(TrainConfig(dataset="flickr", data_path=str(tmp_path),
                              epochs=3, hidden_dim=16, hidden_layers=2,
                              maxk=4, device="cpu", mesh_shape=2),
                  logger=tr.QUIET).run()
    assert losses(log0) == [f"{r.loss:.4f}" for r in ref["history"]]
