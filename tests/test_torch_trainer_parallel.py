"""The port's Trainer over a mesh (`--mesh_shape`, train/loop.py) on the
CPU: its first-epoch loss against the JAX Trainer on its mesh of virtual
devices (impl "xla", weights carried across by convert.py) for D = 2, 4,
8 and both of the port's paths (impl "torch": `sharded_spmm`; "auto": the
shards' plan pairs and the halo exchange), `--remat` and batched steps
bit-equal to their plain runs, bf16 under a mesh, the trajectory match
with its checkpoint restore, serving and the CLI."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from spgemm_gnn_tpu.graphs.datasets import load_dataset as jload
from spgemm_gnn_tpu.train.config import TrainConfig as JConfig
from spgemm_gnn_tpu.train.loop import Trainer as JTrainer
from spgemm_gnn_tpu_torch.convert import params_from_flax
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.datasets import Dataset
from spgemm_gnn_tpu_torch.parallel.dryrun import run_trajectory_match
from spgemm_gnn_tpu_torch.parallel.planned_sharded import (
    ShardedPlannedGraph, sharded_planned_aggregate)
from spgemm_gnn_tpu_torch.parallel.sharded import ShardedGraph
from spgemm_gnn_tpu_torch.train.__main__ import main as tmain
from spgemm_gnn_tpu_torch.train.config import TrainConfig
from spgemm_gnn_tpu_torch.train.loop import Trainer

COMMON = dict(dataset="flickr", model="sage", epochs=2, hidden_dim=16,
              hidden_layers=2, maxk=4, dropout=0.0, w_lr=0.01,
              nonlinear="maxk", synthetic=True, synthetic_scale=0.003,
              eval_every=1, log_every=0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's many small ops: with the
    suite's parallel workers on the host's cores, a thread a core each
    makes every small op wait on the other workers' threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data():
    """The JAX stand-in's arrays, and the port's Dataset of them."""
    jd = jload("flickr", "/nonexistent", allow_synthetic=True,
               synthetic_scale=COMMON["synthetic_scale"], seed=97)
    td = Dataset(name=jd.name,
                 graph=from_edges(np.asarray(jd.graph.indices),
                                  np.asarray(jd.graph.edge_dst),
                                  jd.graph.num_nodes),
                 features=jd.features, labels=jd.labels,
                 train_mask=jd.train_mask, val_mask=jd.val_mask,
                 test_mask=jd.test_mask, num_classes=jd.num_classes,
                 multilabel=jd.multilabel)
    return jd, td, {}


def _jax_params(data):
    """The JAX model's initial params, as its Trainer's `init_state` draws
    them (from the seed and the widths, whatever the graph), by one jitted
    init on the unsharded graph: an eager init over a mesh of virtual
    devices takes seconds a mesh."""
    jd, _, runs = data
    if "params" not in runs:
        jt = JTrainer(JConfig(impl="xla", **COMMON), dataset=jd)
        init = jax.jit(lambda key, g, x: jt.model.init(
            {"params": key}, g, x, train=False)["params"])
        runs["params"] = jax.device_get(init(
            jax.random.PRNGKey(jt.config.seed), jt.g, jt.features))
    return runs["params"]


def _jax_run(data, mesh: int):
    """(the losses of two train steps, the initial params as a port
    state_dict) of the JAX Trainer on a mesh of `mesh` virtual devices,
    impl "xla" (dropout is off, so the step's key draws nothing), from
    `init_state`'s state: the params replicated over the mesh with their
    optimizer state; once per mesh size."""
    jd, _, runs = data
    if mesh not in runs:
        jt = JTrainer(JConfig(impl="xla", mesh_shape=mesh, **COMMON),
                      dataset=jd)
        params = _jax_params(data)
        state = jax.device_put(
            {"params": params, "batch_stats": {},
             "opt_state": jt.tx.init(params),
             "step": jnp.zeros((), jnp.int32)},
            NamedSharding(jt.mesh, PartitionSpec()))
        weights = params_from_flax(params)
        losses = []
        for _ in range(COMMON["epochs"]):
            state, loss = jt.train_step(state, jax.random.PRNGKey(0))
            losses.append(float(loss))
        runs[mesh] = (losses, weights)
    return runs[mesh]


def _run(td, **kw):
    tr = Trainer(TrainConfig(device="cpu", **{**COMMON, **kw}), dataset=td)
    return tr, tr.run()


@pytest.mark.parametrize("impl", ["torch", "auto"])
@pytest.mark.parametrize("mesh", [2, 4, 8])
def test_mesh_trainer_matches_jax(data, mesh, impl):
    """The first epoch's loss within 1e-4 relative of the JAX mesh
    Trainer's from the same weights; the second epoch's loss too."""
    _, td, _ = data
    jlosses, weights = _jax_run(data, mesh)
    tr = Trainer(TrainConfig(device="cpu", impl=impl, mesh_shape=mesh,
                             **COMMON), dataset=td)
    assert isinstance(tr.g, ShardedGraph if impl == "torch"
                      else ShardedPlannedGraph)
    assert tr.features.shape[0] == tr.g.padded_nodes >= td.num_nodes
    hist = tr.run(state=tr.init_state(weights=weights))["history"]
    np.testing.assert_allclose([r.loss for r in hist], jlosses, rtol=1e-4)


def _history(res):
    return [(r.loss, r.train_acc, r.val_acc, r.test_acc)
            for r in res["history"]]


def test_mesh_remat_matches_no_remat(data):
    """--remat under a mesh (dropout on) gives the run's losses and
    metrics bit for bit."""
    _, td, _ = data
    kw = dict(mesh_shape=4, dropout=0.5, epochs=3)
    assert _history(_run(td, remat=True, **kw)[1]) == _history(
        _run(td, **kw)[1])


def test_mesh_steps_per_call_matches_one(data):
    """Batched steps under a mesh (on the CPU a group runs eagerly): the
    history of steps_per_call 1."""
    _, td, _ = data
    kw = dict(mesh_shape=4, dropout=0.5, epochs=5, eval_every=4)
    assert _history(_run(td, steps_per_call=3, **kw)[1]) == _history(
        _run(td, **kw)[1])


@pytest.mark.parametrize("over", [dict(dtype="bfloat16"),
                                  dict(stream="bf16x2")])
def test_mesh_16bit_trains(data, over):
    """--dtype bfloat16 and --stream bf16x2 under a mesh: finite losses
    that fall."""
    _, td, _ = data
    tr, res = _run(td, mesh_shape=4, epochs=8, eval_every=4, **over)
    if "dtype" in over:
        assert tr.features.dtype == torch.bfloat16
    losses = [r.loss for r in res["history"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_trajectory_match_with_checkpoint_restore():
    rec = run_trajectory_match(4, epochs=5, device="cpu")
    assert rec["ok"] and rec["max_loss_diff"] < 2e-4
    assert rec["best_epoch_single"] == rec["best_epoch_sharded"]
    assert rec["ckpt_restore_val_diff"] < 1e-6


def test_mesh_predict_uses_the_unsharded_graph(data):
    """predict under a mesh serves from the plain graph, which the Trainer
    moves to its device only at the first predict: the logits of the
    single-device Trainer with the same weights."""
    _, td, _ = data
    mesh_tr = Trainer(TrainConfig(device="cpu", mesh_shape=4, **COMMON),
                      dataset=td)
    one_tr = Trainer(TrainConfig(device="cpu", **COMMON), dataset=td)
    state = mesh_tr.init_state()
    assert mesh_tr._serve_graph is None
    ids = np.arange(0, td.num_nodes, 7)
    torch.testing.assert_close(mesh_tr.predict(state, ids),
                               one_tr.predict(state, ids))
    assert mesh_tr.graph is mesh_tr._serve_graph is not None
    assert one_tr.graph is one_tr.g.graph


def test_mesh_cli_trains(tmp_path):
    res = tmain(["--dataset", "flickr", "--synthetic", "--synthetic_scale",
                 "0.003", "--epochs", "3", "--hidden_dim", "16",
                 "--hidden_layers", "2", "--maxk", "4", "--device", "cpu",
                 "--mesh_shape", "4", "--path", str(tmp_path)])
    losses = [r.loss for r in res["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    log = (tmp_path / "flickr.log").read_text()
    assert "mesh of 4 shards on cpu, one process" in log


@pytest.mark.parametrize("synthetic", [False, True])
def test_mesh_trainer_caches_npz_builds_only(data, tmp_path, synthetic):
    """An npz dataset's sharded build is stored under <data_path>/plans
    (the JAX Trainer's rule) and a second Trainer loads it; a synthetic
    run stores nothing."""
    _, td, _ = data
    cfg = TrainConfig(device="cpu", mesh_shape=4, data_path=str(tmp_path),
                      **{**COMMON, "synthetic": synthetic})
    first = Trainer(cfg, dataset=td)
    entries = list((tmp_path / "plans").glob("shard_*"))
    assert len(entries) == (0 if synthetic else 1)
    second = Trainer(cfg, dataset=td)
    x = torch.randn(first.g.padded_nodes, 16)
    assert torch.equal(sharded_planned_aggregate(first.g, x, "mean"),
                       sharded_planned_aggregate(second.g, x, "mean"))
