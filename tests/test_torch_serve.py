"""The port's serving and persistence path against the JAX package (CPU):
the k-hop extraction (`train/infer.py::khop_in_subgraph`), the feature
stores (`graphs/features.py`), `predict_nodes` through every model family,
checkpoints, resume and eval-only (`train/checkpoint.py`, `Trainer`), the
optimizer state carried across by `convert.checkpoint_from_flax`, and the
CLI's flags; then the predict path on the card (GPU, marker `gpu`, no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_serve.py
"""
import json

import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs.csr import Graph, from_edges
from spgemm_gnn_tpu_torch.graphs.datasets import Dataset
from spgemm_gnn_tpu_torch.graphs.features import (DeviceFeatureStore,
                                                  HostFeatureStore,
                                                  make_feature_store)
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.train import checkpoint as tckpt
from spgemm_gnn_tpu_torch.train.config import TrainConfig, check_supported
from spgemm_gnn_tpu_torch.train.infer import khop_in_subgraph, predict_nodes
from spgemm_gnn_tpu_torch.train.loop import Trainer

GRAPH_FIELDS = ("indptr", "indices", "edge_dst", "t_indptr", "t_indices",
                "t_edge_dst", "in_degrees", "out_degrees")


def star_graph(n: int = 200, extra: int = 800, seed: int = 4):
    """Node 0 sends an edge to every other node, and `extra` random edges
    follow: a one-hop closure of a few seeds holds node 0, whose out-row
    dwarfs the induced edges (the argsort transpose regime)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([np.zeros(n - 1, np.int64),
                          rng.integers(1, n, extra)])
    dst = np.concatenate([np.arange(1, n), rng.integers(1, n, extra)])
    return src, dst, n


def _regime(g: Graph, nodes: np.ndarray, e_sub: int) -> str:
    """The transpose regime khop_in_subgraph takes (its own test)."""
    t = g.host_arrays()["t_indptr"].astype(np.int64)
    t_scan = int((t[nodes + 1] - t[nodes]).sum())
    return "filter" if t_scan <= 3 * e_sub else "argsort"


def test_khop_matches_jax():
    """Every integer array of the subgraph, the node ids and the seed
    positions equal the JAX package's, at hops 0-4 on a random graph in both
    orientations and on a star graph: the filter and the argsort transpose
    regimes, a closure that reaches every node but not every row's edges,
    and a saturated closure (the graph itself) all occur."""
    from spgemm_gnn_tpu.graphs.csr import from_edges as jfrom_edges
    from spgemm_gnn_tpu.graphs.synthetic import random_graph as jrandom
    from spgemm_gnn_tpu.train.infer import khop_in_subgraph as jkhop

    cases = []
    for symmetric in (True, False):
        cases.append((jrandom(300, 2500, seed=7, symmetric=symmetric),
                      tsyn.random_graph(300, 2500, seed=7,
                                        symmetric=symmetric)))
    src, dst, n = star_graph()
    cases.append((jfrom_edges(src, dst, n), from_edges(src, dst, n)))
    seen = set()
    for jg, tg in cases:
        for seeds in (np.random.default_rng(2).choice(tg.num_nodes, 25,
                                                      replace=False),
                      np.array([5, 9, 5])):
            for hops in range(5):
                jsub, jnodes, jpos = jkhop(jg, seeds, hops)
                sub, nodes, pos = khop_in_subgraph(tg, seeds, hops)
                np.testing.assert_array_equal(nodes, jnodes)
                np.testing.assert_array_equal(pos, jpos)
                assert (sub.num_nodes, sub.num_edges) == (jsub.num_nodes,
                                                          jsub.num_edges)
                for f in GRAPH_FIELDS:
                    np.testing.assert_array_equal(
                        getattr(sub, f).numpy(),
                        np.asarray(getattr(jsub, f)), err_msg=f)
                if sub is tg:
                    seen.add("saturated")
                    continue
                assert not sub.symmetric and sub.plans is None
                if sub.num_nodes == tg.num_nodes:
                    seen.add("all nodes")
                if hops:
                    seen.add(_regime(tg, nodes, sub.num_edges))
    assert seen == {"saturated", "all nodes", "filter", "argsort"}, seen


def test_khop_host_arrays_made_once():
    g = tsyn.random_graph(50, 300, seed=1)
    khop_in_subgraph(g, [3], 2)
    first = g.host
    khop_in_subgraph(g, [4], 1)
    assert g.host is first and first is not None
    assert g.to("cpu").host is None      # a moved copy starts without one


# ---------------------------------------------------------------------------
# Feature stores against the JAX stores
# ---------------------------------------------------------------------------

def _fetch_sequence(n: int, count: int = 20, seed: int = 11):
    """`count` batches of ids, sizes 0 to 150, skewed toward low ids (hot
    rows) and with repeats."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        size = 0 if i == 7 else int(rng.integers(1, 150))
        hot = rng.integers(0, n // 10, size)
        cold = rng.integers(0, n, size)
        out.append(np.where(rng.random(size) < 0.6, hot, cold))
    return out


@pytest.mark.parametrize("ratio", [0.05, 0.5])
@pytest.mark.parametrize("policy", ["direct", "static-outd", "fifo", "lru"])
def test_feature_store_matches_jax(policy, ratio):
    """A seeded sequence of 20 fetches: the rows equal the JAX store's
    bitwise, and the hits and misses after each fetch exactly. Bytes from
    the host: the JAX store's for direct and static-outd; fifo and lru admit
    from the fetch's own copy, so theirs are the misses' rows alone."""
    from spgemm_gnn_tpu.graphs.features import make_feature_store as jmake

    n, dim = 600, 12
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((n, dim)).astype(np.float32)
    out_deg = rng.integers(0, 40, n).astype(np.int32)
    js = jmake(feats, policy=policy, cache_ratio=ratio, out_degrees=out_deg)
    ts = make_feature_store(feats, policy=policy, cache_ratio=ratio,
                            out_degrees=torch.tensor(out_deg), device="cpu")
    assert isinstance(ts, HostFeatureStore)
    for ids in _fetch_sequence(n):
        got = ts.fetch(ids)
        want = np.asarray(js.fetch(ids))
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))
        assert ts.stats["hits"] == js.stats["hits"]
        assert ts.stats["misses"] == js.stats["misses"]
        assert ts.stats["hit_rate"] == js.stats["hit_rate"]
        if policy in ("direct", "static-outd"):
            assert ts.stats["bytes_from_host"] == js.stats["bytes_from_host"]
        else:
            assert ts.stats["bytes_from_host"] == \
                ts.stats["misses"] * dim * 4 <= js.stats["bytes_from_host"]
    if policy != "direct":
        np.testing.assert_array_equal(ts._slot_table, js._slot_table)
        assert ts.stats["hits"] > 0
    ts.reset_stats()
    assert ts.stats == {"hits": 0, "misses": 0, "hit_rate": 0.0,
                        "bytes_from_host": 0}


def test_device_store_and_dtype():
    feats = np.random.default_rng(0).standard_normal((30, 6)).astype(
        np.float32)
    ds = make_feature_store(feats, device="cpu")
    assert isinstance(ds, DeviceFeatureStore)
    np.testing.assert_array_equal(ds.fetch([3, 1, 3]).numpy(),
                                  feats[[3, 1, 3]])
    hs = make_feature_store(feats, policy="lru", cache_ratio=0.2,
                            dtype=torch.bfloat16, device="cpu")
    rows = hs.fetch(np.array([4, 2]))
    assert rows.dtype == torch.bfloat16
    assert torch.equal(rows, torch.tensor(feats[[4, 2]]).to(torch.bfloat16))
    assert hs.full().dtype == torch.bfloat16
    with pytest.raises(ValueError, match="policy"):
        HostFeatureStore(feats, policy="random", device="cpu")
    with pytest.raises(ValueError, match="out_degrees"):
        HostFeatureStore(feats, policy="static-outd", device="cpu")


# ---------------------------------------------------------------------------
# predict_nodes through every family, against JAX and the full forward
# ---------------------------------------------------------------------------

N, IN_DIM, HID, OUT, K, LAYERS = 300, 12, 32, 5, 8, 2
FAMILIES = ["sage", "gcn", "gin", "gnn_res", "sage_integrated",
            "gcn_integrated", "gin_integrated"]


@pytest.mark.parametrize("model", FAMILIES)
def test_predict_nodes_matches_jax(model):
    """The port's predict_nodes (impl "auto": the subgraph's aggregation on
    its own windowed plan) at the flax weights (convert.py) within 2e-4 of
    the JAX package's predict_nodes (GNNRes: the same JAX pipeline with its
    batch_stats, which JAX's predict_nodes does not pass), and within 1e-5
    of max |logit| of the port's own full-graph forward at the seed rows;
    through a device store and a host store with a cache."""
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.graphs.features import DeviceFeatureStore as JStore
    from spgemm_gnn_tpu.graphs.synthetic import powerlaw_graph as jpowerlaw
    from spgemm_gnn_tpu.models.models import build_model as jbuild
    from spgemm_gnn_tpu.train.infer import khop_in_subgraph as jkhop
    from spgemm_gnn_tpu.train.infer import predict_nodes as jpredict
    from spgemm_gnn_tpu_torch.convert import (buffers_from_flax,
                                              params_from_flax)
    from spgemm_gnn_tpu_torch.models.models import build_model as tbuild

    rng = np.random.default_rng(3)
    x = rng.standard_normal((N, IN_DIM)).astype(np.float32)
    jg = jpowerlaw(N, 3000, seed=7)
    tg = tsyn.powerlaw_graph(N, 3000, seed=7)
    kw = dict(hidden_dim=HID, num_layers=LAYERS, out_dim=OUT, maxk=K,
              feat_drop=0.0, use_norm=True, nonlinear="maxk")
    jm = jbuild(model, impl="xla", **kw)
    variables = jm.init({"params": jax.random.PRNGKey(0)}, jg,
                        jnp.asarray(x), train=False)
    tm = tbuild(model, in_dim=IN_DIM, impl="auto", **kw)
    tm.load_state_dict({
        **params_from_flax(jax.device_get(variables["params"])),
        **buffers_from_flax(jax.device_get(variables.get("batch_stats",
                                                         {})))})
    tm.eval()
    seeds = np.array([3, 40, 77, 101, 250, 40])
    if "batch_stats" in variables:
        jsub, jnodes, jpos = jkhop(jg, seeds, LAYERS)
        want = jm.apply(variables, jsub, jnp.asarray(x[jnodes]),
                        train=False)[jpos]
    else:
        want = jpredict(jm, variables["params"], jg, JStore(x), seeds,
                        hops=LAYERS)
    want = np.asarray(want)
    with torch.no_grad():
        full = tm(tg, torch.tensor(x))[np.unique(seeds)]
    stores = (DeviceFeatureStore(x, device="cpu"),
              HostFeatureStore(x, policy="static-outd", cache_ratio=0.3,
                               out_degrees=tg.out_degrees, device="cpu"))
    for store in stores:
        got = predict_nodes(tm, None, tg, store, seeds, hops=LAYERS)
        assert got.shape == (len(np.unique(seeds)), OUT)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
        err = float((got - full).abs().max())
        assert err <= 1e-5 * float(full.abs().max()), err
    assert stores[1].stats["hits"] > 0
    # params as a state_dict (functional_call): the module is not touched
    params = {n: p * 0 for n, p in tm.named_parameters()}
    zero = predict_nodes(tm, params, tg, stores[0], seeds, hops=LAYERS)
    assert float(zero.abs().max()) == 0.0
    assert any(float(p.abs().max()) > 0 for p in tm.parameters())


# ---------------------------------------------------------------------------
# Checkpoints, resume and eval-only
# ---------------------------------------------------------------------------

COMMON = dict(dataset="flickr", model="sage", epochs=4, hidden_dim=16,
              hidden_layers=2, maxk=4, dropout=0.0, w_lr=0.01,
              nonlinear="maxk", norm=True, synthetic=True,
              synthetic_scale=0.003, eval_every=1, log_every=0, seed=3,
              device="cpu")


def _cfg(tmp, **kw) -> TrainConfig:
    return TrainConfig(**{**COMMON, "path": str(tmp), **kw})


def _snap_bits(snap: dict) -> dict:
    """Every tensor of a snapshot as int32 bits, every int as itself."""
    out = {}
    for key, value in snap.items():
        if isinstance(value, dict):
            for name, t in value.items():
                out[f"{key}.{name}"] = t.detach().cpu().view(
                    torch.int32).numpy().tolist()
        elif isinstance(value, torch.Tensor):
            out[key] = value.tolist()
        else:
            out[key] = value
    return out


@pytest.mark.parametrize("extra", [
    dict(), dict(enable_lookahead=True, w_weight_decay=1e-3),
    dict(model="gnn_res")])
def test_checkpoint_roundtrip_bitwise(tmp_path, extra):
    """A state after 3 steps (Adam moments, Lookahead's slow weights,
    GNNRes's running statistics, the dropout generator) saved and restored
    into a fresh state: every tensor bitwise, every count equal; the next
    step from either gives the same loss."""
    tr = Trainer(_cfg(tmp_path, dropout=0.5, **extra))
    state = tr.init_state()
    state["dropout_rng"] = torch.Generator().manual_seed(9)
    for _ in range(3):
        tr.train_step(state, state["dropout_rng"])
    path = tckpt.save_checkpoint(str(tmp_path), state, 3)
    assert tckpt.latest_step(str(tmp_path)) == 3
    fresh = tr.init_state(seed=123)
    fresh["dropout_rng"] = torch.Generator()
    tckpt.restore_checkpoint(path, fresh)
    a, b = tckpt.snapshot(state), tckpt.snapshot(fresh)
    assert _snap_bits(a) == _snap_bits(b)
    assert a["count"] == 3 and a["step"] == 3
    assert (a["slow"] is not None) == ("enable_lookahead" in extra)
    assert (len(a["batch_stats"]) > 0) == (extra.get("model") == "gnn_res")
    la = float(tr.train_step(state, state["dropout_rng"]))
    lb = float(tr.train_step(fresh, fresh["dropout_rng"]))
    assert la == lb


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_resume_gives_uninterrupted_history(tmp_path, dropout):
    """4 epochs with checkpoint_every=2 against 2 epochs, then a fresh
    Trainer with resume to 4: the resumed run starts at epoch 2 and its
    records equal the uninterrupted run's bitwise. The checkpoint carries
    the dropout generator, so that holds at dropout 0.5 too."""
    whole = Trainer(_cfg(tmp_path / "a", checkpoint_every=2,
                         dropout=dropout)).run()
    Trainer(_cfg(tmp_path / "b", checkpoint_every=2, epochs=2,
                 dropout=dropout)).run()
    assert tckpt.latest_step(str(tmp_path / "b")) == 2
    resumed = Trainer(_cfg(tmp_path / "b", checkpoint_every=2, resume=True,
                           dropout=dropout)).run()
    assert [r.epoch for r in resumed["history"]] == [2, 3]
    assert resumed["history"] == whole["history"][2:]
    assert tckpt.latest_step(str(tmp_path / "b")) == 4


def test_best_snapshot_and_evaluate_checkpoint(tmp_path):
    """The best-val snapshot is a copy taken at its epoch (saved at the end
    even off a checkpoint boundary), and evaluate_checkpoint of `best`
    returns that epoch's (train, val, test) exactly; of the run directory,
    the last epoch's."""
    cfg = _cfg(tmp_path, epochs=7, checkpoint_every=3)
    tr = Trainer(cfg)
    res = tr.run()
    hist = {r.epoch: r for r in res["history"]}
    best = hist[res["best_epoch"]]
    assert res["best_epoch"] < 6    # the best is not the last epoch here
    snap = tckpt.read_checkpoint(str(tmp_path / "checkpoints" / "best"))
    assert snap["step"] == res["best_epoch"] + 1
    got = tr.evaluate_checkpoint(str(tmp_path / "checkpoints" / "best"))
    assert got == (best.train_acc, best.val_acc, best.test_acc)
    last = tr.evaluate_checkpoint(str(tmp_path))
    assert last == (hist[6].train_acc, hist[6].val_acc, hist[6].test_acc)
    assert tckpt.latest_step(str(tmp_path)) == 7


def _jax_and_port_datasets(scale: float):
    from spgemm_gnn_tpu.graphs.datasets import load_dataset as jload
    jd = jload("flickr", "/nonexistent", allow_synthetic=True,
               synthetic_scale=scale, seed=COMMON["seed"])
    td = Dataset(name=jd.name,
                 graph=from_edges(np.asarray(jd.graph.indices),
                                  np.asarray(jd.graph.edge_dst),
                                  jd.graph.num_nodes),
                 features=jd.features, labels=jd.labels,
                 train_mask=jd.train_mask, val_mask=jd.val_mask,
                 test_mask=jd.test_mask, num_classes=jd.num_classes,
                 multilabel=jd.multilabel)
    return jd, td


def _losses(history) -> np.ndarray:
    return np.array([r.loss for r in history])


def test_resumed_history_matches_jax(tmp_path):
    """The JAX Trainer and the port, each from the same initial weights,
    2 epochs with checkpoint_every=2 and then resumed to 4 from its own
    checkpoint: the resumed losses within 1e-4, the accuracies within one
    node."""
    from spgemm_gnn_tpu.train.config import TrainConfig as JConfig
    from spgemm_gnn_tpu.train.loop import Trainer as JTrainer
    import jax
    from spgemm_gnn_tpu_torch.convert import params_from_flax

    jd, td = _jax_and_port_datasets(0.004)
    jcfg = {k: v for k, v in COMMON.items() if k != "device"}
    JTrainer(JConfig(impl="xla", **{**jcfg, "epochs": 2,
                                    "checkpoint_every": 2,
                                    "path": str(tmp_path / "j")}),
             dataset=jd).run()
    jt = JTrainer(JConfig(impl="xla", **{**jcfg, "checkpoint_every": 2,
                                         "resume": True,
                                         "path": str(tmp_path / "j")}),
                  dataset=jd)
    jres = jt.run()
    weights = params_from_flax(jax.device_get(jt.init_state()["params"]))
    t1 = Trainer(_cfg(tmp_path / "t", epochs=2, checkpoint_every=2),
                 dataset=td)
    t1.run(state=t1.init_state(weights=weights))
    tres = Trainer(_cfg(tmp_path / "t", checkpoint_every=2, resume=True),
                   dataset=td).run()
    assert [r.epoch for r in tres["history"]] == \
        [r.epoch for r in jres["history"]] == [2, 3]
    np.testing.assert_allclose(_losses(tres["history"]),
                               _losses(jres["history"]), rtol=0, atol=1e-4)
    n_val = int(jd.val_mask.sum())
    for rj, rt in zip(jres["history"], tres["history"]):
        assert abs(rj.val_acc - rt.val_acc) * n_val <= 1 + 1e-6


@pytest.mark.parametrize("jax_epochs,epochs,extra", [
    (2, 4, dict()),
    (4, 8, dict(enable_lookahead=True, w_weight_decay=1e-3))])
def test_jax_state_resumes_in_port(tmp_path, jax_epochs, epochs, extra):
    """convert.checkpoint_from_flax: a JAX Trainer state after `jax_epochs`
    (params, Adam's moments and count, Lookahead's slow params and step)
    saved as the port's checkpoint and resumed in the port to `epochs`
    gives the JAX run's history over those epochs within 1e-4 (loss) and
    one node (val accuracy). With Lookahead the resumed epochs cross its
    sync at step 6."""
    import jax
    from spgemm_gnn_tpu.train.config import TrainConfig as JConfig
    from spgemm_gnn_tpu.train.loop import Trainer as JTrainer
    from spgemm_gnn_tpu_torch.convert import checkpoint_from_flax

    jd, td = _jax_and_port_datasets(0.004)
    jcfg = {k: v for k, v in {**COMMON, **extra}.items() if k != "device"}
    jwhole = JTrainer(JConfig(impl="xla", **{**jcfg, "epochs": epochs}),
                      dataset=jd).run()
    jpart = JTrainer(JConfig(impl="xla", **{**jcfg, "epochs": jax_epochs}),
                     dataset=jd).run()
    snap = checkpoint_from_flax(jax.device_get(jpart["final_state"]))
    assert snap["step"] == snap["count"] == jax_epochs
    assert (snap["slow"] is not None) == bool(extra)
    tckpt.save_checkpoint(str(tmp_path), snap, jax_epochs)
    tres = Trainer(_cfg(tmp_path, epochs=epochs, resume=True, **extra),
                   dataset=td).run()
    want = jwhole["history"][jax_epochs:]
    assert [r.epoch for r in tres["history"]] == [r.epoch for r in want]
    np.testing.assert_allclose(_losses(tres["history"]), _losses(want),
                               rtol=0, atol=1e-4)
    n_val = int(jd.val_mask.sum())
    for rj, rt in zip(want, tres["history"]):
        assert abs(rj.val_acc - rt.val_acc) * n_val <= 1 + 1e-6


def test_trainer_predict_through_cache_strategy(tmp_path):
    """cache_strategy builds the feature store (its full() feeds training)
    and Trainer.predict serves through it, equal to the full-graph eval
    forward at the seeds within 1e-5 of max |logit|."""
    tr = Trainer(_cfg(tmp_path, cache_strategy="static-outd",
                      cache_size_ratio=0.3))
    assert isinstance(tr.feature_store, HostFeatureStore)
    np.testing.assert_array_equal(tr.features.numpy(),
                                  tr.dataset.features)
    res = tr.run()
    state = res["final_state"]
    seeds = np.array([0, 1, 2, 50])
    got = tr.predict(state, seeds)
    assert got.shape == (4, tr.dataset.num_classes)
    with torch.no_grad():
        full = state["model"].eval()(tr.g, tr.features)[seeds]
    assert float((got - full).abs().max()) <= 1e-5 * float(full.abs().max())
    assert tr.feature_store.stats["hits"] > 0


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def test_cli_checkpoint_resume_evaluate(tmp_path):
    """--checkpoint_every, --resume and --evaluate through the CLI: the
    resumed run trains only the epochs after the checkpoint, and
    --evaluate of `best` prints and writes that epoch's accuracies."""
    from spgemm_gnn_tpu_torch.train.__main__ import main as tmain
    base = ["--dataset", "flickr", "--synthetic", "--synthetic_scale",
            "0.003", "--hidden_dim", "16", "--hidden_layers", "1", "--maxk",
            "4", "--device", "cpu", "--path", str(tmp_path),
            "--checkpoint_every", "2", "--log_every", "0"]
    first = tmain(base + ["--epochs", "2"])
    assert len(first["history"]) == 2
    res = tmain(base + ["--epochs", "4", "--resume"])
    assert [r.epoch for r in res["history"]] == [2, 3]
    assert tckpt.latest_step(str(tmp_path)) == 4
    best = {r.epoch: r for r in res["history"]}[res["best_epoch"]]
    ev = tmain(base + ["--evaluate",
                       str(tmp_path / "checkpoints" / "best")])
    assert ev == {"train_acc": best.train_acc, "val_acc": best.val_acc,
                  "test_acc": best.test_acc}
    assert json.loads((tmp_path / "results.json").read_text()) == ev
    log = (tmp_path / "flickr.log").read_text()
    assert "Eval-only: train" in log and "Resumed from step 2" in log


@pytest.mark.parametrize("flag,item", [
    (dict(mesh_shape=4), "A13"), (dict(multihost=True), "A13"),
    (dict(coordinator="h:1"), "A13")])
def test_unported_flags_name_their_item(flag, item):
    with pytest.raises(NotImplementedError, match=f"Queue {item}"):
        check_supported(TrainConfig(**{**COMMON, **flag}))


@pytest.mark.parametrize("flag", [
    dict(device_inputs=True), dict(dataset="ogbn-proteins"),
    dict(remat=True)])
def test_a7_a9c_a11_flags_pass_the_check(flag):
    """--device_inputs (A11), ogbn-proteins (A7) and --remat (A9c) are
    ported: only the multi-GPU flags (A13) still raise."""
    check_supported(TrainConfig(**{**COMMON, **flag}))


def test_ported_flags_pass_the_check():
    for flag in (dict(checkpoint_every=5), dict(resume=True),
                 dict(evaluate="ckpt"), dict(cache_strategy="lru")):
        check_supported(TrainConfig(**{**COMMON, **flag}))


# ---------------------------------------------------------------------------
# GPU: the predict path on the card (skip without one)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["none", "direct", "static-outd", "fifo",
                                    "lru"])
def test_predict_on_gpu(cuda, policy):
    """predict_nodes on the card through each store: the subgraph's
    aggregation through csr_spmm (one launch per layer, no stream_spmm),
    MaxK's forward per layer, the logits within 1e-5 of max |logit| of the
    full-graph forward through the kernels, repeated requests equal."""
    from spgemm_gnn_tpu_torch.kernels import planned
    from spgemm_gnn_tpu_torch.models.models import build_model
    g = tsyn.powerlaw_graph(3000, 15000, seed=2).to(cuda)
    pg = planned.plan_graph(g, kind="stream")
    x = np.random.default_rng(1).standard_normal((3000, 24)).astype(
        np.float32)
    model = build_model("sage", in_dim=24, hidden_dim=64, num_layers=2,
                        out_dim=7, maxk=8, feat_drop=0.0, use_norm=True,
                        nonlinear="maxk", impl="auto", dtype=None)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(cuda).eval()
    with torch.no_grad():
        full = model(pg, torch.tensor(x, device=cuda))
    store = make_feature_store(x, policy=policy, cache_ratio=0.05,
                               out_degrees=g.out_degrees, device=cuda)
    seeds = np.array([5, 17, 2900, 17, 640])
    for _ in range(2):
        _build.launches.clear()
        got = predict_nodes(model, None, g, store, seeds, hops=2)
        torch.cuda.synchronize()
        assert dict(_build.launches) == {"maxk_fwd": 2, "csr_spmm": 2}
        want = full[np.unique(seeds)]
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err
