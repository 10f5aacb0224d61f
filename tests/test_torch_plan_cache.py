"""The rest of A11 in the port: the plan disk cache (`graphs/plan_cache.py`,
`plan_graph(cache_dir=...)`, the Trainer's cache under `<data_path>/plans`),
the stand-in without its payload and `device_synthetic_inputs`
(`--device_inputs`), and the `windowed_classes` plan kind; each against
the JAX package where it has a counterpart."""
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu.graphs import plan_cache as jcache
from spgemm_gnn_tpu_torch.graphs import plan_cache as tcache
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph
from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
from spgemm_gnn_tpu_torch.kernels import planned
from spgemm_gnn_tpu_torch.kernels.planned import plan_graph, planned_aggregate

DIM = 32


def _graphs():
    rng = np.random.default_rng(1)
    src, dst = rng.integers(0, 300, 3000), rng.integers(0, 300, 3000)
    return {"symmetric": powerlaw_graph(300, 4000, seed=3),
            "directed": from_edges(src, dst, 300, symmetric=False)}


def plan_tensors(plan) -> dict:
    """Every tensor and number a plan holds beyond its CSR, by name."""
    out = {}
    if isinstance(plan, CSRPlan):
        for key, s in plan._schedules.items():
            for f in ("indices", "block_indptr", "seg", "fix", "pass_seg",
                      "pass_fix"):
                out[f"{key}.{f}"] = getattr(s, f)
            out[f"{key}.meta"] = (s.nb, s.block_rows, s.segment, s.n_slots)
        return out
    out.update(chunk_row0=plan.chunk_row0, carry_rows=plan.carry_rows,
               meta=(plan.chunk, plan.warp_chunks))
    for key, v in plan._hot.items():
        if key == "order":
            out["order_ids"], out["order_counts"] = v
        elif key == "positions":
            out["positions"] = v
        else:
            out[f"{key}.meta"] = (v.rows, v.row_bytes, v.budget,
                                  v.edge_share)
            out[f"{key}.mask"] = v.mask
    return out


def assert_plans_equal(a, b, what, same_csr: bool = True):
    """Every tensor of plan a equal to b's (dtype, device, values); with
    `same_csr` both on the same CSR tensors, else on equal ones."""
    ta, tb = plan_tensors(a), plan_tensors(b)
    assert ta.keys() == tb.keys(), what
    for k in ta:
        if isinstance(ta[k], torch.Tensor):
            assert ta[k].dtype == tb[k].dtype and ta[k].device == \
                tb[k].device, f"{what}: {k}"
            assert torch.equal(ta[k], tb[k]), f"{what}: {k}"
        else:
            assert ta[k] == tb[k], f"{what}: {k}"
    if same_csr:
        assert a.indptr is b.indptr and a.indices is b.indices, what
    else:
        assert torch.equal(a.indptr, b.indptr), what
        assert torch.equal(a.indices, b.indices), what


@pytest.mark.parametrize("which", ["symmetric", "directed"])
def test_fingerprint_equals_jax(which):
    g = _graphs()[which]
    for ip, ix in ((g.indptr, g.indices), (g.t_indptr, g.t_indices)):
        assert tcache.graph_fingerprint(ip, ix) == jcache.graph_fingerprint(
            jnp.asarray(ip.numpy()), jnp.asarray(ix.numpy()))
    assert tcache.graph_fingerprint(g.indptr, g.indices) != \
        tcache.graph_fingerprint(g.indptr, g.indices.flip(0))


def test_plan_key_drops_none_and_orders_params():
    a = tcache.plan_key("ab", "f", "stream", dim=4, chunk=None, elem=2)
    assert a == tcache.plan_key("ab", "f", "stream", elem=2, dim=4)
    assert a == f"ab_v{tcache.PLANNER_VERSION}_f_stream_dim4_elem2"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["windowed", "stream"])
@pytest.mark.parametrize("which", ["symmetric", "directed"])
def test_cached_plan_round_trips(which, kind, dtype, tmp_path):
    """A cold build stores each plan; a warm load gives every tensor of
    the built plan (on the CSR's own tensors), and the aggregation, forward
    and backward (the sampled backward's positions included, for bf16
    rows), on the loaded plan is bitwise the fresh plan's."""
    g = _graphs()[which]
    cold = plan_graph(g, kind=kind, dim=DIM, dtype=dtype,
                      cache_dir=str(tmp_path))
    files = sorted(os.listdir(tmp_path))
    assert len(files) == (1 if g.symmetric else 2)
    warm = plan_graph(g, kind=kind, dim=DIM, dtype=dtype,
                      cache_dir=str(tmp_path))
    fresh = plan_graph(g, kind=kind, dim=DIM, dtype=dtype)
    assert sorted(os.listdir(tmp_path)) == files
    for a, b, c, what in ((cold.fwd_plan, warm.fwd_plan, fresh.fwd_plan,
                           "fwd"),
                          (cold.bwd_plan, warm.bwd_plan, fresh.bwd_plan,
                           "bwd")):
        assert_plans_equal(b, c, f"warm {what}")
        assert_plans_equal(a, c, f"cold {what}")
    if kind == "stream" and dtype == torch.bfloat16:
        assert "positions" in warm.bwd_plan._hot
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((g.num_nodes, DIM), generator=gen).to(dtype)
    ct = torch.randn((g.num_nodes, DIM), generator=gen).to(dtype)
    outs = []
    for pg in (warm, fresh):
        xt = x.clone().requires_grad_(True)
        y = planned_aggregate(pg, xt, "gcn")
        y.backward(ct)
        outs.append((y.detach(), xt.grad))
    for u, v in zip(*outs):
        assert torch.equal(u, v)


def test_windowed_schedules_of_several_blocks_round_trip(tmp_path):
    """A windowed plan holding schedules of 1 and 3 source blocks saves and
    loads each, the re-bucketed sources included; `csr_spmm` on the loaded
    schedule is bitwise the built one's."""
    g = _graphs()["directed"]
    plan = CSRPlan(g.indptr, g.indices)
    plan.schedule(g.num_nodes, DIM)
    forced = CSRPlan(g.indptr, g.indices, src_blocks=3)
    forced.schedule(g.num_nodes, DIM)
    for p, name in ((plan, "one"), (forced, "three")):
        path = str(tmp_path / f"{name}.npz")
        tcache.save_plan(path, p)
        loaded = tcache.load_plan(path, g.indptr, g.indices)
        assert_plans_equal(loaded, p, name)
        assert loaded.src_blocks == p.src_blocks
        x = torch.randn(g.num_nodes, DIM)
        from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm
        assert torch.equal(csr_spmm(loaded, x), csr_spmm(p, x))
    (nb, _), = forced._schedules
    assert nb == 3


def test_corrupt_or_partial_file_rebuilds(tmp_path):
    """A file that does not load is deleted and the plan rebuilt and
    stored anew (the reference's rule)."""
    g = _graphs()["symmetric"]
    plan_graph(g, kind="stream", dim=DIM, cache_dir=str(tmp_path))
    path, = (tmp_path / f for f in os.listdir(tmp_path))
    good = path.read_bytes()
    for bad in (b"not an npz", good[: len(good) // 2]):
        path.write_bytes(bad)
        pg = plan_graph(g, kind="stream", dim=DIM, cache_dir=str(tmp_path))
        assert_plans_equal(pg.fwd_plan,
                           plan_graph(g, kind="stream", dim=DIM).fwd_plan,
                           "rebuilt")
        assert path.read_bytes() != bad
        tcache.load_plan(str(path), g.indptr, g.indices)


def test_key_holds_every_plan_parameter(tmp_path):
    """Another dim, channel size, chunk or kind is another file; the same
    parameters are the same file."""
    g = _graphs()["symmetric"]
    runs = [dict(kind="stream", dim=DIM), dict(kind="stream", dim=DIM),
            dict(kind="stream", dim=2 * DIM),
            dict(kind="stream", dim=DIM, dtype=torch.bfloat16),
            dict(kind="stream", dim=DIM, chunk=64),
            dict(kind="windowed", dim=DIM), dict(kind="windowed")]
    seen = []
    for kw in runs:
        plan_graph(g, cache_dir=str(tmp_path), **kw)
        seen.append(len(os.listdir(tmp_path)))
    assert seen == [1, 1, 2, 3, 4, 5, 6]


def _write_npz(data_path, n: int = 300):
    """A tiny dataset in the npz interchange format (flickr's name)."""
    g = powerlaw_graph(n, 3000, seed=9)
    rng = np.random.default_rng(9)
    split = rng.permutation(n)
    masks = [np.isin(np.arange(n), split[a:b])
             for a, b in ((0, 180), (180, 240), (240, n))]
    np.savez(os.path.join(data_path, "flickr.npz"),
             edge_src=g.indices.numpy().astype(np.int64),
             edge_dst=g.edge_dst.numpy().astype(np.int64),
             feat=rng.standard_normal((n, 10)).astype(np.float32),
             label=rng.integers(0, 4, n), train_mask=masks[0],
             val_mask=masks[1], test_mask=masks[2], num_classes=4)


def test_trainer_caches_real_datasets_only(tmp_path):
    """The Trainer plans a real (npz) dataset through <data_path>/plans
    and a second Trainer loads them (the same losses); a synthetic run
    writes no cache."""
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    _write_npz(str(tmp_path))
    cfg = TrainConfig(dataset="flickr", data_path=str(tmp_path),
                      hidden_dim=16, hidden_layers=1, maxk=4, epochs=2,
                      device="cpu", log_every=0)
    first = Trainer(cfg)
    plans = tmp_path / "plans"
    files = sorted(os.listdir(plans))
    assert files and all(f.startswith("plan_") for f in files)
    stamps = [os.stat(plans / f).st_mtime_ns for f in files]
    second = Trainer(cfg)
    assert sorted(os.listdir(plans)) == files
    assert [os.stat(plans / f).st_mtime_ns for f in files] == stamps
    assert_plans_equal(second.g.fwd_plan, first.g.fwd_plan, "trainer",
                       same_csr=False)
    assert [r.loss for r in first.run()["history"]] == \
        [r.loss for r in second.run()["history"]]
    syn = tmp_path / "syn"
    syn.mkdir()
    Trainer(cfg.replace(data_path=str(syn), synthetic=True,
                        synthetic_scale=0.003))
    assert not (syn / "plans").exists()


def test_windowed_classes_plans_as_windowed():
    g = _graphs()["directed"]
    pg = plan_graph(g, kind="windowed_classes", dim=DIM)
    want = plan_graph(g, kind="windowed", dim=DIM)
    assert pg.kind == "windowed" and "windowed_classes" in planned.KINDS
    assert_plans_equal(pg.fwd_plan, want.fwd_plan, "fwd")
    with pytest.raises(ValueError, match="unknown plan kind"):
        plan_graph(g, kind="classes")


# ---- the stand-in without its payload, and device inputs ------------------

@pytest.mark.parametrize("name", ["flickr", "ogbn-proteins"])
def test_payload_free_stand_in_equals_jax(name):
    from spgemm_gnn_tpu.graphs.datasets import load_dataset as jload
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    kw = dict(allow_synthetic=True, synthetic_scale=0.003, seed=5,
              synthetic_payload=False)
    t, j = load_dataset(name, "/nonexistent", **kw), jload(
        name, "/nonexistent", **kw)
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert not t.features.any()
    np.testing.assert_array_equal(t.graph.indices.numpy(),
                                  np.asarray(j.graph.indices))


@pytest.mark.parametrize("name,scale", [("ogbn-proteins", 0.01),
                                        ("yelp", 0.003), ("flickr", 0.03)])
def test_device_inputs_against_jax(name, scale):
    """Shapes and dtypes as the JAX package's (single-label classes int64,
    torch's class-index type, where JAX draws int32); each class's
    positive fraction within 0.02 of JAX's, the single-label class
    histogram within 10 %, and the planted signal there (the class
    centroids separate)."""
    from spgemm_gnn_tpu.graphs.datasets import (
        device_synthetic_inputs as jinputs)
    from spgemm_gnn_tpu_torch.graphs.datasets import (
        MULTILABEL, SYNTH_SPECS, device_synthetic_inputs)
    feat, labels = device_synthetic_inputs(name, scale, 7, "cpu")
    jfeat, jlabels = (np.asarray(a) for a in jinputs(name, scale, 7))
    assert tuple(feat.shape) == jfeat.shape and feat.dtype == torch.float32
    assert tuple(labels.shape) == jlabels.shape
    assert jfeat.dtype == np.float32
    if name in MULTILABEL:
        assert labels.dtype == torch.float32 and jlabels.dtype == np.float32
        frac, jfrac = labels.mean(0).numpy(), jlabels.mean(0)
        assert np.abs(frac - jfrac).max() <= 0.02
        assert set(np.unique(labels.numpy())) <= {0.0, 1.0}
    else:
        assert labels.dtype == torch.int64 and jlabels.dtype == np.int32
        c = SYNTH_SPECS[name]["c"]
        hist = np.bincount(labels.numpy(), minlength=c)
        jhist = np.bincount(jlabels, minlength=c)
        assert np.all(np.abs(hist - jhist) <= 0.1 * jhist)
        f = feat.numpy()[:, :16]
        means = np.stack([f[labels.numpy() == k].mean(0) for k in range(c)])
        assert np.linalg.norm(means - means.mean(0), axis=1).min() > 1.0


def test_trainer_device_inputs(caplog):
    """--device_inputs: features and labels drawn on the device, the host
    stand-in without its payload; a run trains. Without --synthetic the
    flag is ignored with a warning."""
    from spgemm_gnn_tpu_torch.graphs.datasets import device_synthetic_inputs
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    cfg = TrainConfig(dataset="ogbn-proteins", synthetic=True,
                      synthetic_scale=0.002, hidden_dim=16, hidden_layers=1,
                      maxk=4, epochs=3, device="cpu", log_every=0,
                      device_inputs=True)
    tr = Trainer(cfg)
    assert not tr.dataset.features.any() and not tr.dataset.labels.any()
    feat, labels = device_synthetic_inputs("ogbn-proteins", 0.002, cfg.seed,
                                           "cpu")
    assert torch.equal(tr.features, feat) and torch.equal(tr.labels, labels)
    losses = [r.loss for r in tr.run()["history"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    with caplog.at_level(logging.WARNING):
        Trainer(cfg.replace(synthetic=False, data_path="/nonexistent"),
                dataset=tr.dataset, logger=logging.getLogger("device_in"))
    assert "--device_inputs ignored" in caplog.text

