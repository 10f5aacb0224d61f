"""The port's benches (bench/harness.py, the two
CLIs `python -m spgemm_gnn_tpu_torch.bench` and `.bench.kernels`), batched
train steps (`--steps_per_call`) and the train CLI's `--timing`,
`--profile` and `--tensorboard`, on the CPU; the JAX package's Trainer and
generators where the port is held to them.

The GPU case (marker `gpu`: `--steps_per_call` through a captured CUDA
graph, bit-equal to unbatched steps) skips without a card. This file
imports JAX only inside the CPU tests that compare with it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_bench.py
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.bench import harness
from spgemm_gnn_tpu_torch.bench import kernels as bkernels
from spgemm_gnn_tpu_torch.train.__main__ import main as tmain
from spgemm_gnn_tpu_torch.train.config import (TrainConfig, check_supported,
                                               from_args)
from spgemm_gnn_tpu_torch.train.loop import Trainer, train_and_evaluate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(dataset="flickr", model="sage", epochs=4, hidden_dim=16,
            hidden_layers=2, maxk=4, dropout=0.5, w_lr=0.01, norm=True,
            synthetic=True, synthetic_scale=0.003, eval_every=1,
            log_every=0, seed=3, device="cpu")
CLI = ["--dataset", "flickr", "--synthetic", "--synthetic_scale", "0.003",
       "--hidden_dim", "16", "--hidden_layers", "2", "--maxk", "4",
       "--device", "cpu", "--log_every", "0"]
# the JAX package's batching test's config (tests/test_train.py:102-117)
SPC_ARGS = ["--dataset", "flickr", "--synthetic", "--synthetic_scale",
            "0.004", "--model", "sage", "--maxk", "4", "--hidden_dim", "32",
            "--hidden_layers", "2", "--dropout", "0.5", "--epochs", "10",
            "--eval_every", "3", "--log_every", "0"]


def history(res):
    return [(r.epoch, r.loss, r.train_acc, r.val_acc, r.test_acc)
            for r in res["history"]]


# ---------------------------------------------------------------------------
# harness primitives
# ---------------------------------------------------------------------------

def test_time_chained_chains_and_never_reuses_x0():
    seen = []

    def step(x):
        seen.append(x)
        return x + 1

    x0 = torch.zeros(3)
    t = harness.time_chained(step, x0, iters=5)
    assert t >= 0.0
    assert len(seen) == 1 + 1 + 5
    assert seen[0] is x0 and all(s is not x0 for s in seen[1:])
    assert [float(s[0]) for s in seen] == list(range(7))


def test_time_chained_caps_slow_steps_and_finds_state_tensors():
    import time as _time
    calls = []

    def step(state):
        calls.append(1)
        _time.sleep(0.02)
        return state

    state = {"model": torch.nn.Linear(2, 2), "step": 0}
    harness.time_chained(step, state, iters=50, max_seconds=0.1)
    assert len(calls) < 2 + 50
    with pytest.raises(ValueError, match="no tensor"):
        harness.time_chained(step, {"step": 0})


@pytest.mark.parametrize("generator,kw", [
    ("powerlaw", {}), ("sbm", {"communities": 8}), ("rmat", {})])
def test_cached_graph_bitwise_jax_and_cached(tmp_path, generator, kw):
    """The harness's cached graph is the JAX package's generator's graph
    for the same arguments and seed, from a fresh build and from the disk
    cache (its own directory)."""
    from spgemm_gnn_tpu.graphs import synthetic as jsyn
    jg = getattr(jsyn, f"{generator}_graph")(500, 3000, seed=4, **kw)
    for _ in range(2):     # built, then read back
        g = harness._cached_graph(generator, 500, 3000, 4,
                                  cache_dir=tmp_path, **kw)
        for f in ("indptr", "indices", "edge_dst", "in_degrees"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(jg, f)))
        assert g.symmetric
    assert len(list(tmp_path.glob("*.npz"))) == 1
    with pytest.raises(ValueError, match="unknown generator"):
        harness._cached_graph("er", 10, 10, 0, cache_dir=tmp_path)


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    """Bench inputs on the CPU: 600 nodes, dim 32, k 8."""
    old = harness.BENCH_CACHE
    harness.BENCH_CACHE = tmp_path_factory.mktemp("bench")
    try:
        yield harness._bench_inputs(600, 6000, 32, 8, 0, None, "cpu")
    finally:
        harness.BENCH_CACHE = old


def test_bench_inputs(micro):
    g, pg, xk, ct = micro
    assert pg.graph is g and xk.shape == ct.shape == (g.num_nodes, 32)
    assert int((xk != 0).sum(dim=1).max()) <= 8


@pytest.mark.parametrize("impl", ["torch", "ell", "cuda"])
def test_bench_impl(micro, impl):
    r = harness.bench_impl(*micro, 32, 8, "mean", impl, iters=2)
    assert set(r) == {"fwd_s", "bwd_s", "fwd_gedges", "bwd_gedges"}
    assert all(np.isfinite(v) and v > 0 for v in r.values())


@pytest.mark.parametrize("impl", ["torch", "ell", "cuda"])
def test_bench_steps_keep_sparsity_and_agree(micro, impl):
    """Every impl's forward step gives the same chained x (within 1e-5 of
    it), and keeps MaxK's zeros."""
    g, pg, xk, ct = micro
    graph = {"torch": g, "cuda": pg, "ell": harness.ell_graph(g)}[impl]
    fwd, bwd, c0 = harness._step_fns(graph, xk, ct, 32, 8, "mean", impl)
    x1 = fwd(xk)
    assert torch.equal(x1 != 0, xk != 0)
    ref, _, _ = harness._step_fns(g, xk, ct, 32, 8, "mean", "torch")
    torch.testing.assert_close(x1, ref(xk), rtol=0, atol=1e-5)
    c1 = bwd(c0)
    assert c1.shape == ct.shape and torch.isfinite(c1).all()


def test_validate_numerics_keys_and_pass(micro):
    jax_keys = {"backend", "num_edges", "dim", "k", "plan_kind",
                "fwd_f32_relerr_vs_oracle", "bwd_f32_relerr_vs_oracle",
                "fwd_bf16x2_relerr_vs_f32", "recorded", "pass"}
    val = harness.validate_numerics(*micro, 32, 8)
    assert jax_keys <= set(val)
    assert val["pass"] and val["backend"] == "cpu"
    assert val["fwd_f32_relerr_vs_oracle"] < 1e-5
    assert val["bwd_f32_relerr_vs_oracle"] < 1e-5
    assert 0 < val["fwd_bf16x2_relerr_vs_f32"] < 2e-2


def test_bench_aggregation_caps_the_baselines(monkeypatch, tmp_path,
                                              capsys):
    monkeypatch.setattr(harness, "BENCH_CACHE", tmp_path)
    monkeypatch.setattr(harness, "BASELINE_EDGE_CAP", 2000)
    r = harness.bench_aggregation(1200, 8000, 16, 4,
                                  impls=("torch", "ell", "cuda"), iters=2,
                                  device="cpu")
    assert r["num_edges"] > 2000 and r["plan_kind"] in ("windowed",
                                                         "stream")
    for impl in ("torch", "ell"):
        assert 0 < r[impl]["subsampled_edges"] <= 2000
    assert "subsampled_edges" not in r["cuda"]
    assert "baselines on a cut graph" in capsys.readouterr().err


def test_bench_training_step():
    r = harness.bench_training_step(None, TrainConfig(**TINY), iters=2)
    assert set(r) == {"step_s", "epochs_per_s", "edges_per_s"}
    assert r["step_s"] > 0 and r["epochs_per_s"] == 1.0 / r["step_s"]


def test_card_on_the_cpu():
    assert harness.card("cpu") == "cpu"


# ---------------------------------------------------------------------------
# batched steps (--steps_per_call)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spc", [2, 4, 11])
def test_steps_per_call_identical_history(tmp_path, spc):
    """The JAX package's contract (tests/test_train.py:102-117): epoch
    batching gives exactly the unbatched per-epoch history."""
    base = SPC_ARGS + ["--device", "cpu", "--path", str(tmp_path)]
    r1 = Trainer(from_args(base + ["--steps_per_call", "1"])).run()
    rn = Trainer(from_args(base + ["--steps_per_call", str(spc)])).run()
    assert history(r1) == history(rn)
    assert r1["best_val_accuracy"] == rn["best_val_accuracy"]
    assert [r.epoch for r in rn["history"]] == [0, 3, 6, 9]
    assert rn["graph_replays"] == 0 and rn["graph_launches"] == {}


def test_steps_per_call_groups_respect_checkpoints(tmp_path):
    """Groups end at checkpoint boundaries too: the checkpoints of a
    batched run are those of the unbatched run, step for step."""
    from spgemm_gnn_tpu_torch.train import checkpoint as tckpt
    runs = {}
    for spc in (1, 3):
        path = tmp_path / f"spc{spc}"
        cfg = TrainConfig(**{**TINY, "epochs": 7, "eval_every": 0,
                             "checkpoint_every": 2, "steps_per_call": spc,
                             "path": str(path)})
        res = Trainer(cfg).run()
        runs[spc] = (res, sorted(os.listdir(path / "checkpoints")))
    assert runs[1][1] == runs[3][1]
    assert tckpt.latest_step(str(tmp_path / "spc3")) == 7
    p1 = runs[1][0]["final_state"]["model"].state_dict()
    p3 = runs[3][0]["final_state"]["model"].state_dict()
    assert all(torch.equal(p1[n], p3[n]) for n in p1)


def test_steps_per_call_matches_jax_trainer_at_4():
    """The port at steps_per_call 4 against the JAX Trainer at 4 (lax.scan
    groups) from the same weights, dropout off: losses within 1e-4."""
    import jax
    from spgemm_gnn_tpu.graphs.datasets import load_dataset as jload
    from spgemm_gnn_tpu.train.config import TrainConfig as JConfig
    from spgemm_gnn_tpu.train.loop import Trainer as JTrainer
    from spgemm_gnn_tpu_torch.convert import params_from_flax
    from spgemm_gnn_tpu_torch.graphs.csr import from_edges
    from spgemm_gnn_tpu_torch.graphs.datasets import Dataset

    common = dict(dataset="flickr", model="sage", epochs=9, hidden_dim=32,
                  hidden_layers=2, maxk=8, dropout=0.0, w_lr=0.01,
                  nonlinear="maxk", norm=True, synthetic=True,
                  synthetic_scale=0.004, eval_every=4, log_every=0, seed=3,
                  steps_per_call=4)
    jd = jload("flickr", "/nonexistent", allow_synthetic=True,
               synthetic_scale=common["synthetic_scale"], seed=common["seed"])
    jt = JTrainer(JConfig(impl="xla", **common), dataset=jd)
    jres = jt.run()
    td = Dataset(name=jd.name,
                 graph=from_edges(np.asarray(jd.graph.indices),
                                  np.asarray(jd.graph.edge_dst),
                                  jd.graph.num_nodes),
                 features=jd.features, labels=jd.labels,
                 train_mask=jd.train_mask, val_mask=jd.val_mask,
                 test_mask=jd.test_mask, num_classes=jd.num_classes,
                 multilabel=jd.multilabel)
    tt = Trainer(TrainConfig(impl="auto", device="cpu", **common),
                 dataset=td)
    weights = params_from_flax(jax.device_get(jt.init_state()["params"]))
    tres = tt.run(state=tt.init_state(weights=weights))
    assert [r.epoch for r in tres["history"]] == \
        [r.epoch for r in jres["history"]] == [0, 4, 8]
    np.testing.assert_allclose([r.loss for r in tres["history"]],
                               [r.loss for r in jres["history"]], rtol=0,
                               atol=1e-4)


def test_train_and_evaluate():
    res = train_and_evaluate(TrainConfig(**{**TINY, "epochs": 2}))
    assert len(res["history"]) == 2 and res["best_epoch"] >= 0


# ---------------------------------------------------------------------------
# the train CLI's --timing, --profile, --tensorboard
# ---------------------------------------------------------------------------

def test_a12_flags_pass_the_check():
    for flag in (dict(steps_per_call=4), dict(timing=True),
                 dict(profile="trace"), dict(tensorboard=True)):
        check_supported(TrainConfig(**{**TINY, **flag}))


def test_as_markdown():
    text = TrainConfig(**TINY).as_markdown()
    lines = text.split("  \n")
    assert lines[0] == "|name|value|" and lines[1] == "|-|-|"
    assert "|steps_per_call|1|" in lines and "|device|cpu|" in lines


def test_cli_timing(tmp_path):
    """--timing: the run's phases from its spans, and the aggregation
    share of its steps measured inside them (on the CPU, host time)."""
    res = tmain(CLI + ["--epochs", "2", "--timing", "--path",
                       str(tmp_path)])
    stats = res["aggregation_stats"]
    assert set(stats) == {"step_s", "aggregation_s", "aggregation_pct"}
    assert stats["step_s"] > 0 and stats["aggregation_s"] > 0
    assert 0 < stats["aggregation_pct"] <= 100.0
    summary = json.loads((tmp_path / "results.json").read_text())
    assert summary["aggregation_stats"] == stats
    assert summary["timing"] == res["timing"]
    assert "Aggregation percentage" in (tmp_path / "flickr.log").read_text()


def test_cli_profile_leaves_the_run_unchanged(tmp_path):
    plain = tmain(CLI + ["--epochs", "3", "--path", str(tmp_path / "a")])
    prof = tmain(CLI + ["--epochs", "3", "--path", str(tmp_path / "b"),
                        "--profile", str(tmp_path / "trace")])
    assert history(plain) == history(prof)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    assert "profiler trace written" in (tmp_path / "b" /
                                        "flickr.log").read_text()


def test_cli_tensorboard_writes_events(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    res = tmain(CLI + ["--epochs", "2", "--tensorboard", "--path",
                       str(tmp_path)])
    assert len(res["history"]) == 2
    assert any(f.startswith("events.") for f in os.listdir(tmp_path / "tb"))


def test_cli_tensorboard_missing_is_logged(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    res = tmain(CLI + ["--epochs", "2", "--tensorboard", "--path",
                       str(tmp_path)])
    assert len(res["history"]) == 2
    assert not (tmp_path / "tb").exists()
    assert "tensorboard unavailable; skipping TB logging" in (
        tmp_path / "flickr.log").read_text()


# ---------------------------------------------------------------------------
# the bench CLIs on the CPU, and the imports
# ---------------------------------------------------------------------------

def test_bench_cli_prints_one_json_line():
    out = subprocess.run(
        [sys.executable, "-m", "spgemm_gnn_tpu_torch.bench", "--device",
         "cpu", "--scale", "micro", "--iters", "2", "--validate"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    # the JAX bench.py's keys, less its TPU rooflines
    for key in ("metric", "value", "unit", "vs_baseline", "stream",
                "msg_gbps", "vs_ell"):
        assert key in line
    assert line["metric"] == "maxk_spgemm_aggregation_micro_k32"
    assert line["unit"] == "Gedges/s" and line["value"] > 0
    assert line["validate_pass"] is True and line["device"] == "cpu"
    assert line["copy_gbps"] is None and line["gather_gbps"] is None


def test_bench_cli_rejects_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from spgemm_gnn_tpu_torch.bench.__main__ import main as bmain
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bmain(["--scale", "micro"])


def test_kernels_cli_validates(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(harness, "BENCH_CACHE", tmp_path)
    assert bkernels.main(["--device", "cpu", "--validate", "--k", "4", "8",
                          "--iters", "2", "--json", "--impls", "torch",
                          "ell", "cuda"]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["k"] for r in rows] == [4, 8]
    for r in rows:
        assert r["graph"] == "synth-tiny" and r["generator"] == "powerlaw"
        assert r["ell_err"] < 1e-5 and r["cuda_err"] < 1e-5
        assert r["cuda_rows_err"] < 1e-5
        for impl in ("torch", "ell", "cuda"):
            assert r[f"{impl}_gedges"] > 0


@pytest.mark.parametrize("op", ["maxk", "cbsr"])
def test_kernels_cli_ops(op, capsys):
    assert bkernels.main(["--device", "cpu", "--op", op, "--k", "4",
                          "--iters", "2", "--validate", "--json"]) == 0
    row = json.loads(capsys.readouterr().out.strip())
    assert row["op"] == op and row["err"] == 0.0 and row["cuda_ms"] > 0


def test_kernels_cli_sample_sectors(capsys):
    """--op sample: the plain gather's bits, and the sectors it touches:
    at least the bytes it needs, at most a whole row per channel."""
    bkernels.main(["--device", "cpu", "--op", "sample", "--k", "8", "32",
                   "--rows", "500", "--iters", "1", "--validate", "--json"])
    for line in capsys.readouterr().out.strip().splitlines():
        row = json.loads(line)
        n, k = row["n"], row["k"]
        assert n == 500 and row["err"] == row["bf16_err"] == 0.0
        for tag, elem in (("", 4), ("bf16_", 2)):
            sec = row[f"{tag}sector_bytes"] - n * k * (4 + elem)
            assert n * k * 32 >= sec >= max(n * k * elem, n * 32)
            assert row[f"{tag}bound_bytes"] == n * k * (2 * elem + 4)
        assert "bound_ms" not in row     # a card's floor, not the CPU's


def test_sector_bytes_counts_distinct_sectors():
    ch = torch.tensor([[0, 1, 7, 8], [0, 64, 128, 255]], dtype=torch.int32)
    assert bkernels._sector_bytes(ch, 4) == (2 + 4) * 32
    assert bkernels._sector_bytes(ch, 2) == (1 + 4) * 32


@pytest.mark.parametrize("generator", ["sbm", "rmat"])
def test_kernels_cli_generators(tmp_path, monkeypatch, capsys, generator):
    monkeypatch.setattr(harness, "BENCH_CACHE", tmp_path)
    bkernels.main(["--device", "cpu", "--k", "4", "--iters", "2", "--json",
                   "--generator", generator, "--stream", "bf16x2"])
    row = json.loads(capsys.readouterr().out.strip())
    assert row["generator"] == generator and row["cuda_gedges"] > 0


def test_kernels_cli_real_graph_needs_its_npz(tmp_path):
    with pytest.raises(FileNotFoundError, match="convert_to_npz"):
        bkernels.main(["--device", "cpu", "--graphs", "reddit",
                       "--data_path", str(tmp_path)])


def test_corpus_names():
    assert set(bkernels.CORPUS_SWEEP) <= set(bkernels.SYNTH_CORPUS)
    assert len(bkernels.CORPUS_SWEEP) == 8


def test_new_modules_import_no_jax():
    modules = ("bench", "bench.harness", "bench.kernels", "bench.__main__",
               "ops.ell", "utils.spans", "train.__main__",
               "graphs.synthetic")
    code = "".join(f"import spgemm_gnn_tpu_torch.{m}\n" for m in modules) + (
        "import sys\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'spgemm_gnn_tpu')]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# GPU: --steps_per_call through a captured CUDA graph (skips without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("over", [{}, {"dtype": "bfloat16"},
                                  {"stream": "bf16x2"},
                                  {"enable_lookahead": True}])
def test_steps_per_call_graph_bit_equal_on_gpu(cuda, tmp_path, over):
    cfg = TrainConfig(**{**TINY, "device": "cuda", "epochs": 9,
                         "eval_every": 4, "path": str(tmp_path), **over})
    r1 = Trainer(cfg).run()
    r4 = Trainer(cfg.replace(steps_per_call=4)).run()
    assert history(r1) == history(r4)
    assert r4["graph_replays"] == 8 and r4["graph_launches"]
    p1 = r1["final_state"]["model"].state_dict()
    p4 = r4["final_state"]["model"].state_dict()
    assert all(torch.equal(p1[n], p4[n]) for n in p1)
