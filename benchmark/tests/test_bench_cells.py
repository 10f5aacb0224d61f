"""BENCHMARK.json against the contract, and the harness finding every file
of a cell by name, also one added as files only."""
import json
import re
import shutil

import pytest

from benchmark import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
    assert {m["name"] for m in bench["end_to_end"]} == {"epoch_s", "setup_s"}
    for m in bench["per_layer"]:
        setup = m["name"].startswith("setup_")
        assert m["moves"] == ("setup_s" if setup else "epoch_s"), m


@pytest.mark.parametrize("index", range(4))
def test_every_cell_finds_its_files(bench, index):
    w = bench["workloads"][index]
    config = cells.config(bench, w["config"])
    assert config["name"] == w["config"] and config["model"]["maxk"] == 32
    assert config["model"]["hidden_dim"] == 256
    assert set(cells.limits(w["name"])) == {"loss_gap", "grad_gap",
                                            "change_gap"}
    assert cells.traffic(w["traffic"])["dtype"] in ("float32", "bfloat16")
    for m in cells.metrics_of(bench, w["name"], "per_layer"):
        assert callable(cells.reader(m["name"]))


def test_published_widths(bench):
    want = {"reddit-sage-maxk": (232965, 114615892, 602, 41, 4, 0.01),
            "products-sage-maxk": (2449029, 123718280, 100, 47, 3, 0.003)}
    for name, (n, e, f, c, layers, lr) in want.items():
        cfg = cells.config(bench, name)
        ds, m = cfg["dataset"], cfg["model"]
        assert (ds["num_nodes"], ds["num_edges"], ds["num_features"],
                ds["num_classes"]) == (n, e, f, c)
        assert (m["hidden_layers"], m["w_lr"], m["dropout"], m["norm"]) == (
            layers, lr, 0.5, True)
        assert cfg["reduced"] == [] and cfg["assumed"]


PER_LAYER = ["launches_per_epoch", "agg_ms", "agg_roofline", "model_ms",
             "device_idle_pct", "peak_mem_gib", "mfu", "fwd_ms", "bwd_ms",
             "optim_ms", "eval_ms", "agg_span_ms", "host_syncs_per_epoch",
             "setup_kernels_s", "setup_graph_s", "setup_state_s",
             "setup_first_step_s", "record_passes_per_epoch"]


def test_added_cell_is_found_from_files_alone(bench, tmp_path):
    """A new configuration, traffic mix, limits and metric, and a
    configuration of another model family with self-loops, added as files
    and BENCHMARK.json entries, are found with no file of the harness
    edited."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    new = json.loads(json.dumps(bench))
    cfg = cells.config(bench, "reddit-sage-maxk")
    cfg["name"] = "reddit-sage-maxk-k16"
    cfg["model"]["maxk"] = 16
    (root / "benchmark/configs/reddit-sage-maxk-k16.json").write_text(
        json.dumps(cfg))
    gcn = cells.config(bench, "products-sage-maxk")
    gcn["name"] = "products-gcn-maxk"
    gcn["model"]["model"] = "gcn"
    gcn["graph"]["self_loops"] = True
    (root / "benchmark/configs/products-gcn-maxk.json").write_text(
        json.dumps(gcn))
    (root / "benchmark/traffic/train-f32-long.json").write_text(
        json.dumps(dict(cells.traffic("train-f32"), epochs_per_call=16)))
    for cell in ("reddit-sage-maxk-k16.train-f32-long",
                 "products-gcn-maxk.train-f32"):
        (root / f"benchmark/limits/{cell}.json").write_text(
            json.dumps(cells.limits("reddit-sage-maxk.train-f32")))
    (root / "benchmark/metrics/epochs_traced.py").write_text(
        "def read(ctx):\n    return ctx.traced_epochs or None\n")
    for name in ("reddit-sage-maxk-k16", "products-gcn-maxk"):
        new["configs"].append({"name": name, "source": "x",
                               "file": f"benchmark/configs/{name}.json",
                               "reduced": [], "why": "x"})
    new["workloads"].append({"name": "reddit-sage-maxk-k16.train-f32-long",
                             "config": "reddit-sage-maxk-k16",
                             "traffic": "train-f32-long", "chips": 1,
                             "why": "x"})
    new["workloads"].append({"name": "products-gcn-maxk.train-f32",
                             "config": "products-gcn-maxk",
                             "traffic": "train-f32", "chips": 1, "why": "x"})
    new["per_layer"].append({"name": "epochs_traced", "unit": "epochs",
                             "better": "higher", "source": "host_clock",
                             "layer": "x", "moves": "epoch_s",
                             "workloads": ["reddit-sage-maxk-k16.train-f32-"
                                           "long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    loaded = cells.load_benchmark(root)
    w = cells.workload(loaded, "reddit-sage-maxk-k16.train-f32-long")
    assert cells.config(loaded, w["config"], root)["model"]["maxk"] == 16
    bdir = root / "benchmark"
    assert cells.traffic(w["traffic"], bdir)["epochs_per_call"] == 16
    assert cells.limits(w["name"], bdir)["loss_gap"] > 0
    names = [m["name"] for m in cells.metrics_of(loaded, w["name"],
                                                 "per_layer")]
    # every cell reads every per-layer metric but those that list cells
    assert names == PER_LAYER + ["epochs_traced"]
    assert cells.reader("epochs_traced", bdir)(
        type("Ctx", (), {"traced_epochs": 8})()) == 8
    g = cells.workload(loaded, "products-gcn-maxk.train-f32")
    config = cells.config(loaded, g["config"], root)
    assert config["graph"]["self_loops"] is True
    assert cells.limits(g["name"], bdir)["loss_gap"] > 0
    assert [m["name"] for m in cells.metrics_of(loaded, g["name"],
                                                "per_layer")] == PER_LAYER
    model = cells.model_file(config, bdir)
    assert model.__file__ == str(bdir / "models" / "gcn.py")
    names = [s[0] for s in model.weight_shapes(config["model"], 100, 47)]
    assert names[2:7] == ["lin0.weight", "lin0.bias", "conv0.bias",
                          "norm0.weight", "norm0.bias"]


def test_a_model_without_a_file_is_named(tiny_config):
    config = dict(tiny_config, model=dict(tiny_config["model"], model="gat"))
    with pytest.raises(cells.NoModelFile, match="models/gat.py"):
        cells.model_file(config)
