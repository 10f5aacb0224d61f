"""A whole run of a cell, on the CPU at a tiny size: the look for a card is
skipped (device "cpu") and everything else runs, the traced window and the
comparison included. Sound, it is correct; with each fault the cell can
have planted under the timed path, it is not."""
import math
import sys

import pytest

from benchmark import cells, faults, graphgen, run

PER_LAYER = [{"name": "launches_per_epoch", "unit": "launches/epoch"},
             {"name": "peak_mem_gib", "unit": "GiB"}]


def _run(config, cell, traffic, fault=None, trace=False, monkeypatch=None):
    if fault is not None:
        prepare = run.prepare

        def planted(*args, **kwargs):
            trainer, state, host = prepare(*args, **kwargs)
            faults.FAULTS[fault](trainer, state)
            return trainer, state, host

        monkeypatch.setattr(run, "prepare", planted)
    return run.run_cell(config, cells.traffic(traffic),
                        cells.limits(cell), 2**31 + 9, 0.5, trace,
                        device="cpu", per_layer=PER_LAYER)


@pytest.mark.parametrize("cell,traffic", [
    ("reddit-sage-maxk.train-f32", "train-f32"),
    ("products-sage-maxk.train-f32", "train-f32")])
def test_sound_run_is_correct(tiny_config, cell, traffic):
    """(The bf16 cells' limits are set at their full size, where a loss is
    a mean over 10^5 rows; at the tiny size here the sound bf16 run's
    loss gap reads 3e-3 to 5e-3, at or above them.)"""
    res = _run(tiny_config, cell, traffic, trace=True)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["failed"] == 0
    assert res["attempted"] >= 16
    assert set(res["metrics"]) == {"launches_per_epoch"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_sound_gcn_run_is_correct(tiny_gcn_config):
    """A configuration of the `gcn` family, with self-loops, runs through
    the harness from its model file alone (no GCN cell has limits yet:
    the f32 products cell's are used)."""
    res = _run(tiny_gcn_config, "products-sage-maxk.train-f32", "train-f32")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 16
    assert res["checks"]["loss_gap"]["value"] < 1e-6


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell,traffic", [
    ("reddit-sage-maxk.train-f32", "train-f32"),
    ("products-sage-maxk.train-bf16", "train-bf16")])
def test_planted_fault_is_not_correct(tiny_config, monkeypatch, fault, cell,
                                      traffic):
    res = _run(tiny_config, cell, traffic, fault=fault,
               monkeypatch=monkeypatch)
    assert not res["correct"], res["checks"]
    if fault == "frozen":
        assert math.isclose(res["checks"]["change_gap"]["value"], 1.0)


def test_a_run_without_a_card_prints_nothing(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", "reddit-sage-maxk.train-f32", "--seed",
                   "1", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_a_model_without_a_file_fails_before_the_graph(tiny_config,
                                                       monkeypatch, capsys):
    """A configuration whose model family has no file under `models/`
    exits 1 at once, naming the file, before the graph loads or a card is
    looked for."""
    config = dict(tiny_config, model=dict(tiny_config["model"], model="gat"))
    monkeypatch.setattr(cells, "config", lambda bench, name: config)

    def loaded(*args, **kwargs):
        raise AssertionError("the graph loaded")

    monkeypatch.setattr(graphgen, "load_graph", loaded)
    rc = run.main(["--workload", "reddit-sage-maxk.train-f32", "--seed",
                   "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 1 and out.out == "" and "models/gat.py" in out.err


def test_jax_loaded_after_the_window_prints_nothing(tiny_config, monkeypatch,
                                                    tmp_path, capsys):
    """A per-layer reader that imports `jax` (a stand-in package here) runs
    after the traced window; the run exits 3 and prints no result."""
    fake = tmp_path / "fake"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "loads_jax.py").write_text(
        "def read(ctx):\n    import jax  # noqa: F401\n    return 1.0\n")
    monkeypatch.syspath_prepend(str(fake))
    for name in [m for m in sys.modules if m.split(".")[0] == "jax"]:
        monkeypatch.delitem(sys.modules, name)
    reader = cells.reader
    monkeypatch.setattr(cells, "reader",
                        lambda name: reader(name, bench_dir=tmp_path))
    run_cell = run.run_cell

    def on_cpu(config, traffic, limits, seed, seconds, trace, **kwargs):
        return run_cell(tiny_config, traffic, limits, seed, 0.5, trace,
                        device="cpu",
                        per_layer=[{"name": "loads_jax", "unit": "1"}])

    monkeypatch.setattr(run, "run_cell", on_cpu)
    try:
        rc = run.main(["--workload", "reddit-sage-maxk.train-f32", "--seed",
                       "1", "--seconds", "1", "--trace", "1"])
    finally:
        for name in [m for m in sys.modules if m.split(".")[0] == "jax"]:
            del sys.modules[name]
    assert rc == 3 and capsys.readouterr().out == ""
