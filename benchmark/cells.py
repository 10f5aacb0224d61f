"""Finding what a cell names: the benchmark's files are found by the names
in `BENCHMARK.json`, so that a configuration, a traffic mix, a cell's
limits or a per-layer metric is added by adding files and entries.

- a configuration: the `file` of its entry (`configs/<name>.json`);
- a traffic mix: `traffic/<name>.json`;
- a cell's correctness limits: `limits/<cell>.json`;
- a per-layer metric: `metrics/<name>.py`, whose `read(ctx)` returns the
  value or None (`context.Context`);
- a model family: `models/<model>.py`, by the configuration's
  `model["model"]`: its weights, its plain forward and its counts
  (`models/sage.py` says what such a file provides).
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the family of a configuration whose model group names none: the port's
# default (`train/config.py::TrainConfig.model`)
DEFAULT_MODEL = "sage"
_MODEL_FILES: dict[Path, object] = {}


class NoModelFile(LookupError):
    """A configuration's model family has no file under `models/`."""


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    known = ", ".join(w["name"] for w in bench["workloads"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _read(root / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH) -> dict:
    return _read(bench_dir / "traffic" / f"{name}.json")


def limits(cell: str, bench_dir: Path = BENCH) -> dict:
    return _read(bench_dir / "limits" / f"{cell}.json")


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The `end_to_end` or `per_layer` entries that `cell` reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def _load(path: Path, prefix: str, name: str):
    spec = importlib.util.spec_from_file_location(
        prefix + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(name: str, bench_dir: Path = BENCH):
    """The `read` function of `metrics/<name>.py`."""
    return _load(bench_dir / "metrics" / f"{name}.py", "benchmark_metric_",
                 name).read


def model_file(config: dict, bench_dir: Path = BENCH):
    """The module `models/<model>.py` of the configuration's model family
    (its `model["model"]`, else DEFAULT_MODEL), loaded once a path; raises
    NoModelFile, naming the file, where there is none."""
    name = config["model"].get("model", DEFAULT_MODEL)
    path = bench_dir / "models" / f"{name}.py"
    if path not in _MODEL_FILES:
        if not path.is_file():
            raise NoModelFile(f"model {name!r}: no model file {path}")
        _MODEL_FILES[path] = _load(path, "benchmark_model_", name)
    return _MODEL_FILES[path]
