"""Shared pieces of the benchmark's own tests: a configuration of the
Reddit cell's model at a size a CPU test holds, with its graph cached in
the test's temporary directory."""
import copy

import pytest

from benchmark import cells, graphgen


@pytest.fixture
def tiny_config(monkeypatch, tmp_path):
    bench = cells.load_benchmark()
    config = copy.deepcopy(cells.config(bench, "reddit-sage-maxk"))
    config["name"] = "tiny-sage-maxk"
    config["dataset"].update(num_nodes=1500, num_edges=30000,
                             num_features=24, num_classes=5)
    monkeypatch.setattr(graphgen, "CACHE", tmp_path / "graphs")
    return config
