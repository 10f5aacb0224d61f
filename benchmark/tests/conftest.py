"""Shared pieces of the benchmark's own tests: a configuration of the
Reddit cell's model at a size a CPU test holds, with its graph cached in
the test's temporary directory, and its GCN sibling."""
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


@pytest.fixture
def tiny_gcn_config(tiny_config):
    """The tiny configuration with the port's `gcn` family, on the graph
    with self-loops, as the recipes run GCN."""
    config = copy.deepcopy(tiny_config)
    config["name"] = "tiny-gcn-maxk"
    config["model"]["model"] = "gcn"
    config["graph"]["self_loops"] = True
    return config
