"""The port's graphs and datasets against the JAX package: the same edge
lists and seeds give identical arrays. Also: the port imports nothing of
JAX (checked in a subprocess, since this test process has JAX loaded)."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from spgemm_gnn_tpu.graphs import csr as jcsr
from spgemm_gnn_tpu.graphs import datasets as jds
from spgemm_gnn_tpu.graphs import synthetic as jsyn
from spgemm_gnn_tpu_torch.graphs import csr as tcsr
from spgemm_gnn_tpu_torch.graphs import datasets as tds
from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("indptr", "indices", "edge_dst", "t_indptr", "t_indices",
          "t_edge_dst", "in_degrees", "out_degrees")


def assert_same_graph(jg, tg):
    assert (tg.num_nodes, tg.num_edges, tg.symmetric) == (
        jg.num_nodes, jg.num_edges, jg.symmetric)
    for f in FIELDS:
        t = getattr(tg, f)
        assert t.dtype == torch.int32, f
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jg, f)),
                                      err_msg=f)
    if tg.symmetric:
        assert tg.t_indices is tg.indices and tg.t_indptr is tg.indptr


def _edges(kind: str):
    rng = np.random.default_rng(11)
    src = rng.integers(0, 60, 300)
    dst = rng.integers(0, 60, 300)
    if kind == "symmetric":
        return np.concatenate([src, dst]), np.concatenate([dst, src])
    return src, dst


@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_from_edges_and_self_loops_match_jax(kind):
    src, dst = _edges(kind)
    jg, tg = jcsr.from_edges(src, dst, 60), tcsr.from_edges(src, dst, 60)
    assert tg.symmetric == (kind == "symmetric")
    assert_same_graph(jg, tg)
    assert_same_graph(jcsr.add_self_loops(jg), tcsr.add_self_loops(tg))
    # .to() keeps the transpose aliasing of a symmetric graph
    assert_same_graph(jg, tg.to("cpu"))


def test_to_undirected_matches_jax():
    src, dst = _edges("directed")
    assert_same_graph(jcsr.to_undirected(src, dst, 60),
                      tcsr.to_undirected(src, dst, 60))


@pytest.mark.parametrize("gen", ["powerlaw", "random", "random_directed"])
def test_generators_match_jax(gen):
    if gen == "powerlaw":
        pair = (jsyn.powerlaw_graph(300, 3000, seed=5),
                tsyn.powerlaw_graph(300, 3000, seed=5))
    else:
        sym = gen == "random"
        pair = (jsyn.random_graph(200, 1500, seed=6, symmetric=sym),
                tsyn.random_graph(200, 1500, seed=6, symmetric=sym))
    assert_same_graph(*pair)


@pytest.mark.parametrize("name,scale,self_loop", [
    ("flickr", 0.004, False), ("yelp", 0.0006, True)])
def test_synthetic_dataset_matches_jax(name, scale, self_loop):
    kw = dict(allow_synthetic=True, synthetic_scale=scale, seed=3,
              self_loop=self_loop)
    j = jds.load_dataset(name, "/nonexistent", **kw)
    t = tds.load_dataset(name, "/nonexistent", **kw)
    assert (t.name, t.num_classes, t.multilabel) == (
        j.name, j.num_classes, j.multilabel)
    for f in ("features", "labels", "train_mask", "val_mask", "test_mask"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert_same_graph(j.graph, t.graph)


def test_npz_missing_without_synthetic_raises():
    with pytest.raises(FileNotFoundError, match="convert_to_npz"):
        tds.load_dataset("flickr", "/nonexistent")


def test_port_imports_without_jax():
    """A meta-path finder refuses jax, flax, optax and the JAX package (not
    the port, whose name begins with the JAX package's); then the port and
    every one of its modules import."""
    script = textwrap.dedent("""
        import importlib, importlib.abc, pkgutil, sys
        BLOCKED = ("jax", "jaxlib", "flax", "optax", "spgemm_gnn_tpu")
        def blocked(name):
            return any(name == b or name.startswith(b + ".") for b in BLOCKED)
        for m in [m for m in sys.modules if blocked(m)]:
            del sys.modules[m]
        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if blocked(name):
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Refuse())
        import spgemm_gnn_tpu_torch, chip_smoke
        names = [m.name for m in pkgutil.walk_packages(
            spgemm_gnn_tpu_torch.__path__, "spgemm_gnn_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules if blocked(m))
        assert not leaked, leaked
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", script], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20   # every module was walked
