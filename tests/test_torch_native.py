"""The port's binding of the native graph core (`graphs/native.py`, built
here with g++ into build/native/) against its numpy paths and the JAX
package's builds: the CSR and its transpose, and label propagation, bit
for bit."""
import logging

import numpy as np
import pytest

from spgemm_gnn_tpu.graphs.csr import from_edges as jfrom_edges
from spgemm_gnn_tpu.graphs.relabel import _labelprop_labels as jlabelprop
from spgemm_gnn_tpu_torch.graphs import csr as tcsr
from spgemm_gnn_tpu_torch.graphs import native
from spgemm_gnn_tpu_torch.graphs.relabel import _labelprop_labels
from spgemm_gnn_tpu_torch.graphs.synthetic import (powerlaw_graph,
                                                   sbm_graph)

FIELDS = ("indptr", "indices", "edge_dst", "t_indptr", "t_indices",
          "t_edge_dst", "in_degrees", "out_degrees")


def _edges(kind: str, seed: int = 0):
    """Edge lists: random with repeats and self-loops, with rows and
    columns left empty, and one already in CSR order."""
    rng = np.random.default_rng(seed)
    n = 300
    if kind == "sorted":
        g = powerlaw_graph(n, 2000, seed=seed)
        return g.indices.numpy(), g.edge_dst.numpy(), n
    src = rng.integers(0, n - 20, 4000)
    dst = rng.integers(10, n, 4000)
    return src, dst, n


def _assert_graph_equal(a, b, what):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)),
                                      err_msg=f"{what}: {f}")
    assert a.symmetric == b.symmetric and a.num_edges == b.num_edges


def test_library_builds_here():
    """g++ builds the source into build/native/ under a name keyed on the
    source's hash; the checked-in library is not the one loaded."""
    assert native.available()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libgraphcore_")
    assert path != native.SOURCE.parent / "libgraphcore.so"


@pytest.mark.parametrize("kind", ["random", "sorted"])
@pytest.mark.parametrize("symmetric", [None, False])
def test_native_csr_bitwise(kind, symmetric):
    """from_edges through the native sort: bitwise its numpy build and the
    JAX package's from_edges, the transpose arrays included."""
    src, dst, n = _edges(kind)
    got = tcsr.from_edges(src, dst, n, symmetric=symmetric)
    plain = tcsr.from_edges(src, dst, n, symmetric=symmetric,
                            use_native=False)
    _assert_graph_equal(got, plain, "numpy")
    _assert_graph_equal(got, jfrom_edges(src, dst, n, symmetric=symmetric),
                        "jax")


def test_build_csr_is_the_sorted_csr():
    src, dst, n = _edges("random", 3)
    indptr, indices, edge_dst = native.build_csr(src, dst, n)
    order = np.lexsort((src, dst))
    np.testing.assert_array_equal(indices, src[order])
    np.testing.assert_array_equal(edge_dst, dst[order])
    np.testing.assert_array_equal(indptr, np.r_[0, np.cumsum(
        np.bincount(dst, minlength=n))])
    assert indptr.dtype == indices.dtype == edge_dst.dtype == np.int32


def test_add_self_loops_native_bitwise():
    g = tcsr.to_undirected(*_edges("random", 4))
    src, dst = g.indices.numpy(), g.edge_dst.numpy()
    keep = src != dst
    loops = np.arange(g.num_nodes)
    want = tcsr.from_edges(np.r_[src[keep], loops], np.r_[dst[keep], loops],
                           g.num_nodes, symmetric=True, use_native=False)
    _assert_graph_equal(tcsr.add_self_loops(g), want, "self-loops")


@pytest.mark.parametrize("maker", ["sbm", "powerlaw"])
def test_labelprop_native_bitwise(maker):
    """gc_labelprop gives the numpy sweeps' labels and the JAX package's."""
    g = (sbm_graph(600, 6000, communities=8, seed=5) if maker == "sbm"
         else powerlaw_graph(500, 5000, seed=6))
    ip, ix = g.indptr.numpy(), g.indices.numpy()
    got = native.labelprop(ip, ix, g.num_nodes)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, _labelprop_labels(ip, ix, g.num_nodes, use_native=False))
    np.testing.assert_array_equal(
        got, jlabelprop(ip, ix, g.num_nodes, use_native=False))


def test_numpy_path_without_the_library(monkeypatch, caplog):
    """With no compiler the entry points return None, the builds take
    their numpy paths (the same arrays), and the reason is logged at INFO
    level."""
    src, dst, n = _edges("random", 7)
    want = tcsr.from_edges(src, dst, n, symmetric=False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "library_path",
                        lambda: native.BUILD_DIR / "libgraphcore_absent.so")
    # a Trainer made earlier in this process (utils/logging.py::get_logger)
    # stops the package's records at its logger; caplog reads the root's
    monkeypatch.setattr(logging.getLogger("spgemm_gnn_tpu_torch"),
                        "propagate", True)
    with caplog.at_level(logging.INFO, logger=native.__name__):
        assert not native.available()
    assert "no g++" in caplog.text
    assert native.build_csr(src, dst, n) is None
    assert native.labelprop(want.indptr.numpy(), want.indices.numpy(),
                            n) is None
    _assert_graph_equal(tcsr.from_edges(src, dst, n, symmetric=False), want,
                        "without the library")


def test_sort_route(monkeypatch):
    """Edges in CSR order are not sorted, a few sorted runs go to numpy's
    merge, shuffled edges to the native sort: the same arrays each way."""
    calls = []
    build = native.build_csr
    monkeypatch.setattr(native, "build_csr",
                        lambda *a: calls.append(1) or build(*a))
    g = powerlaw_graph(300, 3000, seed=8)
    src, dst = g.indices.numpy(), g.edge_dst.numpy()
    perm = np.random.default_rng(8).permutation(src.shape[0])
    half = src.shape[0] // 2
    runs = np.r_[half:src.shape[0], 0:half]      # two sorted runs
    for order, native_calls in ((np.arange(src.shape[0]), 0), (runs, 0),
                                (perm, 1)):
        calls.clear()
        got = tcsr.from_edges(src[order], dst[order], g.num_nodes)
        assert len(calls) == native_calls
        _assert_graph_equal(got, g, f"{native_calls} native sorts")


def test_new_modules_import_no_jax():
    """This slice's modules (and chip_smoke.py) pull in neither JAX nor
    the JAX package."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    modules = ("graphs.native", "graphs.relabel", "graphs.plan_cache",
               "models.remat", "train.metrics", "train.loop")
    code = "".join(f"import spgemm_gnn_tpu_torch.{m}\n" for m in modules) + (
        "import chip_smoke\nimport sys\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'spgemm_gnn_tpu')]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
