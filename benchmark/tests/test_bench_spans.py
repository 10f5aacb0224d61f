"""The readers of the program's spans and counters (`program_spans.py`) on
a made-up record: each reads its span or counter over the traced epochs,
and gives None where the span did not occur, where the run was not
traced, and where the program has no spans module (an older program)."""
import collections
import sys

import pytest

from benchmark import cells
from benchmark.context import Context
from spgemm_gnn_tpu_torch.utils import spans

PER_EPOCH = {"fwd_ms": ("step.forward",), "bwd_ms": ("step.backward",),
             "optim_ms": ("step.optimizer",), "eval_ms": ("eval",),
             "agg_span_ms": ("aggregate", "aggregate.backward")}
SETUP = {"setup_kernels_s": "setup.kernels", "setup_graph_s": "setup.graph",
         "setup_state_s": "setup.state",
         "setup_first_step_s": "setup.first_step"}


def _ctx(traced=True):
    return Context(config={}, traffic={}, num_edges=0, epoch_s=0.1,
                   peak_window_bytes=0, trace=object() if traced else None,
                   traced_epochs=8 if traced else 0,
                   launches=collections.Counter(), own_kernels=set())


@pytest.fixture
def record(monkeypatch):
    """Every phase twice (device ms 4 and 12, so 16 over 8 epochs), the
    aggregation once each way inside, the set-up nested: the first step
    holds the kernels' build, which its self time leaves out, and a
    phase, which it keeps."""
    mk = spans.Span
    rec = []
    for i, name in enumerate(("step.forward", "step.backward",
                              "step.optimizer", "eval")):
        rec += [mk(name, 10 * i, None, 0, 0, 0.0, 1.0, device_ms=4.0),
                mk(name, 10 * i + 1, None, 1, 0, 2.0, 3.0, device_ms=12.0)]
    rec += [mk("aggregate", 100, 0, 0, 0, 0.1, 0.2, device_ms=2.0),
            mk("aggregate.backward", 101, 10, 0, 0, 0.1, 0.2,
               device_ms=6.0),
            mk("setup.graph", 200, None, None, 0, 0.0, 2.0),
            mk("setup.state", 201, None, None, 0, 2.0, 5.0),
            mk("setup.first_step", 202, None, None, 0, 5.0, 9.0),
            mk("setup.kernels", 203, 202, None, 0, 5.5, 6.0),
            # a phase inside the first step, as under --timing: not set-up
            mk("step.forward", 300, 202, 0, 0, 6.0, 8.0)]
    monkeypatch.setattr(spans, "record", lambda: rec)
    monkeypatch.setattr(spans, "counters",
                        collections.Counter(host_syncs=3))
    return rec


@pytest.mark.parametrize("name", sorted(PER_EPOCH))
def test_device_ms_per_epoch(record, name):
    want = {"agg_span_ms": 1.0}.get(name, 2.0)
    assert cells.reader(name)(_ctx()) == pytest.approx(want)
    assert cells.reader(name)(_ctx(traced=False)) is None


@pytest.mark.parametrize("name", sorted(PER_EPOCH))
def test_device_ms_none_without_its_spans(record, monkeypatch, name):
    kept = [s for s in record if s.name not in PER_EPOCH[name]]
    monkeypatch.setattr(spans, "record", lambda: kept)
    assert cells.reader(name)(_ctx()) is None


def test_host_syncs_per_epoch(record):
    read = cells.reader("host_syncs_per_epoch")
    assert read(_ctx()) == pytest.approx(3 / 8)
    assert read(_ctx(traced=False)) is None


@pytest.mark.parametrize("name,want", [
    ("setup_graph_s", 2.0), ("setup_state_s", 3.0),
    ("setup_first_step_s", 3.5), ("setup_kernels_s", 0.5)])
def test_setup_self_seconds(record, name, want):
    assert cells.reader(name)(_ctx()) == pytest.approx(want)
    # read in the traced run, but set-up happened before its trace
    assert cells.reader(name)(_ctx(traced=False)) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(SETUP))
def test_setup_none_without_its_span(record, monkeypatch, name):
    kept = [s for s in record if s.name != SETUP[name]]
    monkeypatch.setattr(spans, "record", lambda: kept)
    assert cells.reader(name)(_ctx()) is None


@pytest.mark.parametrize("name", sorted([*PER_EPOCH, *SETUP,
                                         "host_syncs_per_epoch"]))
def test_none_from_a_program_without_spans(record, monkeypatch, name):
    monkeypatch.setitem(sys.modules, "spgemm_gnn_tpu_torch.utils.spans",
                        None)
    monkeypatch.delattr(sys.modules["spgemm_gnn_tpu_torch.utils"], "spans")
    assert cells.reader(name)(_ctx()) is None
