"""The program's spans and counters (utils/spans.py) on the CPU: nothing
recorded outside the profiler, the phases and the aggregation nested in the
profiler's trace and in memory, the set-up spans always, `host_syncs`, no
event while a CUDA graph captures, and the CLI's --timing built on them.

The GPU cases (marker `gpu`) skip without a card: the phases' device time
between the device's busy time and the window, `aggregate.backward` under
`step.backward` across autograd's thread, and `host_syncs` against the
profiler's synchronising calls:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_spans.py
"""
import collections
import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from spgemm_gnn_tpu_torch.train.__main__ import main as tmain
from spgemm_gnn_tpu_torch.train.config import TrainConfig
from spgemm_gnn_tpu_torch.train.loop import Trainer
from spgemm_gnn_tpu_torch.utils import spans

TINY = dict(dataset="flickr", model="sage", epochs=8, hidden_dim=16,
            hidden_layers=2, maxk=4, dropout=0.5, w_lr=0.01, norm=True,
            synthetic=True, synthetic_scale=0.003, eval_every=1,
            log_every=0, seed=3, device="cpu")
CLI = ["--dataset", "flickr", "--synthetic", "--synthetic_scale", "0.003",
       "--hidden_dim", "16", "--hidden_layers", "2", "--maxk", "4",
       "--device", "cpu", "--log_every", "0"]
PHASES = ("step.forward", "step.backward", "step.optimizer", "eval")


@pytest.fixture(autouse=True)
def clean_record():
    spans.reset()
    yield
    spans.reset()


def warm_trainer(**over) -> tuple[Trainer, dict]:
    """A Trainer of TINY and its state after one run of 2 epochs (its
    set-up spans done), the record cleared."""
    tr = Trainer(TrainConfig(**{**TINY, **over}))
    state = tr.init_state()
    tr.run(epochs=2, state=state)
    spans.reset()
    return tr, state


def by_id(record):
    return {s.id: s for s in record}


def parent_name(s, ids):
    p = ids.get(s.parent)
    return None if p is None else p.name


# ---------------------------------------------------------------------------
# off, on, and the record
# ---------------------------------------------------------------------------

def test_off_outside_the_profiler(monkeypatch):
    tr, state = warm_trainer()
    entered = []
    real = torch.autograd.profiler.record_function

    def spy(name, *args, **kwargs):
        entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    gen = torch.Generator().manual_seed(0)
    tr.train_step(state, gen)
    tr.eval_step(state)
    assert spans.record() == [] and not spans.counters
    # torch.optim annotates its own steps; the program's spans none
    assert not set(entered) & {*PHASES, "aggregate", "aggregate.backward"}
    # the null context is one shared object
    assert spans.span("a") is spans.span("b", 3)


def test_recording_block_and_reset():
    assert not spans.recording_now()
    with spans.recording():
        assert spans.recording_now()
        with spans.span("outer", 7) as outer:
            with spans.span("inner") as inner:
                spans.count("things")
                spans.count("things")
    assert not spans.recording_now()
    rec = spans.record()
    assert [s.name for s in rec] == ["inner", "outer"]
    assert inner.parent == outer.id and inner.step == 7
    assert spans.counters["things"] == 2
    spans.reset()
    assert spans.record() == [] and not spans.counters


def test_self_time_and_sums():
    mk = spans.Span
    rec = [mk("child", 1, 0, None, 0, 1.0, 2.0),
           mk("child", 2, 0, None, 0, 1.5, 3.0),
           mk("outer", 0, None, None, 0, 0.0, 4.0, device_ms=5.0),
           mk("outer", 3, None, None, 0, 10.0, 11.0, device_ms=1.0)]
    assert spans.host_s("outer", spans=rec) == pytest.approx(5.0)
    # the children cover [1, 3] of the first outer span
    assert spans.host_s("outer", own=True, spans=rec) == pytest.approx(3.0)
    assert spans.device_ms("outer", rec) == pytest.approx(6.0)
    assert spans.device_ms("child", rec) is None
    assert spans.host_s("missing", spans=rec) is None
    assert spans.device_ms("missing", rec) is None
    assert [s.id for s in spans.under(rec, "outer")] == [1, 2]


def test_thread_without_spans_takes_the_waiting_caller():
    """Autograd's worker thread on the card opens its spans with none of
    its own open: their parent is the span its caller waits in."""
    seen = {}

    def worker():
        with spans.span("aggregate.backward") as s:
            seen["span"] = s

    with spans.recording():
        with spans.span("step.backward", 4) as caller:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    s = seen["span"]
    assert s.parent == caller.id and s.step == 4
    assert s.thread != caller.thread


@pytest.mark.parametrize("capturing", [True, False])
def test_no_event_while_a_graph_captures(monkeypatch, capturing):
    """(A stub of the CUDA calls: this machine has no card.)"""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)

        def record(self):
            self.recorded = True

        def query(self):
            return True

        def elapsed_time(self, end):
            return 1.5

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    with spans.recording():
        with spans.span("step.forward", 0):
            pass
    (s,) = spans.record()
    if capturing:
        assert made == [] and s.device_ms is None
    else:
        assert len(made) == 2 and all(e.recorded for e in made)
        assert s.device_ms == 1.5 and s.events is None


# ---------------------------------------------------------------------------
# the Trainer's spans
# ---------------------------------------------------------------------------

def test_phases_in_the_profilers_trace(tmp_path):
    tr, state = warm_trainer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.run(epochs=2, state=state)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    named = collections.defaultdict(list)
    for e in events:
        named[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    for name in ("trainer.run", "fetch", "aggregate", "aggregate.backward",
                 *PHASES):
        assert named[name], name
    assert len(named["step.forward"]) == 2 and len(named["eval"]) == 2

    def inside(name, outers):
        """Every span of `name` lies in one of a span named in `outers`."""
        return all(any(a <= x and y <= b for o in outers for a, b in named[o])
                   for x, y in named[name])

    for name in (*PHASES, "fetch"):
        assert inside(name, ["trainer.run"]), name
    assert inside("aggregate", ["step.forward", "eval"])
    assert inside("aggregate.backward", ["step.backward"])


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_parents_and_steps_in_memory(impl):
    tr, state = warm_trainer(impl=impl)
    first = state["step"]
    with spans.recording():
        tr.run(epochs=3, state=state)
    rec = spans.record()
    ids = by_id(rec)
    names = collections.Counter(s.name for s in rec)
    assert names["trainer.run"] == 1 and names["fetch"] == 1
    for name in PHASES:
        assert names[name] == 3, name
    fwd = [s for s in rec if s.name == "step.forward"]
    assert [s.step for s in fwd] == [first, first + 1, first + 2]
    for s in rec:
        if s.name in PHASES:
            assert parent_name(s, ids) == "trainer.run"
    # an eval belongs to the step whose result it evaluates
    assert [s.step for s in rec if s.name == "eval"] == \
        [s.step for s in fwd]
    aggs = [s for s in rec if s.name == "aggregate"]
    assert len(aggs) == 3 * 2 * TINY["hidden_layers"]
    for s in aggs:
        assert parent_name(s, ids) in ("step.forward", "eval")
        assert s.step == ids[s.parent].step
    backs = [s for s in rec if s.name == "aggregate.backward"]
    # the plain product is differentiated by autograd: no Function of ours
    assert len(backs) == (0 if impl == "torch"
                          else 3 * TINY["hidden_layers"])
    for s in backs:
        assert parent_name(s, ids) == "step.backward"


def test_setup_spans_recorded_with_the_profiler_off():
    tr = Trainer(TrainConfig(**TINY))
    state = tr.init_state()
    gen = torch.Generator().manual_seed(0)
    tr.train_step(state, gen)
    tr.train_step(state, gen)
    rec = spans.record()
    assert [s.name for s in rec] == ["setup.graph", "setup.state",
                                     "setup.first_step"]
    for s in rec:
        assert s.end >= s.start and s.device_ms is None
        assert spans.host_s(s.name, own=True) >= 0


def test_host_syncs_three_a_call_of_8():
    """The steady clock's synchronise after the first epoch, the one fetch
    of 8 epochs' metrics, and the closing synchronise."""
    tr, state = warm_trainer()
    with spans.recording():
        tr.run(epochs=8, state=state)
    assert spans.counters["host_syncs"] == 3
    assert sum(s.name == "fetch" for s in spans.record()) == 1


# ---------------------------------------------------------------------------
# --timing
# ---------------------------------------------------------------------------

def test_cli_timing_writes_its_spans(tmp_path):
    res = tmain(CLI + ["--epochs", "4", "--timing", "--path",
                       str(tmp_path)])
    summary = json.loads((tmp_path / "results.json").read_text())
    timing = summary["timing"]
    assert timing == res["timing"]
    for name in (*PHASES, "aggregate", "aggregate.backward", "fetch"):
        p = timing["phases"][name]
        assert p["device_ms"] is None and p["host_ms"] > 0, name
    assert set(timing["setup_s"]) == {"setup.graph", "setup.state",
                                      "setup.first_step"}
    # the first step's own phases are recorded, but it stays set-up
    assert timing["setup_s"]["setup.first_step"] > (
        timing["phases"]["step.forward"]["host_ms"] / 1e3)
    # 4 epochs: the first (set-up) is left out of the phases' means
    assert timing["host_syncs"] == 3
    stats = summary["aggregation_stats"]
    step_ms = sum(timing["phases"][n]["host_ms"] for n in PHASES[:3])
    assert stats["step_s"] * 1e3 == pytest.approx(step_ms)
    assert 0 < stats["aggregation_pct"] <= 100
    log = (tmp_path / "flickr.log").read_text()
    assert "Phase step.forward: device - ms, host" in log
    assert "Set-up setup.state" in log and "Host syncs: 3" in log


# ---------------------------------------------------------------------------
# GPU (skips without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _traced_run(tmp_path, tr, state, epochs=8):
    """(trace events, window (start, end) in us) of one
    `Trainer.run(epochs)` under the profiler, recorded."""
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        with record_function("test.window"):
            tr.run(epochs=epochs, state=state)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    (win,) = [e for e in events if e["name"] == "test.window"]
    return events, (win["ts"], win["ts"] + win["dur"])


def _gpu_trainer(cuda, **over):
    tr = Trainer(TrainConfig(**{**TINY, "device": "cuda",
                                "synthetic_scale": 0.02, **over}))
    state = tr.init_state()
    tr.run(epochs=2, state=state)
    spans.reset()
    return tr, state


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phases_between_busy_and_window_on_gpu(cuda, tmp_path, dtype):
    tr, state = _gpu_trainer(cuda, dtype=dtype)
    events, (w0, w1) = _traced_run(tmp_path, tr, state)
    dev = sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and e["ts"] + e["dur"] > w0 and e["ts"] < w1)
    busy, at = 0.0, w0
    for a, b in dev:
        busy += max(b - max(a, at), 0.0)
        at = max(at, b)
    phases = sum(spans.device_ms(n) for n in PHASES) * 1e3   # us
    assert busy <= phases <= w1 - w0, (busy, phases, w1 - w0)


@pytest.mark.gpu
def test_backward_span_under_step_backward_on_gpu(cuda):
    tr, state = _gpu_trainer(cuda)
    with spans.recording():
        tr.train_step(state, torch.Generator(device=cuda).manual_seed(0))
        tr._sync()
    rec = spans.record()
    ids = by_id(rec)
    backs = [s for s in rec if s.name == "aggregate.backward"]
    assert backs
    for s in backs:
        assert parent_name(s, ids) == "step.backward"
        assert s.step == ids[s.parent].step and s.device_ms is not None


@pytest.mark.gpu
def test_host_syncs_match_the_profiler_on_gpu(cuda, tmp_path):
    """Each wait in the trace: a device or stream synchronise, or a copy
    to the host that no stream synchronise follows (a copy that one
    follows is one wait with it)."""
    tr, state = _gpu_trainer(cuda)
    events, (w0, w1) = _traced_run(tmp_path, tr, state)
    runtime = sorted((e for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and w0 <= e["ts"] <= w1), key=lambda e: e["ts"])
    d2h = {e["args"].get("correlation") for e in events
           if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"]}
    waits, names = 0, collections.Counter()
    for i, e in enumerate(runtime):
        name = e["name"]
        if name in ("cudaDeviceSynchronize", "cudaStreamSynchronize"):
            waits += 1
            names[name] += 1
        elif (name.startswith("cudaMemcpy")
              and e["args"].get("correlation") in d2h):
            names["copy to host"] += 1
            after = [r["name"] for r in runtime[i + 1:]
                     if r.get("tid") == e.get("tid")][:1]
            if after != ["cudaStreamSynchronize"]:
                waits += 1
    assert spans.counters["host_syncs"] == waits == 3, dict(names)
