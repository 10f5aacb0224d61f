"""The trace arithmetic on a made-up trace: busy time as the union of the
device's intervals, the idle gaps labelled by what the host was doing,
the port's kernel names, and the readers built on them."""
import collections
import json

import pytest

from benchmark import cells, trace
from benchmark.context import Context

CONFIG = {"dataset": {"num_nodes": 10, "num_features": 3, "num_classes": 2},
          "model": {"hidden_dim": 4, "hidden_layers": 2, "maxk": 2}}


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


@pytest.fixture
def made_up(tmp_path):
    events = [
        _event(trace.WINDOW, "user_annotation", 100, 100),     # [100, 200]
        # kernels: two overlapping, one before the window, one across its end
        _event("void csr_cbsr_kernel<F32Rec, 8>(int4 const*)", "kernel",
               110, 20),                                       # 110-130
        _event("ampere_sgemm_128x64_tn", "kernel", 120, 30),   # 120-150
        _event("Memset (Device)", "gpu_memset", 160, 5),       # 160-165
        _event("void sspmm_walk_kernel<F32Msg>(Walk)", "kernel",
               190, 20),                                       # 190-210
        _event("early", "kernel", 50, 20),
        # host: an outer op, an inner op in the first gap, nothing later
        _event("aten::linear", "cpu_op", 100, 60),
        _event("cudaLaunchKernel", "cuda_runtime", 150, 5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace.load(path)


def test_union_merges_overlaps():
    assert trace.union([(5, 7), (1, 3), (2, 4), (7, 8)]) == [(1, 4), (5, 8)]


def test_busy_and_gaps(made_up):
    assert made_up.window_s == pytest.approx(100e-6)
    # busy: 110-150, 160-165, 190-200 (cut at the window's end) = 55 us
    assert trace.busy_s(made_up) == pytest.approx(55e-6)
    assert trace.gaps(made_up) == [(100, 110), (150, 160), (165, 190)]


def test_idle_gaps_by_host_op(made_up):
    gaps = dict((k, v) for k, v in trace.top_idle_gaps(made_up))
    assert gaps["aten::linear"] == pytest.approx(10e-6)     # 100-110
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)  # 150-160
    assert gaps["host: no traced op"] == pytest.approx(25e-6)


def test_kernel_names(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text(
        "template <typename T>\n__global__ void __launch_bounds__(kW * 32, "
        "min_blocks<T>())\nfoo_kernel(const T* x) {}\n"
        "__global__ void bar_kernel(int n) {}\n")
    assert trace.own_kernels(csrc) == {"foo_kernel", "bar_kernel"}
    for name in ("void csr_cbsr_kernel<F32Rec, 8>(int4 const*)",
                 "void (anonymous namespace)::csr_cbsr_kernel<(anonymous "
                 "namespace)::F32Rec<16, 2>, 8>(int4 const*, long)"):
        assert trace.base_name(name) == "csr_cbsr_kernel"
    assert trace.base_name("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n") == \
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n"
    assert trace.base_name("void at::native::vectorized_elementwise_kernel"
                           "<4, at::native::CUDAFunctor_add<float>>(int)") \
        == "vectorized_elementwise_kernel"
    assert trace.is_aggregation("void sspmm_slots_kernel(int const*)")
    assert not trace.is_aggregation("void maxk_fwd_kernel<float>(float*)")


def test_readers_on_made_up_trace(made_up):
    ctx = Context(config=CONFIG, traffic={"dtype": "float32"}, num_edges=20,
                  epoch_s=0.5, peak_window_bytes=3 * 2**30, trace=made_up,
                  traced_epochs=2,
                  launches=collections.Counter(a=6, b=4),
                  own_kernels={"csr_cbsr_kernel", "sspmm_walk_kernel"})
    read = {m: cells.reader(m)(ctx) for m in (
        "launches_per_epoch", "agg_ms", "agg_roofline", "model_ms",
        "device_idle_pct", "peak_mem_gib", "mfu")}
    assert read["launches_per_epoch"] == 5
    # aggregation: 20 us + 10 us inside the window, over 2 epochs
    assert read["agg_ms"] == pytest.approx(30e-3 / 2)
    assert read["model_ms"] == pytest.approx(35e-3 / 2)
    assert read["device_idle_pct"] == pytest.approx(45.0)
    assert read["peak_mem_gib"] == 3
    from benchmark.counts import epoch_aggregation_floor_s, epoch_flops
    assert read["agg_roofline"] == pytest.approx(
        100 * epoch_aggregation_floor_s(CONFIG, 20, "float32") * 2 / 30e-6)
    assert read["mfu"] == pytest.approx(
        100 * epoch_flops(CONFIG, 20) / (0.5 * 67e12))


def test_readers_find_nothing_without_a_trace():
    ctx = Context(config=CONFIG, traffic={"dtype": "float32"}, num_edges=20,
                  epoch_s=0.5, peak_window_bytes=0, trace=None,
                  traced_epochs=0, launches=collections.Counter(),
                  own_kernels=set())
    for m in ("launches_per_epoch", "agg_ms", "agg_roofline", "model_ms",
              "device_idle_pct", "peak_mem_gib", "mfu"):
        assert cells.reader(m)(ctx) is None
