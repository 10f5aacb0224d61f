"""The plain reference against the port's CPU path on a tiny graph, for
each model family with a model file, and the control: the reference in the
precision below the cell's, put in the program's place, comes out not
correct against the cell's limits."""
import pytest
import torch

from benchmark import calibrate, cells, compare, graphgen, run


def _steps(config, traffic_name, seed):
    traffic = cells.traffic(traffic_name)
    indptr, indices, _ = graphgen.load_graph(config)
    graph = run.build_graph(indptr, indices, "cpu")
    prog, host = calibrate.program_steps(config, traffic, seed, "cpu",
                                         graph)
    ref = calibrate.reference_steps(config, traffic, seed, "cpu", indptr,
                                    indices, host)
    low = calibrate.reference_steps(
        config, traffic, seed, "cpu", indptr, indices, host,
        calibrate.CONTROL[traffic["dtype"]])
    return prog, ref, low


@pytest.mark.parametrize("seed", [5, 2**31 + 77])
@pytest.mark.parametrize("model", ["sage", "gcn"])
def test_reference_matches_the_ports_cpu_path(tiny_config, tiny_gcn_config,
                                              model, seed):
    config = tiny_gcn_config if model == "gcn" else tiny_config
    prog, ref, _ = _steps(config, "train-f32", seed)
    got = compare.readings(prog, ref)
    assert len(prog.losses) == 3 and len(set(prog.losses)) == 3
    assert got["loss_gap"] < 1e-6, got
    assert got["grad_gap"] < 1e-5 and got["change_gap"] < 1e-5, got


@pytest.mark.parametrize("seed", [5, 2**31 + 77])
def test_gcn_bf16_reference_follows_the_ports_cpu_path(tiny_gcn_config,
                                                       seed):
    """GCN at dtype bfloat16 against the port's CPU bf16 path. A loss over
    ~900 rows after bf16 rounding and MaxK near-ties reads gaps of 1e-3 to
    4e-3 here, and the first gradient by its worst leaf under 7e-5; the
    same program against the f32 reference reads 2e-2 to 0.17 and 3e-2 to
    4e-2. So the reference's bf16 rules are those the program follows."""
    traffic = cells.traffic("train-bf16")
    indptr, indices, _ = graphgen.load_graph(tiny_gcn_config)
    graph = run.build_graph(indptr, indices, "cpu")
    prog, host = calibrate.program_steps(tiny_gcn_config, traffic, seed,
                                         "cpu", graph)
    ref, f32 = (calibrate.reference_steps(
        tiny_gcn_config, dict(traffic, dtype=dtype), seed, "cpu", indptr,
        indices, host) for dtype in ("bfloat16", "float32"))
    got = compare.readings(prog, ref)
    assert got["loss_gap"] < 1e-2 and got["grad_gap"] < 5e-4, got
    assert compare.readings(prog, f32)["grad_gap"] > 10 * got["grad_gap"]


@pytest.mark.parametrize("cell,traffic", [
    ("reddit-sage-maxk.train-f32", "train-f32"),
    ("products-sage-maxk.train-f32", "train-f32"),
    ("reddit-sage-maxk.train-bf16", "train-bf16"),
    ("products-sage-maxk.train-bf16", "train-bf16")])
def test_control_is_not_correct(tiny_config, cell, traffic):
    _, ref, low = _steps(tiny_config, traffic, 11)
    ok, checks = compare.judge(compare.readings(low, ref), cells.limits(cell))
    assert not ok, checks


def test_tf32_and_fp8_rounding():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0000002])
    assert torch.equal(calibrate.reference.round_tf32(x),
                       torch.tensor([1.0, 1.0 + 2**-9, -3.0]))
    y = torch.tensor([448.0, 1.0, 0.3])
    assert torch.equal(calibrate.reference.round_fp8(y)[:2], y[:2])
    assert calibrate.reference.round_fp8(y)[2] != y[2]


@pytest.mark.parametrize("block", [7, 1 << 21])
def test_csr_product_is_the_plain_sum(monkeypatch, block):
    """The reference's product A x, in blocks smaller than a hub row or
    in one: each row the sum of its sources' rows (against float64), the
    same bits on a second call, zero on a row with no edge."""
    monkeypatch.setattr(calibrate.reference, "EDGE_BLOCK", block)
    indptr, indices = graphgen.powerlaw_csr(300, 2000, 1.5, 4)
    ptr, idx = torch.from_numpy(indptr), torch.from_numpy(indices)
    ptr = torch.cat([ptr, ptr[-1:]])               # node 300 has no edge
    x = torch.randn((301, 16), generator=torch.Generator().manual_seed(3))
    adj = calibrate.reference.CSR(ptr.int(), idx)
    y = adj @ x
    rows = torch.repeat_interleave(torch.arange(301), ptr.diff())
    want = torch.zeros((301, 16), dtype=torch.float64).index_add_(
        0, rows, x.double()[idx.long()])
    assert torch.allclose(y.double(), want, rtol=1e-6, atol=1e-5)
    assert torch.equal(adj @ x, y) and not y[300].any()
