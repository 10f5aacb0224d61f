"""The plain reference against the port's CPU path on a tiny graph, and
the control: the reference in the precision below the cell's, put in the
program's place, comes out not correct against the cell's limits."""
import pytest
import torch

from benchmark import calibrate, cells, compare, graphgen, run


def _steps(config, traffic_name, seed):
    traffic = cells.traffic(traffic_name)
    indptr, indices, _ = graphgen.load_csr(config)
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
def test_reference_matches_the_ports_cpu_path(tiny_config, seed):
    prog, ref, _ = _steps(tiny_config, "train-f32", seed)
    got = compare.readings(prog, ref)
    assert len(prog.losses) == 3 and len(set(prog.losses)) == 3
    assert got["loss_gap"] < 1e-6, got
    assert got["grad_gap"] < 1e-5 and got["change_gap"] < 1e-5, got


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
