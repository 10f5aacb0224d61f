"""On the card: a short run of a cell through the benchmark's own command,
correct, with its result line in the documented form (run with `python -m
pytest -m gpu benchmark/tests/test_bench_card.py` on the card)."""
import json
import subprocess
import sys

import pytest

from benchmark import cells


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "reddit-sage-maxk.train-f32", "--seed", str(2**31 + 5),
         "--seconds", "2", "--trace", str(trace)],
        cwd=cells.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        for m in ("agg_roofline", "mfu"):
            assert 0 < res["metrics"][m]["value"] <= 100
    else:
        assert set(res["metrics"]) == {"epoch_s", "setup_s"}
