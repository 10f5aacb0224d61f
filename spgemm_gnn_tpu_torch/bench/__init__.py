"""Benchmarks of the port (counterpart of `spgemm_gnn_tpu/bench/`): the
aggregation implementations timed over synthetic graphs, as edges/s beside
the plain-PyTorch and ELL baselines.

  python -m spgemm_gnn_tpu_torch.bench           # the headline JSON line
  python -m spgemm_gnn_tpu_torch.bench.kernels   # the per-graph table
"""
from spgemm_gnn_tpu_torch.bench.harness import (  # noqa: F401
    bench_aggregation, bench_training_step, time_chained,
)
