"""spgemm_gnn_tpu_torch — the PyTorch/CUDA port of `spgemm_gnn_tpu`.

Full-graph GNN training with MaxK sparse activations on one NVIDIA H100
(Hopper, sm_90a). The package mirrors the JAX package's layout
(`graphs/`, `ops/`, `kernels/`, `models/`, `train/`, `utils/`) so each module
has a counterpart of the same name:

- `ops/` holds the plain PyTorch version of every kernel: the CPU path and the
  reference the CUDA kernels are held to;
- `kernels/` holds the hand-written CUDA kernels (sources in `csrc/`), their
  ctypes wrappers and the autograd Functions around them;
- entry points (`Trainer`, `python -m spgemm_gnn_tpu_torch.train`) run on
  `cuda` unless the caller asks for the CPU.

The package imports torch and numpy only — never jax, flax, optax or the JAX
package.
"""
from spgemm_gnn_tpu_torch.graphs.stream_tiles import StreamPlan
from spgemm_gnn_tpu_torch.kernels.api import (aggregate, aggregate_cbsr,
                                              cbsr_compact, maxk_op)
from spgemm_gnn_tpu_torch.kernels.planned import (PlannedGraph, plan_graph,
                                                  planned_aggregate)
from spgemm_gnn_tpu_torch.ops.maxk import (cbsr_from_masked, cbsr_to_dense,
                                           maxk_cbsr)
from spgemm_gnn_tpu_torch.train.config import TrainConfig
from spgemm_gnn_tpu_torch.train.loop import Trainer

__all__ = ["PlannedGraph", "StreamPlan", "TrainConfig", "Trainer",
           "aggregate", "aggregate_cbsr", "cbsr_compact", "cbsr_from_masked",
           "cbsr_to_dense", "maxk_cbsr", "maxk_op", "plan_graph",
           "planned_aggregate"]
