"""Training configuration (counterpart of `spgemm_gnn_tpu/train/config.py`):
the JAX package's flag names, plus `--device`.

`--mesh_shape D` (D > 1) trains over a mesh of D graph shards in one
process, every shard on the one device (parallel/mesh.py). With
`--multihost` or `--coordinator`, the CLI starts a process group
(parallel/multihost.py: `--num_processes`, `--process_id`, or their env
vars) and trains one graph shard a rank; `--mesh_shape` then equals the
number of processes. `check_supported` rejects a `dtype` other than
float32 and bfloat16 (ValueError).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Any

from spgemm_gnn_tpu_torch.graphs.datasets import DATASETS
from spgemm_gnn_tpu_torch.models.layers import COMPUTE_DTYPES
from spgemm_gnn_tpu_torch.models.models import MODELS


@dataclasses.dataclass
class TrainConfig:
    dataset: str = "yelp"
    data_path: str = "./data/"
    model: str = "sage"
    selfloop: bool = False
    epochs: int = 1000
    w_lr: float = 0.01
    w_weight_decay: float = 0.0
    enable_lookahead: bool = False
    hidden_dim: int = 256
    hidden_layers: int = 3
    nonlinear: str = "maxk"              # maxk | relu
    maxk: int = 32
    dropout: float = 0.5
    norm: bool = False
    seed: int = 97
    evaluate: str | None = None
    path: str = "./run/"
    impl: str = "auto"                   # auto | torch | cuda (kernels/api.py)
    device: str = "cuda"                 # cuda | cpu
    remat: bool = False
    eval_every: int = 1
    # eval metrics stay on the device and reach the host in batches of this
    # many evaluations (each host read waits for the device)
    eval_fetch_every: int = 8
    steps_per_call: int = 1
    checkpoint_every: int = 0
    resume: bool = False
    dtype: str = "float32"               # compute dtype: float32 | bfloat16
    synthetic: bool = False              # allow synthetic stand-in datasets
    synthetic_scale: float = 1.0
    device_inputs: bool = False
    mesh_shape: int = 1
    multihost: bool = False
    coordinator: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
    log_every: int = 1
    tensorboard: bool = False
    timing: bool = False
    profile: str | None = None
    cache_strategy: str = "none"
    cache_size_ratio: float = 0.05
    stream: str = "f32"                  # feature stream: f32 | bf16x2

    def print_params(self, prtf=print) -> None:
        prtf("")
        prtf("Parameters:")
        for f in sorted(dataclasses.fields(self), key=lambda f: f.name):
            prtf(f"{f.name.upper()}={getattr(self, f.name)}")
        prtf("")

    def as_markdown(self) -> str:
        """The config as a two-column markdown table (the TensorBoard
        text summary of `--tensorboard`)."""
        text = "|name|value|  \n|-|-|  \n"
        for f in sorted(dataclasses.fields(self), key=lambda f: f.name):
            text += f"|{f.name}|{getattr(self, f.name)}|  \n"
        return text

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


DTYPES = tuple(COMPUTE_DTYPES)


def check_supported(config: TrainConfig) -> None:
    """Raise ValueError for a dtype the model does not compute in."""
    if config.dtype not in DTYPES:
        raise ValueError(f"--dtype {config.dtype!r}: expected one of "
                         f"{DTYPES}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "MaxK-GNN training (PyTorch/CUDA port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    d = TrainConfig()
    p.add_argument("--dataset", default=d.dataset, choices=list(DATASETS))
    p.add_argument("--data_path", default=d.data_path)
    p.add_argument("--model", default=d.model, choices=list(MODELS))
    p.add_argument("--selfloop", action="store_true")
    p.add_argument("--epochs", type=int, default=d.epochs)
    p.add_argument("--w_lr", type=float, default=d.w_lr)
    p.add_argument("--w_weight_decay", type=float, default=d.w_weight_decay)
    p.add_argument("--enable_lookahead", action="store_true")
    p.add_argument("--hidden_dim", type=int, default=d.hidden_dim)
    p.add_argument("--hidden_layers", type=int, default=d.hidden_layers)
    p.add_argument("--nonlinear", default=d.nonlinear, choices=["maxk", "relu"])
    p.add_argument("--maxk", type=int, default=d.maxk)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--norm", action="store_true")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("-e", "--evaluate", default=None, metavar="PATH")
    p.add_argument("--path", default=d.path, metavar="PATH")
    p.add_argument("--impl", default=d.impl, choices=["auto", "torch", "cuda"],
                   help="auto: CUDA kernels on the GPU, plain PyTorch on the "
                        "CPU; cuda: kernels only; torch: plain PyTorch only")
    p.add_argument("--device", default=d.device,
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--remat", action="store_true",
                   help="keep only each layer's input and aggregation "
                        "outputs, rerun the rest in the backward (less "
                        "memory, the same losses bit for bit)")
    p.add_argument("--eval_every", type=int, default=d.eval_every)
    p.add_argument("--eval_fetch_every", type=int, default=d.eval_fetch_every)
    p.add_argument("--steps_per_call", type=int, default=d.steps_per_call,
                   help="train epochs run as one group between evals; on "
                        "the GPU every step after the first replays a CUDA "
                        "graph of the step when a group holds more than one")
    p.add_argument("--checkpoint_every", type=int, default=d.checkpoint_every)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--dtype", default=d.dtype, choices=list(DTYPES),
                   help="compute dtype of the hidden stack: float32, or "
                        "bfloat16 (flax mixed precision: params and lin_out "
                        "f32, bf16 activations and aggregation outputs)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_scale", type=float, default=d.synthetic_scale)
    p.add_argument("--device_inputs", action="store_true",
                   help="with --synthetic: draw the stand-in's features and "
                        "labels on the device (no host payload)")
    p.add_argument("--mesh_shape", type=int, default=d.mesh_shape,
                   help="graph shards (D > 1: the edge-partitioned path; in "
                        "one process every shard on the one device, across "
                        "processes one shard a rank and D = the processes)")
    p.add_argument("--multihost", action="store_true",
                   help="start a process group (torch.distributed) before "
                        "training: one graph shard a rank")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's address (tcp://HOST:PORT; an address "
                        "with a scheme, e.g. file://PATH, as it is); else "
                        "COORDINATOR_ADDRESS")
    p.add_argument("--num_processes", type=int, default=None,
                   help="the world size; else NUM_PROCESSES")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank; else PROCESS_ID")
    p.add_argument("--log_every", type=int, default=d.log_every)
    p.add_argument("--tensorboard", action="store_true",
                   help="scalars per logged epoch under <path>/tb")
    p.add_argument("--timing", action="store_true",
                   help="after training, the aggregation share of a step "
                        "(utils/timing.py) into the log and results.json")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="before training, a torch.profiler Chrome trace of "
                        "3 steps on a separate state, written into DIR")
    p.add_argument("--cache-strategy", dest="cache_strategy", default="none",
                   choices=["none", "direct", "static-outd", "fifo", "lru"])
    p.add_argument("--cache-size-ratio", dest="cache_size_ratio", type=float,
                   default=d.cache_size_ratio)
    p.add_argument("--stream", default=d.stream, choices=["f32", "bf16x2"],
                   help="the aggregation kernels' feature stream: f32 "
                        "(exact), or bf16x2 (messages bf16(pre * x), f32 "
                        "sums; kernels.planned.DEFAULT_STREAM)")
    return p


def from_args(argv=None) -> TrainConfig:
    args = build_parser().parse_args(argv)
    return TrainConfig(**vars(args))
