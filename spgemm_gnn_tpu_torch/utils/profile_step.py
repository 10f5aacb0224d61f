"""Where one train step's device time goes, on the GPU: a dataset's recipe on
its synthetic stand-in, one warm step, then one step under `torch.profiler`,
with device time summed by kernel name.

    python -m spgemm_gnn_tpu_torch.utils.profile_step \
        [--dataset reddit|ogbn-products] [--model sage|gcn|...] \
        [--stream_cbsr_forward [auto|on|off]] \
        [--sampled_backward [auto|on|off]] [--stream f32|bf16x2] \
        [--dtype float32|bfloat16] [--synthetic_scale S]

Recipes (scripts_train/*_maxk.sh): reddit (the default) MaxK k=32, hidden
256, 4 layers, LayerNorm, dropout 0.5, lr 0.01; ogbn-products the same with
3 layers and lr 0.003. The model is SAGE unless `--model` names another
family (the JAX CLI's flag); every other family takes self-loops, as the
recipes give them. The Trainer plans the graph, so the step runs the kernel
the reference's rule picks (csr_spmm on reddit, stream_spmm on
ogbn-products); `--stream_cbsr_forward` sets
`kernels.planned.STREAM_CBSR_FORWARD`: "auto" (the default, None: its rule,
which gives a MaxK forward at hidden <= 256 the CBSR form of the plan's
kernel: stream_cbsr_spmm on a stream plan, csr_cbsr_spmm on a windowed one
for bf16 records, under `--stream bf16x2` or `--dtype bfloat16`), "on"
(True; the flag alone) or "off" (False: the dense forward);
`--sampled_backward` sets `kernels.planned.SAMPLED_BACKWARD` the same way
("auto": its rule, which gives MaxK's backward its sampled form, on f32
or bf16 messages, `stream_sspmm` on a stream plan and `csr_sspmm` on a
windowed one; "off": the dense backward, `stream_spmm` or `csr_spmm`);
`--stream bf16x2` runs the 16-bit feature stream (the Trainer's
`--stream`: round_rows and the bf16 forms of the kernels);
`--dtype bfloat16` the 16-bit model (bf16 matmuls and activations, the
kernels' bf16-output forms); under it the script also times steps with
cuBLAS allowed to reduce bf16 split-K partial sums in bf16
(`torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`, which
the entry points turn off) against steps without, to show what the f32
reduction costs.

Prints the card's name and power limit, the plan kind, the step's wall time,
the device's busy time and idle share, and the kernels that took the most
device time.
"""
from __future__ import annotations

import argparse
import subprocess
import time

import torch

from spgemm_gnn_tpu_torch.models.models import MODELS

RECIPES = {
    "reddit": dict(hidden_layers=4, w_lr=0.01),
    "ogbn-products": dict(hidden_layers=3, w_lr=0.003),
}


FLAG = {"auto": None, "on": True, "off": False}


def profile_step(dataset: str, model: str, stream_cbsr_forward: bool | None,
                 stream: str, dtype: str, synthetic_scale: float, seed: int,
                 top: int, sampled_backward: bool | None = None) -> None:
    from torch.profiler import ProfilerActivity, profile

    from spgemm_gnn_tpu_torch.kernels import planned
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    planned.STREAM_CBSR_FORWARD = stream_cbsr_forward
    planned.SAMPLED_BACKWARD = sampled_backward
    cfg = TrainConfig(dataset=dataset, model=model, selfloop=model != "sage",
                      nonlinear="maxk", maxk=32,
                      hidden_dim=256, norm=True, dropout=0.5, seed=seed,
                      stream=stream, dtype=dtype,
                      device="cuda", impl="auto", synthetic=True,
                      synthetic_scale=synthetic_scale,
                      data_path="/nonexistent", **RECIPES[dataset])
    trainer = Trainer(cfg)
    print(f"{dataset}, {model}: N={trainer.g.num_nodes} "
          f"E={trainer.g.num_edges}, plan kind {trainer.g.kind}, "
          f"STREAM_CBSR_FORWARD {stream_cbsr_forward}, SAMPLED_BACKWARD "
          f"{sampled_backward}, stream {stream}, dtype {dtype}", flush=True)
    state = trainer.init_state()
    gen = torch.Generator(device=trainer.device).manual_seed(seed)
    trainer.train_step(state, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a host op's own device time repeats the
    # kernels it launched (the ctypes launches have no aten op of their own)
    rows = [(evt.self_device_time_total / 1e3, evt.key, evt.count)
            for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CUDA
            and evt.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    print(f"one train step (profiler on): wall {wall_ms:.2f} ms, device busy "
          f"{busy:.2f} ms, idle {1 - busy / wall_ms:.1%}")
    for ms, key, count in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:9.3f} ms  {count:4d}x  {key[:90]}")
    if dtype == "bfloat16":
        reduced_reduction_cost(trainer, state, gen)


def reduced_reduction_cost(trainer, state, gen, pairs: int = 3) -> None:
    """Mean wall time of a train step with the bf16 matmuls' split-K sums
    reduced in f32 (the entry points' setting) and in bf16, alternating;
    the setting is left off."""
    matmul = torch.backends.cuda.matmul
    times = {False: [], True: []}
    for _ in range(pairs):
        for reduced in (False, True):
            matmul.allow_bf16_reduced_precision_reduction = reduced
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(state, gen)
            torch.cuda.synchronize()
            times[reduced].append((time.perf_counter() - t0) * 1e3)
    matmul.allow_bf16_reduced_precision_reduction = False
    f32, bf16 = (sum(times[r]) / pairs for r in (False, True))
    print(f"bf16 matmuls, split-K sums reduced in f32: {f32:.2f} ms a step; "
          f"in bf16: {bf16:.2f} ms (means of {pairs}, alternating)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="reddit", choices=sorted(RECIPES))
    ap.add_argument("--model", default="sage", choices=list(MODELS))
    ap.add_argument("--stream_cbsr_forward", nargs="?", const="on",
                    default="auto", choices=sorted(FLAG))
    ap.add_argument("--sampled_backward", nargs="?", const="on",
                    default="auto", choices=sorted(FLAG))
    ap.add_argument("--stream", default="f32", choices=["f32", "bf16x2"])
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--synthetic_scale", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=97)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    profile_step(args.dataset, args.model, FLAG[args.stream_cbsr_forward],
                 args.stream, args.dtype, args.synthetic_scale, args.seed,
                 args.top, FLAG[args.sampled_backward])


if __name__ == "__main__":
    main()
