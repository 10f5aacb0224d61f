#!/usr/bin/env python
"""The reference's accuracy from the PyTorch port's initial weights: the
yardstick of chip_smoke.py's accuracy phase.

TRAJ_r03.json's trajectory gate holds a run's best test accuracy to the CPU
XLA oracle's from the same initial weights, which the JAX package draws from
`jax.random`. The port's Trainer draws its own from a `torch.Generator`, so
the same seed gives it other weights, and the accuracy after 80 epochs moves
with the draw. This script runs the JAX Trainer (on the CPU) on TRAJ_r03's
config (the Reddit stand-in at scale 0.02, SAGE MaxK k=32, 3 x 256,
LayerNorm, dropout 0, lr 0.01, seed 97, 80 epochs) from its own initial
weights and from the weights the port's Trainer draws
(`Trainer.init_state()`, carried into the flax tree by name; params are f32
in either dtype), and prints each best test accuracy
(best-val-selects-test).

    env JAX_PLATFORMS=cpu python scripts/port_accuracy_oracle.py \
        [--epochs 80] [--seed 97] [--dtype float32|bfloat16] \
        [--starts jax,port]

`--dtype float32` (the default) runs impl "xla", exact f32 (about 6 minutes
a run on 8 CPU cores). `--dtype bfloat16` is the reference's 16-bit model
(flax `dtype=bfloat16`): it runs impl "pallas", the planned kernels in
interpret mode, which sum bf16 activations in f32 and round the aggregation
once to bf16, as the TPU path does (impl "xla" would add in bf16).
"""
import argparse
import json
import os
import sys
from collections.abc import Mapping

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIG = dict(dataset="reddit", model="sage", nonlinear="maxk", maxk=32,
              hidden_layers=3, hidden_dim=256, norm=True, dropout=0.0,
              w_lr=0.01, eval_every=1, synthetic=True, synthetic_scale=0.02,
              log_every=0)


def flax_params_from_port(tree: Mapping, state_dict: dict) -> dict:
    """The flax parameter tree `tree` with every leaf replaced by the port's
    tensor of the same name (the inverse of `convert.params_from_flax`)."""
    import jax.numpy as jnp
    import numpy as np
    modules = {"LayerNorm_0": "norm"}
    leaves = {"kernel": "weight", "scale": "weight"}

    def walk(node: Mapping, prefix: tuple) -> dict:
        out = {}
        for name, value in node.items():
            if isinstance(value, Mapping):
                out[name] = walk(value, prefix + (modules.get(name, name),))
                continue
            a = state_dict[".".join(prefix + (leaves.get(name, name),))]
            a = a.detach().cpu().numpy()
            if name == "kernel":
                a = a.T
            if a.shape != value.shape:
                raise ValueError(f"{prefix}/{name}: {a.shape} != "
                                 f"{value.shape}")
            out[name] = jnp.asarray(np.ascontiguousarray(a, np.float32))
        return out

    return walk(tree, ())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=80)
    ap.add_argument("--seed", type=int, default=97)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--starts", default="jax,port",
                    help="comma-separated initial weights to run from: jax "
                         "(the JAX package's draw), port (the port's)")
    args = ap.parse_args(argv)
    starts = args.starts.split(",")
    if not set(starts) <= {"jax", "port"}:
        raise SystemExit(f"--starts takes jax and port; got {args.starts}")
    impl = "xla" if args.dtype == "float32" else "pallas"

    import jax

    from spgemm_gnn_tpu.graphs.datasets import load_dataset
    from spgemm_gnn_tpu.train.config import TrainConfig as JConfig
    from spgemm_gnn_tpu.train.loop import Trainer as JTrainer
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    cfg = dict(CONFIG, epochs=args.epochs, seed=args.seed)
    ds = load_dataset("reddit", "/nonexistent", allow_synthetic=True,
                      synthetic_scale=cfg["synthetic_scale"], seed=args.seed)
    port = Trainer(TrainConfig(impl="torch", device="cpu", **cfg))
    weights = port.init_state()["model"].state_dict()
    out = {}
    for start in starts:
        jt = JTrainer(JConfig(impl=impl, dtype=args.dtype, **cfg), dataset=ds)
        if start == "port":
            state = jt.init_state()
            params = flax_params_from_port(jax.device_get(state["params"]),
                                           weights)
            state = dict(state, params=params,
                         opt_state=jt.tx.init(params))
            jt.init_state = lambda seed=None: state
        res = jt.run()
        out[start] = dict(best_test_accuracy=res["best_test_accuracy"],
                          best_epoch=res["best_epoch"])
        print(json.dumps({"initial_weights": start, "dtype": args.dtype,
                          "impl": impl, **out[start]}),
              flush=True)


if __name__ == "__main__":
    main()
