"""Timing instrumentation (counterpart of `spgemm_gnn_tpu/utils/timing.py`):
the aggregation share of a train step, and a wall-clock epoch timer.

The share is the JAX package's estimate: the time of a full train step
against that of an aggregation-only program of the same shapes, both timed
by `bench.harness.time_chained` (CUDA events on the card, `perf_counter`
on the CPU). The aggregation-only program goes through the dispatch the
model's layers use, so it runs the kernels the planner's rules pick for the
config's stream and dtype: per layer MaxK (with its kept channels where the
sampled backward reads them, `kernels.planned.wants_channel_ids`), then
`aggregate` with them, forward and backward. Its input is drawn from a
fixed seed, where the JAX package takes zeros: MaxK's ties and the k-sparse
forms then see rows like the model's.
"""
from __future__ import annotations

import time
from typing import Any

import torch

from spgemm_gnn_tpu_torch.models.layers import compute_dtype


def measure_aggregation_fraction(trainer, iters: int = 4) -> dict[str, Any]:
    """{step_s, aggregation_s, aggregation_pct}: seconds of a train step of
    `trainer` (on a fresh state and dropout generator), seconds of its
    aggregation-only program (hidden_layers of MaxK or ReLU, then the mean
    aggregation, at hidden_dim, forward and the gradient of the sum of
    squares), and the second as a share of the first (at most 100)."""
    from spgemm_gnn_tpu_torch.bench.harness import time_chained
    from spgemm_gnn_tpu_torch.kernels.api import aggregate, maxk_op
    from spgemm_gnn_tpu_torch.kernels.planned import wants_channel_ids

    cfg = trainer.config
    g = trainer.g
    dev = trainer.device
    state = trainer.init_state()
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)

    def full_step(s):
        trainer.train_step(s, gen)
        return s

    t_step = time_chained(full_step, state, iters)
    del state

    dim, layers = cfg.hidden_dim, cfg.hidden_layers
    k = cfg.maxk if cfg.nonlinear == "maxk" else None
    # the probe rides the config's compute dtype, as the layers do
    x0 = torch.randn((g.num_nodes, dim), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0)
                     ).to(compute_dtype(cfg.dtype))

    def agg_grad(x):
        x = x.detach().requires_grad_()
        h = x
        for _ in range(layers):
            ids = None
            if k is None:
                h2 = torch.relu(h)
            elif cfg.impl != "torch" and wants_channel_ids(g, k, h):
                h2, ids = maxk_op(h, k, cfg.impl, with_ids=True)
            else:
                h2 = maxk_op(h, k, cfg.impl)
            h = aggregate(g, h2, norm="mean", k=k, impl=cfg.impl, ids=ids)
        (gx,) = torch.autograd.grad(h.float().square().sum(), x)
        return gx

    def agg_step(x):
        return x + agg_grad(x) * 1e-9

    t_agg = time_chained(agg_step, x0, iters)
    frac = min(t_agg / t_step, 1.0) if t_step > 0 else 0.0
    return {"step_s": t_step, "aggregation_s": t_agg,
            "aggregation_pct": 100.0 * frac}


class EpochTimer:
    """Wall-clock timer of a block (`with timer:`); the caller syncs the
    device inside the block where it times device work."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)
