"""Checkpoints of the Trainer's state (counterpart of
`spgemm_gnn_tpu/train/checkpoint.py`), with `torch.save` in place of orbax.

Layout, the JAX package's: `<path>/checkpoints/<step>/state.pt`, and
`<path>/checkpoints/best/state.pt` for the best-val snapshot.

A checkpoint is a dict of tensors and ints (`snapshot`):
  params        {name: tensor} — the model's parameters;
  batch_stats   {name: tensor} — its buffers (GNNRes's BatchNorm statistics);
  mu, nu        {name: tensor} — Adam's moments (empty before the first step);
  count         int — Adam's step count;
  slow          {name: tensor} or None — Lookahead's slow weights;
  lookahead_step int — Lookahead's step count;
  step          int — the epochs trained;
  dropout_rng   uint8 tensor or None — the dropout generator's state.
`snapshot` copies every tensor, so a snapshot taken at the best epoch keeps
that epoch's values while training moves on. `load_snapshot` writes one into
a live state in place (the optimizer keeps its parameters).
"""
from __future__ import annotations

import os
from typing import Any

import torch

from spgemm_gnn_tpu_torch.train.optim import Lookahead

FILE = "state.pt"


def _ckpt_dir(path: str) -> str:
    return os.path.abspath(os.path.join(path, "checkpoints"))


def _adam(opt) -> torch.optim.Optimizer:
    return opt.inner if isinstance(opt, Lookahead) else opt


def _names(model: torch.nn.Module) -> dict[int, str]:
    return {id(p): n for n, p in model.named_parameters()}


def snapshot(state: dict[str, Any]) -> dict[str, Any]:
    """A detached copy of a Trainer state ({"model", "optimizer", "step"},
    and "dropout_rng", a torch.Generator, where the run has one)."""
    model, opt = state["model"], state["optimizer"]
    names = _names(model)
    mu, nu, count = {}, {}, 0
    for p, s in _adam(opt).state.items():
        mu[names[id(p)]] = s["exp_avg"].detach().clone()
        nu[names[id(p)]] = s["exp_avg_sq"].detach().clone()
        count = int(s["step"])
    slow, la_step = None, 0
    if isinstance(opt, Lookahead):
        slow = {names[id(p)]: w.detach().clone()
                for p, w in zip(opt.params, opt.slow)}
        la_step = opt.steps
    gen = state.get("dropout_rng")
    return {
        "params": {n: p.detach().clone()
                   for n, p in model.named_parameters()},
        "batch_stats": {n: b.detach().clone()
                        for n, b in model.named_buffers()},
        "mu": mu, "nu": nu, "count": count,
        "slow": slow, "lookahead_step": la_step,
        "step": int(state["step"]),
        "dropout_rng": None if gen is None else gen.get_state(),
    }


@torch.no_grad()
def load_snapshot(state: dict[str, Any], snap: dict[str, Any]
                  ) -> dict[str, Any]:
    """Write `snap` into the live `state` in place and return it."""
    model, opt = state["model"], state["optimizer"]
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    if params.keys() != snap["params"].keys():
        raise ValueError(f"checkpoint parameters {sorted(snap['params'])} do "
                         f"not match the model's {sorted(params)}")
    for n, p in params.items():
        p.copy_(snap["params"][n])
    for n, b in buffers.items():
        b.copy_(snap["batch_stats"][n])
    adam = _adam(opt)
    adam.state.clear()
    # Adam keeps its step count as a CPU scalar of this dtype
    step_dtype = (torch.float64 if torch.get_default_dtype() == torch.float64
                  else torch.float32)
    for n, p in params.items():
        if n in snap["mu"]:
            adam.state[p] = {
                "step": torch.tensor(float(snap["count"]), dtype=step_dtype),
                "exp_avg": snap["mu"][n].to(p.device, p.dtype).clone(),
                "exp_avg_sq": snap["nu"][n].to(p.device, p.dtype).clone()}
    if isinstance(opt, Lookahead):
        if snap["slow"] is None:
            raise ValueError("the checkpoint has no Lookahead state")
        names = _names(model)
        for p, w in zip(opt.params, opt.slow):
            w.copy_(snap["slow"][names[id(p)]])
        opt.steps = int(snap["lookahead_step"])
    state["step"] = int(snap["step"])
    gen = state.get("dropout_rng")
    if gen is not None and snap.get("dropout_rng") is not None:
        gen.set_state(snap["dropout_rng"].cpu())
    return state


def save_checkpoint(path: str, state: dict[str, Any], step: int,
                    is_best: bool = False) -> str:
    """Save `state` (a Trainer state, or a `snapshot`) under
    <path>/checkpoints/<step>, and under /best too if `is_best`. Returns the
    step's directory."""
    base = _ckpt_dir(path)
    snap = state if "params" in state else snapshot(state)
    targets = [os.path.join(base, str(step))]
    if is_best:
        targets.append(os.path.join(base, "best"))
    for t in targets:
        os.makedirs(t, exist_ok=True)
        tmp = os.path.join(t, f"{FILE}.{os.getpid()}.tmp")
        torch.save(snap, tmp)
        os.replace(tmp, os.path.join(t, FILE))   # atomic
    return targets[0]


def _resolve(path_or_dir: str) -> str:
    """A checkpoint directory: the one given, or under a run directory its
    latest numeric step (else `best`)."""
    base = _ckpt_dir(path_or_dir)
    if os.path.isdir(base):
        steps = [d for d in os.listdir(base) if d.isdigit()]
        if steps:
            return os.path.join(base, max(steps, key=int))
        if os.path.isdir(os.path.join(base, "best")):
            return os.path.join(base, "best")
        raise FileNotFoundError(f"no checkpoints under {base}")
    return path_or_dir


def read_checkpoint(path_or_dir: str,
                    map_location: str | torch.device = "cpu"
                    ) -> dict[str, Any]:
    """The checkpoint dict at a checkpoint directory or a run directory
    (its latest step), its tensors on `map_location`."""
    return torch.load(os.path.join(_resolve(path_or_dir), FILE),
                      map_location=map_location, weights_only=True)


def restore_checkpoint(path_or_dir: str, target: dict[str, Any]
                       ) -> dict[str, Any]:
    """Restore into the Trainer state `target` (in place; returned). Takes a
    checkpoint directory, a run directory (its latest step), or a run's
    `checkpoints/best`."""
    dev = next(target["model"].parameters()).device
    return load_snapshot(target, read_checkpoint(path_or_dir, dev))


def latest_step(path: str) -> int | None:
    base = _ckpt_dir(path)
    if not os.path.isdir(base):
        return None
    steps = [int(d) for d in os.listdir(base) if d.isdigit()]
    return max(steps) if steps else None
