"""Weights and training state carried across from the JAX package.

`params_from_flax` turns a flax parameter tree (nested mappings of arrays,
e.g. `jax.device_get(variables["params"])`) into a PyTorch `state_dict` for
the port's model of the same family; `buffers_from_flax` does the same for
the `batch_stats` collection (GNNRes's BatchNorm). `checkpoint_from_flax`
turns a whole JAX Trainer state (params, batch_stats, the optax Adam
moments and count, Lookahead's slow params, step) into the port's
checkpoint dict (train/checkpoint.py), so a JAX run resumes in the port.
All read plain arrays and import no JAX.

  Dense   kernel [in, out] → <module>.weight [out, in];  bias → bias
  LayerNorm_0  scale → norm.weight;  bias → norm.bias
  LayerNorm / BatchNorm  scale → weight;  bias → bias
  scalars and vectors of a model (eps{i}, conv_b{i}) → the same names
  batch_stats  mean → running_mean;  var → running_var
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_MODULE_NAMES = {"LayerNorm_0": "norm"}
_LEAF_NAMES = {"kernel": "weight", "scale": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def buffers_from_flax(batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """flax batch_stats tree → the running statistics of the port's
    BatchNorm modules (a partial state_dict, f32 tensors)."""
    return {".".join((module, _STAT_NAMES[name])):
            torch.from_numpy(np.array(value, dtype=np.float32))
            for module, stats in batch_stats.items()
            for name, value in stats.items()}


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """flax params tree → state_dict (f32 tensors)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: tuple[str, ...]) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, prefix + (_MODULE_NAMES.get(name, name),))
                continue
            a = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                a = a.T
            key = ".".join(prefix + (_LEAF_NAMES.get(name, name),))
            # a copy: arrays fetched from a device are read-only
            out[key] = torch.from_numpy(np.array(a, order="C"))

    walk(tree, ())
    return out


def _find_state(node, field: str):
    """The first optax state (a NamedTuple) with `field` in a nest of
    tuples, or None."""
    if isinstance(node, tuple):
        if field in getattr(node, "_fields", ()):
            return node
        for child in node:
            found = _find_state(child, field)
            if found is not None:
                return found
    return None


def checkpoint_from_flax(state: Mapping) -> dict:
    """A JAX Trainer state as host arrays (`jax.device_get(state)`: params,
    batch_stats, opt_state, step) → the port's checkpoint dict, to save
    with `train.checkpoint.save_checkpoint` and resume from. The optax
    Adam state (ScaleByAdamState: count, mu, nu) maps to Adam's step count
    and moments, a LookaheadState's slow params and step to Lookahead's.
    The dropout generator's state is left out (None): a run resumed from it
    restarts the dropout stream at seed + 1, as the JAX Trainer does."""
    opt_state = state["opt_state"]
    adam = _find_state(opt_state, "mu")
    if adam is None:
        raise ValueError("no optax Adam state (mu, nu, count) in opt_state")
    la = _find_state(opt_state, "slow")
    return {
        "params": params_from_flax(state["params"]),
        "batch_stats": buffers_from_flax(state.get("batch_stats") or {}),
        "mu": params_from_flax(adam.mu),
        "nu": params_from_flax(adam.nu),
        "count": int(np.asarray(adam.count)),
        "slow": None if la is None else params_from_flax(la.slow),
        "lookahead_step": 0 if la is None else int(np.asarray(la.step)),
        "step": int(np.asarray(state["step"])),
        "dropout_rng": None,
    }
