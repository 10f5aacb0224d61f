"""Weights carried across from the JAX package.

`params_from_flax` turns a flax parameter tree (nested mappings of arrays,
e.g. `jax.device_get(variables["params"])`) into a PyTorch `state_dict` for
the port's model of the same family; `buffers_from_flax` does the same for
the `batch_stats` collection (GNNRes's BatchNorm). Both read plain arrays and
import no JAX.

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
