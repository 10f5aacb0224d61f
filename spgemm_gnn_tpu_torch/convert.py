"""Weights carried across from the JAX package.

`params_from_flax` turns a flax parameter tree (nested mappings of arrays,
e.g. `jax.device_get(variables["params"])`) into a PyTorch `state_dict` for
the port's model of the same family. It reads plain arrays and imports no
JAX.

  Dense   kernel [in, out] → <module>.weight [out, in];  bias → bias
  LayerNorm_0  scale → norm.weight;  bias → norm.bias
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

_MODULE_NAMES = {"LayerNorm_0": "norm"}
_LEAF_NAMES = {"kernel": "weight", "scale": "weight"}


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
