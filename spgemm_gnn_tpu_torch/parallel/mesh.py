"""The port's mesh (counterpart of `spgemm_gnn_tpu/parallel/mesh.py`).

In the JAX package a mesh is a 1-D `jax.sharding.Mesh` over D devices on
the axis "graph". In the port, in one process, a mesh is D shards of the
graph over one torch device: node arrays stay global tensors [n_pad, ...],
shard d owns rows [d·nps, (d + 1)·nps), each shard's aggregation runs its
own plans, and the exchange rounds are index copies between the shards'
row blocks on that device. This is the counterpart of the JAX tests' 8
virtual CPU devices; on the card all D shards share the one GPU. One GPU a
shard, one process a rank, is ROADMAP Queue A13b.
"""
from __future__ import annotations

import dataclasses

import torch

from spgemm_gnn_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """D shards of the graph over one device, on the axis `axis`."""
    num_shards: int
    device: torch.device
    axis: str = "graph"

    def __str__(self) -> str:
        return (f"mesh of {self.num_shards} shards on {self.device}, one "
                f"process")


def make_mesh(n_shards: int = 1, device: str | torch.device | None = None,
              axis: str = "graph") -> Mesh:
    """A 1-D mesh of n_shards graph shards on `device` (the card unless the
    caller asks for the CPU)."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard; got {n_shards}")
    return Mesh(n_shards, resolve_device(device), axis)
