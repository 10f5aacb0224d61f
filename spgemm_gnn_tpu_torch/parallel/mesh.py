"""The port's meshes (counterpart of `spgemm_gnn_tpu/parallel/mesh.py`).

In the JAX package a mesh is a 1-D `jax.sharding.Mesh` over D devices on
the axis "graph". The port has two forms.

- `Mesh`, in one process: D shards of the graph over one torch device.
  Node arrays stay global tensors [n_pad, ...], shard d owns rows
  [d·nps, (d + 1)·nps), each shard's aggregation runs its own plans, and
  the exchange rounds are index copies between the shards' row blocks on
  that device. This is the counterpart of the JAX tests' 8 virtual CPU
  devices; on the card all D shards share the one GPU.
- `RankMesh`, one shard a rank (parallel/multihost.py): the JAX layout
  with one device a process. Shard index = the rank's index in its "graph"
  process group, `num_shards` = the group's size; node arrays are the
  rank's nps rows, and the exchange and the reductions are collectives of
  the group. Where the backend is gloo and the rank's device is CUDA
  (ranks that share a GPU), every collective is staged explicitly: device
  to pinned host memory, the stream synchronised, the collective, host to
  device. `stats` counts each kind of collective's calls, bytes on the
  wire, bytes staged and host milliseconds (the staging included).

`make_mesh(n)` gives a RankMesh where a process group of more than one
rank runs (then n must be its size), else a Mesh.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import torch
import torch.distributed as dist

from spgemm_gnn_tpu_torch.utils import spans
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


@dataclasses.dataclass(frozen=True, eq=False)
class RankMesh:
    """One graph shard a rank (module docstring).

    Attributes:
      num_shards, shard: the "graph" row's size and this rank's index in it.
      device: this rank's device.
      ranks: the row's global ranks in shard order.
      group: the row's process group (None for a row of one rank: every
          collective is then the identity).
      dp, dp_ranks, dp_group: the "dp" column's size, global ranks and
          group (a hybrid mesh, parallel/multihost.py::make_hybrid_mesh).
      stats: per collective kind, "<kind>_calls", "<kind>_bytes" (sent),
          "<kind>_staged_bytes" (device to host and back) and "<kind>_ms".
    """
    num_shards: int
    shard: int
    device: torch.device
    ranks: tuple
    group: Any = None
    dp: int = 1
    dp_ranks: tuple = ()
    dp_group: Any = None
    axis: str = "graph"
    dp_axis: str = "dp"
    stats: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    @property
    def shape(self) -> dict:
        return {self.dp_axis: self.dp, self.axis: self.num_shards}

    @property
    def backend(self) -> str | None:
        return None if self.group is None else dist.get_backend(self.group)

    @property
    def staged(self) -> bool:
        """Whether collectives stage CUDA tensors through host memory."""
        return self.device.type == "cuda" and self.backend == "gloo"

    def __str__(self) -> str:
        return (f"mesh of {self.num_shards} shards, one a rank (shard "
                f"{self.shard} on {self.device}, {self.backend})")

    # -- staging ---------------------------------------------------------------

    def _sync(self) -> None:
        spans.count("host_syncs")
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _to_host(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Pinned host copies of CUDA tensors where staged (the stream is
        synchronised before they are read), else the tensors."""
        if not self.staged:
            return tensors
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in tensors]
        for h, t in zip(hosts, tensors):
            h.copy_(t, non_blocking=True)
        self._sync()
        return hosts

    def _empty(self, shape, dtype) -> torch.Tensor:
        """A receive buffer: pinned host memory where staged."""
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True) if self.staged else t

    def _record(self, kind: str, sent: int, staged: int, t0: float) -> None:
        if self.staged:
            self._sync()      # the host-to-device copies count too
        self.stats[f"{kind}_calls"] += 1
        self.stats[f"{kind}_bytes"] += sent
        self.stats[f"{kind}_staged_bytes"] += staged
        self.stats[f"{kind}_ms"] += (time.perf_counter() - t0) * 1e3

    def _start(self) -> float:
        """The clock after the work queued before the collective (which
        its staging would wait for) is done."""
        if self.staged:
            self._sync()
        return time.perf_counter()

    # -- collectives -----------------------------------------------------------

    def _group_of(self, axis: str | None):
        return self.dp_group if axis == self.dp_axis else self.group

    def all_reduce(self, t: torch.Tensor, kind: str = "all_reduce",
                   axis: str | None = None) -> torch.Tensor:
        """The sum of t over the "graph" row (or the `axis` column), a new
        tensor on t's device, identical on every rank."""
        group = self._group_of(axis)
        if group is None:
            return t.clone()
        t0 = self._start()
        nbytes = t.numel() * t.element_size()
        (h,) = self._to_host([t.contiguous()])
        if h is t:
            h = t.clone()
        dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
        out = self._to_device(h)
        self._record(kind, nbytes, 2 * nbytes if self.staged else 0, t0)
        return out

    def all_gather(self, t: torch.Tensor, kind: str = "all_gather"
                   ) -> torch.Tensor:
        """The row's tensors concatenated on dim 0 in shard order."""
        if self.group is None:
            return t.clone()
        t0 = self._start()
        nbytes = t.numel() * t.element_size()
        (h,) = self._to_host([t.contiguous()])
        parts = [self._empty(h.shape, h.dtype)
                 for _ in range(self.num_shards)]
        dist.all_gather(parts, h, group=self.group)
        out = self._to_device(torch.cat(parts))
        self._record(kind, nbytes, (1 + self.num_shards) * nbytes
                     if self.staged else 0, t0)
        return out

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """t overwritten, in place, with shard 0's."""
        if self.group is None:
            return t
        t0 = self._start()
        (h,) = self._to_host([t.contiguous()])
        dist.broadcast(h, src=self.ranks[0], group=self.group)
        if h is not t:
            t.copy_(h, non_blocking=self.staged)
        nbytes = t.numel() * t.element_size()
        self._record("broadcast", nbytes, 2 * nbytes if self.staged else 0,
                     t0)
        return t

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def exchange(self, payloads: list[torch.Tensor], sizes: list,
                 reverse: bool = False, kind: str = "exchange"
                 ) -> list[torch.Tensor]:
        """The halo rounds: payload rows laid out round by round (round i:
        sizes[i] = (s, M_s), M_s rows) go to shard + s (mod D) and as many
        come from shard - s, in the same layout; `reverse` sends to
        shard - s and receives from shard + s (the transposed rounds).
        Every round is posted by every rank, so a rank whose rows are all
        padding still matches its peers. Returns the received tensors."""
        d, sign = self.num_shards, -1 if reverse else 1
        t0 = self._start()
        sends = self._to_host([p.contiguous() for p in payloads])
        recvs = [self._empty(p.shape, p.dtype) for p in sends]
        ops, lo = [], 0
        for i, (s, rows) in enumerate(sizes):
            to = self.ranks[(self.shard + sign * s) % d]
            frm = self.ranks[(self.shard - sign * s) % d]
            for j, (snd, rcv) in enumerate(zip(sends, recvs)):
                tag = i * len(sends) + j
                ops.append(dist.P2POp(dist.isend, snd[lo:lo + rows], to,
                                      self.group, tag))
                ops.append(dist.P2POp(dist.irecv, rcv[lo:lo + rows], frm,
                                      self.group, tag))
            lo += rows
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        out = [self._to_device(r) for r in recvs]
        nbytes = sum(p.numel() * p.element_size() for p in sends)
        self._record(kind, nbytes, 2 * nbytes if self.staged else 0, t0)
        return out


class AllReduce(torch.autograd.Function):
    """The sum over a RankMesh's row, differentiable: each rank's input
    feeds every rank's output, so the gradient is the sum of the ranks'
    output gradients."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.all_reduce(t)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.mesh.all_reduce(grad, kind="all_reduce_bwd"), None


class AllGather(torch.autograd.Function):
    """The row's tensors concatenated in shard order, differentiable: the
    gradient of this rank's block is its rows of the summed output
    gradients."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
        ctx.mesh, ctx.rows = mesh, t.shape[0]
        return mesh.all_gather(t)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh, rows = ctx.mesh, ctx.rows
        total = mesh.all_reduce(grad, kind="all_gather_bwd")
        return total[mesh.shard * rows:(mesh.shard + 1) * rows], None


def world() -> tuple[int, int]:
    """(rank, world size): (0, 1) where no process group is running."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(n_shards: int = 1, device: str | torch.device | None = None,
              axis: str = "graph") -> Mesh | RankMesh:
    """A 1-D mesh of n_shards graph shards: one a rank where a process
    group of more than one rank runs (n_shards must then be its size;
    parallel/multihost.py::make_hybrid_mesh for a ("dp", "graph") grid),
    else all on `device` in this process (the card unless the caller asks
    for the CPU)."""
    if n_shards < 1:
        raise ValueError(f"a mesh needs at least one shard; got {n_shards}")
    size = world()[1]
    if size > 1:
        if n_shards != size:
            raise ValueError(
                f"--mesh_shape {n_shards} with {size} processes: one graph "
                f"shard a rank needs a mesh of {size} shards")
        from spgemm_gnn_tpu_torch.parallel.multihost import make_hybrid_mesh
        return make_hybrid_mesh(dcn=1, ici=size, ici_axis=axis,
                                device=device)
    return Mesh(n_shards, resolve_device(device), axis)


def rank_rows(g) -> tuple[RankMesh, int, int] | None:
    """(mesh, first row, padded rows) where the graph `g` is one rank's
    shard of a RankMesh (its node arrays are rows [first, first + nps) of
    the padded_nodes rows), else None."""
    mesh = getattr(g, "mesh", None)
    if not isinstance(mesh, RankMesh):
        return None
    return mesh, mesh.shard * g.nodes_per_shard, g.padded_nodes
