"""Aggregation over a mesh through the plan kernels, with the boundary-halo
exchange (counterpart of `spgemm_gnn_tpu/parallel/planned_sharded.py`).

Layout, as the JAX package's: the graph is partitioned by contiguous
destination-node blocks of nps rows (`nodes_per_shard`, a multiple of
`dst_block`), and each shard's in-edges split into
- local edges (source owned by the shard): aggregated from the shard's own
  block, no exchange;
- halo edges (source owned by shard o != c): only the boundary set B(o→c),
  the distinct rows of o that consumer c reads, is exchanged, in D-1 rounds
  (round s: every owner o sends to o + s mod D). Each round is padded to
  the largest boundary of its own D pairs (a multiple of MIN_HALO), empty
  rounds are skipped, and shard c's halo kernel runs on the compact source
  space of the rounds' rows in round order (`halo_round_sizes`).

Each shard holds a rectangular plan pair per edge class (its four roles:
fwd_local, bwd_local, fwd_halo, bwd_halo): y[:nps] = A·x over sources that
are not its rows, and the transpose pair for the backward. A role's kind,
"windowed" (`csr_spmm`) or "stream" (`stream_spmm`), is the JAX package's
rule on the role's average shard (`_choose_kind`), shared by every shard.
The pairs go through `kernels/planned.py::Aggregate` with no k and no ids,
as the JAX package's shard pairs take no k: the CBSR forward and the
sampled backward stay off this path, and the values follow the reference's
dense pair.

In one process (parallel/mesh.py::Mesh) the exchange is an index copy:
shard c's halo is `index_select` of the global rows its rounds deliver, in
round order (`recv_idx`). With k < dim (a MaxK input) the payload is the
CBSR pair of the scaled rows, as the JAX package's: `cbsr_compact` (B7) on
the rows, the k values (optionally in `halo_dtype`, bf16 on the wire) and
the channel ids packed dim-aware (`ops/maxk.py::pack_channels`: uint8×4 a
word up to dim 256, uint16×2 above), densified on arrival. The backward is
autograd: the halo gather transposes to a boundary-sized `index_add_`, as
the JAX package's transposed `ppermute` does.

One shard a rank (parallel/mesh.py::RankMesh, the JAX layout with one
device a process): the rank holds its own rows, its own plan of each role
and its row of each live round's send schedule (`send_rows`), and the
exchange is `HaloExchange`, the rounds as point-to-point messages of the
rank's "graph" group (round s: to shard + s, from shard - s), the payload
and the rounding points those of the index copy. Its backward is the
transposed rounds: each rank sends the cotangent of the rows it received
back to their owner, which `index_add_`s them into the gradient of what it
sent, consumers in ascending shard order (the order of the index copy's
backward on the CPU, so that the gradients agree bit for bit there).

The host build (`_shard_host`) is numpy, mesh-free and disk-cacheable
(graphs/plan_cache.py::cached_shard_host). Of the JAX package's geometry
arguments, `dst_block` aligns nps (so `padded_nodes`, `send_idx` and the
round sizes are the JAX package's), `src_block` (default 256) and `window`
(default the auto window) feed the kind rule only. `tile_slots` is the TPU
tiles' slot count, which the card's plans do not have: it is no argument
here, and the cache key writes the JAX package's default in its place
(`TILE_SLOTS`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spgemm_gnn_tpu_torch.graphs import native, plan_cache
from spgemm_gnn_tpu_torch.graphs.csr import Graph
from spgemm_gnn_tpu_torch.graphs.tiles import (auto_window,
                                               predicted_windowed_fill)
from spgemm_gnn_tpu_torch.kernels.cbsr import CBSRCompact
from spgemm_gnn_tpu_torch.kernels.planned import (KIND_SRC_BLOCK,
                                                  WINDOWED_FILL_CUTOVER,
                                                  Aggregate, build_plan,
                                                  row_elem)
from spgemm_gnn_tpu_torch.ops.maxk import (cbsr_to_dense,
                                           packed_channel_words,
                                           pack_channels, unpack_channels)
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.ops.spmm import _scale
from spgemm_gnn_tpu_torch.parallel.mesh import Mesh, RankMesh
from spgemm_gnn_tpu_torch.parallel.sharded import padded_degrees

MIN_HALO = 8    # floor on a round's padded boundary (the JAX package's)
# the JAX package's default TPU tile slot count, the S of the cache key
TILE_SLOTS = 1024
ROLES = ("fwd_local", "bwd_local", "fwd_halo", "bwd_halo")


# ---------------------------------------------------------------------------
# host-side build
# ---------------------------------------------------------------------------

def _choose_kind(rows: int, avg_edges: float, src_block: int, num_src: int,
                 window: int | None) -> str:
    """The JAX package's kind rule for a shard's plan of `rows` rows over
    `num_src` sources: the predicted fill of the TPU's windowed plan."""
    rw = window or auto_window(rows, int(avg_edges), src_block,
                               num_src_nodes=num_src)
    est = predicted_windowed_fill(rows, int(avg_edges), src_block, num_src,
                                  rw)
    return "windowed" if est >= WINDOWED_FILL_CUTOVER else "stream"


def _csr_from_pairs(dst: np.ndarray, src: np.ndarray, num_rows: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """CSR (indptr int64 [R + 1], indices int32) over rows dst of the
    unsorted (dst, src) pairs, sorted by (dst, src): the native graph core
    where it is built (graphs/native.py), else numpy's lexsort, the same
    arrays bit for bit."""
    if native.available() and len(dst):
        res = native.build_csr(src, dst, num_rows)
        if res is not None:
            return res[0].astype(np.int64), res[1]
    order = np.lexsort((src, dst))
    dst_o, src_o = dst[order], src[order]
    ptr = np.zeros(num_rows + 1, np.int64)
    np.add.at(ptr, dst_o + 1, 1)
    np.cumsum(ptr, out=ptr)
    return ptr, src_o.astype(np.int32)


def _build_role(csrs: list[tuple[np.ndarray, np.ndarray]], rows: int,
                num_src: int, *, src_block: int | None,
                window: int | None) -> dict:
    """One role: its kind (the rule on the average shard's edges) and each
    shard's CSR, in the mesh-free host form {"kind", "statics", "arrays"}
    that the plan cache stores."""
    total_e = sum(int(p[-1]) for p, _ in csrs)
    avg_e = total_e / max(len(csrs), 1)
    kind = _choose_kind(rows, avg_e, src_block or KIND_SRC_BLOCK, num_src,
                        window)
    arrays = {}
    for i, (p, ix) in enumerate(csrs):
        arrays[f"indptr{i}"] = p
        arrays[f"indices{i}"] = ix
    return {"kind": kind,
            "statics": dict(rows=rows, num_src=num_src, shards=len(csrs)),
            "arrays": arrays}


def _shard_host(g: Graph, d: int, *, src_block: int | None, dst_block: int,
                window: int | None) -> dict:
    """The mesh-free host build: partition by destination blocks, split the
    local and halo edges, the boundary sets and their send schedule, and
    each role's per-shard CSR. `nodes_per_shard`, `halo_round_sizes`,
    `boundary_rows`, every `send_idx` array and each role's CSRs are the
    JAX package's `_shard_host`'s bit for bit. Returns plain numpy arrays
    and statics (module docstring for the geometry arguments)."""
    nps = -(-g.num_nodes // d)
    nps = -(-nps // dst_block) * dst_block      # align a shard to R
    n_pad = nps * d
    host = g.host_arrays()
    indptr = host["indptr"].astype(np.int64)
    indices = host["indices"].astype(np.int64)

    # per consumer: the local and halo edges, and its boundary sources
    # (sorted, so owner-contiguous: per-owner offsets by searchsorted)
    loc_pairs, halo_raw, uniq_per_c = [], [], []
    bnd_sizes = np.zeros((d, d), np.int64)   # |B(owner -> consumer)|
    empty = np.zeros(0, np.int64)
    for c in range(d):
        lo, hi = c * nps, min((c + 1) * nps, g.num_nodes)
        if lo >= g.num_nodes:            # a shard past N: no rows, no edges
            loc_pairs.append((empty, empty))
            halo_raw.append((empty, empty))
            uniq_per_c.append((empty, np.zeros(d + 1, np.int64)))
            continue
        src = indices[indptr[lo]:indptr[hi]]
        dst = np.repeat(np.arange(lo, hi, dtype=np.int64),
                        np.diff(indptr[lo:hi + 1]))
        local = (src >= lo) & (src < lo + nps)
        loc_pairs.append((dst[local] - lo, src[local] - lo))
        halo_raw.append((dst[~local] - lo, src[~local]))
        uniq = np.unique(src[~local])
        starts = np.searchsorted(uniq, np.arange(d + 1) * nps)
        uniq_per_c.append((uniq, starts))
        bnd_sizes[:, c] = np.diff(starts)
    boundary_rows = int(bnd_sizes.sum())

    # round s pads to the largest of its own d pairs; empty rounds vanish
    round_sizes = []
    for s in range(1, d):
        mx = int(max(bnd_sizes[o, (o + s) % d] for o in range(d)))
        round_sizes.append(-(-mx // MIN_HALO) * MIN_HALO if mx else 0)
    round_base = np.zeros(d, np.int64)
    if round_sizes:
        round_base[1:] = np.cumsum(round_sizes)

    # owner o sends B(o -> c) at round s = (c - o) mod d, in local ids
    send_idx = []
    for s in range(1, d):
        ms = round_sizes[s - 1]
        if ms == 0:
            continue
        arr = np.zeros((d, ms), np.int32)
        for o in range(d):
            uniq, starts = uniq_per_c[(o + s) % d]
            seg = uniq[starts[o]:starts[o + 1]]
            arr[o, :len(seg)] = seg - o * nps
        send_idx.append(arr)

    # halo sources into the compact receive space: a row from the round-s
    # owner lands at round_base[s - 1] + its rank within B(o -> c)
    rank_of = np.empty(n_pad, np.int64)
    halo_pairs = []
    for c in range(d):
        r_dst, r_src = halo_raw[c]
        if len(r_src):
            uniq, starts = uniq_per_c[c]
            rank_of[uniq] = np.arange(len(uniq), dtype=np.int64)
            owners = r_src // nps
            s = (c - owners) % d
            compact = round_base[s - 1] + (rank_of[r_src] - starts[owners])
        else:
            compact = np.zeros_like(r_src)
        halo_pairs.append((r_dst, compact))

    halo_src_space = max(int(round_base[-1]), MIN_HALO)
    kw = dict(src_block=src_block, window=window)
    fwd_local = _build_role(
        [_csr_from_pairs(dl, sl, nps) for dl, sl in loc_pairs], nps, nps,
        **kw)
    # a symmetric graph's local edges are symmetric within each shard, so
    # the backward local CSR is the forward one: one role for both
    bwd_local = fwd_local if g.symmetric else _build_role(
        [_csr_from_pairs(sl, dl, nps) for dl, sl in loc_pairs], nps, nps,
        **kw)
    fwd_halo = bwd_halo = None
    if d > 1 and any(len(p[0]) for p in halo_pairs):
        fwd_halo = _build_role(
            [_csr_from_pairs(dl, sc, nps) for dl, sc in halo_pairs], nps,
            halo_src_space, **kw)
        bwd_halo = _build_role(
            [_csr_from_pairs(sc, dl, halo_src_space)
             for dl, sc in halo_pairs], halo_src_space, nps, **kw)
    return {"roles": {"fwd_local": fwd_local,
                      "bwd_local": "=fwd_local" if g.symmetric else bwd_local,
                      "fwd_halo": fwd_halo, "bwd_halo": bwd_halo},
            "send_idx": send_idx,
            "statics": dict(num_nodes=g.num_nodes, num_edges=g.num_edges,
                            nodes_per_shard=nps,
                            halo_round_sizes=list(round_sizes),
                            boundary_rows=boundary_rows)}


# ---------------------------------------------------------------------------
# the device-side graph
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedPlannedGraph:
    """An edge-partitioned graph, each shard's plan pairs and the halo
    exchange's schedule, on the mesh's device.

    Attributes:
      fwd_local, bwd_local, fwd_halo, bwd_halo: per role a tuple of D plans
          (CSRPlan or StreamPlan, one kind a role), the halo roles None
          where no edge crosses a shard; bwd_local is fwd_local on a
          symmetric graph.
      kinds: each present role's kind.
      recv_idx: int64 [D · H] (H = Σ M_s, 0 without a halo): the global
          rows each shard's halo gathers, shard by shard, rounds in order
          (the host build's `send_idx`: owner o's local rows a round).
      in_degrees / out_degrees: int32 [n_pad].
      halo_round_sizes: M_s per round s = 1..D-1 (0: the round is skipped).
      boundary_rows: Σ |B(o -> c)|, the real boundary rows.

    On a RankMesh (one shard a rank) each role's tuple holds the rank's
    plan only, the degrees are the rank's nps rows, `recv_idx` is empty,
    and `send_rows` holds the rank's local rows of each live round (int64
    [M_s] each, in round order).
    """
    fwd_local: tuple
    bwd_local: tuple
    fwd_halo: tuple | None
    bwd_halo: tuple | None
    kinds: dict
    recv_idx: torch.Tensor
    in_degrees: torch.Tensor
    out_degrees: torch.Tensor
    num_nodes: int
    num_edges: int
    nodes_per_shard: int
    halo_round_sizes: tuple
    boundary_rows: int
    mesh: Mesh | RankMesh
    send_rows: tuple = ()

    @property
    def num_shards(self) -> int:
        return self.mesh.num_shards

    @property
    def live_rounds(self) -> list[tuple[int, int]]:
        """(s, M_s) of each round that runs, in order."""
        return [(s, m) for s, m in enumerate(self.halo_round_sizes, 1) if m]

    @property
    def padded_nodes(self) -> int:
        return self.nodes_per_shard * self.num_shards

    def comm_stats(self, dim: int, k: int | None = None,
                   value_bytes: int = 4) -> dict:
        """A layer's exchange volume against the full all-gather (the JAX
        package's dict, key for key). value_bytes: 2 where the CBSR values
        ride bf16 (`halo_dtype`)."""
        d = self.num_shards
        row_bytes = (value_bytes * dim if k is None
                     else value_bytes * k + packed_channel_words(k, dim) * 4)
        rows_padded = d * sum(self.halo_round_sizes)
        halo_bytes = rows_padded * row_bytes
        full_bytes = d * self.padded_nodes * (4 * dim if k is None
                                              else 4 * k + 4 * k)
        return {"halo_rows_padded": rows_padded,
                "boundary_rows": self.boundary_rows,
                "exchange_bytes": halo_bytes,
                "boundary_bytes": self.boundary_rows * row_bytes,
                "padding_ratio": rows_padded / max(self.boundary_rows, 1),
                "full_gather_bytes": full_bytes,
                "ratio_vs_full_gather": halo_bytes / max(full_bytes, 1)}


def _device_int32(a: np.ndarray, device) -> torch.Tensor:
    # a copy: cached arrays are read-only memory maps
    return torch.from_numpy(np.array(a, np.int32)).to(device)


def _role_plans(role: dict, device, dim: int | None, elem: int,
                shards) -> tuple:
    st = role["statics"]
    return tuple(
        build_plan(_device_int32(role["arrays"][f"indptr{i}"], device),
                   _device_int32(role["arrays"][f"indices{i}"], device),
                   role["kind"], num_src=st["num_src"], dim=dim, elem=elem)
        for i in shards)


def _recv_idx(send_idx: list, round_sizes: list, d: int, nps: int
              ) -> np.ndarray:
    """Shard c's halo rows, global ids: round by round in order, the rows
    owner (c - s) mod d sends it."""
    live = [s for s in range(1, d) if round_sizes[s - 1] > 0]
    per_c = [[(c - s) % d * nps + send_idx[ri][(c - s) % d].astype(np.int64)
              for ri, s in enumerate(live)] for c in range(d)]
    if not live:
        return np.zeros(0, np.int64)
    return np.concatenate([np.concatenate(p) for p in per_c])


def _shard_host_to_device(host: dict, g: Graph, mesh: Mesh,
                          dim: int | None, dtype: torch.dtype
                          ) -> ShardedPlannedGraph:
    """The device graph of the host build: every shard's plans on a Mesh;
    on a RankMesh the rank's own plan of each role, its degrees and its
    send rows."""
    dev, d = mesh.device, mesh.num_shards
    st = host["statics"]
    elem = row_elem(dtype)
    on_rank = isinstance(mesh, RankMesh)
    shards = [mesh.shard] if on_rank else range(d)
    plans, kinds = {}, {}
    for name in ROLES:
        role = host["roles"][name]
        if isinstance(role, str):       # "=fwd_local": the alias
            plans[name] = plans["fwd_local"]
        elif role is not None:
            plans[name] = _role_plans(role, dev, dim, elem, shards)
        else:
            plans[name] = None
        if plans[name] is not None:
            kinds[name] = plans[name][0].kind
    nps = st["nodes_per_shard"]
    in_deg, out_deg = padded_degrees(g, nps * d, dev)
    if on_rank:
        rows = slice(mesh.shard * nps, (mesh.shard + 1) * nps)
        in_deg, out_deg = in_deg[rows].clone(), out_deg[rows].clone()
        recv_idx = torch.zeros(0, dtype=torch.int64, device=dev)
        send_rows = tuple(
            torch.from_numpy(a[mesh.shard].astype(np.int64)).to(dev)
            for a in host["send_idx"])
    else:
        recv_idx = torch.from_numpy(_recv_idx(
            host["send_idx"], st["halo_round_sizes"], d, nps)).to(dev)
        send_rows = ()
    return ShardedPlannedGraph(
        **plans, kinds=kinds, recv_idx=recv_idx,
        in_degrees=in_deg, out_degrees=out_deg,
        num_nodes=st["num_nodes"], num_edges=st["num_edges"],
        nodes_per_shard=nps,
        halo_round_sizes=tuple(st["halo_round_sizes"]),
        boundary_rows=st["boundary_rows"], mesh=mesh, send_rows=send_rows)


def shard_planned_graph(g: Graph, mesh: Mesh, *,
                        src_block: int | None = None, dst_block: int = 2048,
                        window: int | None = None,
                        cache_dir: str | None = None,
                        dim: int | None = None,
                        dtype: torch.dtype = torch.float32
                        ) -> ShardedPlannedGraph:
    """Partition g over the mesh, split local and halo edges, the boundary
    sets, and each shard's plan pairs (module docstring), on the mesh's
    device. Where `dim` is given, each plan's schedule or hot set is built
    for rows of that width in `dtype` (as `plan_graph(g, dim=...)` does);
    else at the first product of each width.

    cache_dir: where given, the host build is loaded from there, keyed by
    the CSR's fingerprint, the shard count and the geometry (the JAX
    package's key), or built and stored (graphs/plan_cache.py::
    cached_shard_host). On a RankMesh every rank needs the whole host
    build: shard 0 loads or builds and stores it while the others wait at
    a barrier, then they load it (no two ranks write one entry); without
    a cache_dir every rank builds it (the build is deterministic)."""
    d = mesh.num_shards
    kw = dict(src_block=src_block, dst_block=dst_block, window=window)
    if cache_dir:
        host_g = g.host_arrays()
        key = plan_cache.plan_key(
            plan_cache.graph_fingerprint(host_g["indptr"],
                                         host_g["indices"]),
            "shard", f"d{d}", sym=int(g.symmetric), S=TILE_SLOTS,
            B=src_block, R=dst_block, W=window)
        first = not isinstance(mesh, RankMesh) or mesh.shard == 0
        if not first:
            mesh.barrier()
        host = plan_cache.cached_shard_host(cache_dir, key,
                                            lambda: _shard_host(g, d, **kw))
        if first and isinstance(mesh, RankMesh):
            mesh.barrier()
    else:
        host = _shard_host(g, d, **kw)
    return _shard_host_to_device(host, g, mesh, dim, dtype)


# ---------------------------------------------------------------------------
# the aggregation
# ---------------------------------------------------------------------------

def _halo_rows(spg: ShardedPlannedGraph, xs: torch.Tensor, k: int | None,
               halo_dtype: torch.dtype | None) -> torch.Tensor:
    """Every shard's halo, [D, H, dim] in xs's dtype: the rows its rounds
    deliver, dense, or with k < dim as CBSR (values in `halo_dtype` where
    given, channel ids packed dim-aware) densified on arrival."""
    d, dim = spg.num_shards, xs.shape[1]
    if k is not None and k < dim:
        vals, ch = CBSRCompact.apply(xs.contiguous(), k)
        if halo_dtype is not None:
            vals = vals.to(halo_dtype)
        packed = pack_channels(ch, dim)
        v = vals.index_select(0, spg.recv_idx)
        c = unpack_channels(packed.index_select(0, spg.recv_idx), k, dim)
        halo = cbsr_to_dense(v.to(xs.dtype), c, dim)
    else:
        halo = xs.index_select(0, spg.recv_idx)
    return halo.view(d, -1, dim)


class HaloExchange(torch.autograd.Function):
    """The halo rounds of one rank (module docstring): each payload
    [nps, w]'s rows of each live round go to shard + s and the rows of
    shard - s arrive, [H, w] in round order. Integer payloads (the packed
    channel ids) carry no gradient; a floating one's gradient is its
    received cotangent sent back to the owner and `index_add_`ed at the
    rows sent, consumers in ascending shard order."""

    @staticmethod
    def forward(ctx, spg: ShardedPlannedGraph, *payloads: torch.Tensor):
        ctx.spg, ctx.rows = spg, [p.shape[0] for p in payloads]
        ctx.floating = [p.is_floating_point() for p in payloads]
        sends = [torch.cat([p.index_select(0, r) for r in spg.send_rows])
                 for p in payloads]
        outs = spg.mesh.exchange(sends, spg.live_rounds)
        ctx.mark_non_differentiable(
            *(o for o in outs if not o.is_floating_point()))
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        spg = ctx.spg
        mesh, live = spg.mesh, spg.live_rounds
        # an integer output's gradient is autograd's zeros: it goes nowhere
        which = [i for i, f in enumerate(ctx.floating) if f]
        back = mesh.exchange([grads[i] for i in which], live, reverse=True,
                             kind="exchange_bwd")
        offsets = np.cumsum([0] + [m for _, m in live])
        # round s serves consumer shard + s: ascending consumer order
        order = sorted(range(len(live)), key=lambda i: (
            (mesh.shard + live[i][0]) % mesh.num_shards))
        out = [None] * len(grads)
        for i, got in zip(which, back):
            dx = got.new_zeros((ctx.rows[i],) + tuple(got.shape[1:]))
            for ri in order:
                dx.index_add_(0, spg.send_rows[ri],
                              got[offsets[ri]:offsets[ri + 1]])
            out[i] = dx
        return (None, *out)


def _rank_halo(spg: ShardedPlannedGraph, xs: torch.Tensor, k: int | None,
               halo_dtype: torch.dtype | None) -> torch.Tensor:
    """This rank's halo, [H, dim] in xs's dtype: `_halo_rows`'s payload
    and rounding points, through `HaloExchange`."""
    dim = xs.shape[1]
    if k is not None and k < dim:
        vals, ch = CBSRCompact.apply(xs.contiguous(), k)
        if halo_dtype is not None:
            vals = vals.to(halo_dtype)
        v, packed = HaloExchange.apply(spg, vals, pack_channels(ch, dim))
        return cbsr_to_dense(v.to(xs.dtype), unpack_channels(packed, k, dim),
                             dim)
    (halo,) = HaloExchange.apply(spg, xs)
    return halo


def sharded_planned_aggregate(spg: ShardedPlannedGraph, x: torch.Tensor,
                              norm: str = "sum", k: int | None = None,
                              halo_dtype: torch.dtype | None = None
                              ) -> torch.Tensor:
    """y = A_w x over the mesh: per shard the local pair on its own rows
    and the halo pair on the rows the exchange delivers (module
    docstring); x [n_pad, dim] f32 or bf16, y the same shape.

    k states that x is MaxK k-sparse: with k < dim the exchange carries
    the CBSR pair. halo_dtype (e.g. torch.bfloat16) rounds the CBSR values
    on the wire (2k + ids bytes a boundary row instead of 4k + ids); None
    keeps them exact. The JAX package's rounding points: xs = x ⊙ src_f
    in x's dtype, the local and halo outputs each in it (bf16 for bf16 x),
    their sum, then ⊙ dst_f.

    On a RankMesh x and y are the rank's rows [nps, dim], and the halo
    comes through `HaloExchange`: the values of the index copy."""
    src_f, dst_f = node_factors(spg, norm)
    d, nps = spg.num_shards, spg.nodes_per_shard
    xs = _scale(x, src_f).contiguous()
    if isinstance(spg.mesh, RankMesh):
        y = Aggregate.apply(xs, spg.fwd_local[0], spg.bwd_local[0], None,
                            None, None, None)
        if spg.fwd_halo is not None:
            y = y + Aggregate.apply(_rank_halo(spg, xs, k, halo_dtype),
                                    spg.fwd_halo[0], spg.bwd_halo[0], None,
                                    None, None, None)
        return _scale(y, dst_f)
    blocks = xs.view(d, nps, -1)
    halo = (_halo_rows(spg, xs, k, halo_dtype)
            if spg.fwd_halo is not None else None)
    ys = []
    for c in range(d):
        y = Aggregate.apply(blocks[c], spg.fwd_local[c], spg.bwd_local[c],
                            None, None, None, None)
        if halo is not None:
            y = y + Aggregate.apply(halo[c], spg.fwd_halo[c],
                                    spg.bwd_halo[c], None, None, None, None)
        ys.append(y)
    return _scale(torch.cat(ys), dst_f)
