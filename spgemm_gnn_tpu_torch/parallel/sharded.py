"""The edge-partitioned graph and its plain aggregation (counterpart of
`spgemm_gnn_tpu/parallel/sharded.py`, the JAX package's XLA path; the port
runs it for impl "torch").

Partitioning (on the host, once per graph), as the JAX package's:
- the nodes are padded to a multiple of D and split into D contiguous
  blocks of nps rows; shard d owns block d;
- the edges, sorted by destination, are split at the block boundaries, so
  every in-edge lives with the shard that owns its destination; each
  shard's edge list is padded to the common maximum with sentinel edges
  (source 0) whose destination is a trash row (nps);
- source ids stay global.

`sharded_spmm` aggregates shard by shard. The JAX package all-gathers the
source rows first; in one process the global tensor is that gather. Each
shard takes its edges' rows (`index_select`) and sums them into its block,
and autograd carries the backward. With k < dim (a MaxK input) the rows
go as their CBSR pair, k values and k channel ids, as the JAX package's
collective does.

One shard a rank (parallel/mesh.py::RankMesh): the graph holds the rank's
edges and degrees, x is the rank's rows, and the gather is the collective
(`mesh.AllGather`, whose gradient sums the ranks' and keeps the rank's
block), of the dense rows or of the CBSR pair.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spgemm_gnn_tpu_torch.graphs.csr import Graph
from spgemm_gnn_tpu_torch.ops.maxk import cbsr_compact_plain
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.ops.spmm import _gather_add, _scale
from spgemm_gnn_tpu_torch.parallel.mesh import AllGather, Mesh, RankMesh


def padded_degrees(g: Graph, n_pad: int, device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(in, out) degrees int32 [n_pad] on `device`, 0 on the padding rows."""
    out = []
    for deg in (g.in_degrees, g.out_degrees):
        a = np.zeros(n_pad, np.int32)
        a[:g.num_nodes] = deg.cpu().numpy()
        out.append(torch.from_numpy(a).to(device))
    return out[0], out[1]


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """A graph partitioned over a mesh by destination-node blocks.

    Attributes:
      edge_src: int32 [D·Eps], the global source of each shard's edges.
      edge_dst_local: int32 [D·Eps], each edge's destination less its
                      block's first row; nps for a sentinel edge.
      in_degrees / out_degrees: int32 [n_pad] (0 on padding rows).
      num_nodes / num_edges: the graph's N and E.
      nodes_per_shard / edges_per_shard: nps and Eps.

    On a RankMesh the edge arrays are the rank's Eps edges and the degrees
    its nps rows.
    """
    edge_src: torch.Tensor
    edge_dst_local: torch.Tensor
    in_degrees: torch.Tensor
    out_degrees: torch.Tensor
    num_nodes: int
    num_edges: int
    nodes_per_shard: int
    edges_per_shard: int
    mesh: Mesh | RankMesh

    @property
    def num_shards(self) -> int:
        return self.mesh.num_shards

    @property
    def padded_nodes(self) -> int:
        return self.nodes_per_shard * self.num_shards


def shard_graph(g: Graph, mesh: Mesh) -> ShardedGraph:
    """Partition g over the mesh (module docstring), on the mesh's device:
    the JAX package's `shard_graph` arrays bit for bit."""
    d = mesh.num_shards
    n_pad = -(-g.num_nodes // d) * d
    nps = n_pad // d
    host = g.host_arrays()
    indptr, src = host["indptr"], host["indices"]
    dst = np.repeat(np.arange(g.num_nodes, dtype=np.int32),
                    np.diff(indptr))
    bounds = indptr[np.minimum(np.arange(d + 1) * nps, g.num_nodes)]
    eps = max(int(np.diff(bounds).max()), 1)
    e_src = np.zeros((d, eps), np.int32)
    e_dst_local = np.full((d, eps), nps, np.int32)   # sentinel: trash row
    for i in range(d):
        lo, hi = bounds[i], bounds[i + 1]
        e_src[i, :hi - lo] = src[lo:hi]
        e_dst_local[i, :hi - lo] = dst[lo:hi] - i * nps
    in_deg, out_deg = padded_degrees(g, n_pad, mesh.device)
    if isinstance(mesh, RankMesh):      # the rank's edges and rows only
        r = mesh.shard
        e_src, e_dst_local = e_src[r], e_dst_local[r]
        in_deg = in_deg[r * nps:(r + 1) * nps].clone()
        out_deg = out_deg[r * nps:(r + 1) * nps].clone()
    return ShardedGraph(
        edge_src=torch.from_numpy(e_src.reshape(-1)).to(mesh.device),
        edge_dst_local=torch.from_numpy(e_dst_local.reshape(-1)).to(
            mesh.device),
        in_degrees=in_deg, out_degrees=out_deg, num_nodes=g.num_nodes,
        num_edges=g.num_edges, nodes_per_shard=nps, edges_per_shard=eps,
        mesh=mesh)


def sharded_spmm(sg: ShardedGraph, x: torch.Tensor, norm: str = "sum",
                 k: int | None = None) -> torch.Tensor:
    """y = A_w x over the sharded graph; x [n_pad, dim] (zeros on padding
    rows give zeros there). With k < dim, x is MaxK k-sparse and each
    shard gathers its edges' CBSR pairs (k values, k channels) instead of
    dense rows. On a RankMesh x and y are the rank's rows [nps, dim]."""
    src_f, dst_f = node_factors(sg, norm)
    d, nps, eps = sg.num_shards, sg.nodes_per_shard, sg.edges_per_shard
    dim = x.shape[-1]
    x_in = _scale(x, src_f)
    if isinstance(sg.mesh, RankMesh):
        return _scale(_rank_spmm(sg, x_in, k), dst_f)
    e_src = sg.edge_src.view(d, eps)
    e_dst = sg.edge_dst_local.view(d, eps)
    if k is not None and k < dim:
        values, channels = cbsr_compact_plain(x_in, k)
        blocks = [_cbsr_block(values, channels, e_src[i], e_dst[i], nps,
                              dim) for i in range(d)]
    else:
        blocks = [_gather_add(e_src[i], e_dst[i], x_in, nps + 1)[:nps]
                  for i in range(d)]
    return _scale(torch.cat(blocks), dst_f)


def _cbsr_block(values: torch.Tensor, channels: torch.Tensor,
                e_src: torch.Tensor, e_dst: torch.Tensor, nps: int,
                dim: int) -> torch.Tensor:
    """A shard's block [nps, dim] of the sum of its edges' CBSR pairs
    (values [N, k] and channels [N, k] of every source row)."""
    ev = values.index_select(0, e_src)                          # [Eps, k]
    ec = channels.index_select(0, e_src).long()                 # [Eps, k]
    at = e_dst.long()[:, None] * dim + ec
    acc = values.new_zeros((nps + 1) * dim)
    return acc.index_add(0, at.flatten(), ev.flatten()).view(
        nps + 1, dim)[:nps]


def _rank_spmm(sg: ShardedGraph, x_in: torch.Tensor, k: int | None
               ) -> torch.Tensor:
    """The rank's block of A x_in before the destination factor: the
    group's rows gathered (dense, or the CBSR pair with k < dim), then the
    rank's edges summed into its rows."""
    mesh, nps, dim = sg.mesh, sg.nodes_per_shard, x_in.shape[-1]
    if k is not None and k < dim:
        values, channels = cbsr_compact_plain(x_in, k)
        return _cbsr_block(AllGather.apply(values, mesh),
                           mesh.all_gather(channels), sg.edge_src,
                           sg.edge_dst_local, nps, dim)
    return _gather_add(sg.edge_src, sg.edge_dst_local,
                       AllGather.apply(x_in, mesh), nps + 1)[:nps]
