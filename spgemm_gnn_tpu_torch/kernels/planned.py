"""PlannedGraph: a Graph with its forward and backward plans, the autograd
pair over them, and the explicit CBSR forward/backward (counterpart of
`spgemm_gnn_tpu/kernels/planned.py`).

Two plan kinds, chosen per graph by the reference's rule (`plan_kind`):
- "windowed" (graphs/tiles.py::CSRPlan): the `csr_spmm` kernel over the CSR
  re-bucketed into L2-sized source blocks and cut into row segments of at
  most `segment` edges (the plan's schedule). The name is the JAX package's,
  whose plan buckets edges into source windows.
- "stream" (graphs/stream_tiles.py::StreamPlan): the `stream_spmm` kernel
  over fixed-size edge chunks, for graphs of low degree.

Entry points:
- `planned_aggregate` (the models' path): dense (MaxK-masked) activations in;
  forward = the plan's kernel on A, backward = the same kernel on Aᵀ with the
  node factors swapped. The aggregation is linear, so no forward residual is
  kept and MaxK's own backward applies the mask.
- `spgemm_forward` / `sspmm_backward` (the explicit CBSR API,
  kernels/api.py::aggregate_cbsr): CBSR → densify → the plan's kernel; the
  backward is the transpose product sampled at the k channels.
With `STREAM_CBSR_FORWARD` set, the forward of either entry point on a
stream plan takes `stream_cbsr_spmm` on CBSR instead (the models' path
compacts its k-sparse input first).
"""
from __future__ import annotations

import dataclasses

import torch

from spgemm_gnn_tpu_torch.graphs.csr import Graph
from spgemm_gnn_tpu_torch.graphs.stream_tiles import (StreamPlan,
                                                      stream_plan_for_graph)
from spgemm_gnn_tpu_torch.graphs.tiles import (CHUNK, CSRPlan, auto_window,
                                               predicted_windowed_fill)
from spgemm_gnn_tpu_torch.kernels.cbsr import (cbsr_compact, cbsr_densify,
                                               cbsr_sample)
from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm
from spgemm_gnn_tpu_torch.kernels.stream import stream_cbsr_spmm, stream_spmm
from spgemm_gnn_tpu_torch.ops.maxk import cbsr_records
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.ops.spmm import _scale

# below this predicted chunk fill of the TPU's windowed plan the reference
# switches to the stream plan (the JAX package's cutover and source block)
WINDOWED_FILL_CUTOVER = 0.25
KIND_SRC_BLOCK = 256

# The CBSR edge-gather stream forward (`stream_cbsr_spmm`): a k-sparse input
# over a stream plan is compacted to k values and packed channel ids per
# node, and the forward gathers those per edge instead of a dense row. The
# name and the default are the reference's (`spgemm_gnn_tpu/kernels/
# planned.py`); read at each call, so a caller may set it on the module.
# Windowed plans ignore it, and every backward takes the dense kernel.
STREAM_CBSR_FORWARD = False

KINDS = ("auto", "windowed", "stream")


@dataclasses.dataclass(frozen=True)
class PlannedGraph:
    """Graph + plans. Quacks like Graph for the norms' degrees and for the
    plain aggregation (`indices`, `edge_dst`)."""
    graph: Graph
    fwd_plan: CSRPlan | StreamPlan
    bwd_plan: CSRPlan | StreamPlan     # on the transpose CSR

    @property
    def kind(self) -> str:
        return self.fwd_plan.kind

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes

    @property
    def num_edges(self) -> int:
        return self.graph.num_edges

    @property
    def in_degrees(self) -> torch.Tensor:
        return self.graph.in_degrees

    @property
    def out_degrees(self) -> torch.Tensor:
        return self.graph.out_degrees

    @property
    def indices(self) -> torch.Tensor:
        return self.graph.indices

    @property
    def edge_dst(self) -> torch.Tensor:
        return self.graph.edge_dst


def plan_kind(num_nodes: int, num_edges: int) -> str:
    """The reference's rule (`spgemm_gnn_tpu/kernels/planned.py:99-112`):
    predict the TPU windowed plan's chunk fill at source block 256 and take
    the stream plan below the cutover."""
    rw = auto_window(num_nodes, num_edges, KIND_SRC_BLOCK)
    fill = predicted_windowed_fill(num_nodes, num_edges, KIND_SRC_BLOCK,
                                   num_nodes, rw)
    return "windowed" if fill >= WINDOWED_FILL_CUTOVER else "stream"


def plan_graph(g: Graph, *, kind: str = "auto", chunk: int = CHUNK,
               dim: int | None = None) -> PlannedGraph:
    """Both plans of a graph, on its device. kind: "auto" (the reference's
    rule, `plan_kind`), "windowed" or "stream"; chunk: edges per chunk of a
    stream plan. A windowed plan's `csr_spmm` schedule, or a stream plan's
    hot set for rows of `dim` floats, is built here for width `dim` when it
    is given (else at the first product of each width). A symmetric graph's
    backward plan is its forward plan."""
    if kind not in KINDS:
        raise ValueError(f"unknown plan kind {kind!r}; expected one of "
                         f"{KINDS}")
    if kind == "auto":
        kind = plan_kind(g.num_nodes, g.num_edges)

    def one(transpose: bool):
        if kind == "stream":
            plan = stream_plan_for_graph(g, transpose=transpose, chunk=chunk)
            if dim is not None:
                plan.hot_set(4 * dim)
            return plan
        plan = (CSRPlan(g.t_indptr, g.t_indices) if transpose
                else CSRPlan(g.indptr, g.indices))
        if dim is not None:
            plan.schedule(g.num_nodes, dim)
        return plan

    fwd = one(False)
    return PlannedGraph(graph=g, fwd_plan=fwd,
                        bwd_plan=fwd if g.symmetric else one(True))


def graph_plans(g) -> tuple[CSRPlan | StreamPlan, CSRPlan | StreamPlan]:
    """(forward, backward) plans: a PlannedGraph's own; for a plain Graph,
    windowed plans over its CSR and its transpose, made at the first call
    and kept in `g.plans`, so that their schedules are built once."""
    if isinstance(g, PlannedGraph):
        return g.fwd_plan, g.bwd_plan
    if g.plans is None:
        # Graph is frozen; `plans` is its one slot set after construction
        object.__setattr__(g, "plans", plan_graph(g, kind="windowed"))
    return g.plans.fwd_plan, g.plans.bwd_plan


def plan_spmm(plan, x: torch.Tensor, pre: torch.Tensor | None = None,
              post: torch.Tensor | None = None,
              k: int | None = None) -> torch.Tensor:
    """y = post ⊙ A (pre ⊙ x) through the plan's kernel. `k` states that x
    has at most k nonzeros per row: with STREAM_CBSR_FORWARD set, a stream
    plan then compacts x to CBSR and takes `stream_cbsr_spmm` (the same y by
    value)."""
    if isinstance(plan, StreamPlan):
        dim = x.shape[1]
        if STREAM_CBSR_FORWARD and k is not None and k < dim:
            vals, ch = cbsr_compact(x, k)
            return stream_cbsr_spmm(plan, cbsr_records(vals, ch, dim), k,
                                    dim, pre, post)
        return stream_spmm(plan, x, pre, post)
    return csr_spmm(plan, x, pre, post)


class Aggregate(torch.autograd.Function):
    """y = post ⊙ A (pre ⊙ x); dx = pre ⊙ Aᵀ (post ⊙ g), each through its
    plan's kernel (the forward reads `k` as `plan_spmm` does; the cotangent
    is dense). The cotangent keeps the primal's dtype."""

    @staticmethod
    def forward(ctx, x, fwd_plan, bwd_plan, pre, post, k):
        ctx.save_for_backward(pre, post)
        ctx.bwd_plan = bwd_plan
        ctx.x_dtype = x.dtype
        return plan_spmm(fwd_plan, x, pre, post, k)

    @staticmethod
    def backward(ctx, g):
        pre, post = ctx.saved_tensors
        dx = plan_spmm(ctx.bwd_plan, g.contiguous(), post, pre)
        return dx.to(ctx.x_dtype), None, None, None, None, None


def planned_aggregate(g, x: torch.Tensor, norm: str = "sum",
                      k: int | None = None) -> torch.Tensor:
    """y = A_w x through the kernel pair of `g`'s plans (a PlannedGraph's, or
    windowed plans for a plain Graph). `k` (optional) states that x is MaxK
    top-k sparse per row (see `plan_spmm`)."""
    src_f, dst_f = node_factors(g, norm)
    fwd, bwd = graph_plans(g)
    return Aggregate.apply(x.contiguous(), fwd, bwd, src_f, dst_f, k)


def spgemm_forward(dim: int, values: torch.Tensor, channels: torch.Tensor,
                   src_f, dst_f, plans) -> torch.Tensor:
    """CBSR forward: y = dst_f ⊙ A densify(src_f ⊙ values) through the
    forward plan's kernel; on a stream plan with STREAM_CBSR_FORWARD set,
    (src_f ⊙ values, channels) go to `stream_cbsr_spmm` with no densify."""
    v = _scale(values, src_f).contiguous()
    if STREAM_CBSR_FORWARD and isinstance(plans[0], StreamPlan):
        return stream_cbsr_spmm(plans[0], cbsr_records(v, channels, dim),
                                values.shape[1], dim, None, dst_f)
    return plan_spmm(plans[0], cbsr_densify(v, channels, dim), None, dst_f)


def sspmm_backward(g_ct: torch.Tensor, channels: torch.Tensor, src_f, dst_f,
                   plans) -> torch.Tensor:
    """Sampled backward: dvalues = src_f ⊙ (Aᵀ (dst_f ⊙ g)) at the channels,
    the transpose product through the backward plan's kernel."""
    z = plan_spmm(plans[1], g_ct.contiguous(), dst_f, None)
    return _scale(cbsr_sample(z, channels), src_f)
