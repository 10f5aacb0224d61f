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
Where `STREAM_CBSR_FORWARD` takes it (`cbsr_forward`: by default a
k-sparse input of k < dim <= 256), the forward of either entry point on a
stream plan takes `stream_cbsr_spmm` on CBSR instead (the models' path
compacts its k-sparse input first).

`DEFAULT_STREAM` selects the feature stream of every product, forward on A
and backward on Aᵀ: "f32" (exact), or "bf16x2", the reference's 16-bit
stream. Its messages are bf16(pre ⊙ x) (the node factor in f32, then one
rounding, `kernels/round.py::round_rows`), gathered by the bf16 form of the
plan's kernel with no pre factor, summed in f32, with the post factor on the
f32 sum; the output stays f32.

bf16 activations (the 16-bit model, `--dtype bfloat16`) take the
reference's arithmetic under either stream: pre ⊙ x in bf16 (the factor
rounded to bf16, the product rounded once), the bf16-input kernel with no
pre factor and a bf16 output, bf16(bf16(Σ) · bf16(post)); the backward the
same on Aᵀ with the factors swapped, its cotangent in bf16
(`spgemm_gnn_tpu/kernels/planned.py:189-190, :271-332`). Their messages are
already bf16, so `round_rows` does not run, and no f32 kernel does.
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
from spgemm_gnn_tpu_torch.kernels.round import round_rows
from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm
from spgemm_gnn_tpu_torch.kernels.stream import (MAX_CBSR_DIM,
                                                 STREAM_DTYPES,
                                                 stream_cbsr_spmm, stream_spmm)
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
# name is the reference's (`spgemm_gnn_tpu/kernels/planned.py`); read at
# each call (`cbsr_forward`), so a caller may set it on the module:
# - None (the default): the rule. Take it where it applies: k < dim <= 256
#   (the ids are packed as uint8, so yelp's hidden 384 stays dense), on f32
#   or bf16 values (what a record holds);
# - True: force it (dim > 256 then raises, as the reference does);
# - False: the dense-row forward (`stream_spmm`).
# Windowed plans ignore it, and every backward takes the dense kernel. The
# reference defaults to False from a TPU v5e measurement, where its row
# gathers are tile-granular (0.29x at k = 32, `spgemm_gnn_tpu/kernels/
# planned.py:180-186`). On the card the CBSR forward is the faster one: one
# ogbn-products stand-in epoch (SAGE recipe, k 32, dim 256) with it against
# without takes about 0.50 against 0.66 s in f32, 0.43 against 0.49 under
# bf16x2 and 0.24 against 0.30 with bf16 activations, with the same losses,
# since the two forwards are equal by value (chip_smoke.py's products
# phases on an NVIDIA H100 80GB HBM3 at a 700 W power limit; PERF.md §5
# holds the measured epochs and the call that measured them).
STREAM_CBSR_FORWARD: bool | None = None

# The feature stream of the planned products: "f32" or "bf16x2" (the name,
# values and default of the reference's `DEFAULT_STREAM`, which its Trainer
# sets from `--stream`; read at each call). The name is the TPU kernel's,
# which packs two bf16 to a 32-bit lane; here a bf16 row is a bf16 tensor.
DEFAULT_STREAM = "f32"
STREAMS = ("f32", "bf16x2")

KINDS = ("auto", "windowed", "stream")


def cbsr_forward(plan, k: int | None, dim: int, dtype: torch.dtype) -> bool:
    """Whether the forward on `plan` of a k-sparse input of width `dim` and
    `dtype` takes `stream_cbsr_spmm` (STREAM_CBSR_FORWARD's rule): on stream
    plans only, with k stated and k < dim; under the default (None) also
    dim <= 256 and f32 or bf16 values, while True takes it regardless (and
    the kernel's wrapper raises above dim 256)."""
    if (STREAM_CBSR_FORWARD is False or not isinstance(plan, StreamPlan)
            or k is None or k >= dim):
        return False
    return STREAM_CBSR_FORWARD is True or (dim <= MAX_CBSR_DIM
                                           and dtype in STREAM_DTYPES)


def _stream16() -> bool:
    """True under the 16-bit stream (DEFAULT_STREAM "bf16x2")."""
    if DEFAULT_STREAM not in STREAMS:
        raise ValueError(f"unknown stream {DEFAULT_STREAM!r}; expected one "
                         f"of {STREAMS}")
    return DEFAULT_STREAM == "bf16x2"


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
               dim: int | None = None,
               dtype: torch.dtype = torch.float32) -> PlannedGraph:
    """Both plans of a graph, on its device. kind: "auto" (the reference's
    rule, `plan_kind`), "windowed" or "stream"; chunk: edges per chunk of a
    stream plan. A windowed plan's `csr_spmm` schedule, or a stream plan's
    hot set, is built here for the rows the kernels gather when `dim` is
    given (else at the first product of each row size): rows of width `dim`
    of activations of `dtype` in DEFAULT_STREAM's feature stream, 2 B a
    channel for bf16 activations or the "bf16x2" stream, else 4. A
    symmetric graph's backward plan is its forward plan."""
    if kind not in KINDS:
        raise ValueError(f"unknown plan kind {kind!r}; expected one of "
                         f"{KINDS}")
    if kind == "auto":
        kind = plan_kind(g.num_nodes, g.num_edges)
    elem = 2 if _stream16() or dtype == torch.bfloat16 else 4

    def one(transpose: bool):
        if kind == "stream":
            plan = stream_plan_for_graph(g, transpose=transpose, chunk=chunk)
            if dim is not None:
                plan.hot_set(elem * dim)
            return plan
        plan = (CSRPlan(g.t_indptr, g.t_indices) if transpose
                else CSRPlan(g.indptr, g.indices))
        if dim is not None:
            plan.schedule(g.num_nodes, dim, elem)
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
    has at most k nonzeros per row: where `cbsr_forward` says so, a stream
    plan then compacts x to CBSR and takes `stream_cbsr_spmm` (the same y by
    value). Under the 16-bit stream (DEFAULT_STREAM "bf16x2") the kernel
    gathers bf16(pre ⊙ x), or the CBSR values so rounded, with no pre
    factor; a windowed plan then needs dim % 16 == 0, as the reference's
    packed stream does. bf16 x takes `_plan_spmm16`, and y is bf16."""
    stream16 = _stream16()
    dim = x.shape[1]
    if stream16 and dim % 16 and not isinstance(plan, StreamPlan):
        raise ValueError(f"the bf16x2 stream needs dim % 16 == 0 on a "
                         f"windowed plan; got {dim}")
    if x.dtype == torch.bfloat16:
        return _plan_spmm16(plan, _scale(x, pre), post, k)
    if isinstance(plan, StreamPlan):
        if cbsr_forward(plan, k, dim, x.dtype):
            vals, ch = cbsr_compact(x, k)
            if stream16:
                return stream_cbsr_spmm(
                    plan, cbsr_records(round_rows(vals, pre), ch, dim), k,
                    dim, None, post, torch.bfloat16)
            return stream_cbsr_spmm(plan, cbsr_records(vals, ch, dim), k,
                                    dim, pre, post)
        if stream16:
            return stream_spmm(plan, round_rows(x, pre), None, post)
        return stream_spmm(plan, x, pre, post)
    if stream16:
        return csr_spmm(plan, round_rows(x, pre), None, post)
    return csr_spmm(plan, x, pre, post)


def _plan_spmm16(plan, x: torch.Tensor, post: torch.Tensor | None,
                 k: int | None) -> torch.Tensor:
    """bf16(bf16(A x) · bf16(post)) for bf16 rows x that already carry the
    pre factor: the bf16-input kernels with their bf16 output, under either
    stream (f32 sums of the same bf16 values). Where `cbsr_forward` says
    so, a stream plan compacts x first (`cbsr_compact` on bf16 rows) and
    gathers the bf16 records, as the reference scales, then compacts."""
    bf16 = torch.bfloat16
    dim = x.shape[1]
    if isinstance(plan, StreamPlan):
        if cbsr_forward(plan, k, dim, x.dtype):
            vals, ch = cbsr_compact(x, k)
            return stream_cbsr_spmm(plan, cbsr_records(vals, ch, dim), k, dim,
                                    None, post, bf16, out_dtype=bf16)
        return stream_spmm(plan, x, None, post, out_dtype=bf16)
    return csr_spmm(plan, x, None, post, out_dtype=bf16)


class Aggregate(torch.autograd.Function):
    """y = post ⊙ A (pre ⊙ x); dx = pre ⊙ Aᵀ (post ⊙ g), each through its
    plan's kernel (the forward reads `k` as `plan_spmm` does; the cotangent
    is dense). The cotangent keeps the primal's dtype (for bf16 x, g is
    bf16 and so is dx)."""

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
    """CBSR forward: y f32 = dst_f ⊙ A densify(src_f ⊙ values) through the
    forward plan's kernel. bf16 values are scaled in bf16 (the factor
    rounded to bf16, the product rounded once) and densified into f32, the
    reference's `stream_dtype` (`spgemm_gnn_tpu/kernels/planned.py:198-
    243`). Where `cbsr_forward` takes it (k = values.shape[1]), (src_f ⊙
    values, channels) go to `stream_cbsr_spmm` with no densify (f32 values
    under the 16-bit stream rounded to bf16 after the factor; bf16 values
    as they are, through its bf16 form)."""
    bf16 = values.dtype == torch.bfloat16
    k = values.shape[1]
    if cbsr_forward(plans[0], k, dim, values.dtype):
        if _stream16() and not bf16:
            rec = cbsr_records(round_rows(values, src_f), channels, dim)
            return stream_cbsr_spmm(plans[0], rec, k, dim, None, dst_f,
                                    torch.bfloat16)
        v = _scale(values, src_f).contiguous()
        return stream_cbsr_spmm(plans[0], cbsr_records(v, channels, dim), k,
                                dim, None, dst_f, v.dtype)
    v = _scale(values, src_f).contiguous()
    dense = cbsr_densify(v, channels, dim,
                         torch.float32 if bf16 else values.dtype)
    return plan_spmm(plans[0], dense, None, dst_f)


def sspmm_backward(g_ct: torch.Tensor, channels: torch.Tensor, src_f, dst_f,
                   plans) -> torch.Tensor:
    """Sampled backward: dvalues f32 = src_f ⊙ (Aᵀ (dst_f ⊙ g)) at the
    channels, the transpose product through the backward plan's kernel (the
    caller casts them to the values' dtype)."""
    z = plan_spmm(plans[1], g_ct.contiguous(), dst_f, None)
    return _scale(cbsr_sample(z, channels), src_f)
