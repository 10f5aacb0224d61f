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
k-sparse input of k < dim <= 256), the forward of either entry point takes
the CBSR form of the plan's kernel instead: `stream_cbsr_spmm` on a stream
plan, `csr_cbsr_spmm` on a windowed one (the models' path compacts its
k-sparse input first). Where `SAMPLED_BACKWARD` takes it
(`sampled_backward`: by default the channel ids of the MaxK whose output x
is and k < dim <= 256, on either plan kind, f32 or bf16 messages), the
models' backward computes only the channels that MaxK kept (`stream_sspmm`
on a stream plan, `csr_sspmm` on a windowed one), the dense backward's
bits there.

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

from spgemm_gnn_tpu_torch.graphs import plan_cache
from spgemm_gnn_tpu_torch.graphs.csr import Graph
from spgemm_gnn_tpu_torch.graphs.stream_tiles import (HOT_BUDGET,
                                                      WARP_CHUNKS, StreamPlan,
                                                      build_stream_plan)
from spgemm_gnn_tpu_torch.graphs.tiles import (CHUNK, SEGMENT, CSRPlan,
                                               auto_src_blocks, auto_window,
                                               predicted_windowed_fill)
from spgemm_gnn_tpu_torch.kernels.cbsr import (cbsr_compact, cbsr_densify,
                                               cbsr_sample)
from spgemm_gnn_tpu_torch.kernels.round import round_rows
from spgemm_gnn_tpu_torch.kernels.spmm import (csr_cbsr_spmm, csr_spmm,
                                               csr_sspmm)
from spgemm_gnn_tpu_torch.kernels.stream import (MAX_CBSR_DIM,
                                                 STREAM_DTYPES,
                                                 stream_cbsr_spmm, stream_spmm,
                                                 stream_sspmm)
from spgemm_gnn_tpu_torch.models.remat import saved_output
from spgemm_gnn_tpu_torch.ops.maxk import cbsr_records
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.ops.spmm import _scale
from spgemm_gnn_tpu_torch.utils import spans

# below this predicted chunk fill of the TPU's windowed plan the reference
# switches to the stream plan (the JAX package's cutover and source block)
WINDOWED_FILL_CUTOVER = 0.25
KIND_SRC_BLOCK = 256

# The CBSR forward: a k-sparse input is compacted to k values and channel
# ids per node, and the forward gathers those per edge instead of a dense
# row: `stream_cbsr_spmm` on a stream plan, `csr_cbsr_spmm` on a windowed
# one. The name is the reference's (`spgemm_gnn_tpu/kernels/planned.py`);
# read at each call (`cbsr_forward`), so a caller may set it on the module:
# - None (the default): the rule. Take it where it applies: k < dim <= 256
#   (the ids are packed as uint8, so yelp's hidden 384 stays dense), on f32
#   or bf16 values (what a record holds), on either plan kind;
# - True: force it (dim > 256 then raises, as the reference does);
# - False: the dense-row forward (`stream_spmm`, `csr_spmm`) on both.
# The reference defaults to False from a TPU v5e measurement, where its row
# gathers are tile-granular (0.29x at k = 32,
# `spgemm_gnn_tpu/kernels/planned.py:180-186`). On the card the CBSR
# forward is the faster one, with the same losses, since the two forwards
# are equal by value (on a windowed plan, where it runs at the dense form's
# schedule, bit for bit). On an NVIDIA H100 80GB HBM3 at a 700 W power
# limit (k 32, dim 256; PERF.md §5-§6 hold the numbers and the calls that
# measured them): one ogbn-products stand-in epoch (SAGE recipe) with it
# against without takes about 0.50 against 0.66 s in f32, 0.43 against
# 0.49 under bf16x2 and 0.24 against 0.30 with bf16 activations
# (chip_smoke.py's products phases); on the Reddit stand-in's windowed plan
# (A, k-sparse x) `csr_cbsr_spmm` takes 4.18 ms against `csr_spmm`'s 8.49 on
# bf16 records (5 source blocks; utils/csr_sweep.py --stream bf16x2
# --probes) and 9.16 against 15.43 on f32 records (10 source blocks;
# chip_smoke.py), and the f32 recipe's epoch 0.157 s against 0.206 with
# the flag off.
STREAM_CBSR_FORWARD: bool | None = None

# The sampled backward: an aggregation whose input x is the output of MaxK
# (possibly after dropout) needs its input gradient only at the k channels
# MaxK kept, since MaxK's backward zeroes the rest. Given MaxK's kept
# channels (`kernels/maxk.py::maxk_fwd(..., with_ids=True)`, which the
# models pass as `ids`), the backward then takes the sampled form of the
# plan's kernel: `stream_sspmm` on a stream plan (each edge moves k values
# instead of a row of dim), `csr_sspmm` on a windowed one (k channels of
# each gathered row, at the dense form's schedule). At the kept channels
# dx is the dense backward's bit for bit (zeros elsewhere), so the losses
# are the dense run's. A port-only selection: the reference's backward is
# dense (`spgemm_gnn_tpu/kernels/planned.py:326`), and its `sspmm_backward`
# (dense, then `sample_channels`) is this function at the CBSR API. Read
# at each call (`sampled_backward`):
# - None (the default): the rule. Take it with MaxK's ids given and k <
#   dim <= 256 (uint8 ids), on either plan kind, for f32 messages (the raw
#   cotangent on f32 activations, the pre factor applied per edge) or bf16
#   ones (the bf16x2 stream, or bf16 activations);
# - True: the same, raising above dim 256;
# - False: the dense backward (`stream_spmm` or `csr_spmm` on Aᵀ).
# Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (k 32, dim
# 256; PERF.md §5-§6): on the ogbn-products stand-in (SAGE recipe) the
# dense bf16 backward takes 20.1 ms a layer, `stream_sspmm` 15.2, and on
# f32 messages `stream_spmm` on Aᵀ then `maxk_bwd` 41.0 + 2.4 ms against
# `stream_sspmm`'s 24.6, the f32 recipe's epoch 0.453 s against 0.502
# with the flag off (chip_smoke.py's products phases); on the Reddit
# stand-in's windowed plan `csr_spmm_bf16` then `maxk_bwd` took 8.79 ms
# and `csr_sspmm` 6.70 in one call (utils/csr_sweep.py --sampled_only),
# and on f32 messages
# `csr_spmm` then `maxk_bwd` 15.95 ms against `csr_sspmm`'s 9.89, the f32
# recipe's epoch 0.157 s against 0.181 with the flag off (chip_smoke.py).
SAMPLED_BACKWARD: bool | None = None

# The feature stream of the planned products: "f32" or "bf16x2" (the name,
# values and default of the reference's `DEFAULT_STREAM`, which its Trainer
# sets from `--stream`; read at each call). The name is the TPU kernel's,
# which packs two bf16 to a 32-bit lane; here a bf16 row is a bf16 tensor.
DEFAULT_STREAM = "f32"
STREAMS = ("f32", "bf16x2")

# "windowed_classes" is the reference's windowed plan split into degree
# classes, so that hub rows do not set a tile's length
# (`spgemm_gnn_tpu/kernels/planned.py:97,120-127`); on the card the
# windowed plan's CSR schedule already cuts every row into segments of at
# most `tiles.SEGMENT` edges, so the name maps to it
KINDS = ("auto", "windowed", "stream", "windowed_classes")


def cbsr_forward(plan, k: int | None, dim: int, dtype: torch.dtype) -> bool:
    """Whether the forward on `plan` (either kind) of a k-sparse input of
    width `dim` and `dtype` takes the CBSR form of the plan's kernel
    (STREAM_CBSR_FORWARD's rule): with k stated and k < dim; under the
    default (None) also dim <= 256 and f32 or bf16 values, while True takes
    it regardless (and the kernel's wrapper raises above dim 256)."""
    if STREAM_CBSR_FORWARD is False or k is None or k >= dim:
        return False
    return STREAM_CBSR_FORWARD is True or (dim <= MAX_CBSR_DIM
                                           and dtype in STREAM_DTYPES)


def sampled_backward(plan, k: int | None, dim: int,
                     dtype: torch.dtype) -> bool:
    """Whether the backward on `plan` (Aᵀ) of an aggregation whose input
    of width `dim` and `dtype` is the output of a MaxK whose k kept
    channels are given (k None: none are) takes the sampled form,
    `stream_sspmm` on a stream plan and `csr_sspmm` on a windowed one
    (SAMPLED_BACKWARD's rule): k < dim, on either plan kind and for f32
    or bf16 messages (`dtype`, the plan and the stream decide which form
    runs); under the default (None) also dim <= 256, while True takes it
    regardless (and the kernels' wrappers raise above dim 256)."""
    if SAMPLED_BACKWARD is False or k is None or k >= dim:
        return False
    return SAMPLED_BACKWARD is True or dim <= MAX_CBSR_DIM


def wants_channel_ids(g, k: int | None, x: torch.Tensor) -> bool:
    """Whether MaxK of width-k on x should return its kept channels for the
    aggregation over `g` that follows it: where the backward will read
    them (`sampled_backward` on g's backward plan) and a backward will
    run."""
    if (not isinstance(g, PlannedGraph)
            or not (torch.is_grad_enabled() and x.requires_grad)):
        return False
    return sampled_backward(g.bwd_plan, k, x.shape[-1], x.dtype)


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


def row_elem(dtype: torch.dtype) -> int:
    """Bytes a channel of the rows the kernels gather: 2 for bf16
    activations or under the bf16x2 stream, else 4."""
    return 2 if _stream16() or dtype == torch.bfloat16 else 4


def build_plan(indptr: torch.Tensor, indices: torch.Tensor, kind: str, *,
               num_src: int | None = None, chunk: int = CHUNK,
               dim: int | None = None, elem: int = 4
               ) -> CSRPlan | StreamPlan:
    """One plan of `kind` ("windowed" or "stream") over the CSR (indptr,
    indices), on its device, for num_src sources (None: as many as rows;
    a shard's halo pair is rectangular, parallel/planned_sharded.py):
    where `dim` is given, with the windowed plan's `csr_spmm` schedule, or
    the stream plan's hot set, built for rows of dim × elem bytes."""
    if kind == "stream":
        plan = build_stream_plan(indptr, indices, chunk=chunk,
                                 num_src=num_src)
        if dim is not None:
            plan.hot_set(elem * dim)
        return plan
    plan = CSRPlan(indptr, indices, num_src=num_src)
    if dim is not None:
        plan.schedule(plan.num_src, dim, elem)
    return plan


def plan_graph(g: Graph, *, kind: str = "auto", chunk: int = CHUNK,
               dim: int | None = None,
               dtype: torch.dtype = torch.float32,
               k: int | None = None,
               cache_dir: str | None = None) -> PlannedGraph:
    """Both plans of a graph, on its device. kind: "auto" (the reference's
    rule, `plan_kind`), "windowed", "stream", or "windowed_classes" (the
    windowed plan; KINDS); chunk: edges per chunk of a stream plan. A
    windowed plan's `csr_spmm` schedule, or a stream plan's hot set, is
    built here for the rows the kernels gather when `dim` is given (else at
    the first product of each row size): rows of width `dim` of activations
    of `dtype` in DEFAULT_STREAM's feature stream, 2 B a channel for bf16
    activations or the "bf16x2" stream, else 4; on a stream plan also the
    backward plan's transpose positions (the sampled backward's, else built
    at its first call) for 2-B channels, and for 4-B ones where a MaxK of
    width `k` on those rows takes the sampled backward (`sampled_backward`;
    k None: the model runs no MaxK). A symmetric graph's backward plan is
    its forward plan.

    cache_dir: where given, each plan is loaded from a file there keyed by
    its CSR's fingerprint and every parameter above that shapes it (the
    resolved kind, the chunk, dim and the channel bytes, the source blocks
    and segment size, the hot budget), or built and stored
    (graphs/plan_cache.py); a loaded plan is the built one tensor for
    tensor."""
    if kind not in KINDS:
        raise ValueError(f"unknown plan kind {kind!r}; expected one of "
                         f"{KINDS}")
    if kind == "auto":
        kind = plan_kind(g.num_nodes, g.num_edges)
    elif kind == "windowed_classes":
        kind = "windowed"
    elem = row_elem(dtype)
    positions = kind == "stream" and dim is not None and (
        elem == 2 or sampled_backward(None, k, dim, dtype))

    def build(transpose: bool, fwd=None):
        ip, ix = ((g.t_indptr, g.t_indices) if transpose
                  else (g.indptr, g.indices))
        plan = build_plan(ip, ix, kind, num_src=g.num_nodes, chunk=chunk,
                          dim=dim, elem=elem)
        if positions and (transpose or g.symmetric):
            # the sampled backward's, on the backward plan
            plan.transpose_positions(plan if fwd is None else fwd)
        return plan

    def one(transpose: bool, fwd=None):
        if not cache_dir:
            return build(transpose, fwd)
        ip, ix = ((g.t_indptr, g.t_indices) if transpose
                  else (g.indptr, g.indices))
        params = {"dim": dim, "elem": elem if dim is not None else None}
        if kind == "stream":
            params.update(chunk=chunk, warp=WARP_CHUNKS,
                          budget=HOT_BUDGET if dim is not None else None,
                          pos=1 if positions and (transpose or g.symmetric)
                          else None)
        else:
            params.update(segment=SEGMENT, nb=None if dim is None else
                          auto_src_blocks(g.num_nodes, ix.numel(), dim,
                                          g.num_nodes, elem))
        key = plan_cache.plan_key(plan_cache.graph_fingerprint(ip, ix),
                                  "t" if transpose else "f", kind, **params)
        return plan_cache.cached_plan(cache_dir, key,
                                      lambda: build(transpose, fwd), ip, ix)

    # a symmetric graph's backward plan is its forward plan, whose
    # transpose positions then map it onto itself
    fwd = one(False)
    bwd = fwd if g.symmetric else one(True, fwd)
    return PlannedGraph(graph=g, fwd_plan=fwd, bwd_plan=bwd)


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
    has at most k nonzeros per row: where `cbsr_forward` says so, x is then
    compacted to CBSR and the plan's CBSR kernel takes its records
    (`stream_cbsr_spmm`, the same y by value; `csr_cbsr_spmm`, the same y
    bit for bit). Under the 16-bit stream (DEFAULT_STREAM "bf16x2") the kernel
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
    if cbsr_forward(plan, k, dim, x.dtype):
        vals, ch = cbsr_compact(x, k)
        if stream16:
            return _cbsr(plan, cbsr_records(round_rows(vals, pre), ch, dim),
                         k, dim, None, post, torch.bfloat16)
        return _cbsr(plan, cbsr_records(vals, ch, dim), k, dim, pre, post,
                     torch.float32)
    kernel = stream_spmm if isinstance(plan, StreamPlan) else csr_spmm
    if stream16:
        return kernel(plan, round_rows(x, pre), None, post)
    return kernel(plan, x, pre, post)


def _cbsr(plan, records: torch.Tensor, k: int, dim: int,
          pre: torch.Tensor | None, post: torch.Tensor | None,
          value_dtype: torch.dtype,
          out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The CBSR form of the plan's kernel on records of `value_dtype` (bf16
    ones with the pre factor in their values): `stream_cbsr_spmm` on a
    stream plan, `csr_cbsr_spmm` on a windowed one."""
    if isinstance(plan, StreamPlan):
        return stream_cbsr_spmm(plan, records, k, dim, pre, post,
                                value_dtype, out_dtype)
    return csr_cbsr_spmm(plan, records, k, dim, post, out_dtype, pre=pre,
                         value_dtype=value_dtype)


def _plan_spmm16(plan, x: torch.Tensor, post: torch.Tensor | None,
                 k: int | None) -> torch.Tensor:
    """bf16(bf16(A x) · bf16(post)) for bf16 rows x that already carry the
    pre factor: the bf16-input kernels with their bf16 output, under either
    stream (f32 sums of the same bf16 values). Where `cbsr_forward` says
    so, x is compacted first (`cbsr_compact` on bf16 rows) and the plan's
    kernel gathers the bf16 records, as the reference scales, then
    compacts."""
    bf16 = torch.bfloat16
    dim = x.shape[1]
    if cbsr_forward(plan, k, dim, x.dtype):
        vals, ch = cbsr_compact(x, k)
        return _cbsr(plan, cbsr_records(vals, ch, dim), k, dim, None, post,
                     bf16, bf16)
    kernel = stream_spmm if isinstance(plan, StreamPlan) else csr_spmm
    return kernel(plan, x, None, post, out_dtype=bf16)


def plan_sspmm(plan, fwd_plan, g: torch.Tensor, ids: torch.Tensor,
               pre: torch.Tensor | None,
               post: torch.Tensor | None) -> torch.Tensor:
    """`plan_spmm(plan, g, pre, post)` on the transpose `plan` of
    `fwd_plan` at each row's channels ids[v] only, zeros elsewhere:
    `stream_sspmm` on a stream plan, `csr_sspmm` on a windowed one. The
    messages are the dense form's, bf16(pre ⊙ g) under the bf16x2 stream
    (y f32), pre ⊙ g in bf16 for bf16 g (y bf16), and under the f32 stream
    the f32 g itself, with pre applied per edge (y f32)."""
    stream = isinstance(plan, StreamPlan)
    if g.dtype == torch.bfloat16:
        m, out_dtype = _scale(g, pre).contiguous(), torch.bfloat16
    elif not _stream16():
        if stream:
            return stream_sspmm(plan, fwd_plan, g, ids, post, pre=pre)
        return csr_sspmm(plan, g, ids, post, pre=pre)
    else:
        m, out_dtype = round_rows(g, pre), None
    if stream:
        return stream_sspmm(plan, fwd_plan, m, ids, post, out_dtype)
    return csr_sspmm(plan, m, ids, post, out_dtype)


class Aggregate(torch.autograd.Function):
    """y = post ⊙ A (pre ⊙ x); dx = pre ⊙ Aᵀ (post ⊙ g), each through its
    plan's kernel (the forward reads `k` as `plan_spmm` does; the cotangent
    is dense). The cotangent keeps the primal's dtype (for bf16 x, g is
    bf16 and so is dx). With MaxK's kept channels `ids`, the backward takes
    `plan_sspmm` where `sampled_backward` says so. Inside a layer under
    `--remat` (models/remat.py) the output is kept, and the backward's
    rerun of the layer takes it back instead of launching the kernel."""

    @staticmethod
    def forward(ctx, x, fwd_plan, bwd_plan, pre, post, k, ids):
        ctx.save_for_backward(pre, post, ids)
        ctx.plans = (fwd_plan, bwd_plan)
        ctx.x_dtype = x.dtype
        return saved_output(lambda: plan_spmm(fwd_plan, x, pre, post, k))

    @staticmethod
    def backward(ctx, g):
        with spans.span("aggregate.backward"):
            pre, post, ids = ctx.saved_tensors
            fwd_plan, bwd_plan = ctx.plans
            g = g.contiguous()
            k = None if ids is None else ids.shape[1]
            if sampled_backward(bwd_plan, k, g.shape[1], g.dtype):
                dx = plan_sspmm(bwd_plan, fwd_plan, g, ids, post, pre)
            else:
                dx = plan_spmm(bwd_plan, g, post, pre)
            return dx.to(ctx.x_dtype), None, None, None, None, None, None


def planned_aggregate(g, x: torch.Tensor, norm: str = "sum",
                      k: int | None = None,
                      ids: torch.Tensor | None = None) -> torch.Tensor:
    """y = A_w x through the kernel pair of `g`'s plans (a PlannedGraph's, or
    windowed plans for a plain Graph). `k` (optional) states that x is MaxK
    top-k sparse per row (see `plan_spmm`); `ids` (optional, uint8 [N, k])
    that x is the output of a MaxK that kept those channels, which the
    sampled backward reads (`sampled_backward`)."""
    src_f, dst_f = node_factors(g, norm)
    fwd, bwd = graph_plans(g)
    return Aggregate.apply(x.contiguous(), fwd, bwd, src_f, dst_f, k, ids)


def spgemm_forward(dim: int, values: torch.Tensor, channels: torch.Tensor,
                   src_f, dst_f, plans) -> torch.Tensor:
    """CBSR forward: y f32 = dst_f ⊙ A densify(src_f ⊙ values) through the
    forward plan's kernel. bf16 values are scaled in bf16 (the factor
    rounded to bf16, the product rounded once) and densified into f32, the
    reference's `stream_dtype` (`spgemm_gnn_tpu/kernels/planned.py:198-
    243`). Where `cbsr_forward` takes it (k = values.shape[1]), (src_f ⊙
    values, channels) go to the CBSR form of the plan's kernel with no
    densify (f32 values under the 16-bit stream rounded to bf16 after the
    factor; bf16 values as they are, through its bf16 form)."""
    bf16 = values.dtype == torch.bfloat16
    k = values.shape[1]
    if cbsr_forward(plans[0], k, dim, values.dtype):
        if _stream16() and not bf16:
            rec = cbsr_records(round_rows(values, src_f), channels, dim)
            return _cbsr(plans[0], rec, k, dim, None, dst_f, torch.bfloat16)
        v = _scale(values, src_f).contiguous()
        return _cbsr(plans[0], cbsr_records(v, channels, dim), k, dim, None,
                     dst_f, torch.bfloat16 if bf16 else torch.float32)
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
