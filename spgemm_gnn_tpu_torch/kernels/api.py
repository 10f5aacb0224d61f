"""Dispatch of the nonlinearity, the aggregation and the 16-bit layer norm
(counterpart of `spgemm_gnn_tpu/kernels/api.py`).

impl:
  "auto"  — the kernels for CUDA tensors, their plain versions for CPU ones;
  "cuda"  — the kernels; a CPU tensor raises;
  "torch" — the plain PyTorch ops (ops/) on any device;
  "ell"   — the neighbor-group baseline (ops/ell.py, plain PyTorch on any
            device), for the aggregations only, on an ELLGraph
            (`ops.ell.ell_graph`); "auto" on an ELLGraph is "ell".
The JAX package's "xla"/"xla_dense" are "torch" here and its "pallas" is the
kernels.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.kernels import maxk as _maxk_kernel
from spgemm_gnn_tpu_torch.kernels.cbsr import CBSRCompact
from spgemm_gnn_tpu_torch.kernels.layernorm import LayerNorm16
from spgemm_gnn_tpu_torch.kernels import planned as _planned
from spgemm_gnn_tpu_torch.kernels.planned import (graph_plans,
                                                  planned_aggregate)
from spgemm_gnn_tpu_torch.ops import ell as _ell
from spgemm_gnn_tpu_torch.ops import maxk as _maxk_plain
from spgemm_gnn_tpu_torch.ops.layernorm import layer_norm16_forward
from spgemm_gnn_tpu_torch.ops import spmm as _spmm_plain
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.parallel.planned_sharded import (
    ShardedPlannedGraph, sharded_planned_aggregate)
from spgemm_gnn_tpu_torch.parallel.sharded import ShardedGraph, sharded_spmm
from spgemm_gnn_tpu_torch.utils import spans

IMPLS = ("auto", "torch", "cuda")
AGGREGATE_IMPLS = (*IMPLS, "ell")


def _check_impl(impl: str, x: torch.Tensor,
                impls: tuple[str, ...] = IMPLS) -> None:
    if impl not in impls:
        raise ValueError(f"unknown impl {impl!r}; expected one of {impls}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors; got one on "
                         f"{x.device}")


def maxk_op(x: torch.Tensor, k: int | None,
            impl: str = "auto", with_ids: bool = False):
    """Top-k nonlinearity: x unchanged when k is None or k >= dim. With
    `with_ids` (the kernels' impls, k < dim <= 256): (y, ids), ids uint8
    [N, k] the channels each row kept (`kernels/maxk.py::maxk_fwd`)."""
    if k is None or k >= x.shape[-1]:
        return x
    _check_impl(impl, x)
    if impl == "torch":
        if with_ids:
            raise ValueError("impl='torch' gives no MaxK channel ids")
        return _maxk_plain.maxk(x, k)
    return _maxk_kernel.maxk(x, k, with_ids)


def cbsr_compact(x: torch.Tensor, k: int, impl: str = "auto"
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """CBSR of an already MaxK-masked x f32 or bf16 [N, dim]: (values
    [N, k] in x's dtype, channels int32 [N, k]), `ops.maxk.cbsr_from_masked`'s
    channel set in the compaction kernel's slot order (the nonzero channels
    ascending, then the lowest zero channels). Differentiable in the values:
    dx is the densify of dvalues in x's dtype (`cbsr_densify_bf16` for a
    bf16 CUDA x, `maxk_pallas.py:244-253`)."""
    _check_impl(impl, x)
    if impl == "torch":
        return _maxk_plain.cbsr_compact_plain(x, k)
    return CBSRCompact.apply(x.contiguous(), k)


def layer_norm16(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 eps: float, impl: str = "auto") -> torch.Tensor:
    """Differentiable layer norm of bf16 rows x [N, dim] with f32 weight and
    bias [dim] (flax LayerNorm(dtype=bfloat16): f32 arithmetic, one rounding
    to bf16): the `layer_norm16` kernels, or with impl "torch" the plain ops
    differentiated by autograd."""
    _check_impl(impl, x)
    if impl == "torch":
        return layer_norm16_forward(x, weight, bias, eps)[0]
    return LayerNorm16.apply(x.contiguous(), weight, bias, eps)


def _ell_route(g, impl: str, x: torch.Tensor) -> str:
    """The impl an aggregation over g takes (the JAX package's rule,
    `spgemm_gnn_tpu/kernels/api.py:163-172`): "auto" on an ELLGraph is
    "ell", and "ell" needs an ELLGraph."""
    _check_impl(impl, x, AGGREGATE_IMPLS)
    if isinstance(g, _ell.ELLGraph):
        if impl == "auto":
            return "ell"
        if impl != "ell":
            raise ValueError(f"impl={impl!r} takes a Graph or a "
                             f"PlannedGraph, not an ELLGraph")
    elif impl == "ell":
        raise ValueError("impl='ell' requires an ELLGraph "
                         "(ops.ell.ell_graph)")
    return impl


def aggregate(g, x: torch.Tensor, norm: str = "sum", k: int | None = None,
              impl: str = "auto",
              ids: torch.Tensor | None = None) -> torch.Tensor:
    """Aggregate node features over the graph: y = A_w x (norm sum/mean/gcn).

    A PlannedGraph aggregates through its plan's kernel pair (`csr_spmm` for
    the "windowed" kind, `stream_spmm` for "stream"); a plain Graph through
    `csr_spmm`. `k` states that x is MaxK top-k sparse per row: by
    `kernels.planned.STREAM_CBSR_FORWARD`'s rule (by default where k < dim
    <= 256), a stream plan's forward then takes `stream_cbsr_spmm` on x's
    CBSR. The backward is the dense kernel
    on Aᵀ (the aggregation is linear and MaxK's own backward applies the
    mask), or, given `ids` (the channels x's MaxK kept, `maxk_op(...,
    with_ids=True)`), by `kernels.planned.SAMPLED_BACKWARD`'s rule the
    sampled form at those channels only (`stream_sspmm` on a stream plan,
    `csr_sspmm` on a windowed one). impl "torch" takes the plain dense
    product; an ELLGraph (impl "ell" or "auto") the neighbor-group
    baseline, forward and backward (`ops.ell.ell_aggregate`). A sharded
    graph aggregates over its mesh, as the JAX package dispatches it
    (`spgemm_gnn_tpu/kernels/api.py:214-220`): a ShardedGraph through the
    plain `sharded_spmm` (impl "torch" or "auto"), a ShardedPlannedGraph
    through its shards' kernel pairs and the halo exchange
    (`sharded_planned_aggregate`, impl "cuda" or "auto"; the kernels on
    CUDA tensors, their plain versions on CPU ones); any other impl raises.
    Its span is `aggregate`; the backward of each autograd Function it
    reaches, `aggregate.backward` (utils/spans.py).
    """
    with spans.span("aggregate"):
        return _aggregate(g, x, norm, k, impl, ids)


def _aggregate(g, x: torch.Tensor, norm: str, k: int | None, impl: str,
               ids: torch.Tensor | None) -> torch.Tensor:
    if isinstance(g, (ShardedGraph, ShardedPlannedGraph)):
        _check_impl(impl, x)
        if isinstance(g, ShardedGraph):
            if impl == "cuda":
                raise ValueError("impl='cuda' takes a ShardedPlannedGraph "
                                 "(shard_planned_graph); a ShardedGraph "
                                 "aggregates by the plain sharded_spmm")
            return sharded_spmm(g, x, norm, k)
        if impl == "torch":
            raise ValueError("impl='torch' takes a ShardedGraph "
                             "(shard_graph); a ShardedPlannedGraph "
                             "aggregates through the kernels")
        return sharded_planned_aggregate(g, x, norm, k)
    impl = _ell_route(g, impl, x)
    if impl == "ell":
        return _ell.ell_aggregate(g, x, norm)
    if impl == "torch":
        return _spmm_plain.spmm(g, x, norm)
    return planned_aggregate(g, x, norm, k, ids)


class SpGEMM(torch.autograd.Function):
    """y = dst_f ⊙ A densify(src_f ⊙ values) (the SpGEMM forward);
    dvalues = src_f ⊙ (Aᵀ (dst_f ⊙ g)) sampled at the channels (the SSpMM
    backward), by `ops`' `spgemm_forward` / `sspmm_backward` over `plans`
    (kernels/planned.py over the plans, or ops/ell.py over the group
    tables). Only `values` gets a gradient, in its own dtype."""

    @staticmethod
    def forward(ctx, values, channels, dim, plans, src_f, dst_f, ops):
        ctx.save_for_backward(channels, src_f, dst_f)
        ctx.plans = plans
        ctx.ops = ops
        ctx.v_dtype = values.dtype
        return ops.spgemm_forward(dim, values, channels, src_f, dst_f, plans)

    @staticmethod
    def backward(ctx, g):
        channels, src_f, dst_f = ctx.saved_tensors
        with spans.span("aggregate.backward"):
            dv = ctx.ops.sspmm_backward(g, channels, src_f, dst_f, ctx.plans)
        return dv.to(ctx.v_dtype), None, None, None, None, None, None


def aggregate_cbsr(g, values: torch.Tensor, channels: torch.Tensor, dim: int,
                   norm: str = "sum", impl: str = "auto") -> torch.Tensor:
    """Aggregate CBSR features over the graph: dense y = A_w cbsr(values, ch).

    Args:
      g: Graph or PlannedGraph; the kernels take its plans (a plain Graph's
         are `csr_spmm` over its CSR).
      values/channels: CBSR features (f32 or bf16 [N, k], int32 [N, k])
         from `ops.maxk.maxk_cbsr` or `cbsr_compact` (above). bf16 values
         are scaled in bf16 and densified into f32 (kernels/planned.py::
         spgemm_forward); y is f32 and dvalues take the values' dtype.
      dim: dense feature width.
      norm: "sum" | "mean" | "gcn" (ops/norms.py).
      impl: "auto" | "cuda" (the kernels: densify, the plan's product,
         sample) | "torch" (densify and the plain product, differentiated by
         autograd) | "ell" (an ELLGraph's group tables; "auto" on one).
    """
    impl = _ell_route(g, impl, values)
    if impl == "torch":
        return _spmm_plain.spmm(
            g, _maxk_plain.cbsr_to_dense(values, channels, dim), norm)
    src_f, dst_f = node_factors(g, norm)
    if impl == "ell":
        return SpGEMM.apply(values, channels.contiguous(), dim,
                            (g.fwd, g.bwd), src_f, dst_f, _ell)
    return SpGEMM.apply(values, channels.contiguous(), dim, graph_plans(g),
                        src_f, dst_f, _planned)
