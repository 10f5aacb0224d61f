"""Dispatch of the nonlinearity, the aggregation and the 16-bit layer norm
(counterpart of `spgemm_gnn_tpu/kernels/api.py`).

impl:
  "auto"  — the kernels for CUDA tensors, their plain versions for CPU ones;
  "cuda"  — the kernels; a CPU tensor raises;
  "torch" — the plain PyTorch ops (ops/) on any device.
The JAX package's "xla"/"xla_dense" are "torch" here and its "pallas" is the
kernels; its "ell" waits for the ELL baseline (ROADMAP Queue A12).
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.kernels import maxk as _maxk_kernel
from spgemm_gnn_tpu_torch.kernels.cbsr import CBSRCompact
from spgemm_gnn_tpu_torch.kernels.layernorm import LayerNorm16
from spgemm_gnn_tpu_torch.kernels.planned import (graph_plans,
                                                  planned_aggregate,
                                                  spgemm_forward,
                                                  sspmm_backward)
from spgemm_gnn_tpu_torch.ops import maxk as _maxk_plain
from spgemm_gnn_tpu_torch.ops.layernorm import layer_norm16_forward
from spgemm_gnn_tpu_torch.ops import spmm as _spmm_plain
from spgemm_gnn_tpu_torch.ops.norms import node_factors

IMPLS = ("auto", "torch", "cuda")


def _check_impl(impl: str, x: torch.Tensor) -> None:
    if impl == "ell":
        raise NotImplementedError("impl='ell' is not ported to "
                                  "spgemm_gnn_tpu_torch yet (ROADMAP Queue "
                                  "A12, the ELL baseline)")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors; got one on "
                         f"{x.device}")


def maxk_op(x: torch.Tensor, k: int | None,
            impl: str = "auto") -> torch.Tensor:
    """Top-k nonlinearity: x unchanged when k is None or k >= dim."""
    if k is None or k >= x.shape[-1]:
        return x
    _check_impl(impl, x)
    if impl == "torch":
        return _maxk_plain.maxk(x, k)
    return _maxk_kernel.maxk(x, k)


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


def aggregate(g, x: torch.Tensor, norm: str = "sum", k: int | None = None,
              impl: str = "auto") -> torch.Tensor:
    """Aggregate node features over the graph: y = A_w x (norm sum/mean/gcn).

    A PlannedGraph aggregates through its plan's kernel pair (`csr_spmm` for
    the "windowed" kind, `stream_spmm` for "stream"); a plain Graph through
    `csr_spmm`. `k` states that x is MaxK top-k sparse per row: by
    `kernels.planned.STREAM_CBSR_FORWARD`'s rule (by default where k < dim
    <= 256), a stream plan's forward then takes `stream_cbsr_spmm` on x's
    CBSR. The backward is the dense kernel
    on Aᵀ either way (the aggregation is linear and MaxK's own backward
    applies the mask). impl "torch" takes the plain dense product.
    """
    _check_impl(impl, x)
    if impl == "torch":
        return _spmm_plain.spmm(g, x, norm)
    return planned_aggregate(g, x, norm, k)


class SpGEMM(torch.autograd.Function):
    """y = dst_f ⊙ A densify(src_f ⊙ values) (the SpGEMM forward);
    dvalues = src_f ⊙ (Aᵀ (dst_f ⊙ g)) sampled at the channels (the SSpMM
    backward). Only `values` gets a gradient, in its own dtype."""

    @staticmethod
    def forward(ctx, values, channels, dim, plans, src_f, dst_f):
        ctx.save_for_backward(channels, src_f, dst_f)
        ctx.plans = plans
        ctx.v_dtype = values.dtype
        return spgemm_forward(dim, values, channels, src_f, dst_f, plans)

    @staticmethod
    def backward(ctx, g):
        channels, src_f, dst_f = ctx.saved_tensors
        dv = sspmm_backward(g, channels, src_f, dst_f, ctx.plans)
        return dv.to(ctx.v_dtype), None, None, None, None, None


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
         autograd).
    """
    _check_impl(impl, values)
    if impl == "torch":
        return _spmm_plain.spmm(
            g, _maxk_plain.cbsr_to_dense(values, channels, dim), norm)
    src_f, dst_f = node_factors(g, norm)
    return SpGEMM.apply(values, channels.contiguous(), dim, graph_plans(g),
                        src_f, dst_f)
