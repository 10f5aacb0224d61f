"""Dispatch of the nonlinearity and the aggregation (counterpart of
`spgemm_gnn_tpu/kernels/api.py`).

impl:
  "auto"  — the kernels for CUDA tensors, their plain versions for CPU ones;
  "cuda"  — the kernels; a CPU tensor raises;
  "torch" — the plain PyTorch ops (ops/) on any device.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.kernels import maxk as _maxk_kernel
from spgemm_gnn_tpu_torch.kernels import spmm as _spmm_kernel
from spgemm_gnn_tpu_torch.ops import maxk as _maxk_plain
from spgemm_gnn_tpu_torch.ops import spmm as _spmm_plain

IMPLS = ("auto", "torch", "cuda")


def _check_impl(impl: str, x: torch.Tensor) -> None:
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


def aggregate(g, x: torch.Tensor, norm: str = "sum", k: int | None = None,
              impl: str = "auto") -> torch.Tensor:
    """Aggregate node features over the graph: y = A_w x (norm sum/mean/gcn).

    `k` states that x is MaxK top-k sparse per row. Dense and masked inputs
    take the same kernel pair (the aggregation is linear and MaxK's own
    backward applies the mask), so this slice does not read it.
    """
    del k
    _check_impl(impl, x)
    if impl == "torch":
        return _spmm_plain.spmm(g, x, norm)
    return _spmm_kernel.aggregate(g, x, norm)
