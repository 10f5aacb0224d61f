"""Plain PyTorch MaxK (counterpart of `spgemm_gnn_tpu/ops/maxk.py` and of the
mask semantics of `spgemm_gnn_tpu/kernels/maxk_pallas.py`).

MaxK keeps the k largest entries of each row and zeroes the rest; its
gradient multiplies the incoming gradient by the same mask. The order is the
one of the JAX kernel: floats map to order-preserving uint32 keys (so −0.0
ranks below +0.0), and ties at the k-th key keep the lowest channel indices.
`torch.topk` promises no tie order, so it is not used.

Per row the forward also yields meta = (pivot, tie bound) as int32 [N, 2]:
the k-th largest key (its uint32 bits) and the first channel of a tie that
was dropped (dim when none was). The backward rebuilds the mask from
(x, meta) in one pass; no [N, dim] mask is kept. These are the plain
versions of the `maxk_fwd` / `maxk_bwd` CUDA kernels (kernels/maxk.py).
"""
from __future__ import annotations

import torch

_U32 = 1 << 32
_SIGN = 1 << 31


def ordered_keys(x: torch.Tensor) -> torch.Tensor:
    """int64 keys in [0, 2^32) whose order is the float order of x (f32)."""
    b = x.to(torch.float32).view(torch.int32)
    return torch.where(b < 0, (~b).to(torch.int64), b.to(torch.int64) + _SIGN)


def _mask(keys: torch.Tensor, pivot: torch.Tensor,
          bound: torch.Tensor) -> torch.Tensor:
    iota = torch.arange(keys.shape[-1], device=keys.device)
    return (keys > pivot) | ((keys == pivot) & (iota < bound))


def maxk_forward(x: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, meta): y = x · topk_mask(x), meta int32 [N, 2] = (pivot, bound).
    Requires 1 <= k < dim."""
    dim = x.shape[-1]
    if not 1 <= k < dim:
        raise ValueError(f"maxk needs 1 <= k < dim; got k={k}, dim={dim}")
    keys = ordered_keys(x)
    pivot = torch.sort(keys, dim=-1, descending=True).values[:, k - 1:k]
    ties = keys == pivot
    budget = k - (keys > pivot).sum(-1, keepdim=True)
    dropped = ties & (ties.cumsum(-1) > budget)
    iota = torch.arange(dim, device=x.device)
    bound = torch.where(dropped, iota, dim).amin(-1, keepdim=True)
    pivot_bits = torch.where(pivot >= _SIGN, pivot - _U32, pivot)
    meta = torch.cat([pivot_bits, bound], dim=-1).to(torch.int32)
    y = x * _mask(keys, pivot, bound).to(x.dtype)
    return y, meta


def mask_from_meta(x: torch.Tensor, meta: torch.Tensor) -> torch.Tensor:
    """The forward's boolean mask, rebuilt from (x, meta) in one pass."""
    pivot = meta[:, :1].to(torch.int64) & (_U32 - 1)
    return _mask(ordered_keys(x), pivot, meta[:, 1:2])


def maxk_backward(x: torch.Tensor, meta: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """dx = g · mask(x, meta)."""
    return g * mask_from_meta(x, meta).to(g.dtype)


def maxk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Float mask of the top-k entries of each row (ties: lowest index)."""
    if k >= x.shape[-1]:
        return torch.ones_like(x)
    _, meta = maxk_forward(x, k)
    return mask_from_meta(x, meta).to(x.dtype)


def maxk(x: torch.Tensor, k: int) -> torch.Tensor:
    """MaxK: y = x · topk_mask(x); the mask is a constant to autograd, so the
    gradient is g · mask."""
    return x * maxk_mask(x.detach(), k)
