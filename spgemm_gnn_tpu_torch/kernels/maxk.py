"""MaxK on its CUDA kernels (counterpart of `spgemm_gnn_tpu/kernels/
maxk_pallas.py`; sources in `csrc/maxk.cu`).

`maxk_fwd` and `maxk_bwd` launch the kernels on CUDA tensors and take the
plain versions (ops/maxk.py) on CPU tensors. `MaxK` is the autograd Function:
its forward keeps (x, meta), and its backward rebuilds the mask from them.

On bf16 rows (the 16-bit model, `--dtype bfloat16`) they launch the bf16
forms, `maxk_fwd_bf16` and `maxk_bwd_bf16` (counted under those names):
keys from the exact f32 widening, y and dx in bf16. A bf16 tensor never
reaches an f32 kernel.

`maxk_fwd(x, k, with_ids=True)` also returns the channels each row keeps,
ascending, as uint8 ids [N, k] (dim <= 256): the mask's channel set
exactly, kept zeros included, which the sampled backward of the
aggregation reads (kernels/planned.py::SAMPLED_BACKWARD). The kernel is the
same forward with a k-byte store a row (C entry points `maxk_fwd_ids` and
`maxk_fwd_bf16_ids`), counted under `maxk_fwd` / `maxk_fwd_bf16`.
"""
from __future__ import annotations

import torch

from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.ops.maxk import (maxk_backward, maxk_channel_ids,
                                           maxk_forward)

MAX_DIM = 1024   # a row lives in one warp's registers
MAX_IDS_DIM = 256   # the kept channels' ids are uint8


ROW_DTYPES = (torch.float32, torch.bfloat16)


def _name(base: str, x: torch.Tensor) -> str:
    return base + "_bf16" if x.dtype == torch.bfloat16 else base


def maxk_fwd(x: torch.Tensor, k: int, with_ids: bool = False
             ) -> tuple[torch.Tensor, ...]:
    """(y, meta) = MaxK of the rows of x (f32 or bf16 [N, dim]), y in x's
    dtype; meta int32 [N, 2]. with_ids: (y, meta, ids), ids uint8 [N, k]
    the kept channels of each row, ascending (dim <= 256)."""
    if with_ids and x.shape[-1] > MAX_IDS_DIM:
        raise ValueError(f"maxk_fwd's channel ids need dim <= {MAX_IDS_DIM}"
                         f"; got {x.shape[-1]}")
    if _build.on_cpu(x):
        y, meta = maxk_forward(x, k)
        return (y, meta, maxk_channel_ids(x, meta, k)) if with_ids else (
            y, meta)
    _build.require(x, "x", ROW_DTYPES, x.device, (None, None))
    n, dim = x.shape
    if dim > MAX_DIM:
        raise ValueError(f"maxk_fwd supports dim <= {MAX_DIM}; got {dim}")
    if not 1 <= k < dim:
        raise ValueError(f"maxk_fwd needs 1 <= k < dim; got k={k}, dim={dim}")
    _build.require_aligned(x, "x")
    y = torch.empty_like(x)
    meta = torch.empty((n, 2), dtype=torch.int32, device=x.device)
    ids = (torch.empty((n, k), dtype=torch.uint8, device=x.device)
           if with_ids else None)
    if n:
        name = _name("maxk_fwd", x)
        lib = _build.library("maxk")
        with torch.cuda.device(x.device):
            if with_ids:
                status = getattr(lib, name + "_ids")(
                    x.data_ptr(), y.data_ptr(), meta.data_ptr(),
                    ids.data_ptr(), n, dim, k, _build.stream_of(x))
            else:
                status = getattr(lib, name)(
                    x.data_ptr(), y.data_ptr(), meta.data_ptr(), n, dim, k,
                    _build.stream_of(x))
        _build.check(status, name)
        _build.launches[name] += 1
    return (y, meta, ids) if with_ids else (y, meta)


def maxk_bwd(x: torch.Tensor, meta: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
    """dx = g · mask(x, meta) (x, g and dx f32 [N, dim], or all bf16; meta
    int32 [N, 2])."""
    if _build.on_cpu(x):
        return maxk_backward(x, meta, g)
    _build.require(x, "x", ROW_DTYPES, x.device, (None, None))
    n, dim = x.shape
    _build.require(meta, "meta", torch.int32, x.device, (n, 2))
    _build.require(g, "g", x.dtype, x.device, (n, dim))
    for t, what in ((x, "x"), (g, "g")):
        _build.require_aligned(t, what)
    dx = torch.empty_like(g)
    if n:
        name = _name("maxk_bwd", x)
        with torch.cuda.device(x.device):
            status = getattr(_build.library("maxk"), name)(
                x.data_ptr(), meta.data_ptr(), g.data_ptr(), dx.data_ptr(),
                n, dim, _build.stream_of(x))
        _build.check(status, name)
        _build.launches[name] += 1
    return dx


class MaxK(torch.autograd.Function):
    """y = x · topk_mask(x); dx = g · topk_mask(x), the mask rebuilt from
    the per-row (pivot, bound) meta. With `with_ids` the forward returns
    (y, ids), the kept channels' ids not differentiable."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, k: int, with_ids: bool = False):
        out = maxk_fwd(x, k, with_ids)
        ctx.save_for_backward(x, out[1])
        if with_ids:
            ctx.mark_non_differentiable(out[2])
            return out[0], out[2]
        return out[0]

    @staticmethod
    def backward(ctx, g: torch.Tensor, *_):
        x, meta = ctx.saved_tensors
        return maxk_bwd(x, meta, g.contiguous()), None, None


def maxk(x: torch.Tensor, k: int, with_ids: bool = False):
    """Differentiable MaxK through the kernels (1 <= k < dim); with_ids:
    (y, ids uint8 [N, k]), as `maxk_fwd`."""
    return MaxK.apply(x.contiguous(), k, with_ids)
