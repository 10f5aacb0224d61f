"""Plain PyTorch layer norm of bf16 rows: the 16-bit model's LayerNorm
(`--dtype bfloat16`) and the plain version of the `layer_norm16` CUDA
kernels (kernels/layernorm.py).

flax `LayerNorm(dtype=bfloat16)` takes the statistics in f32 and computes
y = (x − mean) · (rsqrt(var + eps) · scale) + bias in f32 with f32
parameters, then rounds y once to bf16 (`_normalize` with
`force_float32_reductions`). The association matters: `F.layer_norm` folds
it otherwise, and the last f32 bit decides bf16 roundings. The backward is
the layer norm gradient in f32, dx rounded to bf16.
"""
from __future__ import annotations

import torch


def layer_norm16_forward(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y in x's dtype, mean f32 [N], rstd f32 [N]) of the rows of x."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, -1, unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x32 - mean) * (rstd * weight) + bias
    return y.to(x.dtype), mean.squeeze(-1), rstd.squeeze(-1)


def layer_norm16_backward(x: torch.Tensor, mean: torch.Tensor,
                          rstd: torch.Tensor, weight: torch.Tensor,
                          g: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """(dx in x's dtype, dweight f32, dbias f32) for the cotangent g of y."""
    g32 = g.float()
    mean, rstd = mean[:, None], rstd[:, None]
    xhat = (x.float() - mean) * rstd
    gx = g32 * weight
    dx = rstd * (gx - gx.mean(-1, keepdim=True)
                 - xhat * (gx * xhat).mean(-1, keepdim=True))
    return dx.to(x.dtype), (g32 * xhat).sum(0), g32.sum(0)
