"""Edge-weight normalisations as per-node factors (counterpart of
`spgemm_gnn_tpu/ops/norms.py`).

Every supported norm is separable, w_e = src_f[src] · dst_f[dst], so it is
applied as a pre-scaling of the gathered rows and a post-scaling of the
output rows. No [E] weight array is ever built.
"""
from __future__ import annotations

import torch

NORM_SUM = "sum"    # w_e = 1
NORM_MEAN = "mean"  # w_e = 1 / max(in_deg[dst], 1)        (DGL fn.mean / SAGE)
NORM_GCN = "gcn"    # w_e = rsqrt(max(out_deg[src],1)) * rsqrt(max(in_deg[dst],1))


def _clamp1(d: torch.Tensor) -> torch.Tensor:
    return d.clamp(min=1).to(torch.float32)


def node_factors(g, norm: str
                 ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """Per-node (src_factor, dst_factor) f32 tensors such that
    w_e = src_f[src] · dst_f[dst]. Either factor may be None (≡ 1.0)."""
    if norm == NORM_SUM:
        return None, None
    if norm == NORM_MEAN:
        return None, 1.0 / _clamp1(g.in_degrees)
    if norm == NORM_GCN:
        return (torch.rsqrt(_clamp1(g.out_degrees)),
                torch.rsqrt(_clamp1(g.in_degrees)))
    raise ValueError(f"unknown norm {norm!r}")
