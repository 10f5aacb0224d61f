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


def edge_weights(g, norm: str, *, transpose: bool = False
                 ) -> torch.Tensor | None:
    """Per-edge weights f32 [E] in forward (in-CSR) or transpose (out-CSR)
    edge order; None for "sum" (every weight 1).

    In transpose order, edge e' has src = t_edge_dst[e'] (the original
    source) and dst = t_indices[e'] (the original destination).
    """
    src_f, dst_f = node_factors(g, norm)
    if src_f is None and dst_f is None:
        return None
    if transpose:
        src_ids, dst_ids = g.t_edge_dst, g.t_indices
    else:
        src_ids, dst_ids = g.indices, g.edge_dst
    w = None
    if src_f is not None:
        w = src_f[src_ids.long()]
    if dst_f is not None:
        w = dst_f[dst_ids.long()] if w is None else w * dst_f[dst_ids.long()]
    return w
