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

The CBSR helpers (per node, k values and k int32 channel ids) follow:
`maxk_cbsr`, `cbsr_from_masked` and `cbsr_to_dense`, with the plain versions
of the `cbsr_compact`, `cbsr_densify` and `cbsr_sample` kernels
(kernels/cbsr.py): `cbsr_compact_plain`, `cbsr_to_dense` and
`sample_channels`. The differentiable compaction that chooses between the
kernel and its plain version is `kernels/api.py::cbsr_compact`.
`pack_channels` / `unpack_channels` pack the channel ids into int32 words, and
`cbsr_records` / `split_records` put a node's values and ids in one
record, the layout the `stream_cbsr_spmm` kernel gathers (f32 values and
packed ids; or bf16 values and ids a word each, in whole 128-byte lines).
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


def maxk_channel_ids(x: torch.Tensor, meta: torch.Tensor,
                     k: int) -> torch.Tensor:
    """uint8 [N, k]: the channels each row's mask keeps, ascending, rebuilt
    from (x, meta) (the plain version of the ids that `maxk_fwd_ids` and
    `maxk_fwd_bf16_ids` write beside y). Needs dim <= 256."""
    if x.shape[-1] > 256:
        raise ValueError(f"MaxK channel ids are uint8: dim <= 256; got "
                         f"{x.shape[-1]}")
    return _first_channels(mask_from_meta(x, meta), k).to(torch.uint8)


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


# ---------------------------------------------------------------------------
# CBSR: per node, k values and their k channel ids (int32, so no id wraps at
# a hidden dim above 256)
# ---------------------------------------------------------------------------

def _first_channels(keep: torch.Tensor, k: int) -> torch.Tensor:
    """int32 [N, k]: per row the channels where `keep` holds, ascending, then
    the others, ascending, cut to k."""
    dim = keep.shape[-1]
    iota = torch.arange(dim, device=keep.device)
    keys = torch.where(keep, iota, dim + iota)     # distinct per row
    return (torch.topk(keys, k, dim=-1, largest=False).values % dim).int()


def maxk_cbsr(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """MaxK → CBSR: (values [N, k], channels int32 [N, k]), channels
    ascending, ties kept as `maxk` keeps them. `values` carries the gradient
    (a gather of x)."""
    ch = _first_channels(maxk_mask(x.detach(), k) != 0, k)
    return torch.gather(x, 1, ch.long()), ch


def cbsr_from_masked(x: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """CBSR of an already MaxK-masked x (≤ k nonzeros per row): the nonzero
    channels and, on shorter rows, the lowest zero channels, all in ascending
    order (the JAX oracle's channel set and order)."""
    ch = torch.sort(_first_channels(x.detach() != 0, k), dim=-1).values
    return torch.gather(x, 1, ch.long()), ch


def cbsr_compact_plain(x: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the `cbsr_compact` kernel (kernels/cbsr.py): the
    nonzero channels in ascending order, then the lowest zero channels, with
    x's values there (the slot order of the JAX `cbsr_compact_pallas`).
    The values are a gather of x, so autograd carries their gradient."""
    ch = _first_channels(x != 0, k)
    return torch.gather(x, 1, ch.long()), ch


def cbsr_to_dense(values: torch.Tensor, channels: torch.Tensor, dim: int,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Scatter CBSR back to a dense [N, dim] array of `out_dtype` (default
    the values' dtype; zeros elsewhere), the values cast to it first: the
    plain version of the `cbsr_densify` kernel."""
    dtype = values.dtype if out_dtype is None else out_dtype
    out = values.new_zeros((values.shape[0], dim), dtype=dtype)
    return out.scatter(1, channels.long(), values.to(dtype))


def sample_channels(z: torch.Tensor, channels: torch.Tensor) -> torch.Tensor:
    """dv[n, j] = z[n, channels[n, j]] in z's dtype: the plain version of the
    `cbsr_sample` kernel."""
    return torch.gather(z, 1, channels.long())


# ---------------------------------------------------------------------------
# Packed channel ids: the payload the `stream_cbsr_spmm` kernel gathers per
# edge (kernels/stream.py). Four uint8 ids per int32 word at dim <= 256, two
# uint16 ids above; k is padded to a whole word with channel 0.
# ---------------------------------------------------------------------------

def _ids_per_word(dim: int) -> int:
    if dim > 65536:
        raise ValueError(f"pack_channels supports dim <= 65536; got {dim}")
    return 4 if dim <= 256 else 2


def packed_channel_words(k: int, dim: int) -> int:
    """int32 words per row of a packed channel payload."""
    per = _ids_per_word(dim)
    return -(-k // per)


def pack_channels(channels: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """int32 [N, packed_channel_words(k, dim)] of channel ids [N, k], id j
    of a word in bits [b·j, b·(j + 1)) with b = 32 / ids per word (the JAX
    package's words bit for bit: an id >= 128 in the top byte sets the
    word's sign bit). `dim` is the width the ids index into."""
    per = _ids_per_word(dim)
    n, k = channels.shape
    # in int32: OR and a left shift that drops the high bits give the JAX
    # function's uint32 bits
    c = torch.nn.functional.pad(channels.to(torch.int32), (0, (-k) % per))
    c = c.reshape(n, -1, per)
    words = c[..., 0]
    for j in range(1, per):
        words = words | (c[..., j] << (32 // per * j))
    return words.contiguous()


def unpack_channels(packed: torch.Tensor, k: int, dim: int = 256
                    ) -> torch.Tensor:
    """Inverse of `pack_channels` (with the same `dim`): int32 [N, k]."""
    per = _ids_per_word(dim)
    bits = 32 // per
    p = packed.long() & (_U32 - 1)
    shifts = torch.arange(per, device=p.device) * bits
    parts = (p[..., None] >> shifts) & ((1 << bits) - 1)
    return parts.reshape(packed.shape[0], -1)[:, :k].to(torch.int32)


def record_words(k: int, dim: int, dtype: torch.dtype = torch.float32
                 ) -> int:
    """int32 words of a node's record (`cbsr_records`): k f32 values and
    the packed ids, or, for bf16 values, k slot words padded to 1, 2, 4 or
    8 whole 128-byte lines (32 words each; a power of two, the kernel's
    lines a record)."""
    if dtype == torch.bfloat16:
        return 32 * (1 if k <= 32 else 2 if k <= 64 else 4 if k <= 128
                     else 8)
    return k + packed_channel_words(k, dim)


def cbsr_records(values: torch.Tensor, channels: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """One record per node, what `stream_cbsr_spmm` gathers per edge: int32
    [N, record_words(k, dim, dtype)]. f32 values (any dtype but bf16, as
    f32): the k values' bits, then the packed channel ids
    (`pack_channels`), 160 B at k 32 and dim 256 (five 32-B sectors). bf16
    values (the 16-bit stream and model): word j holds value j's bits in
    its high half and channel j in its low (dim <= 65536), zero words pad
    the record to `record_words`, 128 B at k <= 32: one aligned line, so
    that a warp copies four records with one 16-B load a lane and a lane
    reads a slot with one word."""
    if values.dtype == torch.bfloat16:
        if dim > 65536:
            raise ValueError(f"bf16 records hold channel ids < 65536; got "
                             f"dim={dim}")
        n, k = values.shape
        # a word's two 16-bit halves, low first (little-endian, as on the
        # card and the host): the channel (an id >= 2^15 keeps its bits),
        # then the value's bits
        halves = torch.zeros((n, record_words(k, dim, values.dtype), 2),
                             dtype=torch.int16, device=values.device)
        halves[:, :k, 0] = channels
        halves[:, :k, 1] = values.view(torch.int16)
        return halves.view(torch.int32).view(n, -1)
    bits = values.to(torch.float32).contiguous().view(torch.int32)
    return torch.cat([bits, pack_channels(channels, dim)], dim=1)


def split_records(records: torch.Tensor, k: int, dim: int,
                  dtype: torch.dtype = torch.float32
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of `cbsr_records` for values of `dtype` (f32 or bf16):
    (values [N, k], channels int32 [N, k])."""
    if dtype == torch.bfloat16:
        words = records[:, :k].to(torch.int64) & (_U32 - 1)
        bits = words >> 16
        bits = torch.where(bits >= 1 << 15, bits - (1 << 16), bits)
        return (bits.to(torch.int16).view(torch.bfloat16),
                (words & 0xffff).to(torch.int32))
    values = records[:, :k].contiguous().view(torch.float32)
    return values, unpack_channels(records[:, k:], k, dim)
