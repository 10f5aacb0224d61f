"""MaxK's select and the CBSR compaction on the row families that a select
which starts near the pivot and stops at it must not mishandle
(`utils/rows.py`):
more than 32 keys sharing the pivot's high bits, one repeated value,
integers, zeros and signed zeros, subnormals, infinities, and exactly k,
k - 1, k / 2 and one nonzero.

CPU: the plain versions (`ops/maxk.py::maxk_forward`, `cbsr_compact_plain`)
against the JAX kernels in interpret mode (`maxk_pallas`' call with its meta,
`cbsr_compact_pallas`), each family at dims 48, 100, 256 and 1024, k 1, 7,
32 and 64 (k < dim for MaxK, k <= dim for the compaction), f32 and bf16;
and the warp steps of `csrc/maxk.cu`'s forward select written once in
numpy (`warp_select`: the previous pivot's bucket as a guess, count passes
that stop at one key, the tie scan), held to `maxk_forward`'s meta on the
same rows, walked with the guess and without. GPU (marker `gpu`, no
JAX): `maxk_fwd` / `maxk_fwd_bf16` and `cbsr_compact` / `cbsr_compact_bf16`
bitwise against their plain versions on the families:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_maxk_rows.py
"""
import functools

import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels import cbsr as tcbsr
from spgemm_gnn_tpu_torch.kernels import maxk as tmaxk
from spgemm_gnn_tpu_torch.ops import maxk as plain
from spgemm_gnn_tpu_torch.utils.rows import family_rows

BF16 = torch.bfloat16
DTYPES = {"f32": torch.float32, "bf16": BF16}
FAMILIES = ("shared_prefix", "repeated", "integer", "zeros", "subnormal",
            "inf", "few_nonzeros")
# (dim, k): every k of 1, 7, 32, 64 below each dim
SHAPES = [(dim, k) for dim in (48, 100, 256, 1024) for k in (1, 7, 32, 64)
          if k < dim]
ROWS = 8     # rows per family block: the family's rows, then normal rows


def family_block(dim: int, k: int, dtype: str) -> dict[str, torch.Tensor]:
    """Family -> rows [ROWS, dim] in `dtype` (the family's rows, then random
    normal ones), from a seed of (dim, k)."""
    gen = torch.Generator().manual_seed(dim * 100 + k)
    out = {}
    for name, rows in family_rows(dim, k, gen).items():
        pad = torch.randn((ROWS - rows.shape[0], dim), generator=gen)
        out[name] = torch.cat([rows, pad]).to(DTYPES[dtype])
    return out


def f32(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def flushed(t: torch.Tensor) -> torch.Tensor:
    """t with its subnormals made signed zeros."""
    return torch.where(t.float().abs() < torch.finfo(torch.float32).tiny,
                       t * 0, t)


def all_rows(dim, k, dtype) -> torch.Tensor:
    return torch.cat([family_block(dim, k, dtype)[f] for f in FAMILIES])


@functools.lru_cache(maxsize=None)
def jax_maxk(dim: int, k: int, dtype: str):
    """(y f32, pivot bits, bound) of the JAX kernel on every family's block,
    one interpret-mode call per (dim, k, dtype)."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.maxk_pallas import _maxk_call

    x = jnp.asarray(f32(all_rows(dim, k, dtype)))
    if dtype == "bf16":
        x = x.astype(jnp.bfloat16)
    y, meta = _maxk_call(x, k, 8, True)
    meta = np.asarray(meta)
    return np.asarray(y, np.float32), meta[:, 0], meta[:, 64]


def compact_input(dim: int, k: int, dtype: str) -> torch.Tensor:
    """The rows as they are (more than k nonzeros on most), then their MaxK
    (k nonzeros or fewer): the compaction's inputs."""
    x = all_rows(dim, k, dtype)
    return torch.cat([x, plain.maxk_forward(x, min(k, dim - 1))[0]])


@functools.lru_cache(maxsize=None)
def jax_compact(dim: int, k: int, dtype: str):
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.maxk_pallas import cbsr_compact_pallas

    x = jnp.asarray(f32(compact_input(dim, k, dtype)))
    if dtype == "bf16":
        x = x.astype(jnp.bfloat16)
    v, c = cbsr_compact_pallas(x, k, 8, True)
    return np.asarray(v, np.float32), np.asarray(c)


def family_slice(family: str) -> slice:
    i = FAMILIES.index(family)
    return slice(i * ROWS, (i + 1) * ROWS)


# ---------------------------------------------------------------------------
# CPU: the plain versions against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("dim,k", SHAPES)
def test_maxk_family_matches_jax(dim, k, dtype, family):
    """maxk_forward against the JAX kernel: meta exactly (the pivot bits;
    the tie bound where a tie is dropped, and where none is, dim in the port
    and the top of the JAX kernel's bit search, >= dim), and y by value, as
    `test_maxk_matches_jax_exactly` holds y (the interpret mode writes +0.0
    where the port writes x * 0 = -0.0). XLA's CPU arithmetic is not IEEE
    in two places, both outside the select: on f32 rows it selects instead
    of multiplying, so a dropped infinity is 0 there and x * 0 = NaN in the
    port; on bf16 rows it flushes a kept subnormal to zero."""
    x = family_block(dim, k, dtype)[family]
    y, meta = plain.maxk_forward(x, k)
    y_j, pivot_j, bound_j = jax_maxk(dim, k, dtype)
    rows = family_slice(family)
    np.testing.assert_array_equal(meta[:, 0].numpy(), pivot_j[rows])
    np.testing.assert_array_equal(meta[:, 1].numpy(),
                                  np.minimum(bound_j[rows], dim))
    got, want = f32(flushed(y) if dtype == "bf16" else y), y_j[rows]
    dropped = (x.isinf() & ~plain.mask_from_meta(x, meta)).numpy()
    assert np.isnan(got[dropped]).all()
    if dtype == "f32":
        assert (want[dropped] == 0).all()
        got, want = got[~dropped], want[~dropped]
    np.testing.assert_array_equal(got, want)
    assert y.dtype == x.dtype


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("dim,k", SHAPES + [(48, 48), (100, 100)])
def test_compact_family_matches_jax(dim, k, dtype, family):
    """cbsr_compact_plain against cbsr_compact_pallas slot for slot, on the
    family's rows and on their MaxK: channels exactly, values by value (the
    JAX kernel writes +0.0 where the port keeps x's -0.0). The port keeps a
    subnormal as a nonzero, as x != 0 does in IEEE arithmetic; XLA on the
    CPU reads an f32 subnormal as zero (its slots are the port's on the rows
    with subnormals flushed to signed zeros) and writes a bf16 subnormal's
    value as zero."""
    x = compact_input(dim, k, dtype)
    n = x.shape[0] // 2
    rows = family_slice(family)
    pick = torch.cat([torch.arange(n)[rows], n + torch.arange(n)[rows]])
    x = x[pick]
    if family == "subnormal":
        assert (flushed(x) != x).any()
    v, c = plain.cbsr_compact_plain(flushed(x) if dtype == "f32" else x, k)
    v_j, c_j = jax_compact(dim, k, dtype)
    np.testing.assert_array_equal(c.numpy(), c_j[pick.numpy()])
    np.testing.assert_array_equal(f32(flushed(v)), v_j[pick.numpy()])
    assert v.dtype == x.dtype and c.dtype == torch.int32


# ---------------------------------------------------------------------------
# CPU: the forward kernel's warp steps in numpy
# ---------------------------------------------------------------------------

def lane_layout(dim: int) -> int:
    """Channels per lane: ceil(dim / 32) rounded up to a power of two."""
    per = 1
    while 32 * per < dim:
        per *= 2
    return per


def keys_of(x: torch.Tensor) -> np.ndarray:
    """The kernel's keys: f32 keys; for bf16, 16-bit keys from the bits (h ^
    0x8000 for h >= +0, ~h for h <= -0), held to the high halves of the f32
    keys of the exact widening."""
    if x.dtype != BF16:
        return plain.ordered_keys(x).numpy().astype(np.uint64)
    h = x.view(torch.int16).numpy().astype(np.uint64) & np.uint64(0xFFFF)
    key = h ^ (np.uint64(0x8000) | (h >> np.uint64(15)) * np.uint64(0x7FFF))
    np.testing.assert_array_equal(
        key, plain.ordered_keys(x).numpy().astype(np.uint64) >> np.uint64(16))
    return key


def count_ge(lanes: np.ndarray, c: int, kb: int) -> int:
    """count(key >= c) summed over the lanes (__reduce_add_sync of the
    lanes' counts); 16-bit keys as the kernel counts them, PER minus the
    keys for which key - c wraps past 2^31."""
    if kb == 16:
        lt = ((lanes - np.uint64(c)) & np.uint64(0xFFFFFFFF)) >> np.uint64(31)
        return int(lanes.size - lt.sum())
    return int((lanes >= np.uint64(c)).sum())


def count2(lanes, a: int, b: int, dim: int, kb: int) -> tuple[int, int]:
    top = 1 << kb
    na = count_ge(lanes, a, kb) if a < top else 0
    nb = count_ge(lanes, b, kb) if b < top else 0
    return (dim if a == 0 else na), nb


class Guess:
    """A warp's guess of its next pivot: the previous pivot's bucket at a
    level (kb or more: none)."""

    def __init__(self, kb: int):
        self.pivot, self.level = 0, kb


def warp_select(key: np.ndarray, k: int, kb: int, guess: Guess):
    """(pivot, bound, route, end) of one row as `csrc/maxk.cu`'s select
    finds them, the warp's guess updated: key uint64 [dim] of kb-bit keys
    (f32 keys; for bf16 the high halves), lane l holding channels
    [l * per, (l + 1) * per), channels past dim with key 0. route: "guess",
    "neighbour" or "top" (where the count passes started); end: "single"
    (one key left in the bracket), "kept" (every bit fixed, every tie kept)
    or "ties" (a tie dropped, found by the scan of the lanes' tie counts)."""
    dim = key.size
    per = lane_layout(dim)
    lanes = np.zeros(32 * per, np.uint64)
    lanes[:dim] = key
    valid = np.arange(32 * per) < dim

    t, lo, hi, bit, route = 0, dim, 0, kb - 1, "top"
    if guess.level < kb:
        w = 1 << guess.level
        g = guess.pivot & ~(w - 1)
        c_g, c_up = count2(lanes, g, g + w, dim, kb)
        if c_g >= k and c_up < k:
            t, lo, hi, route = g, c_g, c_up, "guess"
        elif c_g < k and g != 0:
            c, _ = count2(lanes, g - w, 1 << kb, dim, kb)
            if c >= k:
                t, lo, hi, route = g - w, c, c_g, "neighbour"
        elif c_up >= k:
            c, _ = count2(lanes, g + 2 * w, 1 << kb, dim, kb)
            if c < k:
                t, lo, hi, route = g + w, c_up, c, "neighbour"
        if route != "top":
            bit = guess.level - 1
    while bit >= 0 and lo - hi > 1:
        cand = t | 1 << bit
        c = count_ge(lanes, cand, kb)
        if c >= k:
            t, lo = cand, c
        else:
            hi = c
        bit -= 1
    if lo - hi == 1:        # the next guess: five bits above the last key
        guess.level = min(bit + 6, kb - 1)

    bound, end = dim, "kept"
    if lo - hi == 1:
        high = 0 if bit + 1 >= 32 else (0xFFFFFFFF << (bit + 1)) & 0xFFFFFFFF
        in_range = (lanes ^ np.uint64(t)) & np.uint64(high) == 0
        t, end = int(lanes[in_range].max()), "single"
    elif lo > k:
        ties = valid & (lanes == np.uint64(t))
        rank = np.cumsum(ties) - ties       # the lanes' scan, then in-lane
        bound = int(np.flatnonzero(ties & (rank == k - hi)).min())
        end = "ties"
    guess.pivot = t
    return t, bound, route, end


def walk(x: torch.Tensor, k: int, fresh: bool = False):
    """One warp's rows in order (a fresh guess for every row if `fresh`):
    (pivot bits int32, bounds, routes, ends), pivots as meta holds them."""
    kb = 16 if x.dtype == BF16 else 32
    keys = keys_of(x)
    guess = Guess(kb)
    out = []
    for row in keys:
        if fresh:
            guess = Guess(kb)
        out.append(warp_select(row, k, kb, guess))
    pivot = np.array([t for t, _, _, _ in out], np.uint64)
    if kb == 16:
        pivot = pivot << np.uint64(16) | np.where(
            pivot & np.uint64(0x8000), 0, 0xFFFF).astype(np.uint64)
    bits = pivot.astype(np.uint32).view(np.int32)
    return (bits, np.array([b for _, b, _, _ in out]),
            [r for _, _, r, _ in out], [e for _, _, _, e in out])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("dim,k", SHAPES)
def test_warp_select_matches_plain(dim, k, dtype):
    """The warp steps give maxk_forward's (pivot bits, bound) on every
    family, walked in order with the guess carried from row to row and with
    a fresh guess for every row: every route, bit for bit."""
    x = all_rows(dim, k, dtype)
    _, meta = plain.maxk_forward(x, k)
    for fresh in (False, True):
        pivot, bound, route, _ = walk(x, k, fresh)
        np.testing.assert_array_equal(pivot, meta[:, 0].numpy())
        np.testing.assert_array_equal(bound, meta[:, 1].numpy())
        if fresh:
            assert set(route) == {"top"}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_warp_select_takes_every_route(dtype):
    """At the recipes' shape (dim 256, k 32): rows of one scale walked in
    order mostly hit the previous pivot's bucket; a row at another scale
    misses it (neighbour or top); rows end on a single key, and integer and
    constant rows drop ties; every route agrees with maxk_forward."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((64, 256), generator=gen)
    x[40:44] *= 1.3          # k-th values a little higher: the neighbour
    x[50] *= 1000.0          # far away: from the top
    x[20] = x[20].round()
    x[30] = 2.5
    x = x.to(DTYPES[dtype])
    _, meta = plain.maxk_forward(x, 32)
    pivot, bound, route, end = walk(x, 32)
    np.testing.assert_array_equal(pivot, meta[:, 0].numpy())
    np.testing.assert_array_equal(bound, meta[:, 1].numpy())
    assert route.count("guess") >= 32
    assert {"guess", "neighbour", "top"} <= set(route)
    assert {"single", "ties"} <= set(end)


# ---------------------------------------------------------------------------
# GPU: the kernels on the families against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.element_size() == 2
                  else torch.int32).cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("dim,k", SHAPES)
def test_family_rows_bitwise_plain_on_gpu(cuda, dim, k, dtype):
    """maxk_fwd (y and meta) and cbsr_compact (values and channels, on the
    rows and on their MaxK) bit-equal to the plain versions on every
    family, with NaN equal to NaN (a dropped infinity gives inf * 0)."""
    x = all_rows(dim, k, dtype).to(cuda)
    _build.launches.clear()
    y, meta = tmaxk.maxk_fwd(x, k)
    xs = torch.cat([x, y])
    v, c = tcbsr.cbsr_compact(xs, k)
    suffix = "_bf16" if dtype == "bf16" else ""
    assert dict(_build.launches) == {"maxk_fwd" + suffix: 1,
                                     "cbsr_compact" + suffix: 1}
    y_p, meta_p = plain.maxk_forward(x, k)
    np.testing.assert_array_equal(meta.cpu().numpy(), meta_p.cpu().numpy())
    nan = (y.isnan() & y_p.isnan()).cpu().numpy()
    np.testing.assert_array_equal(np.where(nan, 0, _bits(y)),
                                  np.where(nan, 0, _bits(y_p)))
    v_p, c_p = plain.cbsr_compact_plain(xs, k)
    np.testing.assert_array_equal(c.cpu().numpy(), c_p.cpu().numpy())
    nan = (v.isnan() & v_p.isnan()).cpu().numpy()
    np.testing.assert_array_equal(np.where(nan, 0, _bits(v)),
                                  np.where(nan, 0, _bits(v_p)))
