"""CBSR on bf16 values: the densify forms (B5/B6 with bf16 values or a bf16
output), the channel sampling of bf16 z (B4), `aggregate_cbsr` on bf16
values and the gradient of `cbsr_compact` on bf16 rows, against the JAX
package (CPU); and the kernels' bf16 forms against their plain versions
(GPU).

On the CPU the kernel wrappers take their plain versions (ops/maxk.py). The
GPU cases (marker `gpu`) skip without a card; they import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cbsr16.py
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels import api as tapi
from spgemm_gnn_tpu_torch.kernels import cbsr as tcbsr
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.ops import maxk as tmaxk_plain

BF16 = torch.bfloat16
DTYPES = {"f32": torch.float32, "bf16": BF16}


def masked_rows(rng, n: int, dim: int, k: int) -> np.ndarray:
    """MaxK-like f32 rows of bf16 values (k nonzeros), plus a row with no
    nonzero and one with fewer than k, so that the CBSR has pad slots."""
    x = rng.standard_normal((n, dim)).astype(np.float32)
    keep = np.argsort(rng.random((n, dim)), axis=1)[:, :k]
    mask = np.zeros((n, dim), bool)
    np.put_along_axis(mask, keep, True, axis=1)
    x = np.where(mask, x, 0.0).astype(np.float32)
    x[1] = 0.0
    x[2, :] = 0.0
    x[2, [dim - 1, dim // 2]] = 3.0
    # values exactly representable in bf16, so either dtype holds them
    return torch.tensor(x).to(BF16).float().numpy()


def cbsr_of(rng, n: int, dim: int, k: int, v_dtype: torch.dtype):
    """(values of v_dtype, channels int32) from the port's compaction."""
    x = torch.tensor(masked_rows(rng, n, dim, k)).to(v_dtype)
    return tmaxk_plain.cbsr_compact_plain(x, k)


def jnp_dtype(dtype: torch.dtype):
    import jax.numpy as jnp
    return jnp.bfloat16 if dtype == BF16 else jnp.float32


def to_jax(t: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype and bits."""
    import jax.numpy as jnp
    if t.dtype == BF16:
        return jnp.asarray(t.view(torch.int16).numpy()).view(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def from_jax(a) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype and bits."""
    import jax.numpy as jnp
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.view(jnp.int16))).view(BF16)
    return torch.from_numpy(np.array(a))


def assert_equal_by_value(got: torch.Tensor, want: torch.Tensor) -> None:
    """Same dtype, shape and values (+0.0 and -0.0 count as equal: the JAX
    kernels sum one-hot terms, so a -0.0 comes back +0.0)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# CPU: B4-B6 on bf16, the plain versions against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,k", [(16, 1), (48, 8), (256, 32)])
@pytest.mark.parametrize("v_name,out_name",
                         [("bf16", "bf16"), ("bf16", "f32"), ("f32", "bf16")])
def test_densify_bf16_matches_jax(dim, k, v_name, out_name):
    """`cbsr_densify` (its plain version on the CPU) in each new form
    against JAX densify_rows and densify_transpose (transposed back) with
    the same out_dtype (interpret mode): equal by value. The values come
    from a compaction with pad slots, and the output is dense, so the pad
    channels are compared through the densify, not slot by slot."""
    from spgemm_gnn_tpu.kernels.spgemm_pallas import (densify_rows,
                                                      densify_transpose)

    rng = np.random.default_rng(dim + k)
    v_dtype, out_dtype = DTYPES[v_name], DTYPES[out_name]
    n = 72
    vals, ch = cbsr_of(rng, n, dim, k, v_dtype)
    if v_dtype == torch.float32:   # f32 values off the bf16 grid: rounding
        vals = vals * torch.tensor(1.0 + 2.0 ** -12)
    got = tcbsr.cbsr_densify(vals, ch, dim, out_dtype)
    assert got.dtype == out_dtype
    jv, jc = to_jax(vals), to_jax(ch)
    jdt = jnp_dtype(out_dtype)
    assert_equal_by_value(got, from_jax(densify_rows(
        jv, jc, dim, out_dtype=jdt, interpret=True)))
    assert_equal_by_value(got, from_jax(densify_transpose(
        jv, jc, dim, 80, out_dtype=jdt, col_block=16, interpret=True).T[:n]))
    # f32 -> bf16 rounds once, to nearest even: torch's own cast
    assert_equal_by_value(
        got, tmaxk_plain.cbsr_to_dense(vals, ch, dim).to(out_dtype))


@pytest.mark.parametrize("dim,k", [(16, 1), (48, 8), (256, 32)])
def test_sample_bf16_matches_jax(dim, k):
    """`cbsr_sample` on bf16 z against JAX sample_channels (interpret):
    the output in z's dtype, equal by value."""
    from spgemm_gnn_tpu.kernels.spgemm_pallas import sample_channels

    rng = np.random.default_rng(3 * dim + k)
    n = 72
    _, ch = cbsr_of(rng, n, dim, k, BF16)
    z = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32)).to(BF16)
    got = tcbsr.cbsr_sample(z, ch)
    assert got.dtype == BF16 and got.shape == (n, k)
    assert_equal_by_value(got, from_jax(sample_channels(
        to_jax(z), to_jax(ch), interpret=True)))


def test_cbsr_to_dense_keeps_values_dtype_by_default():
    vals = torch.tensor([[1.5, -2.0]], dtype=BF16)
    ch = torch.tensor([[3, 0]], dtype=torch.int32)
    out = tmaxk_plain.cbsr_to_dense(vals, ch, 4)
    assert out.dtype == BF16
    assert out.float().tolist() == [[-2.0, 0.0, 0.0, 1.5]]
    assert tmaxk_plain.cbsr_to_dense(vals, ch, 4, torch.float32).dtype == \
        torch.float32


# ---------------------------------------------------------------------------
# CPU: aggregate_cbsr on bf16 values, cbsr_compact's gradient on bf16 rows
# ---------------------------------------------------------------------------

JPLANS = {"windowed": dict(tile_slots=128, src_block=128, dst_block=128,
                           window=8),
          "stream": dict(tile_slots=128, dst_block=128)}
DIM, K = 128, 16


def bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |a| (f32), the smallest normal's below it."""
    e = torch.floor(torch.log2(a.float().abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
@pytest.mark.parametrize("kind", ["windowed", "stream"])
def test_aggregate_cbsr_bf16_matches_jax(kind, norm):
    """aggregate_cbsr on bf16 values against JAX aggregate_cbsr (impl
    "pallas", interpret) on a PlannedGraph of each kind: y f32 within 1e-5
    of max |y| (the f32 summation order differs), dvalues bf16 within one
    bf16 ulp (1e-5 of max where a sum cancels). Under gcn the src factor is rounded to bf16 before it scales
    the bf16 values, in both packages (`_scale`): the test shows the port
    rounds where JAX does, since an f32 factor would move y by far more
    than 1e-5 of max."""
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.graphs.synthetic import random_graph as jrandom
    from spgemm_gnn_tpu.kernels.api import aggregate_cbsr as jaggregate_cbsr
    from spgemm_gnn_tpu.kernels.planned import plan_graph as jplan_graph

    jg = jrandom(200, 1500, seed=5, symmetric=False)
    tg = tsyn.random_graph(200, 1500, seed=5, symmetric=False)
    rng = np.random.default_rng(len(kind) * 7 + len(norm))
    vals, ch = cbsr_of(rng, 200, DIM, K, BF16)
    ct = rng.standard_normal((200, DIM)).astype(np.float32)
    jpg = jplan_graph(jg, kind=kind, **JPLANS[kind])
    jv, jc = to_jax(vals), to_jax(ch)
    y_ref, vjp = jax.vjp(lambda v: jaggregate_cbsr(jpg, v, jc, DIM, norm,
                                                   "pallas"), jv)
    (dv_ref,) = vjp(jnp.asarray(ct))
    y_ref, dv_ref = from_jax(y_ref), from_jax(dv_ref)
    assert y_ref.dtype == torch.float32 and dv_ref.dtype == BF16

    tpg = tplanned.plan_graph(tg, kind=kind, chunk=9)
    v = vals.clone().requires_grad_(True)
    y = tapi.aggregate_cbsr(tpg, v, ch, DIM, norm)
    (y * torch.tensor(ct)).sum().backward()
    assert y.dtype == torch.float32 and v.grad.dtype == BF16
    err = float((y.detach() - y_ref).abs().max())
    assert err <= 1e-5 * float(y_ref.abs().max()), err
    # one bf16 ulp, but where an f32 sum cancels to near 0 its ulp lies
    # below the f32 summation-order error of its terms: there 1e-5 of max
    # |dvalues|, the f32 tolerance (as chip_smoke.py's bf16-output checks),
    # on at most 0.5 % of the values
    off = (v.grad.float() - dv_ref.float()).abs()
    near = off <= bf16_ulp(dv_ref)
    cancel = off <= 1e-5 * float(dv_ref.float().abs().max())
    assert bool((near | cancel).all()), float(off.max())
    assert int((~near).sum()) <= 0.005 * off.numel()

    # under gcn, the f32 factor on the widened values (no bf16 rounding of
    # the factor or of the product) lies beyond the tolerance
    if norm == "gcn":
        dense = tmaxk_plain.cbsr_to_dense(vals, ch, DIM, torch.float32)
        y_f32 = tapi.aggregate(tg, dense, norm, impl="torch")
        assert float((y_f32 - y_ref).abs().max()) > 1e-5 * float(
            y_ref.abs().max())


@pytest.mark.parametrize("dim,k", [(16, 4), (256, 32)])
def test_cbsr_compact_grad_bf16_matches_pallas(dim, k):
    """The gradient of `cbsr_compact` on bf16 rows (dx = the densify of
    dvalues into bf16) against the VJP of cbsr_compact_pallas (interpret),
    bitwise; the values and channels slot for slot (the same slot order)."""
    import jax
    from spgemm_gnn_tpu.kernels.maxk_pallas import cbsr_compact_pallas

    rng = np.random.default_rng(dim * k)
    n = 64
    x = torch.tensor(masked_rows(rng, n, dim, k)).to(BF16)
    dv = torch.tensor(rng.standard_normal((n, k)).astype(np.float32)).to(BF16)
    (jv, jc), vjp = jax.vjp(
        lambda a: cbsr_compact_pallas(a, k, interpret=True), to_jax(x))
    (jdx,) = vjp((to_jax(dv), np.zeros((n, k), jax.dtypes.float0)))

    xt = x.clone().requires_grad_(True)
    vals, ch = tapi.cbsr_compact(xt, k)
    vals.backward(dv)
    assert torch.equal(ch, from_jax(jc))
    assert_equal_by_value(vals.detach(), from_jax(jv))
    assert xt.grad.dtype == BF16
    np.testing.assert_array_equal(xt.grad.view(torch.int16).numpy(),
                                  from_jax(jdx).view(torch.int16).numpy())


# ---------------------------------------------------------------------------
# GPU: the bf16 forms against their plain versions (skip without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def bits16(a: torch.Tensor) -> np.ndarray:
    a = a.detach().cpu()
    return (a.view(torch.int16) if a.dtype == BF16
            else a.view(torch.int32)).numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("dim,k", [(8, 1), (48, 8), (104, 7), (256, 32),
                                   (1024, 64)])
def test_cbsr_bf16_kernels_bitwise_plain_on_gpu(cuda, dim, k):
    """cbsr_densify in its three new forms and cbsr_sample_bf16 bitwise
    against their plain versions on the card; the f32 -> bf16 densify
    against torch's own cast (round to nearest even), NaN included."""
    rng = np.random.default_rng(dim + k)
    n = 333
    x = torch.tensor(masked_rows(rng, n, dim, k), device=cuda)
    for v_dtype in (torch.float32, BF16):
        vals, ch = tcbsr.cbsr_compact(x.to(v_dtype), k)
        if v_dtype == torch.float32:
            vals = vals * (1.0 + 2.0 ** -12)     # off the bf16 grid
            vals[5, 0] = float("nan")
        for out_dtype in (torch.float32, BF16):
            if v_dtype == out_dtype == torch.float32:
                continue
            name = tcbsr.densify_name(v_dtype, out_dtype)
            before = _build.launches[name]
            got = tcbsr.cbsr_densify(vals, ch, dim, out_dtype)
            assert _build.launches[name] == before + 1, name
            want = tmaxk_plain.cbsr_to_dense(vals, ch, dim, out_dtype)
            np.testing.assert_array_equal(bits16(got), bits16(want), name)
            np.testing.assert_array_equal(
                bits16(got), bits16(tmaxk_plain.cbsr_to_dense(
                    vals, ch, dim).to(out_dtype)), name)
    z = torch.randn((n, dim), device=cuda).to(BF16)
    before = _build.launches["cbsr_sample_bf16"]
    got = tcbsr.cbsr_sample(z, ch)
    assert _build.launches["cbsr_sample_bf16"] == before + 1
    assert got.dtype == BF16
    np.testing.assert_array_equal(
        bits16(got), bits16(tmaxk_plain.sample_channels(z, ch)))


@pytest.mark.gpu
def test_cbsr_bf16_path_on_gpu(cuda):
    """compact -> aggregate_cbsr -> backward on bf16 rows through the
    kernels: dx bitwise the densify of dvalues into bf16, y within 1e-5 of
    max |y| of the plain path (impl "torch" on the widened values) and the
    launches of each form."""
    g = tsyn.powerlaw_graph(900, 9000, seed=3).to(cuda)
    pg = tplanned.plan_graph(g, kind="stream")
    x = tmaxk_plain.maxk(torch.randn((900, 128), device=cuda), 16).to(BF16)
    xt = x.clone().requires_grad_(True)
    _build.launches.clear()
    vals, ch = tapi.cbsr_compact(xt, 16)
    vals.retain_grad()
    y = tapi.aggregate_cbsr(pg, vals, ch, 128, "mean", impl="cuda")
    ct = torch.randn_like(y)
    (y * ct).sum().backward()
    assert dict(_build.launches) == {
        "cbsr_compact_bf16": 1, "cbsr_densify_bf16_f32": 1,
        "stream_spmm": 2, "cbsr_sample": 1, "cbsr_densify_bf16": 1}
    np.testing.assert_array_equal(
        bits16(xt.grad),
        bits16(tmaxk_plain.cbsr_to_dense(vals.grad, ch, 128)))
    xd = tmaxk_plain.cbsr_to_dense(vals.detach(), ch, 128, torch.float32)
    y_ref = tapi.aggregate(pg, xd, "mean", impl="torch")
    err = float((y.detach() - y_ref).abs().max())
    assert err <= 1e-5 * float(y_ref.abs().max()), err


@pytest.mark.gpu
def test_cbsr_bf16_wrappers_raise_on_bad_input(cuda):
    vals = torch.zeros((8, 4), device=cuda, dtype=BF16)
    ch = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dim % 8"):
        tcbsr.cbsr_densify(vals, ch, 12, BF16)      # 16-byte bf16 stores
    assert tcbsr.cbsr_densify(vals, ch, 12).shape == (8, 12)  # f32 out
    with pytest.raises(ValueError, match="dtype"):
        tcbsr.cbsr_densify(vals.half(), ch, 16)
    with pytest.raises(ValueError, match="out_dtype"):
        tcbsr.cbsr_densify(vals, ch, 16, torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        tcbsr.cbsr_sample(torch.zeros((8, 16), device=cuda).half(), ch)
    x6 = torch.zeros((8, 12), device=cuda, dtype=BF16)
    with pytest.raises(ValueError, match="dim % 8"):
        tapi.cbsr_compact(x6.clone().requires_grad_(True), 2)
