"""The port's CBSR helpers and the explicit CBSR API (`aggregate_cbsr`)
against the JAX package (CPU), and the CBSR kernels against their plain
versions (GPU).

On the CPU the kernel wrappers take their plain versions (ops/maxk.py). The
GPU cases (marker `gpu`) skip without a card; they import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_cbsr.py
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


def masked_rows(rng, n: int, dim: int, k: int) -> np.ndarray:
    """MaxK-like rows (k nonzeros) plus short rows, all-zero rows, a row of
    signed zeros and a row with more than k nonzeros."""
    x = rng.standard_normal((n, dim)).astype(np.float32)
    keep = np.argsort(rng.random((n, dim)), axis=1)[:, :k]
    mask = np.zeros((n, dim), bool)
    np.put_along_axis(mask, keep, True, axis=1)
    x = np.where(mask, x, 0.0).astype(np.float32)
    x[1] = 0.0                                   # no nonzero
    x[2, :] = 0.0
    x[2, [dim - 1, dim // 2]] = 3.0              # fewer than k
    x[3] = np.where(rng.random(dim) < 0.5, 0.0, -0.0)
    x[4] = rng.standard_normal(dim)              # more than k
    return x


def bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a).view(np.int32)


# ---------------------------------------------------------------------------
# CPU: CBSR construction against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [48, 256, 384])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_cbsr_compact_matches_pallas(k, dim):
    """Slot for slot against cbsr_compact_pallas (interpret): channels
    exactly, values by value (the JAX kernel writes +0.0 in pad slots where
    the port keeps x's −0.0, ROADMAP Queue C). Through cbsr_to_dense, the
    same as the oracle cbsr_from_masked, whose pad order differs. At dim
    384, ids above 255 come back unwrapped."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.maxk_pallas import cbsr_compact_pallas
    from spgemm_gnn_tpu.ops.maxk import cbsr_from_masked, cbsr_to_dense

    x = masked_rows(np.random.default_rng(k * 1000 + dim), 40, dim, k)
    jv, jc = cbsr_compact_pallas(jnp.asarray(x), k, 8, True)
    dense_or = np.asarray(cbsr_to_dense(*cbsr_from_masked(jnp.asarray(x), k),
                                        dim))
    xt = torch.tensor(x)
    for v, c in (tapi.cbsr_compact(xt, k),
                 tapi.cbsr_compact(xt, k, impl="torch"),
                 tcbsr.cbsr_compact(xt, k)):
        assert c.dtype == torch.int32 and v.shape == c.shape == (40, k)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(v.detach().numpy(), np.asarray(jv))
        np.testing.assert_array_equal(
            tmaxk_plain.cbsr_to_dense(v.detach(), c, dim).numpy(), dense_or)
    if dim == 384 and k == 32:
        assert int(np.asarray(jc).max()) >= 256


@pytest.mark.parametrize("k", [4, 32])
def test_cbsr_compact_grad_matches_jax(k, rng):
    """dx through cbsr_to_dense, against JAX's (the VJP is the densify of the
    values' cotangent; exact: a scatter of the same numbers)."""
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.maxk_pallas import cbsr_compact_pallas
    from spgemm_gnn_tpu.ops.maxk import cbsr_to_dense

    dim = 64
    x = masked_rows(rng, 30, dim, k)
    ct = rng.standard_normal((30, dim)).astype(np.float32)
    gj = jax.grad(lambda v: (cbsr_to_dense(
        *cbsr_compact_pallas(v, k, 8, True), dim) * ct).sum())(jnp.asarray(x))
    for impl in ("auto", "torch"):     # CBSRCompact, autograd of the plain
        xt = torch.tensor(x, requires_grad=True)
        vals, ch = tapi.cbsr_compact(xt, k, impl=impl)
        assert not ch.requires_grad
        (tmaxk_plain.cbsr_to_dense(vals, ch, dim) * torch.tensor(ct)).sum() \
            .backward()
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))


@pytest.mark.parametrize("k", [1, 8])
def test_maxk_cbsr_and_from_masked_match_jax(k, rng):
    import jax.numpy as jnp
    from spgemm_gnn_tpu.ops.maxk import cbsr_from_masked, maxk, maxk_cbsr

    x = rng.standard_normal((50, 40)).astype(np.float32)
    jv, jc = maxk_cbsr(jnp.asarray(x), k)
    tv, tc = tmaxk_plain.maxk_cbsr(torch.tensor(x), k)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    xm = np.array(maxk(jnp.asarray(x), k))
    xm[3] = 0.0
    jv, jc = cbsr_from_masked(jnp.asarray(xm), k)
    tv, tc = tmaxk_plain.cbsr_from_masked(torch.tensor(xm), k)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dim,k", [(64, 8), (384, 32)])
def test_densify_and_sample_match_jax(dim, k, rng):
    """K6 against densify_rows and densify_transpose (transposed back), K7
    against sample_channels (interpret), by value (the JAX kernels sum
    one-hot terms, so a −0.0 value comes back +0.0)."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.spgemm_pallas import (densify_rows,
                                                      densify_transpose,
                                                      sample_channels)

    n = 70
    x = masked_rows(rng, n, dim, k)
    vals, ch = tmaxk_plain.cbsr_from_masked(torch.tensor(x), k)
    jv, jc = jnp.asarray(vals.numpy()), jnp.asarray(ch.numpy())
    dense = tcbsr.cbsr_densify(vals, ch, dim).numpy()
    np.testing.assert_array_equal(
        dense, np.asarray(densify_rows(jv, jc, dim, interpret=True)))
    np.testing.assert_array_equal(
        dense, np.asarray(densify_transpose(jv, jc, dim, 80, col_block=16,
                                            interpret=True)).T[:n])
    z = rng.standard_normal((n, dim)).astype(np.float32)
    np.testing.assert_array_equal(
        tcbsr.cbsr_sample(torch.tensor(z), ch).numpy(),
        np.asarray(sample_channels(jnp.asarray(z), jc, interpret=True)))


# ---------------------------------------------------------------------------
# CPU: aggregate_cbsr against JAX aggregate_cbsr (pallas and xla)
# ---------------------------------------------------------------------------

JPLANS = {"windowed": dict(tile_slots=128, src_block=128, dst_block=128,
                           window=8),
          "stream": dict(tile_slots=128, dst_block=128)}
DIM, K = 128, 16


@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
@pytest.mark.parametrize("kind", ["windowed", "stream"])
def test_aggregate_cbsr_matches_jax(kind, norm):
    """y and dvalues against JAX aggregate_cbsr on a PlannedGraph of each
    kind (impl "pallas", interpret) and on the raw graph (impl "xla"), on a
    directed graph. Tolerance: rtol 1e-5, atol 1e-6 of the output's scale
    (the f32 summation order differs, as tests/test_torch_kernels.py)."""
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.graphs.stream_tiles import StreamPlan as JStreamPlan
    from spgemm_gnn_tpu.graphs.synthetic import random_graph as jrandom
    from spgemm_gnn_tpu.kernels.api import aggregate_cbsr as jaggregate_cbsr
    from spgemm_gnn_tpu.kernels.planned import plan_graph as jplan_graph
    from spgemm_gnn_tpu.ops.maxk import maxk_cbsr

    jg = jrandom(200, 1500, seed=5, symmetric=False)
    tg = tsyn.random_graph(200, 1500, seed=5, symmetric=False)
    rng = np.random.default_rng(len(kind) + len(norm))
    x = rng.standard_normal((200, DIM)).astype(np.float32)
    ct = rng.standard_normal((200, DIM)).astype(np.float32)
    jv, jc = maxk_cbsr(jnp.asarray(x), K)
    jpg = jplan_graph(jg, kind=kind, **JPLANS[kind])
    assert isinstance(jpg.fwd_plan, JStreamPlan) == (kind == "stream")

    def jax_pair(graph, impl):
        y, vjp = jax.vjp(lambda v: jaggregate_cbsr(graph, v, jc, DIM, norm,
                                                   impl), jv)
        return np.asarray(y), np.asarray(vjp(jnp.asarray(ct))[0])

    refs = [jax_pair(jpg, "pallas"), jax_pair(jg, "xla")]
    tpg = tplanned.plan_graph(tg, kind=kind, chunk=9)
    ch = torch.tensor(np.asarray(jc))
    for impl in ("auto", "torch"):
        vals = torch.tensor(np.asarray(jv), requires_grad=True)
        y = tapi.aggregate_cbsr(tpg, vals, ch, DIM, norm, impl)
        (y * torch.tensor(ct)).sum().backward()
        for y_ref, dv_ref in refs:
            for got, ref in ((y.detach().numpy(), y_ref),
                             (vals.grad.numpy(), dv_ref)):
                np.testing.assert_allclose(
                    got, ref, rtol=1e-5,
                    atol=1e-6 * max(1.0, float(np.abs(ref).max())))


def test_aggregate_cbsr_values_grad_only_in_their_dtype(rng):
    g = tsyn.random_graph(40, 200, seed=6)
    x = torch.tensor(masked_rows(rng, 40, 16, 4)).double()
    vals, ch = tmaxk_plain.cbsr_from_masked(x, 4)
    vals.requires_grad_(True)
    for graph in (g, tplanned.plan_graph(g, kind="stream", chunk=4)):
        y = tapi.aggregate_cbsr(graph, vals, ch, 16, "gcn")
        assert y.dtype == torch.float64 and y.shape == (40, 16)
        (vals.grad,) = torch.autograd.grad(y.sum(), [vals])
        assert vals.grad.dtype == torch.float64 and vals.grad.shape == (40, 4)


def test_aggregate_cbsr_impl_checks(rng):
    g = tsyn.random_graph(30, 120, seed=4)
    vals = torch.zeros((30, 4))
    ch = torch.zeros((30, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        tapi.aggregate_cbsr(g, vals, ch, 8, "mean", impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tapi.aggregate_cbsr(g, vals, ch, 8, "mean", impl="pallas")
    with pytest.raises(NotImplementedError, match="Queue A12"):
        tapi.aggregate_cbsr(g, vals, ch, 8, "mean", impl="ell")
    x = torch.zeros((30, 8))        # the compaction entry checks alike
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        tapi.cbsr_compact(x, 2, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tapi.cbsr_compact(x, 2, impl="pallas")
    with pytest.raises(NotImplementedError, match="Queue A12"):
        tapi.cbsr_compact(x, 2, impl="ell")


# ---------------------------------------------------------------------------
# GPU: the CBSR kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dim,k", [(4, 1), (48, 8), (100, 7), (256, 32),
                                   (384, 32), (1024, 64)])
def test_cbsr_kernels_bitwise_plain_on_gpu(cuda, dim, k):
    rng = np.random.default_rng(dim + k)
    x = torch.tensor(masked_rows(rng, 333, dim, k), device=cuda)
    x[5, 0] = float("nan")
    vals, ch = tcbsr.cbsr_compact(x, k)
    vals_p, ch_p = tmaxk_plain.cbsr_compact_plain(x, k)
    np.testing.assert_array_equal(ch.cpu().numpy(), ch_p.cpu().numpy())
    np.testing.assert_array_equal(bits(vals), bits(vals_p))
    z = torch.tensor(rng.standard_normal((333, dim)).astype(np.float32),
                     device=cuda)
    np.testing.assert_array_equal(
        bits(tcbsr.cbsr_sample(z, ch)),
        bits(tmaxk_plain.sample_channels(z, ch)))
    if dim % 4 == 0:
        np.testing.assert_array_equal(
            bits(tcbsr.cbsr_densify(vals, ch, dim)),
            bits(tmaxk_plain.cbsr_to_dense(vals, ch, dim)))


@pytest.mark.gpu
def test_aggregate_cbsr_kernels_match_dense_on_gpu(cuda, monkeypatch):
    """aggregate_cbsr through the kernels (compact, densify, stream product,
    sample; the dense forward, STREAM_CBSR_FORWARD off) against aggregate on
    cbsr_to_dense: y within 1e-5 of max |y|, dvalues against the dense dx
    at the channels."""
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", False)
    g = tsyn.powerlaw_graph(900, 9000, seed=3).to(cuda)
    pg = tplanned.plan_graph(g, kind="stream")
    x = torch.randn((900, 128), device=cuda)
    xm = tmaxk_plain.maxk(x, 16)
    vals, ch = tapi.cbsr_compact(xm, 16)
    vals = vals.detach().requires_grad_(True)
    before = dict(_build.launches)
    y = tapi.aggregate_cbsr(pg, vals, ch, 128, "mean", impl="cuda")
    ct = torch.randn_like(y)
    (y * ct).sum().backward()
    for name, n in (("cbsr_densify", 1), ("cbsr_sample", 1),
                    ("stream_spmm", 2)):
        assert _build.launches[name] == before.get(name, 0) + n, name
    xd = tmaxk_plain.cbsr_to_dense(vals.detach(), ch, 128).requires_grad_(True)
    y_ref = tapi.aggregate(pg, xd, "mean", impl="torch")
    (y_ref * ct).sum().backward()
    err = float((y - y_ref).detach().abs().max())
    assert err <= 1e-5 * float(y_ref.detach().abs().max()), err
    dv_ref = tmaxk_plain.sample_channels(xd.grad, ch)
    err = float((vals.grad - dv_ref).abs().max())
    assert err <= 1e-5 * float(dv_ref.abs().max()), err


@pytest.mark.gpu
def test_cbsr_wrappers_raise_on_bad_input(cuda):
    x = torch.zeros((8, 16), device=cuda)
    with pytest.raises(ValueError, match="k <= dim"):
        tcbsr.cbsr_compact(x, 17)
    with pytest.raises(ValueError, match="dtype"):
        tcbsr.cbsr_compact(x.double(), 4)
    # a compaction whose backward the densify kernel cannot take raises at
    # the call, not first in backward(); without a gradient it runs
    x6 = torch.zeros((8, 6), device=cuda)
    with pytest.raises(ValueError, match="dim % 4"):
        tapi.cbsr_compact(x6.clone().requires_grad_(True), 2)
    assert tapi.cbsr_compact(x6, 2)[1].shape == (8, 2)
    vals = torch.zeros((8, 4), device=cuda)
    ch = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dim % 4"):
        tcbsr.cbsr_densify(vals, ch, 18)
    with pytest.raises(ValueError, match="dtype"):
        tcbsr.cbsr_densify(vals, ch.long(), 16)
    with pytest.raises(ValueError, match="shape"):
        tcbsr.cbsr_sample(x, ch[:4])
