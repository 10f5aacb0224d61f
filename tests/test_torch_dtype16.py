"""The 16-bit model (`--dtype bfloat16`): MaxK and `cbsr_compact` on bf16
rows, the bf16-output forms of `csr_spmm`, `stream_spmm` and
`stream_cbsr_spmm`, the planner and the autograd pair on bf16 activations,
every model family and the Trainer, against the JAX package's bf16 model
(CPU); and each new kernel form against its plain version (GPU).

Tolerances are stated in bf16 terms: an ulp is the spacing of bf16 values
at the reference value (2^-7 of its power of two). MaxK and the compaction
select and copy bf16 values, so they are held bit for bit (by value where
the JAX kernels' interpret mode writes +0.0 for the port's -0.0). The
aggregation sums the same bf16 values in f32 on both sides, in another
order, and rounds once: held within 1 ulp, with at most 0.5 % of the values
off by that ulp (measured: none, CPU). The JAX functions run their Pallas
kernels in interpret mode (impl "pallas": the XLA impls add bf16 values in
bf16, which the reference's kernels do not). The GPU cases (marker `gpu`)
skip without a card and import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_dtype16.py
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.stream_tiles import (HOT_BUDGET,
                                                      build_stream_plan)
from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels import api as tapi
from spgemm_gnn_tpu_torch.kernels import cbsr as tcbsr
from spgemm_gnn_tpu_torch.kernels import layernorm as tln
from spgemm_gnn_tpu_torch.kernels import maxk as tmaxk_kernel
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm
from spgemm_gnn_tpu_torch.kernels.stream import stream_cbsr_spmm, stream_spmm
from spgemm_gnn_tpu_torch.ops import maxk as tmaxk
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.ops.spmm import csr_spmm_plain
from spgemm_gnn_tpu_torch.ops.stream import (stream_cbsr_spmm_plain,
                                             stream_spmm_plain)
from spgemm_gnn_tpu_torch.utils.rows import with_families

BF16 = torch.bfloat16
# the aggregation's tolerance: ulps anywhere, and the share of values off
AGG_ULPS, AGG_SHARE = 1, 0.005


@pytest.fixture(autouse=True)
def restore_flags(monkeypatch):
    """Both packages' DEFAULT_STREAM and STREAM_CBSR_FORWARD as they were
    after the test, starting from "f32" and off."""
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", "f32")
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", False)
    try:
        import importlib
        jplanned = importlib.import_module("spgemm_gnn_tpu.kernels.planned")
    except ImportError:     # the card's machine has no JAX
        return
    monkeypatch.setattr(jplanned, "DEFAULT_STREAM", "f32")
    monkeypatch.setattr(jplanned, "STREAM_CBSR_FORWARD", False)


def bf16_ulps(got, want) -> np.ndarray:
    """|got - want| in bf16 ulps at want (2^-7 of want's power of two)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    mag = np.maximum(np.abs(want), 2.0 ** -120)
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def near16(got, want) -> None:
    """Within AGG_ULPS bf16 ulps everywhere, and off at most AGG_SHARE of
    the values."""
    u = bf16_ulps(got, want)
    assert u.max(initial=0.0) <= AGG_ULPS, u.max()
    assert (u > 0).mean() <= AGG_SHARE, (u > 0).mean()


def near_rows16(got, want) -> None:
    """Within one bf16 ulp of each row's largest magnitude, and off at most
    AGG_SHARE of the values: a layer norm's output or gradient sums terms
    larger than itself, so a last-bit change of its f32 statistics moves a
    value near 0 by more than that value's own ulp."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    top = np.maximum(np.abs(want).max(-1, keepdims=True), 2.0 ** -120)
    err = np.abs(got - want)
    assert (err <= 2.0 ** (np.floor(np.log2(top)) - 7)).all(), err.max()
    assert (err > 0).mean() <= AGG_SHARE, (err > 0).mean()


def f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32).numpy()


def tie_rows(rng, n: int, dim: int) -> torch.Tensor:
    """bf16 rows of few distinct values (halves in [-3, 3]), so that many
    rows hold exact ties at their k-th value; one row of zeros, one of
    signed zeros, one constant row, and rows of random normals."""
    x = rng.integers(-6, 7, size=(n, dim)).astype(np.float32) * 0.5
    x[1] = 0.0
    x[2] = -0.0
    x[2, ::3] = 0.0
    x[3] = 1.5
    x[4:8] = rng.standard_normal((4, dim)).astype(np.float32)
    return torch.tensor(x).to(BF16)


# ---------------------------------------------------------------------------
# CPU: B1 and B7 on bf16 rows against the JAX kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,k", [(16, 4), (64, 8), (100, 32), (256, 32)])
def test_maxk_bf16_matches_jax(dim, k):
    """MaxK forward and backward on bf16 rows full of exact ties, through
    the autograd Function (plain versions on the CPU) and the plain op,
    against `maxk_pallas` on the same bf16 input: y and dx in bf16, equal by
    value (the interpret mode writes +0.0 where the port writes x · 0 =
    -0.0), so the lowest-index tie rule holds on every row."""
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.maxk_pallas import maxk_pallas

    rng = np.random.default_rng(dim + k)
    x = tie_rows(rng, 40, dim)
    ct = torch.tensor(rng.standard_normal((40, dim)).astype(np.float32)).to(
        BF16)
    xj = jnp.asarray(f32(x)).astype(jnp.bfloat16)
    y_j, vjp = jax.vjp(lambda v: maxk_pallas(v, k, 8, True), xj)
    g_j = vjp(jnp.asarray(f32(ct)).astype(jnp.bfloat16))[0]
    assert y_j.dtype == jnp.bfloat16 and g_j.dtype == jnp.bfloat16
    ties = (f32(x) == np.sort(f32(x), axis=1)[:, ::-1][:, k - 1:k]).sum(1)
    assert (ties > 1).sum() >= 20       # the tie rule decides most rows
    for impl in ("auto", "torch"):
        xt = x.clone().requires_grad_(True)
        y = tapi.maxk_op(xt, k, impl=impl)
        y.backward(ct)
        assert y.dtype == BF16 and xt.grad.dtype == BF16
        np.testing.assert_array_equal(f32(y), np.asarray(y_j, np.float32))
        np.testing.assert_array_equal(f32(xt.grad),
                                      np.asarray(g_j, np.float32))
    # meta holds the f32 key of the bf16 pivot, whose low 16 bits are 0
    # (x >= +0) or 0xffff (x <= -0)
    _, meta = tmaxk.maxk_forward(x, k)
    low = meta[:, 0].long() & 0xFFFF
    assert ((low == 0) | (low == 0xFFFF)).all()


@pytest.mark.parametrize("dim,k", [(48, 8), (256, 32), (384, 32)])
def test_cbsr_compact_bf16_matches_jax(dim, k):
    """The compaction of MaxK-masked bf16 rows (ties and short rows
    included) against `cbsr_compact_pallas` on the same bf16 input: the
    values in bf16, equal by value, and the int32 channels exactly, slot
    for slot; through the autograd entry point, the plain op and the
    wrapper."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.maxk_pallas import cbsr_compact_pallas

    rng = np.random.default_rng(dim)
    x = tmaxk.maxk(tie_rows(rng, 40, dim), k)
    x[5, : dim // 2] = 0.0                   # rows shorter than k
    jv, jc = cbsr_compact_pallas(jnp.asarray(f32(x)).astype(jnp.bfloat16), k,
                                 8, True)
    assert jv.dtype == jnp.bfloat16
    for v, c in (tapi.cbsr_compact(x, k), tapi.cbsr_compact(x, k, "torch"),
                 tcbsr.cbsr_compact(x, k)):
        assert v.dtype == BF16 and c.dtype == torch.int32
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(f32(v), np.asarray(jv, np.float32))


@pytest.mark.parametrize("impl", ["auto", "torch"])
@pytest.mark.parametrize("dim", [64, 256])
def test_layer_norm16_matches_flax(dim, impl):
    """The bf16 LayerNorm (flax's f32 arithmetic and association, one
    rounding) against flax `LayerNorm(dtype=bfloat16)` on bf16 rows, through
    the kernels' autograd Function (their plain versions on the CPU) and
    through the plain ops under autograd: y bit-equal; dscale and dbias
    within 1e-6 of their largest magnitude; dx within 5e-3 of its largest
    (flax's dx rounds more: 3.6e-3 of max from float64 at dim 64, the
    port's 2.0e-3, one bf16 rounding)."""
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(dim)
    x = torch.tensor((rng.standard_normal((200, dim)) * 3 + 1).astype(
        np.float32)).to(BF16)
    w = torch.tensor(rng.random(dim).astype(np.float32) + 0.5,
                     requires_grad=True)
    b = torch.tensor(rng.standard_normal(dim).astype(np.float32),
                     requires_grad=True)
    ct = torch.tensor(rng.standard_normal((200, dim)).astype(np.float32)).to(
        BF16)
    ln = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.bfloat16)
    params = {"params": {"scale": jnp.asarray(f32(w)),
                         "bias": jnp.asarray(f32(b))}}
    y_j, vjp = jax.vjp(lambda p, v: ln.apply(p, v), params,
                       jnp.asarray(f32(x)).astype(jnp.bfloat16))
    gp, gx = vjp(jnp.asarray(f32(ct)).astype(jnp.bfloat16))
    xt = x.clone().requires_grad_(True)
    y = tapi.layer_norm16(xt, w, b, 1e-5, impl)
    y.backward(ct)
    assert y.dtype == xt.grad.dtype == BF16
    np.testing.assert_array_equal(f32(y), np.asarray(y_j, np.float32))
    for got, want, frac in ((xt.grad, gx, 5e-3),
                            (w.grad, gp["params"]["scale"], 1e-6),
                            (b.grad, gp["params"]["bias"], 1e-6)):
        want = np.asarray(want, np.float32)
        assert np.abs(f32(got) - want).max() <= frac * np.abs(want).max()


def test_layer_norm16_follows_the_model_impl():
    """The model's bf16 LayerNorm dispatches through `kernels/api.py` under
    the model's impl: "cuda" on a CPU tensor raises, "torch" and "auto"
    give the same rows on the CPU."""
    from spgemm_gnn_tpu_torch.models.models import build_model

    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((50, 32)).astype(np.float32)).to(
        BF16)
    w, b = torch.ones(32), torch.zeros(32)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        tapi.layer_norm16(x, w, b, 1e-5, "cuda")
    np.testing.assert_array_equal(
        _bits(tapi.layer_norm16(x, w, b, 1e-5, "torch")),
        _bits(tapi.layer_norm16(x, w, b, 1e-5, "auto")))
    for impl in tapi.IMPLS:
        model = build_model("sage", in_dim=32, hidden_dim=32, num_layers=2,
                            out_dim=4, maxk=8, use_norm=True, impl=impl,
                            dtype="bfloat16")
        norms = [m for m in model.modules()
                 if type(m).__name__ == "LayerNorm"]
        assert norms and all(m.impl == impl for m in norms)


# ---------------------------------------------------------------------------
# CPU: the aggregation on bf16 activations against JAX `_planned_aggregate`
# ---------------------------------------------------------------------------

def _graphs():
    from spgemm_gnn_tpu.graphs import synthetic as jsyn
    return (jsyn.random_graph(200, 1500, seed=5, symmetric=False),
            tsyn.random_graph(200, 1500, seed=5, symmetric=False))


def _jax_plans(plan_kind: str, **kw) -> dict:
    if plan_kind == "stream":
        return dict(kind="stream", tile_slots=128, dst_block=128, **kw)
    return dict(kind="windowed", tile_slots=128, src_block=128,
                dst_block=128, window=8)


@pytest.mark.parametrize("norm", ["mean", "gcn"])
@pytest.mark.parametrize("stream", ["f32", "bf16x2"])
@pytest.mark.parametrize("plan_kind,flag", [("windowed", False),
                                            ("stream", False),
                                            ("stream", True)])
def test_planned_aggregate_bf16_matches_jax(plan_kind, flag, stream, norm,
                                            monkeypatch):
    """planned_aggregate on a k-sparse bf16 x, forward and input gradient,
    with both packages' DEFAULT_STREAM and STREAM_CBSR_FORWARD set alike,
    against JAX `planned_aggregate` (its `_planned_aggregate`): y and dx
    bf16, within 1 ulp and off at most 0.5 % of the values (measured: none
    off). The reference rounds twice, bf16(bf16(Σ) · bf16(post)); one
    rounding of the f32 product Σ · post misses 20-23 % of the values by up
    to 2 ulps here, so the test tells the two apart."""
    import importlib

    import jax
    import jax.numpy as jnp
    jplanned = importlib.import_module("spgemm_gnn_tpu.kernels.planned")

    jg, tg = _graphs()
    n, dim, k = tg.num_nodes, 32, 8
    rng = np.random.default_rng(7)
    x = tmaxk.maxk(torch.tensor(rng.standard_normal((n, dim)).astype(
        np.float32)), k).to(BF16)
    ct = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32)).to(
        BF16)
    for mod in (tplanned, jplanned):
        monkeypatch.setattr(mod, "DEFAULT_STREAM", stream)
        monkeypatch.setattr(mod, "STREAM_CBSR_FORWARD", flag)
    jpg = jplanned.plan_graph(jg, **_jax_plans(plan_kind))
    y_j, vjp = jax.vjp(lambda v: jplanned.planned_aggregate(jpg, v, norm,
                                                            k=k),
                       jnp.asarray(f32(x)).astype(jnp.bfloat16))
    dx_j = vjp(jnp.asarray(f32(ct)).astype(jnp.bfloat16))[0]
    assert y_j.dtype == dx_j.dtype == jnp.bfloat16
    y_j, dx_j = np.asarray(y_j, np.float32), np.asarray(dx_j, np.float32)

    tpg = tplanned.plan_graph(tg, kind=plan_kind, dim=dim, dtype=BF16)
    xt = x.clone().requires_grad_(True)
    y = tapi.aggregate(tpg, xt, norm=norm, k=k)
    y.backward(ct)
    assert y.dtype == BF16 and xt.grad.dtype == BF16
    near16(f32(y), y_j)
    near16(f32(xt.grad), dx_j)

    # one rounding of the f32 product misses
    pre, post = node_factors(tg, norm)
    sums = csr_spmm_plain(tg.indptr, tg.indices,
                          (x.float() * (1 if pre is None else pre.to(BF16)
                                        .float()[:, None])).to(BF16))
    once = f32((sums * post[:, None]).to(BF16))
    assert (bf16_ulps(once, y_j) > 0).mean() > 0.1


@pytest.mark.parametrize("plan_kind", ["windowed", "stream"])
def test_both_streams_agree_on_bf16_activations(plan_kind, monkeypatch):
    """On bf16 activations the two feature streams are one arithmetic: y and
    dx bit-equal under DEFAULT_STREAM "f32" and "bf16x2"."""
    g = tsyn.powerlaw_graph(300, 4000, seed=3)
    pg = tplanned.plan_graph(g, kind=plan_kind, dtype=BF16, dim=32)
    rng = np.random.default_rng(2)
    x = torch.tensor(rng.standard_normal((300, 32)).astype(np.float32)).to(
        BF16)
    ct = torch.tensor(rng.standard_normal((300, 32)).astype(np.float32)).to(
        BF16)
    out = []
    for stream in ("f32", "bf16x2"):
        monkeypatch.setattr(tplanned, "DEFAULT_STREAM", stream)
        xt = x.clone().requires_grad_(True)
        y = tplanned.planned_aggregate(pg, xt, "gcn")
        y.backward(ct)
        out.append((_bits(y), _bits(xt.grad)))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("group_tiles,jax_off", [(256, 0), (2, 306)])
def test_stream_bf16_output_rounds_once(group_tiles, jax_off):
    """The JAX stream kernel keeps its bf16 output in the scan's carry and
    rounds it at each group boundary (stream_pallas.py:242); the port
    rounds each row once. Sized here in ulps against bf16 of the float64
    sum, on 300 nodes, 6000 edges, dim 32: with one group, the JAX kernel
    and the port are bit-equal and exact; with 42 groups (group_tiles 2)
    the port stays exact while the JAX kernel is off on 306 of the 9600
    values, by up to 64 ulps (a cancelling sum whose partials were
    rounded)."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.graphs import synthetic as jsyn
    from spgemm_gnn_tpu.graphs.stream_tiles import stream_plan_for_graph
    from spgemm_gnn_tpu.kernels.stream_pallas import stream_spmm as jstream

    jg = jsyn.powerlaw_graph(300, 6000, seed=4)
    tg = tsyn.powerlaw_graph(300, 6000, seed=4)
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal((300, 32)).astype(np.float32)).to(
        BF16)
    jplan = stream_plan_for_graph(jg, tile_slots=128, dst_block=128,
                                  group_tiles=group_tiles)
    want = np.asarray(jstream(jplan, jnp.asarray(f32(x)).astype(jnp.bfloat16),
                              out_dtype=jnp.bfloat16, interpret=True)[:300],
                      np.float32)
    got = stream_spmm(build_stream_plan(tg.indptr, tg.indices), x,
                      out_dtype=BF16)
    exact = f32(csr_spmm_plain(tg.indptr, tg.indices, x.double()).to(BF16))
    assert bf16_ulps(f32(got), exact).max() <= AGG_ULPS
    off = bf16_ulps(want, exact)
    assert int((off > 0).sum()) == jax_off
    if jax_off:
        assert jplan.num_groups > 1 and off.max() > 8


def test_plan_graph_sizes_by_the_activation_row(monkeypatch):
    """Under the f32 stream, bf16 activations gather 2-byte channels: the
    hot set is built at 2 · dim bytes and the schedule at 2-byte channels
    (the f32 ones when the activations are f32)."""
    g = tsyn.random_graph(300, 3000, seed=3)
    spg = tplanned.plan_graph(g, kind="stream", dim=64, dtype=BF16)
    assert (128, HOT_BUDGET) in spg.fwd_plan._hot
    assert (256, HOT_BUDGET) not in spg.fwd_plan._hot
    built = []
    real = CSRPlan.schedule

    def counting(self, n, dim, elem_bytes=4):
        built.append(elem_bytes)
        return real(self, n, dim, elem_bytes)

    monkeypatch.setattr(CSRPlan, "schedule", counting)
    tplanned.plan_graph(g, kind="windowed", dim=64, dtype=BF16)
    tplanned.plan_graph(g, kind="windowed", dim=64)
    assert built == [2, 4]


def test_bf16_output_needs_bf16_rows():
    """A bf16 output is the 16-bit model's: f32 rows or f32 record values
    with out_dtype bf16 raise, as does any other out_dtype."""
    g = tsyn.random_graph(50, 300, seed=1)
    plan = build_stream_plan(g.indptr, g.indices)
    x = torch.zeros((50, 16))
    with pytest.raises(ValueError, match="bf16 rows"):
        csr_spmm(CSRPlan(g.indptr, g.indices), x, out_dtype=BF16)
    with pytest.raises(ValueError, match="bf16 rows"):
        stream_spmm(plan, x, out_dtype=BF16)
    with pytest.raises(ValueError, match="out_dtype"):
        stream_spmm(plan, x.to(BF16), out_dtype=torch.float16)
    vals, ch = tmaxk.cbsr_compact_plain(x, 4)
    with pytest.raises(ValueError, match="bf16 record values"):
        stream_cbsr_spmm(plan, tmaxk.cbsr_records(vals, ch, 16), 4, 16,
                         out_dtype=BF16)


# ---------------------------------------------------------------------------
# CPU: the model families and the Trainer against flax's bf16 model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["sage", "gcn", "gin", "gnn_res",
                                    "sage_integrated", "gcn_integrated",
                                    "gin_integrated"])
def test_family_bf16_logits_match_flax(family):
    """Each family at dtype bfloat16 (ReLU, LayerNorm or BatchNorm on,
    feat_drop 0, 2 layers, 300 nodes, eval mode), with flax's weights
    carried across by convert.py, against flax's bf16 model (impl
    "pallas"): the port's distance to it is at most a quarter of flax-bf16's
    distance to flax-f32 (measured: at most 1e-4 of it, 1.2e-6 against
    1.8e-2 to 2.9e-2). The logits are f32 and the parameters stay f32."""
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.graphs.synthetic import powerlaw_graph as jpowerlaw
    from spgemm_gnn_tpu.kernels.planned import plan_graph as jplan_graph
    from spgemm_gnn_tpu.models.models import build_model as jbuild
    from spgemm_gnn_tpu_torch.convert import (buffers_from_flax,
                                              params_from_flax)
    from spgemm_gnn_tpu_torch.models.models import build_model as tbuild

    n, in_dim, hid, out_dim = 300, 12, 32, 5
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, in_dim)).astype(np.float32)
    jg = jplan_graph(jpowerlaw(n, 3000, seed=7), **_jax_plans("windowed"))
    tg = tplanned.plan_graph(tsyn.powerlaw_graph(n, 3000, seed=7),
                             kind="windowed")
    kw = dict(hidden_dim=hid, num_layers=2, out_dim=out_dim, maxk=8,
              feat_drop=0.0, use_norm=True, nonlinear="relu")
    logits, variables = {}, None
    for dtype in (None, "bfloat16"):
        jm = jbuild(family, impl="pallas", dtype=dtype, **kw)
        if variables is None:
            variables = jm.init({"params": jax.random.PRNGKey(0)}, jg,
                                jnp.asarray(x), train=False)
        xin = jnp.asarray(x) if dtype is None else jnp.asarray(x).astype(
            jnp.bfloat16)
        logits[dtype] = np.asarray(jm.apply(variables, jg, xin, train=False))
    assert logits["bfloat16"].dtype == np.float32

    tm = tbuild(family, in_dim=in_dim, impl="auto", dtype="bfloat16", **kw)
    tm.load_state_dict({
        **params_from_flax(jax.device_get(variables["params"])),
        **buffers_from_flax(jax.device_get(variables.get("batch_stats",
                                                         {})))})
    tm.eval()
    y = tm(tg, torch.tensor(x).to(BF16))
    assert y.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    d_port = float(np.abs(f32(y) - logits["bfloat16"]).max())
    d_bf16 = float(np.abs(logits["bfloat16"] - logits[None]).max())
    assert d_bf16 > 1e-3
    assert d_port <= 0.25 * d_bf16, (d_port, d_bf16)


@pytest.mark.parametrize("stream", ["f32", "bf16x2"])
def test_trainer_bf16_matches_jax_trainer(stream):
    """The port's Trainer against the JAX Trainer (impl "pallas", its
    kernels in interpret mode), both with dtype bfloat16, ReLU, feat_drop 0,
    the JAX initial weights, on the flickr stand-in at scale 0.004 (a
    windowed plan): per-epoch loss within 2e-3 relative over 3 epochs, a
    bf16 ulp being 2^-8 to 2^-7 relative. The logits are f32 on both
    sides, so the loss is."""
    import jax
    from spgemm_gnn_tpu.graphs.datasets import load_dataset as jload
    from spgemm_gnn_tpu.train.config import TrainConfig as JConfig
    from spgemm_gnn_tpu.train.loop import Trainer as JTrainer
    from spgemm_gnn_tpu_torch.convert import params_from_flax
    from spgemm_gnn_tpu_torch.graphs.datasets import Dataset
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    common = dict(dataset="flickr", model="sage", epochs=3, hidden_dim=32,
                  hidden_layers=2, maxk=8, dropout=0.0, w_lr=0.01,
                  nonlinear="relu", norm=True, synthetic=True,
                  synthetic_scale=0.004, eval_every=1, log_every=0, seed=3,
                  stream=stream, dtype="bfloat16")
    jd = jload("flickr", "/nonexistent", allow_synthetic=True,
               synthetic_scale=0.004, seed=3)
    jt = JTrainer(JConfig(impl="pallas", **common), dataset=jd)
    jres = jt.run()
    td = Dataset(name=jd.name,
                 graph=from_edges(np.asarray(jd.graph.indices),
                                  np.asarray(jd.graph.edge_dst),
                                  jd.graph.num_nodes),
                 features=jd.features, labels=jd.labels,
                 train_mask=jd.train_mask, val_mask=jd.val_mask,
                 test_mask=jd.test_mask, num_classes=jd.num_classes,
                 multilabel=jd.multilabel)
    tt = Trainer(TrainConfig(impl="auto", device="cpu", **common),
                 dataset=td)
    assert tt.features.dtype == BF16 and tt.g.kind == "windowed"
    weights = params_from_flax(jax.device_get(jt.init_state()["params"]))
    tres = tt.run(state=tt.init_state(weights=weights))
    jl = np.array([r.loss for r in jres["history"]])
    tl = np.array([r.loss for r in tres["history"]])
    assert len(tl) == len(jl) == common["epochs"]
    np.testing.assert_allclose(tl, jl, rtol=2e-3, atol=0)


def test_cli_trains_bf16_on_cpu(tmp_path):
    """`--dtype bfloat16` trains on the CPU through the plain versions;
    float16 or any other dtype raises (argparse, check_supported and
    build_model alike)."""
    from spgemm_gnn_tpu_torch.models.models import build_model
    from spgemm_gnn_tpu_torch.train.__main__ import main as tmain
    from spgemm_gnn_tpu_torch.train.config import TrainConfig, check_supported

    args = ["--dataset", "flickr", "--synthetic", "--synthetic_scale",
            "0.003", "--epochs", "3", "--hidden_dim", "16",
            "--hidden_layers", "2", "--maxk", "4", "--norm", "--device",
            "cpu", "--path", str(tmp_path)]
    res = tmain(args + ["--dtype", "bfloat16"])
    assert len(res["history"]) == 3
    assert all(np.isfinite(r.loss) for r in res["history"])
    model = res["final_state"]["model"]
    assert model.compute_dtype == BF16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with pytest.raises(SystemExit):
        tmain(args + ["--dtype", "float16"])
    with pytest.raises(ValueError, match="dtype"):
        check_supported(TrainConfig(dtype="float16"))
    with pytest.raises(ValueError, match="dtype"):
        build_model("sage", in_dim=4, hidden_dim=8, num_layers=1, out_dim=2,
                    dtype="float16")


# ---------------------------------------------------------------------------
# GPU: each new kernel form against its plain version (skip without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def hub_graph(n: int = 700, seed: int = 0):
    """Directed, with rows without edges and a hub row of 3000 edges."""
    rng = np.random.default_rng(seed)
    degrees = rng.integers(0, 12, n)
    degrees[::50] = 0
    degrees[3] = 3000
    dst = np.repeat(np.arange(n), degrees)
    return from_edges(rng.integers(0, n, dst.size), dst, n, symmetric=False)


def rounded(y32: torch.Tensor, post: torch.Tensor | None) -> torch.Tensor:
    """bf16(bf16(y32) · bf16(post)) in torch's bf16 arithmetic: what a
    bf16-output form must give from its f32-output run with no post."""
    y = y32.to(BF16)
    return y if post is None else y * post.to(BF16)[:, None]


def family_tie_rows(rng, n: int, dim: int, k: int) -> torch.Tensor:
    """tie_rows, then the families of `utils/rows.py` on every other row
    past the eighth, in bf16."""
    x = tie_rows(rng, max(n, 8), dim)[:n].float()
    if n > 8:
        with_families(x[8:], k, torch.Generator().manual_seed(n), 2)
    return x.to(BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 333, 3000, 100_003])
@pytest.mark.parametrize("dim,k", [(8, 3), (64, 8), (100, 32), (256, 32),
                                   (512, 64), (1000, 100)])
def test_maxk_bf16_bitwise_plain_on_gpu(cuda, dim, k, n):
    """maxk_fwd_bf16 (y and meta) and maxk_bwd_bf16 bit-equal to the plain
    versions on tie-heavy bf16 rows and the row families (NaN equal to NaN:
    a dropped infinity), counted under the bf16 names; N of 1, 7, 333, 3000
    and 100,003 (a ragged tail past many sweeps of the persistent grid)."""
    rng = np.random.default_rng(dim)
    x = family_tie_rows(rng, n, dim, k).to(cuda)
    g = torch.randn((n, dim), device=cuda).to(BF16)
    _build.launches.clear()
    y, meta = tmaxk_kernel.maxk_fwd(x, k)
    dx = tmaxk_kernel.maxk_bwd(x, meta, g)
    assert dict(_build.launches) == {"maxk_fwd_bf16": 1, "maxk_bwd_bf16": 1}
    y_p, meta_p = tmaxk.maxk_forward(x, k)
    np.testing.assert_array_equal(_bits(meta), _bits(meta_p))
    for got, want in ((y, y_p), (dx, tmaxk.maxk_backward(x, meta, g))):
        nan = (got.isnan() & want.isnan()).cpu().numpy()
        np.testing.assert_array_equal(np.where(nan, 0, _bits(got)),
                                      np.where(nan, 0, _bits(want)))


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [8, 30, 64, 256, 1024])
def test_layer_norm16_matches_plain_on_gpu(cuda, dim):
    """layer_norm16_fwd / _bwd against their plain versions: y and dx
    within 1 bf16 ulp of their row's largest magnitude, at most 0.5 % of
    them off (the statistics' f32 sums run in another order), mean and rstd
    within 1e-5 relative, dweight and dbias within 1e-5 of their largest
    magnitude; bitwise repeatable."""
    rng = np.random.default_rng(dim)
    n = 5000
    x = torch.tensor((rng.standard_normal((n, dim)) * 3 + 1).astype(
        np.float32), device=cuda).to(BF16)
    w = torch.tensor(rng.random(dim).astype(np.float32) + 0.5, device=cuda)
    b = torch.tensor(rng.standard_normal(dim).astype(np.float32),
                     device=cuda)
    g = torch.randn((n, dim), device=cuda).to(BF16)
    _build.launches.clear()
    y, mean, rstd = tln.layer_norm16_fwd(x, w, b, 1e-5)
    dx, dw, db = tln.layer_norm16_bwd(x, mean, rstd, w, g)
    assert dict(_build.launches) == {"layer_norm16_fwd": 1,
                                     "layer_norm16_bwd": 1}
    y_p, mean_p, rstd_p = tln.layer_norm16_forward(x, w, b, 1e-5)
    near_rows16(f32(y), f32(y_p))
    for a, e in ((mean, mean_p), (rstd, rstd_p)):
        np.testing.assert_allclose(f32(a), f32(e), rtol=1e-5, atol=1e-6)
    dx_p, dw_p, db_p = tln.layer_norm16_backward(x, mean, rstd, w, g)
    near_rows16(f32(dx), f32(dx_p))
    for a, e in ((dw, dw_p), (db, db_p)):
        assert np.abs(f32(a) - f32(e)).max() <= 1e-5 * np.abs(f32(e)).max()
    y2, _, _ = tln.layer_norm16_fwd(x, w, b, 1e-5)
    dx2, dw2, _ = tln.layer_norm16_bwd(x, mean, rstd, w, g)
    for a, e in ((y, y2), (dx, dx2), (dw, dw2)):
        np.testing.assert_array_equal(_bits(a), _bits(e))


@pytest.mark.gpu
def test_layer_norm16_impl_on_gpu(cuda):
    """impl "torch" keeps the bf16 LayerNorm on the plain ops (no launch),
    "cuda" and "auto" launch the layer_norm16 kernels, forward and
    backward."""
    x = torch.randn((300, 64), device=cuda).to(BF16)
    w = torch.ones(64, device=cuda, requires_grad=True)
    b = torch.zeros(64, device=cuda, requires_grad=True)
    for impl, want in (("torch", {}),
                       ("cuda", {"layer_norm16_fwd": 1,
                                 "layer_norm16_bwd": 1}),
                       ("auto", {"layer_norm16_fwd": 1,
                                 "layer_norm16_bwd": 1})):
        _build.launches.clear()
        xt = x.clone().requires_grad_(True)
        tapi.layer_norm16(xt, w, b, 1e-5, impl).float().sum().backward()
        assert dict(_build.launches) == want, impl
        assert xt.grad.dtype == BF16


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 7, 333, 3000, 100_003])
@pytest.mark.parametrize("dim,k", [(8, 3), (64, 8), (100, 32), (256, 32),
                                   (384, 32), (1000, 100)])
def test_cbsr_compact_bf16_bitwise_plain_on_gpu(cuda, dim, k, n):
    """cbsr_compact_bf16: values (signed zeros and subnormals included) and
    channels bit-equal to the plain version on masked bf16 rows of ties and
    of the row families, short rows included; N of 1, 7, 333, 3000 and
    100,003 (a ragged tail past many sweeps of the persistent grid)."""
    rng = np.random.default_rng(dim + 1)
    x = tmaxk.maxk(family_tie_rows(rng, n, dim, k), k).to(cuda)
    x[::7, : dim // 2] = 0.0
    _build.launches.clear()
    v, c = tcbsr.cbsr_compact(x, k)
    assert dict(_build.launches) == {"cbsr_compact_bf16": 1}
    v_p, c_p = tmaxk.cbsr_compact_plain(x, k)
    assert v.dtype == BF16
    np.testing.assert_array_equal(_bits(v), _bits(v_p))
    np.testing.assert_array_equal(c.cpu().numpy(), c_p.cpu().numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [None, 1, 4])
@pytest.mark.parametrize("dim", [16, 256, 264])
def test_csr_spmm_bf16_out_on_gpu(cuda, dim, nb):
    """On A and Aᵀ of a graph with a hub row and empty rows, with a post
    factor: csr_spmm_bf16_out bit-equal to the rounding of the same
    kernel's f32-output run with no post, bit-equal across two runs, and
    within 1 ulp of the plain version's (other summation order)."""
    g = hub_graph().to(cuda)
    rng = np.random.default_rng(dim)
    x = torch.tensor(rng.standard_normal((700, dim)).astype(np.float32),
                     device=cuda).to(BF16)
    post = torch.tensor(rng.random(700).astype(np.float32) + 0.5,
                        device=cuda)
    for indptr, indices in ((g.indptr, g.indices), (g.t_indptr, g.t_indices)):
        plan = CSRPlan(indptr, indices, nb, 64)
        _build.launches.clear()
        y = csr_spmm(plan, x, None, post, out_dtype=BF16)
        again = csr_spmm(plan, x, None, post, out_dtype=BF16)
        assert dict(_build.launches) == {"csr_spmm_bf16_out": 2}
        assert y.dtype == BF16
        np.testing.assert_array_equal(_bits(y), _bits(again))
        np.testing.assert_array_equal(_bits(y),
                                      _bits(rounded(csr_spmm(plan, x), post)))
        near16(f32(y), f32(csr_spmm_plain(indptr, indices, x, None, post,
                                          BF16)))


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [7, 128])
@pytest.mark.parametrize("dim", [8, 256, 520])
def test_stream_spmm_bf16_out_on_gpu(cuda, dim, chunk):
    """On A and Aᵀ: stream_spmm_bf16_out bit-equal to the rounding of the
    f32-output run with no post, and across hot budgets (none, a few rows,
    every row), fetch depths and warp spans of 1 and 3 chunks (rows across
    spans take the heads slots); within 1 ulp of the plain version's."""
    from spgemm_gnn_tpu_torch.kernels import stream as tstream
    g = hub_graph(seed=1).to(cuda)
    rng = np.random.default_rng(dim + chunk)
    x = torch.tensor(rng.standard_normal((700, dim)).astype(np.float32),
                     device=cuda).to(BF16)
    post = torch.tensor(rng.random(700).astype(np.float32) + 0.5,
                        device=cuda)
    row = 2 * dim
    for indptr, indices in ((g.indptr, g.indices), (g.t_indptr, g.t_indices)):
        plan = build_stream_plan(indptr, indices, chunk=chunk)
        _build.launches.clear()
        y = stream_spmm(plan, x, None, post, out_dtype=BF16)
        assert dict(_build.launches) == {"stream_spmm_bf16_out": 1}
        np.testing.assert_array_equal(
            _bits(y), _bits(rounded(stream_spmm(plan, x), post)))
        near16(f32(y), f32(stream_spmm_plain(plan, x, None, post, BF16)))
        depths = tstream.DEPTHS[tstream._slices(row // 16)]
        for budget, depth in ((0, None), (5 * row, None), (700 * row, None),
                              *((None, d) for d in depths)):
            other = tstream.stream_spmm_at(plan, x, None, post,
                                           hot_budget=budget, depth=depth,
                                           out_dtype=BF16)
            np.testing.assert_array_equal(_bits(y), _bits(other))
        for wc in (1, 3):
            span = build_stream_plan(indptr, indices, chunk=chunk,
                                     warp_chunks=wc)
            np.testing.assert_array_equal(_bits(y), _bits(stream_spmm(
                span, x, None, post, out_dtype=BF16)))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 32, 100])
def test_stream_cbsr_spmm_bf16_out_on_gpu(cuda, k):
    """dim 256: stream_cbsr_spmm_bf16_out bit-equal to the rounding of the
    f32-output run with no post, equal by value to stream_spmm_bf16_out on
    the densified rows, and bit-equal across hot budgets and batches."""
    from spgemm_gnn_tpu_torch.kernels import stream as tstream
    dim = 256
    g = hub_graph(seed=2).to(cuda)
    rng = np.random.default_rng(k)
    x = tmaxk.maxk(torch.tensor(rng.standard_normal((700, dim)).astype(
        np.float32), device=cuda).to(BF16), k)
    post = torch.tensor(rng.random(700).astype(np.float32) + 0.5,
                        device=cuda)
    vals, ch = tcbsr.cbsr_compact(x, k)
    rec = tmaxk.cbsr_records(vals, ch, dim)
    plan = build_stream_plan(g.indptr, g.indices)
    _build.launches.clear()
    y = stream_cbsr_spmm(plan, rec, k, dim, None, post, BF16, BF16)
    assert dict(_build.launches) == {"stream_cbsr_spmm_bf16_out": 1}
    np.testing.assert_array_equal(
        _bits(y), _bits(rounded(stream_cbsr_spmm(plan, rec, k, dim, None,
                                                 None, BF16), post)))
    assert torch.equal(y, stream_spmm(plan, x, None, post, out_dtype=BF16))
    near16(f32(y), f32(stream_cbsr_spmm_plain(plan, rec, k, dim, None, post,
                                              BF16, BF16)))
    row = 4 * rec.shape[1]
    for budget, batch in ((0, None), (5 * row, None), (700 * row, None),
                          *((None, b) for b in
                            tstream.BATCHES16[tstream._slices(k)])):
        other = tstream.stream_cbsr_spmm_at(
            plan, rec, k, dim, None, post, hot_budget=budget, batch=batch,
            value_dtype=BF16, out_dtype=BF16)
        np.testing.assert_array_equal(_bits(y), _bits(other))


@pytest.mark.gpu
@pytest.mark.parametrize("stream", ["f32", "bf16x2"])
@pytest.mark.parametrize("plan_kind,flag", [("windowed", False),
                                            ("stream", False),
                                            ("stream", True)])
def test_bf16_aggregate_launches_only_16bit_forms_on_gpu(
        cuda, plan_kind, flag, stream, monkeypatch):
    """MaxK and a k-sparse aggregation of bf16 activations, forward and
    backward, under either stream: only the 16-bit forms launch (no
    round_rows, no f32 kernel), and y and dx are within 1 ulp of the same
    path through the plain versions."""
    g = tsyn.powerlaw_graph(600, 6000, seed=9).to(cuda)
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", stream)
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", flag)
    pg = tplanned.plan_graph(g, kind=plan_kind, dim=256, dtype=BF16)
    x = torch.randn((600, 256), device=cuda).to(BF16)
    ct = torch.randn((600, 256), device=cuda).to(BF16)
    out = {}
    for plain in (False, True):
        if plain:   # every wrapper takes its plain version
            monkeypatch.setattr(_build, "on_cpu", lambda t: True)
        xt = x.clone().requires_grad_(True)
        _build.launches.clear()
        y = tapi.aggregate(pg, tapi.maxk_op(xt, 32), "gcn", k=32)
        y.backward(ct)
        out[plain] = (y.detach(), xt.grad, dict(_build.launches))
    kernel = {"windowed": "csr_spmm_bf16_out",
              "stream": "stream_spmm_bf16_out"}[plan_kind]
    want = {"maxk_fwd_bf16": 1, "maxk_bwd_bf16": 1}
    want.update({"cbsr_compact_bf16": 1, "stream_cbsr_spmm_bf16_out": 1,
                 kernel: 1} if flag else {kernel: 2})
    assert out[False][2] == want
    assert out[True][2] == {}
    assert out[False][0].dtype == out[False][1].dtype == BF16
    for a, b in zip(out[False][:2], out[True][:2]):
        near16(f32(a), f32(b))


@pytest.mark.gpu
@pytest.mark.parametrize("plan_kind", ["windowed", "stream"])
def test_bf16_never_reaches_an_f32_kernel_on_gpu(cuda, plan_kind,
                                                 monkeypatch):
    """No fallback: where a 16-bit form refuses its launch, a bf16 tensor
    raises; neither the f32 kernel nor the plain version runs instead."""
    g = tsyn.powerlaw_graph(300, 3000, seed=5).to(cuda)
    pg = tplanned.plan_graph(g, kind=plan_kind, dtype=BF16)
    x = torch.randn((300, 64), device=cuda).to(BF16)
    real = _build.library

    class Refusing:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, fn):
            if fn.endswith(("_bf16", "_bf16_out")):
                return lambda *args: 1      # cudaErrorInvalidValue
            return getattr(self.inner, fn)

    monkeypatch.setattr(_build, "library", lambda which: Refusing(real(which)))
    for run in (lambda: tplanned.planned_aggregate(pg, x, "mean"),
                lambda: tmaxk_kernel.maxk_fwd(x, 8),
                lambda: tcbsr.cbsr_compact(tmaxk.maxk(x, 8), 8)):
        _build.launches.clear()
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            run()
        assert not _build.launches
