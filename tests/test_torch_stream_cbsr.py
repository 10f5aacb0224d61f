"""The CBSR edge-gather stream forward: `pack_channels`/`unpack_channels`,
`stream_cbsr_spmm` and `kernels.planned.STREAM_CBSR_FORWARD` against the JAX
package (CPU), and the `stream_cbsr_spmm` kernel against its plain version
and against `stream_spmm` (GPU).

On the CPU the kernel wrapper takes its plain version (ops/stream.py). The
JAX package's flag is set through `monkeypatch.setattr` on its module, as the
port's is. The GPU cases (marker `gpu`) skip without a card; they import no
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_stream_cbsr.py
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels import api as tapi
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.kernels.stream import stream_cbsr_spmm, stream_spmm
from spgemm_gnn_tpu_torch.ops import maxk as tmaxk_plain
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.ops.stream import stream_spmm_plain


def sparse_rows(rng, n: int, dim: int, k: int) -> np.ndarray:
    """Rows of at most k nonzeros: k at random channels (some negative, so
    −0.0 appears where a product is masked), and short and empty rows."""
    x = rng.standard_normal((n, dim)).astype(np.float32)
    keep = np.argsort(rng.random((n, dim)), axis=1)[:, :k]
    mask = np.zeros((n, dim), bool)
    np.put_along_axis(mask, keep, True, axis=1)
    x = (x * mask).astype(np.float32)
    x[1] = 0.0
    x[2, :] = 0.0
    x[2, [dim - 1, dim // 2]] = 3.0
    return x


def scale_tol(ref) -> dict:
    """Only the f32 summation order differs: rtol 1e-5, and atol 1e-6 of the
    output's scale (as tests/test_torch_kernels.py)."""
    ref = np.asarray(ref)
    return dict(rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(ref).max())))


def degree_graph(degrees, seed: int = 0):
    """A directed graph with the given in-degrees (sources at random)."""
    rng = np.random.default_rng(seed)
    n = len(degrees)
    dst = np.repeat(np.arange(n), degrees)
    return from_edges(rng.integers(0, n, dst.size), dst, n, symmetric=False)


# ---------------------------------------------------------------------------
# CPU: the channel packing against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [8, 30, 32, 64])
@pytest.mark.parametrize("dim", [32, 256, 384])
def test_pack_channels_matches_jax(dim, k, rng):
    """Bit for bit (the int32 words), with ids >= 128 in every byte at dim
    256 (the top byte sets the word's sign bit) and ids >= 256 at dim 384
    (two uint16 ids per word); then the round trip."""
    import importlib

    import jax.numpy as jnp
    jmaxk = importlib.import_module("spgemm_gnn_tpu.ops.maxk")

    ch = rng.integers(0, dim, (40, k)).astype(np.int32)
    if dim >= 256:
        ch[0, :] = dim - 1
        ch[1, :] = 128 if dim == 256 else 300
    want = np.asarray(jmaxk.pack_channels(jnp.asarray(ch), dim))
    got = tmaxk_plain.pack_channels(torch.tensor(ch), dim)
    assert got.dtype == torch.int32
    assert got.shape[1] == tmaxk_plain.packed_channel_words(k, dim) \
        == jmaxk.packed_channel_words(k, dim)
    np.testing.assert_array_equal(got.numpy(), want)
    if dim == 256:                      # every full word of row 0
        assert (want[0, :k // 4] < 0).all()
    back = tmaxk_plain.unpack_channels(got, k, dim)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), ch)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jmaxk.unpack_channels(jnp.asarray(want), k,
                                                       dim)))


# ---------------------------------------------------------------------------
# CPU: stream_cbsr_spmm against JAX stream_spmm_cbsr (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["sum", "gcn"])
@pytest.mark.parametrize("dim,k", [(32, 8), (256, 32)])
def test_stream_cbsr_spmm_matches_jax(dim, k, norm):
    """The port's stream_cbsr_spmm (plain on the CPU) against JAX's
    stream_spmm_cbsr (stream "f32", interpret) on a directed graph, with the
    norm's factors applied as the JAX planned path applies them (values
    pre-scaled, the output post-scaled). It also equals the port's
    stream_spmm_plain on the densified input by value."""
    import importlib

    import jax.numpy as jnp
    from spgemm_gnn_tpu.graphs.synthetic import random_graph as jrandom
    from spgemm_gnn_tpu.kernels.planned import plan_graph as jplan_graph
    from spgemm_gnn_tpu.kernels.stream_pallas import stream_spmm_cbsr
    jmaxk = importlib.import_module("spgemm_gnn_tpu.ops.maxk")

    n = 200
    jg = jrandom(n, 1500, seed=5, symmetric=False)
    tg = tsyn.random_graph(n, 1500, seed=5, symmetric=False)
    x = sparse_rows(np.random.default_rng(dim + k), n, dim, k)
    vals, ch = tmaxk_plain.cbsr_compact_plain(torch.tensor(x), k)
    pre, post = node_factors(tg, norm)
    jv = vals.numpy() if pre is None else vals.numpy() * pre.numpy()[:, None]
    jplan = jplan_graph(jg, kind="stream", tile_slots=128,
                        dst_block=128).fwd_plan
    want = np.asarray(stream_spmm_cbsr(
        jplan, jnp.asarray(jv), jmaxk.pack_channels(jnp.asarray(ch.numpy()),
                                                    dim),
        dim, stream="f32", interpret=True))[:n]
    if post is not None:
        want = want * post.numpy()[:, None]

    plan = tplanned.plan_graph(tg, kind="stream", chunk=9).fwd_plan
    got = stream_cbsr_spmm(plan, tmaxk_plain.cbsr_records(vals, ch, dim), k,
                           dim, pre, post)
    assert got.shape == (n, dim) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **scale_tol(want))
    dense = stream_spmm_plain(plan, tmaxk_plain.cbsr_to_dense(vals, ch, dim),
                              pre, post)
    assert torch.equal(got, dense)


def test_stream_cbsr_spmm_limits():
    """The reference's contract (stream_pallas.py: dim <= 256, uint8 ids),
    on the CPU too; 1 <= k < dim; and records of k values and the packed
    ids."""
    g = tsyn.random_graph(20, 60, seed=1)
    plan = build_stream_plan(g.indptr, g.indices, chunk=8)
    ch = torch.zeros((20, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="dim <= 256"):
        stream_cbsr_spmm(plan, tmaxk_plain.cbsr_records(torch.zeros((20, 4)),
                                                        ch, 264), 4, 264)
    for k, dim in ((8, 8), (12, 8), (0, 8)):
        with pytest.raises(ValueError, match="1 <= k < dim"):
            stream_cbsr_spmm(plan, torch.zeros((20, k + 2), dtype=torch.int32),
                             k, dim)
    with pytest.raises(ValueError, match="expected"):
        stream_cbsr_spmm(plan, torch.zeros((20, 4), dtype=torch.int32), 4, 64)


# ---------------------------------------------------------------------------
# CPU: the flag on the models' path and on the CBSR API, against JAX
# ---------------------------------------------------------------------------

DIM, K = 128, 16


def _graphs(kind: str):
    from spgemm_gnn_tpu.graphs import synthetic as jsyn
    if kind == "symmetric":
        return (jsyn.powerlaw_graph(250, 2500, seed=21),
                tsyn.powerlaw_graph(250, 2500, seed=21))
    return (jsyn.random_graph(200, 1500, seed=5, symmetric=False),
            tsyn.random_graph(200, 1500, seed=5, symmetric=False))


def _spy(monkeypatch, name: str) -> list:
    """Record the calls of kernels/planned.py's `name` (still calling it)."""
    calls = []
    fn = getattr(tplanned, name)

    def spy(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)
    monkeypatch.setattr(tplanned, name, spy)
    return calls


def test_flag_defaults_to_the_reference():
    """The JAX package keeps its flag off (the reference); the port's default
    is None, the rule of `test_cbsr_forward_rule`."""
    from spgemm_gnn_tpu.kernels import planned as jplanned
    assert jplanned.STREAM_CBSR_FORWARD is False
    assert tplanned.STREAM_CBSR_FORWARD is None


@pytest.mark.parametrize("acts", ["f32", "bf16x2", "bf16"])
@pytest.mark.parametrize("flag", [None, True, False])
@pytest.mark.parametrize("kind", ["stream", "windowed"])
@pytest.mark.parametrize("k", [32, "dim"])
@pytest.mark.parametrize("dim", [256, 384])
def test_cbsr_forward_rule(dim, k, kind, flag, acts, monkeypatch):
    """STREAM_CBSR_FORWARD's three states on plan_spmm: None (the default)
    takes the CBSR form of the plan's kernel where k < dim <= 256, True
    wherever k < dim (raising above dim 256, as the reference does), False
    never: stream_cbsr_spmm on a stream plan, csr_cbsr_spmm on a windowed
    plan (f32 activations, the bf16x2 stream and bf16 activations alike:
    f32 records on f32 activations). y equals the dense forward's by
    value."""
    k = dim if k == "dim" else k
    g = tplanned.plan_graph(tsyn.random_graph(40, 200, seed=3), kind=kind,
                            chunk=16)
    rng = np.random.default_rng(dim + k)
    x = torch.tensor(sparse_rows(rng, 40, dim, k))
    if acts == "bf16":
        x = x.to(torch.bfloat16)
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM",
                        "bf16x2" if acts == "bf16x2" else "f32")
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", flag)
    names = ("stream_cbsr_spmm", "stream_spmm", "csr_cbsr_spmm", "csr_spmm")
    calls = {name: _spy(monkeypatch, name) for name in names}
    _, post = node_factors(g, "mean")
    cbsr = k < dim and (flag is True or flag is None and dim <= 256)
    if cbsr and dim > 256:
        with pytest.raises(ValueError, match="dim <= 256"):
            tplanned.plan_spmm(g.fwd_plan, x, None, post, k)
        return
    y = tplanned.plan_spmm(g.fwd_plan, x, None, post, k)
    want = {("stream", True): "stream_cbsr_spmm",
            ("stream", False): "stream_spmm",
            ("windowed", True): "csr_cbsr_spmm",
            ("windowed", False): "csr_spmm"}[kind, cbsr]
    assert {name: len(c) for name, c in calls.items()} == {
        name: int(name == want) for name in names}
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", False)
    assert torch.equal(y, tplanned.plan_spmm(g.fwd_plan, x, None, post, k))


@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_planned_aggregate_with_flag_matches_jax(kind, norm, monkeypatch):
    """planned_aggregate(..., k) on a forced stream plan (chunks of 7
    edges) with both packages' flags set: y and dx against JAX
    planned_aggregate (its stream_spmm_cbsr forward, interpret) and the
    XLA oracle; the forward goes through stream_cbsr_spmm and not
    stream_spmm, and equals the flag-off forward by value."""
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels import planned as jplanned
    from spgemm_gnn_tpu.ops.spmm import spmm as jspmm
    from spgemm_gnn_tpu_torch.ops.maxk import maxk

    jg, tg = _graphs(kind)
    rng = np.random.default_rng(len(kind) * 10 + len(norm))
    x = maxk(torch.tensor(rng.standard_normal((tg.num_nodes, DIM))
                          .astype(np.float32)), K).numpy()
    ct = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)
    monkeypatch.setattr(jplanned, "STREAM_CBSR_FORWARD", True)
    jpg = jplanned.plan_graph(jg, kind="stream", tile_slots=128,
                              dst_block=128)
    refs = []
    for fn in (lambda v: jplanned.planned_aggregate(jpg, v, norm, k=K),
               lambda v: jspmm(jg, v, norm)):
        y, vjp = jax.vjp(fn, jnp.asarray(x))
        refs.append((np.asarray(y), np.asarray(vjp(jnp.asarray(ct))[0])))

    tpg = tplanned.plan_graph(tg, kind="stream", chunk=7)
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", True)
    cbsr_calls = _spy(monkeypatch, "stream_cbsr_spmm")
    dense_calls = _spy(monkeypatch, "stream_spmm")
    xt = torch.tensor(x, requires_grad=True)
    y = tapi.aggregate(tpg, xt, norm=norm, k=K)
    assert cbsr_calls == ["stream_cbsr_spmm"] and dense_calls == []
    (y * torch.tensor(ct)).sum().backward()
    assert dense_calls == ["stream_spmm"]          # the backward: dense, Aᵀ
    for y_ref, dx_ref in refs:
        for got, ref in ((y.detach().numpy(), y_ref),
                         (xt.grad.numpy(), dx_ref)):
            np.testing.assert_allclose(got, ref, **scale_tol(ref))
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", False)
    assert torch.equal(y.detach(), tapi.aggregate(tpg, torch.tensor(x),
                                                  norm=norm, k=K))


@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
def test_aggregate_cbsr_with_flag_matches_jax(norm, monkeypatch):
    """aggregate_cbsr on a forced stream plan with both flags set: y and
    dvalues against JAX aggregate_cbsr (impl "pallas": its spgemm_forward
    takes stream_spmm_cbsr). The forward densifies nothing."""
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels import planned as jplanned
    from spgemm_gnn_tpu.kernels.api import aggregate_cbsr as jaggregate_cbsr
    from spgemm_gnn_tpu.ops.maxk import maxk_cbsr

    jg, tg = _graphs("directed")
    rng = np.random.default_rng(len(norm))
    x = rng.standard_normal((200, DIM)).astype(np.float32)
    ct = rng.standard_normal((200, DIM)).astype(np.float32)
    jv, jc = maxk_cbsr(jnp.asarray(x), K)
    monkeypatch.setattr(jplanned, "STREAM_CBSR_FORWARD", True)
    jpg = jplanned.plan_graph(jg, kind="stream", tile_slots=128,
                              dst_block=128)
    y_ref, vjp = jax.vjp(lambda v: jaggregate_cbsr(jpg, v, jc, DIM, norm,
                                                   "pallas"), jv)
    y_ref, dv_ref = np.asarray(y_ref), np.asarray(vjp(jnp.asarray(ct))[0])

    tpg = tplanned.plan_graph(tg, kind="stream", chunk=9)
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", True)
    densify_calls = _spy(monkeypatch, "cbsr_densify")
    cbsr_calls = _spy(monkeypatch, "stream_cbsr_spmm")
    vals = torch.tensor(np.asarray(jv), requires_grad=True)
    y = tapi.aggregate_cbsr(tpg, vals, torch.tensor(np.asarray(jc)), DIM,
                            norm)
    assert densify_calls == [] and cbsr_calls == ["stream_cbsr_spmm"]
    (y * torch.tensor(ct)).sum().backward()
    for got, ref in ((y.detach().numpy(), y_ref),
                     (vals.grad.numpy(), dv_ref)):
        np.testing.assert_allclose(got, ref, **scale_tol(ref))


def test_flag_at_dim_above_256_raises_on_stream_plans_only(monkeypatch):
    """yelp's hidden 384: with the flag set a stream plan raises as the
    reference does (no quiet route to stream_spmm), and so does a windowed
    plan, whose f32 records now have a kernel (csr_cbsr_spmm, dim <= 256);
    at the default rule both keep their dense forwards."""
    g = tsyn.random_graph(40, 200, seed=3)
    x = tmaxk_plain.maxk(torch.randn(40, 384), 8)
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", True)
    for kind in ("stream", "windowed"):
        with pytest.raises(ValueError, match="dim <= 256"):
            tapi.aggregate(tplanned.plan_graph(g, kind=kind), x, "mean", k=8)
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", None)
    y = tapi.aggregate(tplanned.plan_graph(g, kind="windowed"), x, "mean",
                       k=8)
    assert torch.allclose(y, tapi.aggregate(g, x, "mean", impl="torch"),
                          rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# GPU: the stream_cbsr_spmm kernel (skip without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("factors", ["none", "pre", "post", "both"])
@pytest.mark.parametrize("chunk", [7, 128])
@pytest.mark.parametrize("k", [8, 30, 32, 64])
def test_stream_cbsr_spmm_matches_plain_on_gpu(cuda, k, chunk, factors):
    """dim 256, on A and Aᵀ of a directed graph with empty rows and a hub
    row of 3000 edges: within 1e-5 of the largest |y| of the plain version
    run in float64, equal by value to stream_spmm on the densified input,
    bitwise equal across two runs and across hot budgets (none, a few rows,
    every row), edges loaded ahead and warp spans (1 and 3 chunks), and 0 on
    rows without edges."""
    from spgemm_gnn_tpu_torch.kernels import stream as tstream
    dim = 256
    rng = np.random.default_rng(k + chunk)
    degrees = rng.integers(0, 12, 700)
    degrees[::50] = 0
    degrees[3] = 3000
    g = degree_graph(degrees.tolist(), seed=k).to(cuda)
    x = torch.tensor(sparse_rows(rng, 700, dim, k), device=cuda)
    vals, ch = tmaxk_plain.cbsr_compact_plain(x, k)
    rec = tmaxk_plain.cbsr_records(vals, ch, dim)
    f = torch.tensor(rng.random(700).astype(np.float32) + 0.5, device=cuda)
    pre = f if factors in ("pre", "both") else None
    post = f.flip(0) if factors in ("post", "both") else None
    row_bytes = 4 * rec.shape[1]
    for indptr, indices in ((g.indptr, g.indices), (g.t_indptr, g.t_indices)):
        plan = build_stream_plan(indptr, indices, chunk=chunk)
        y = stream_cbsr_spmm(plan, rec, k, dim, pre, post)
        again = stream_cbsr_spmm(plan, rec, k, dim, pre, post)
        ref = stream_spmm_plain(plan, x.double(), pre, post)
        err = float((y.double() - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), err
        assert torch.equal(y, stream_spmm(plan, x, pre, post))
        np.testing.assert_array_equal(_bits(y), _bits(again))
        assert (y[indptr.diff() == 0] == 0).all()
        batches = tstream.BATCHES[1 if k <= 32 else 2]
        for budget, batch in ((0, None), (5 * row_bytes, None),
                              (700 * row_bytes, None),
                              *((None, b) for b in batches)):
            other = tstream.stream_cbsr_spmm_at(
                plan, rec, k, dim, pre, post, hot_budget=budget, batch=batch)
            np.testing.assert_array_equal(_bits(y), _bits(other))
        for wc in (1, 3):
            span_plan = build_stream_plan(indptr, indices, chunk=chunk,
                                          warp_chunks=wc)
            np.testing.assert_array_equal(_bits(y), _bits(stream_cbsr_spmm(
                span_plan, rec, k, dim, pre, post)))
        assert plan.hot_set(row_bytes, 700 * row_bytes).rows == int(
            (torch.bincount(indices) > 0).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
def test_flag_launches_stream_cbsr_spmm_on_gpu(cuda, norm, monkeypatch):
    """With the flag set, a k-sparse aggregation over a stream plan
    launches cbsr_compact and stream_cbsr_spmm forward and stream_spmm
    backward, and gives the flag-off y and dx by value."""
    g = tsyn.powerlaw_graph(600, 6000, seed=9).to(cuda)
    pg = tplanned.plan_graph(g, kind="stream")
    x = tmaxk_plain.maxk(torch.randn((600, 256), device=cuda), 32)
    ct = torch.randn((600, 256), device=cuda)
    out = {}
    for flag in (True, False):
        monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", flag)
        xt = x.clone().requires_grad_(True)
        _build.launches.clear()
        y = tapi.aggregate(pg, xt, norm, k=32, impl="cuda")
        (y * ct).sum().backward()
        out[flag] = (y.detach(), xt.grad, dict(_build.launches))
    assert out[True][2] == {"cbsr_compact": 1, "stream_cbsr_spmm": 1,
                            "stream_spmm": 1}
    assert out[False][2] == {"stream_spmm": 2}
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])


@pytest.mark.gpu
def test_stream_cbsr_wrapper_raises_on_bad_input(cuda):
    from spgemm_gnn_tpu_torch.kernels.stream import stream_cbsr_spmm_at
    g = tsyn.random_graph(50, 200, seed=1).to(cuda)
    plan = build_stream_plan(g.indptr, g.indices)
    rec = torch.zeros((50, 10), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dim <= 256"):
        stream_cbsr_spmm(plan, rec, 8, 264)
    with pytest.raises(ValueError, match="1 <= k < dim"):
        stream_cbsr_spmm(plan, rec, 8, 8)
    with pytest.raises(ValueError, match="dim % 4"):
        stream_cbsr_spmm(plan, rec, 8, 18)
    with pytest.raises(ValueError, match="dtype"):
        stream_cbsr_spmm(plan, rec.float(), 8, 64)
    with pytest.raises(ValueError, match="shape"):
        stream_cbsr_spmm(plan, rec[:, :9].contiguous(), 8, 64)
    with pytest.raises(ValueError, match="is on cpu"):
        stream_cbsr_spmm(build_stream_plan(g.indptr.cpu(), g.indices.cpu()),
                         rec, 8, 64)
    with pytest.raises(ValueError, match="contiguous"):
        stream_cbsr_spmm(plan, torch.zeros((10, 50), dtype=torch.int32,
                                           device=cuda).t(), 8, 64)
    with pytest.raises(ValueError, match="batch"):
        stream_cbsr_spmm_at(plan, rec, 8, 64, batch=12)
