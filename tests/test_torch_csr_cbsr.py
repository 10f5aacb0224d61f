"""The CBSR form of the windowed kind's kernel, `csr_cbsr_spmm` (the kernels
`csr_cbsr_spmm_bf16` and `csr_cbsr_spmm_bf16_out`: y = post ⊙ A ·
densify(records) over `csr_spmm`'s schedule, on bf16 records), and the
windowed branch of `kernels.planned.STREAM_CBSR_FORWARD`'s rule.

CPU: the plain version (`ops/spmm.py::csr_cbsr_plain`) against the blocked
plain sum on the densified rows, bit for bit; the kernel's walk (a batch of
32 edges scattered into a partial row, folded into the segment's sum,
pieces and blocks in order) emulated in numpy f32 and bit-equal to the
dense kernel's walk on the densified rows; the planner's route on windowed
plans; `planned_aggregate` and `aggregate_cbsr` through the new route
against the JAX package (its Pallas kernels in interpret mode); the Trainer
with the rule on against off. GPU (marker `gpu`, skipped without a card,
no JAX): the kernels against `csr_spmm`'s bf16 forms on the densified rows
(bit for bit at the same schedule), against the plain version, repeatable,
and their launch counts.

    python -m pytest tests/test_torch_csr_cbsr.py
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_csr_cbsr.py
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.tiles import FIRST, LAST, CSRPlan
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels import api as tapi
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.kernels.spmm import csr_cbsr_spmm, csr_spmm
from spgemm_gnn_tpu_torch.ops import maxk as tmaxk
from spgemm_gnn_tpu_torch.ops.spmm import (csr_blocked_plain, csr_cbsr_plain,
                                           csr_spmm_plain)

BF16 = torch.bfloat16
N, SEGMENT = 300, 64
# (dim, k): the recipes' k 32 at dim 256, small k, and records of 2 lines
DIM_K = [(32, 4), (64, 8), (256, 32), (128, 40)]


@pytest.fixture
def one_torch_thread():
    """One torch thread for the Trainer runs this file compares bit for
    bit, as the other bit-equal Trainer tests run
    (tests/test_torch_stream.py::one_torch_thread): no sum of the two runs
    is split across an intra-op thread pool."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def restore_flags(monkeypatch):
    """Both packages' DEFAULT_STREAM and STREAM_CBSR_FORWARD as they were
    after the test, starting from "f32" and the port's default rule (None;
    the JAX package's False)."""
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", "f32")
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", None)
    try:
        import importlib
        jplanned = importlib.import_module("spgemm_gnn_tpu.kernels.planned")
    except ImportError:     # the card's machine has no JAX
        return
    monkeypatch.setattr(jplanned, "DEFAULT_STREAM", "f32")
    monkeypatch.setattr(jplanned, "STREAM_CBSR_FORWARD", False)


def hub_graph(n: int = N, seed: int = 11, hub_edges: int = 3000):
    """Directed: random in-degrees 0-11, rows without in-edges (every 50th
    and the last 20), and node 3 with `hub_edges` in-edges, whose run is cut
    into pieces in every source block."""
    rng = np.random.default_rng(seed)
    degrees = rng.integers(0, 12, n)
    degrees[::50] = 0
    degrees[-20:] = 0
    degrees[3] = hub_edges
    dst = np.repeat(np.arange(n), degrees)
    return from_edges(rng.integers(0, n, dst.size), dst, n, symmetric=False)


def records_of(rng, n: int, dim: int, k: int, device="cpu", ints=False):
    """k-sparse bf16 rows and their records: k distinct random channels a
    row holding normals (or, with `ints`, integers in [-4, 4], whose f32
    sums are exact in any order), some slots 0 (short rows), row 1 empty.
    Returns (dense bf16 [n, dim], records int32 [n, record_words])."""
    if ints:
        vals = rng.integers(-4, 5, (n, k)).astype(np.float32)
    else:
        vals = rng.standard_normal((n, k)).astype(np.float32)
        vals[rng.random((n, k)) < 0.1] = 0.0
    vals[1] = 0.0
    ch = np.argsort(rng.random((n, dim)), axis=1)[:, :k].astype(np.int32)
    v = torch.tensor(vals, device=device).to(BF16)
    c = torch.tensor(ch, device=device)
    return (tmaxk.cbsr_to_dense(v, c, dim),
            tmaxk.cbsr_records(v, c, dim).contiguous())


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32).numpy()


def near(got, ref, frac: float = 1e-5) -> None:
    """Within `frac` of ref's largest magnitude: the same bf16 values summed
    in f32 in another order."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= frac * max(float(np.abs(ref).max()), 1e-30), err


def near16(got, want, ulps: int = 1, share: float = 0.005) -> None:
    """bf16 outputs: within `ulps` bf16 ulps of want (2^-7 of its power of
    two) and off on at most `share` of the values (as
    tests/test_torch_dtype16.py holds the bf16-output aggregation)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mag = np.maximum(np.abs(want), 2.0 ** -120)
    u = np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert u.max(initial=0.0) <= ulps, u.max()
    assert (u > 0).mean() <= share, (u > 0).mean()


# ---------------------------------------------------------------------------
# CPU: the plain version and the wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_post", [False, True])
@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("dim,k", DIM_K)
@pytest.mark.parametrize("nb", [1, 2, 3])
def test_plain_is_the_blocked_sum_of_the_densified_rows(nb, dim, k, out,
                                                        with_post):
    """csr_cbsr_plain on a schedule (nb source blocks, segments of 64, the
    hub split into pieces, rows without in-edges) is csr_blocked_plain on
    the densified bf16 rows bit for bit, f32 and bf16 out, with and
    without post; and the wrapper on CPU tensors is csr_spmm on those rows
    (the dense form) bit for bit."""
    g = hub_graph()
    rng = np.random.default_rng(nb * 100 + k)
    dense, rec = records_of(rng, N, dim, k)
    post = (torch.tensor(rng.random(N).astype(np.float32) + 0.5)
            if with_post else None)
    od = BF16 if out == "bf16" else None
    plan = CSRPlan(g.indptr, g.indices, nb, SEGMENT)
    s = plan.schedule(N, dim, 2)
    assert s.nb == nb and s.num_split_runs >= nb
    got = csr_cbsr_plain(s.block_indptr, s.indices, rec, k, dim, post, od)
    want = csr_blocked_plain(s.block_indptr, s.indices, dense, None, post, od)
    assert got.dtype == (BF16 if od else torch.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    y = csr_cbsr_spmm(plan, rec, k, dim, post, od)
    np.testing.assert_array_equal(_bits(y), _bits(csr_spmm(plan, dense, None,
                                                           post, od)))
    assert (y[g.indptr.diff() == 0] == 0).all()


def test_wrapper_checks_its_input():
    g = hub_graph()
    plan = CSRPlan(g.indptr, g.indices)
    _, rec = records_of(np.random.default_rng(0), N, 64, 8)
    for k, dim, match in ((64, 64, "1 <= k < dim"), (8, 264, "<= 256"),
                          (8, 60, "dim % 8"), (0, 64, "1 <= k")):
        with pytest.raises(ValueError, match=match):
            csr_cbsr_spmm(plan, rec, k, dim)
    with pytest.raises(ValueError, match="shape"):
        csr_cbsr_spmm(plan, rec[:, :16].contiguous(), 8, 64)
    with pytest.raises(ValueError, match="out_dtype"):
        csr_cbsr_spmm(plan, rec, 8, 64, out_dtype=torch.float16)


# ---------------------------------------------------------------------------
# CPU: the kernel's walk, emulated (csrc/spmm.cu::csr_cbsr_kernel)
# ---------------------------------------------------------------------------

def walk(s, post, dim: int, edge_add) -> np.ndarray:
    """y of csr_spmm's segment walk in f32, step for step: per pass, a warp
    per segment; a batch of 32 edges summed from 0 (`edge_add(part, e)`
    adds edge e), then added to the segment's sum; a whole segment written
    to y (on FIRST, else added to it; times post on LAST), a piece to its
    scratch slot; then each fix-up adds its slots in order and writes the
    row the same way. Unwritten rows stay NaN."""
    f32 = np.float32
    seg, fix = s.seg.numpy(), s.fix.numpy()
    ps, pf = s.pass_seg.numpy(), s.pass_fix.numpy()
    y = np.full((post.size if post is not None else N, dim), np.nan, f32)

    def store(r, flags, acc):
        v = acc if flags & FIRST else y[r] + acc
        if flags & LAST:
            v = v * (f32(1) if post is None else post[r])
        y[r] = v

    for b in range(s.nb):
        scratch = np.full((s.n_slots, dim), np.nan, f32)
        for r, lo, hi, out in seg[ps[b]:ps[b + 1]]:
            acc = np.zeros(dim, f32)
            for base in range(lo, hi, 32):
                part = np.zeros(dim, f32)
                for e in range(base, min(base + 32, hi)):
                    edge_add(part, e)
                acc = acc + part
            if out >= 0:
                scratch[out] = acc
            else:
                store(r, -1 - out, acc)
        for r, a, c, flags in fix[pf[b]:pf[b + 1]]:
            acc = scratch[a].copy()
            for q in range(a + 1, c):
                acc = acc + scratch[q]
            store(r, flags, acc)
    return y


@pytest.mark.parametrize("with_post", [False, True])
@pytest.mark.parametrize("dim,k", DIM_K)
@pytest.mark.parametrize("nb", [1, 2, 3])
def test_record_walk_is_the_dense_walk_bit_for_bit(nb, dim, k, with_post):
    """The new kernel's walk (each edge's nonzero record slots added into
    the batch's partial row at their channels, in edge order) against
    csr_spmm_bf16's (every channel of every densified row added, zeros
    included): adding an exact zero leaves an f32 sum unchanged, so the two
    give the same bits; both within 1e-5 of max |y| of the plain version
    in float64."""
    g = hub_graph(hub_edges=700)
    rng = np.random.default_rng(nb * 10 + k)
    dense, rec = records_of(rng, N, dim, k)
    post = (rng.random(N).astype(np.float32) + 0.5) if with_post else None
    s = CSRPlan(g.indptr, g.indices, nb, SEGMENT).schedule(N, dim, 2)
    ix = s.indices.numpy()
    rows = dense.float().numpy()
    vals, ch = tmaxk.split_records(rec, k, dim, BF16)
    vals, ch = vals.float().numpy(), ch.numpy()

    def dense_add(part, e):
        part += rows[ix[e]]

    def record_add(part, e):
        u = ix[e]
        for v, c in zip(vals[u], ch[u]):
            if v != 0:
                part[c] += v

    got = walk(s, post, dim, record_add)
    want = walk(s, post, dim, dense_add)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ref = csr_spmm_plain(g.indptr, g.indices, dense.double(), None,
                         None if post is None else torch.tensor(post)
                         .double()).numpy()
    near(got, ref)


# ---------------------------------------------------------------------------
# CPU: the rule and the routes on a windowed plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", [None, True, False])
@pytest.mark.parametrize("acts", ["f32", "bf16x2", "bf16", "bf16-bf16x2"])
@pytest.mark.parametrize("dim,k", [(256, 32), (256, 256), (384, 32)])
def test_windowed_rule(dim, k, acts, flag, monkeypatch):
    """cbsr_forward on a windowed plan: bf16 records (bf16 activations
    under either stream, or f32 activations under bf16x2) and f32 records
    (f32 activations, f32 stream) alike, k < dim; None also dim <= 256,
    True regardless (the wrapper then raises above 256), False never."""
    g = tplanned.plan_graph(tsyn.random_graph(40, 200, seed=3),
                            kind="windowed")
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM",
                        "bf16x2" if acts.endswith("bf16x2") else "f32")
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", flag)
    dtype = BF16 if acts.startswith("bf16-") or acts == "bf16" else \
        torch.float32
    want = k < dim and (flag is True or flag is None and dim <= 256)
    assert tplanned.cbsr_forward(g.fwd_plan, k, dim, dtype) == want
    assert not tplanned.cbsr_forward(g.fwd_plan, None, dim, dtype)


def _spy(monkeypatch, name: str) -> list:
    calls = []
    fn = getattr(tplanned, name)

    def spy(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)
    monkeypatch.setattr(tplanned, name, spy)
    return calls


def _graphs():
    from spgemm_gnn_tpu.graphs import synthetic as jsyn
    return (jsyn.random_graph(200, 1500, seed=5, symmetric=False),
            tsyn.random_graph(200, 1500, seed=5, symmetric=False))


JPLAN = dict(kind="windowed", tile_slots=128, src_block=128, dst_block=128,
             window=8)


@pytest.mark.parametrize("norm", ["mean", "gcn"])
@pytest.mark.parametrize("acts", ["bf16x2", "bf16", "bf16-bf16x2"])
def test_planned_aggregate_on_the_new_route_matches_jax(acts, norm,
                                                        monkeypatch):
    """planned_aggregate(..., k) on a windowed plan at the default rule,
    whose forward takes csr_cbsr_spmm (its backward csr_spmm), against JAX
    `planned_aggregate` (the dense windowed kernel, interpret) with the
    same DEFAULT_STREAM: under bf16x2 on f32 activations y and dx within
    1e-5 of max (the f32 orders differ); on bf16 activations y and dx bf16
    within 1 bf16 ulp, off on at most 0.5 % of the values. The forward
    equals the flag-off forward bit for bit."""
    import importlib

    import jax
    import jax.numpy as jnp
    jplanned = importlib.import_module("spgemm_gnn_tpu.kernels.planned")

    jg, tg = _graphs()
    n, dim, k = tg.num_nodes, 32, 8
    stream = "f32" if acts == "bf16" else "bf16x2"
    bf16 = acts != "bf16x2"
    rng = np.random.default_rng(len(acts) + len(norm))
    x = tmaxk.maxk(torch.tensor(rng.standard_normal((n, dim)).astype(
        np.float32)), k)
    ct = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32))
    if bf16:
        x, ct = x.to(BF16), ct.to(BF16)
    for mod in (tplanned, jplanned):
        monkeypatch.setattr(mod, "DEFAULT_STREAM", stream)
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jpg = jplanned.plan_graph(jg, **JPLAN)
    y_j, vjp = jax.vjp(lambda v: jplanned.planned_aggregate(jpg, v, norm,
                                                            k=k),
                       jnp.asarray(x.float().numpy()).astype(jdt))
    dx_j = vjp(jnp.asarray(ct.float().numpy()).astype(jdt))[0]
    y_j, dx_j = np.asarray(y_j, np.float32), np.asarray(dx_j, np.float32)

    tpg = tplanned.plan_graph(tg, kind="windowed", dim=dim, dtype=x.dtype)
    cbsr, dense = _spy(monkeypatch, "csr_cbsr_spmm"), _spy(monkeypatch,
                                                            "csr_spmm")
    xt = x.clone().requires_grad_(True)
    y = tapi.aggregate(tpg, xt, norm=norm, k=k)
    assert cbsr == ["csr_cbsr_spmm"] and dense == []
    y.backward(ct)
    assert dense == ["csr_spmm"]           # the backward: dense, on Aᵀ
    assert y.dtype == xt.grad.dtype == x.dtype
    check = near16 if bf16 else near
    check(y.detach().float().numpy(), y_j)
    check(xt.grad.float().numpy(), dx_j)
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", False)
    np.testing.assert_array_equal(
        _bits(y), _bits(tapi.aggregate(tpg, x, norm=norm, k=k)))


@pytest.mark.parametrize("norm", ["sum", "gcn"])
@pytest.mark.parametrize("values", ["bf16", "f32-bf16x2"])
def test_aggregate_cbsr_on_the_new_route_matches_jax(values, norm,
                                                     monkeypatch):
    """aggregate_cbsr on a windowed plan at the default rule (its forward
    `spgemm_forward` takes csr_cbsr_spmm and densifies nothing) against JAX
    aggregate_cbsr (impl "pallas": densify, then the windowed kernel,
    interpret): bf16 values under the f32 stream, and f32 values under
    bf16x2 (rounded to bf16 after the src factor on both sides). y f32
    within 1e-5 of max; dvalues (the dense sampled backward) within 1e-5
    of max for f32 values, one bf16 ulp for bf16 ones (1e-5 of max where
    a sum cancels, on at most 0.5 % of the values)."""
    import importlib

    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.api import aggregate_cbsr as jaggregate_cbsr
    jplanned = importlib.import_module("spgemm_gnn_tpu.kernels.planned")

    jg, tg = _graphs()
    n, dim, k = tg.num_nodes, 128, 16
    stream = "bf16x2" if values == "f32-bf16x2" else "f32"
    for mod in (tplanned, jplanned):
        monkeypatch.setattr(mod, "DEFAULT_STREAM", stream)
    rng = np.random.default_rng(len(values) + len(norm))
    vals = torch.tensor(rng.standard_normal((n, k)).astype(np.float32))
    if values == "bf16":
        vals = vals.to(BF16)
    ch = torch.tensor(np.argsort(rng.random((n, dim)), axis=1)[:, :k]
                      .astype(np.int32))
    ct = rng.standard_normal((n, dim)).astype(np.float32)
    jv = jnp.asarray(vals.float().numpy()).astype(
        jnp.bfloat16 if values == "bf16" else jnp.float32)
    jpg = jplanned.plan_graph(jg, **JPLAN)
    y_j, vjp = jax.vjp(lambda v: jaggregate_cbsr(
        jpg, v, jnp.asarray(ch.numpy()), dim, norm, "pallas"), jv)
    dv_j = np.asarray(vjp(jnp.asarray(ct))[0], np.float32)
    y_j = np.asarray(y_j, np.float32)

    tpg = tplanned.plan_graph(tg, kind="windowed", chunk=9)
    densify = _spy(monkeypatch, "cbsr_densify")
    cbsr = _spy(monkeypatch, "csr_cbsr_spmm")
    v = vals.clone().requires_grad_(True)
    y = tapi.aggregate_cbsr(tpg, v, ch, dim, norm)
    assert densify == [] and cbsr == ["csr_cbsr_spmm"]
    (y * torch.tensor(ct)).sum().backward()
    assert y.dtype == torch.float32 and v.grad.dtype == vals.dtype
    near(y.detach().numpy(), y_j)
    if values == "bf16":
        got = v.grad.float().numpy()
        mag = np.maximum(np.abs(dv_j), 2.0 ** -120)
        off = np.abs(got - dv_j)
        by_ulp = off <= 2.0 ** (np.floor(np.log2(mag)) - 7)
        assert (by_ulp | (off <= 1e-5 * np.abs(dv_j).max())).all()
        assert (~by_ulp).mean() <= 0.005
    else:
        near(v.grad.numpy(), dv_j)


@pytest.mark.parametrize("dtype,stream", [("float32", "bf16x2"),
                                          ("bfloat16", "f32")])
def test_trainer_with_the_rule_gives_the_flag_off_losses(dtype, stream,
                                                         monkeypatch,
                                                         one_torch_thread):
    """The Trainer on the flickr stand-in at scale 0.004 (a windowed plan),
    MaxK k 8, dropout 0.5: at the default rule its MaxK forwards take
    csr_cbsr_spmm (the bf16 records of the compacted input), with the flag
    off csr_spmm on the dense rows; the same schedule, so the losses are
    bit-equal."""
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    cfg = TrainConfig(dataset="flickr", model="sage", epochs=2,
                      hidden_dim=32, hidden_layers=2, maxk=8, dropout=0.5,
                      w_lr=0.01, nonlinear="maxk", norm=True, synthetic=True,
                      synthetic_scale=0.004, eval_every=1, log_every=0,
                      seed=3, stream=stream, dtype=dtype, device="cpu")
    losses = {}
    calls = _spy(monkeypatch, "csr_cbsr_spmm")
    for flag in (None, False):
        monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", flag)
        calls.clear()
        tr = Trainer(cfg)
        assert tr.g.kind == "windowed"
        res = tr.run()
        losses[flag] = [r.loss for r in res["history"]]
        # per epoch a train and an eval forward of each of 2 layers
        assert len(calls) == (2 * 2 * 2 if flag is None else 0)
    assert all(np.isfinite(losses[None]))
    assert losses[None] == losses[False]


# ---------------------------------------------------------------------------
# GPU: the kernels (skip without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [None, 1, 3])
@pytest.mark.parametrize("k", [8, 32, 64, 200])
def test_csr_cbsr_spmm_is_the_dense_form_on_gpu(cuda, k, nb):
    """dim 256 on A and Aᵀ of a directed graph with rows without in-edges
    and a hub row of 3000 edges (6 pieces of 512 in a block): both forms
    bit for bit csr_spmm_bf16 / csr_spmm_bf16_out on the densified rows at
    the same schedule, repeatable, the bf16 output the rounding of the f32
    one; the f32 output within 1e-5 of max |y| of the plain version in
    float64; on integer values, whose f32 sums are exact in any order, bit
    for bit the plain version (f32 and bf16 out)."""
    dim = 256
    g = hub_graph(700, seed=k).to(cuda)
    rng = np.random.default_rng(k)
    post = torch.tensor(rng.random(700).astype(np.float32) + 0.5,
                        device=cuda)
    for indptr, indices in ((g.indptr, g.indices), (g.t_indptr, g.t_indices)):
        plan = CSRPlan(indptr, indices, nb)
        s = plan.schedule(700, dim, 2)
        for ints in (False, True):
            dense, rec = records_of(rng, 700, dim, k, cuda, ints)
            for od in (None, BF16):
                y = csr_cbsr_spmm(plan, rec, k, dim, post, od)
                again = csr_cbsr_spmm(plan, rec, k, dim, post, od)
                np.testing.assert_array_equal(_bits(y), _bits(again))
                np.testing.assert_array_equal(
                    _bits(y), _bits(csr_spmm(plan, dense, None, post, od)))
                plain = csr_cbsr_plain(s.block_indptr, s.indices, rec, k,
                                       dim, post, od)
                if ints:
                    np.testing.assert_array_equal(_bits(y), _bits(plain))
                elif od is None:
                    ref = csr_spmm_plain(indptr, indices, dense.double(),
                                         None, post.double())
                    near(y.cpu(), ref.cpu())
                else:
                    # bf16(bf16(Σ) · bf16(post)) of the f32 sums with no post
                    sums = csr_cbsr_spmm(plan, rec, k, dim)
                    want = sums.to(BF16) * post.to(BF16)[:, None]
                    np.testing.assert_array_equal(_bits(y), _bits(want))
                    near16(y.float().cpu(), plain.float().cpu())
                assert (y[indptr.diff() == 0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("acts", ["bf16x2", "bf16", "bf16-bf16x2"])
def test_windowed_cbsr_forward_launches_on_gpu(cuda, acts, monkeypatch):
    """A k-sparse aggregation on a windowed plan, forward and backward, at
    the default rule launches the compaction and csr_cbsr_spmm's form
    forward and csr_spmm's bf16 form backward, and gives the flag-off y and
    dx bit for bit."""
    g = tsyn.powerlaw_graph(600, 6000, seed=9).to(cuda)
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM",
                        "f32" if acts == "bf16" else "bf16x2")
    bf16 = acts != "bf16x2"
    dt = BF16 if bf16 else torch.float32
    pg = tplanned.plan_graph(g, kind="windowed", dim=256, dtype=dt)
    x = tmaxk.maxk(torch.randn((600, 256), device=cuda), 32).to(dt)
    ct = torch.randn((600, 256), device=cuda).to(dt)
    out = {}
    for flag in (None, False):
        monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", flag)
        xt = x.clone().requires_grad_(True)
        _build.launches.clear()
        y = tapi.aggregate(pg, xt, "gcn", k=32, impl="cuda")
        y.backward(ct)
        out[flag] = (y.detach(), xt.grad, dict(_build.launches))
    if bf16:
        want = {"cbsr_compact_bf16": 1, "csr_cbsr_spmm_bf16_out": 1,
                "csr_spmm_bf16_out": 1}
        off = {"csr_spmm_bf16_out": 2}
    else:
        want = {"cbsr_compact": 1, "round_rows": 2, "csr_cbsr_spmm_bf16": 1,
                "csr_spmm_bf16": 1}
        off = {"round_rows": 2, "csr_spmm_bf16": 2}
    assert out[None][2] == want and out[False][2] == off
    for a, b in zip(out[None][:2], out[False][:2]):
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.gpu
def test_csr_cbsr_wrapper_raises_on_gpu(cuda, monkeypatch):
    """Bad inputs raise, and a kernel that refuses its launch raises: the
    plain version never runs for a CUDA tensor."""
    g = hub_graph(200).to(cuda)
    plan = CSRPlan(g.indptr, g.indices)
    _, rec = records_of(np.random.default_rng(1), 200, 64, 8, cuda)
    with pytest.raises(ValueError, match="dtype"):
        csr_cbsr_spmm(plan, rec.float(), 8, 64)
    with pytest.raises(ValueError, match="contiguous"):
        csr_cbsr_spmm(plan, torch.zeros((32, 200), dtype=torch.int32,
                                        device=cuda).t(), 8, 64)
    with pytest.raises(ValueError, match="is on cpu"):
        csr_cbsr_spmm(CSRPlan(g.indptr.cpu(), g.indices.cpu()), rec, 8, 64)
    real = _build.library

    class Refusing:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, fn):
            if fn == "csr_cbsr_spmm_bf16":
                return lambda *args: 1      # cudaErrorInvalidValue
            return getattr(self.inner, fn)

    monkeypatch.setattr(_build, "library", lambda w: Refusing(real(w)))
    _build.launches.clear()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        csr_cbsr_spmm(plan, rec, 8, 64)
    assert not _build.launches
