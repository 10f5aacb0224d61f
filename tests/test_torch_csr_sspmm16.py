"""The sampled backward on a windowed plan (`kernels/spmm.py::csr_sspmm`,
kernels `csr_sspmm_bf16` and `csr_sspmm_bf16_out`: MaxK's backward on Aᵀ
at each row's k kept channels, over `csr_spmm`'s schedule), and the
windowed side of `kernels.planned.SAMPLED_BACKWARD`'s rule.

CPU: the plain version (`ops/spmm.py::csr_sspmm_plain`) bit for bit the
dense bf16 form's plain version at the kept channels, zeros elsewhere;
the kernel's walk (compact sums kept across the block passes, the dense
row written at the row's last block, split runs through compact slots)
emulated in numpy f32 and bit-equal to the dense walk; the plain version
against JAX `sspmm_backward(stream_dtype=bfloat16)` and against
`_planned_aggregate_bwd` then `sample_channels` on windowed plans (the
Pallas kernels in interpret mode) within 1 bf16 ulp; the rule; SAGE and
GCN models and Trainers on a small Reddit stand-in (windowed by rule),
the rule on against off, bit for bit. GPU (marker `gpu`, skipped without a card, no
JAX): the kernels bit for bit the dense forms at the kept channels and 0
elsewhere, equal to their plain versions, on hub rows, split runs and
empty rows at k 8, 32 and 255; the wrapper's checks; a SAGE model with
the rule on against off. The f32 form (`csr_sspmm` on f32 messages) is
tests/test_torch_csr_f32_maxk.py.

    python -m pytest tests/test_torch_csr_sspmm16.py
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_csr_sspmm16.py
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.tiles import FIRST, LAST, CSRPlan
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.kernels.maxk import maxk_fwd
from spgemm_gnn_tpu_torch.kernels.round import round_rows
from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm, csr_sspmm
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.ops.spmm import (_scale, csr_blocked_plain,
                                           csr_sspmm_plain)

BF16 = torch.bfloat16
N, SEGMENT = 300, 64


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
    """The planner's flags as they were after the test, starting from the
    defaults (the JAX package's stream "f32", its CBSR forward off)."""
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", "f32")
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", None)
    monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", None)
    try:
        import importlib
        jplanned = importlib.import_module("spgemm_gnn_tpu.kernels.planned")
    except ImportError:     # the card's machine has no JAX
        return
    monkeypatch.setattr(jplanned, "DEFAULT_STREAM", "f32")
    monkeypatch.setattr(jplanned, "STREAM_CBSR_FORWARD", False)


def hub_graph(n: int = N, seed: int = 11, hub_edges: int = 700):
    """Aᵀ's rows are A's sources: random out-degrees 0-11, rows without
    edges in Aᵀ (every 50th node and the last 20 send none), and node 3
    sending `hub_edges`, a row of Aᵀ cut into pieces in every source
    block."""
    rng = np.random.default_rng(seed)
    degrees = rng.integers(0, 12, n)
    degrees[::50] = 0
    degrees[-20:] = 0
    degrees[3] = hub_edges
    src = np.repeat(np.arange(n), degrees)
    return from_edges(src, rng.integers(0, n, src.size), n, symmetric=False)


def bits(t: torch.Tensor) -> np.ndarray:
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
    two), off on at most `share` of the values."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    mag = np.maximum(np.abs(want), 2.0 ** -120)
    u = np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert u.max(initial=0.0) <= ulps, u.max()
    assert (u > 0).mean() <= share, (u > 0).mean()


def kept(y: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
    """y at each row's channels ch, 0 elsewhere."""
    keep = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    keep.scatter_(1, ch.long(), True)
    return torch.where(keep, y, torch.zeros((), dtype=y.dtype,
                                            device=y.device))


def messages(rng, n: int, dim: int, k: int, device="cpu", ints=False):
    """bf16 messages [n, dim] (normals, or with `ints` integers in [-4, 4],
    whose f32 sums are exact in any order) and the kept channels of MaxK
    on other random rows, uint8 [n, k]."""
    if ints:
        m = rng.integers(-4, 5, (n, dim)).astype(np.float32)
    else:
        m = rng.standard_normal((n, dim)).astype(np.float32)
    h = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32),
                     device=device)
    _, _, ch = maxk_fwd(h, k, with_ids=True)
    return torch.tensor(m, device=device).to(BF16), ch


# ---------------------------------------------------------------------------
# CPU: the plain version, the wrapper, the kernel's walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_post", [False, True])
@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("dim,k", [(32, 4), (64, 8), (256, 32), (256, 255)])
@pytest.mark.parametrize("nb", [1, 2, 3])
def test_plain_is_the_dense_plain_at_the_kept_channels(nb, dim, k, out,
                                                       with_post):
    """csr_sspmm on CPU tensors: the blocked plain sum of the dense bf16
    form (`csr_spmm`'s CPU path at the same schedule) bit for bit at each
    row's kept channels, +0 at the others."""
    g = hub_graph()
    rng = np.random.default_rng(nb * 100 + k)
    m, ch = messages(rng, N, dim, k)
    post = (torch.tensor(rng.random(N).astype(np.float32) + 0.5)
            if with_post else None)
    od = BF16 if out == "bf16" else None
    plan = CSRPlan(g.t_indptr, g.t_indices, nb, SEGMENT)
    y = csr_sspmm(plan, m, ch, post, od)
    assert y.shape == (N, dim) and y.dtype == (BF16 if od else torch.float32)
    np.testing.assert_array_equal(
        bits(y), bits(kept(csr_spmm(plan, m, None, post, od), ch)))
    s = plan.schedule(N, dim, 2)
    np.testing.assert_array_equal(bits(y), bits(csr_sspmm_plain(
        s.block_indptr, s.indices, m, ch, post, od)))
    assert not bits(y)[np.asarray(g.t_indptr.diff() == 0)].any()


def test_wrapper_checks_its_inputs():
    g = hub_graph()
    plan = CSRPlan(g.t_indptr, g.t_indices)
    m = torch.zeros((N, 32), dtype=BF16)
    ch = torch.zeros((N, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="f32 or bf16 messages"):
        csr_sspmm(plan, m.half(), ch)
    with pytest.raises(ValueError, match="pre factor"):
        csr_sspmm(plan, m, ch, pre=torch.ones(N))
    with pytest.raises(ValueError, match="bf16 output needs bf16"):
        csr_sspmm(plan, m.float(), ch, out_dtype=BF16)
    with pytest.raises(ValueError, match="dim % 4"):
        csr_sspmm(plan, torch.zeros((N, 34)), ch)
    with pytest.raises(ValueError, match="uint8"):
        csr_sspmm(plan, m, ch.int())
    with pytest.raises(ValueError, match="k < 32"):
        csr_sspmm(plan, m, torch.zeros((N, 32), dtype=torch.uint8))
    with pytest.raises(ValueError, match="dim <= 256"):
        csr_sspmm(plan, torch.zeros((N, 264), dtype=BF16), ch)
    with pytest.raises(ValueError, match="dim % 8"):
        csr_sspmm(plan, torch.zeros((N, 36), dtype=BF16), ch)
    with pytest.raises(ValueError, match="out_dtype"):
        csr_sspmm(plan, m, ch, out_dtype=torch.float16)


def walk(s, post, dim: int, n: int, cols, src, out16: bool) -> np.ndarray:
    """The output of csr_sspmm_kernel's walk (csrc/spmm.cu) in numpy
    f32, step for step, at the columns cols[r] of each row r (every column
    for the dense kernel's walk): per pass a warp per segment, a batch of
    32 edges summed from +0 and added to the segment's sum; a whole
    segment's sums written to the row's compact sums (on FIRST, else added
    to them), a piece's to its compact scratch slot; each fix-up adds its
    slots in order and finishes its row the same way; on LAST the output
    row is written once: 0, and at the columns the sums times post (f32)
    or bf16(bf16(Σ) · bf16(post)) (bf16, as bits). Unwritten rows stay
    NaN."""
    f32 = np.float32
    seg, fix = s.seg.numpy(), s.fix.numpy()
    ps, pf = s.pass_seg.numpy(), s.pass_fix.numpy()
    ix = s.indices.numpy()
    acc = {}
    y = np.full((n, dim), np.nan, f32)

    def finish(r, flags, v):
        v = v if flags & FIRST else acc[r] + v
        if not flags & LAST:
            acc[r] = v
            return
        y[r] = 0
        p = f32(1) if post is None else post[r]
        if out16:
            p = torch.tensor(p).to(BF16).float().numpy()
            v = torch.tensor(torch.tensor(v).to(BF16).float().numpy() * p)
            y[r, cols[r]] = v.to(BF16).float().numpy()
        else:
            y[r, cols[r]] = v * p

    for b in range(s.nb):
        scratch = {}
        for r, lo, hi, out in seg[ps[b]:ps[b + 1]]:
            v = np.zeros(len(cols[r]), f32)
            for base in range(lo, hi, 32):
                part = np.zeros(len(cols[r]), f32)
                for e in range(base, min(base + 32, hi)):
                    part = part + src[ix[e], cols[r]]
                v = v + part
            if out >= 0:
                scratch[out] = v
            else:
                finish(r, -1 - out, v)
        for r, a, c, flags in fix[pf[b]:pf[b + 1]]:
            v = scratch[a].copy()
            for q in range(a + 1, c):
                v = v + scratch[q]
            finish(r, flags, v)
    return y


@pytest.mark.parametrize("out16", [False, True])
@pytest.mark.parametrize("nb", [1, 3])
def test_sampled_walk_is_the_dense_walk_bit_for_bit(nb, out16):
    """The sampled kernel's walk (compact sums at the kept channels across
    the passes) against the dense kernel's (every channel, y written each
    pass) at the same schedule with hub rows cut into pieces: the same bits
    at the kept channels, 0 elsewhere; within 1e-5 of max |y| of the plain
    version in float64 (f32 out)."""
    g = hub_graph()
    dim, k = 32, 8
    rng = np.random.default_rng(nb)
    m, ch = messages(rng, N, dim, k)
    post = rng.random(N).astype(np.float32) + 0.5
    s = CSRPlan(g.t_indptr, g.t_indices, nb, SEGMENT).schedule(N, dim, 2)
    assert s.num_split_runs > 0
    src = m.float().numpy()
    chn = ch.long().numpy()
    got = walk(s, post, dim, N, chn, src, out16)
    dense = walk(s, post, dim, N, [np.arange(dim)] * N, src, out16)
    assert not np.isnan(got).any()
    want = kept(torch.tensor(dense), ch).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if not out16:
        ref = csr_blocked_plain(s.block_indptr, s.indices, m.double(), None,
                                torch.tensor(post).double())
        near(got, kept(ref, ch).numpy())


# ---------------------------------------------------------------------------
# CPU: the plain sampled backward against the JAX package
# ---------------------------------------------------------------------------

def _graphs(kind: str):
    from spgemm_gnn_tpu.graphs import synthetic as jsyn
    if kind == "symmetric":
        return (jsyn.powerlaw_graph(250, 2500, seed=21),
                tsyn.powerlaw_graph(250, 2500, seed=21))
    return (jsyn.random_graph(200, 1500, seed=5, symmetric=False),
            tsyn.random_graph(200, 1500, seed=5, symmetric=False))


JPLAN = dict(kind="windowed", tile_slots=128, src_block=128, dst_block=128,
             window=8)


def _j(t: torch.Tensor | None):
    import jax.numpy as jnp
    return None if t is None else jnp.asarray(t.numpy())


@pytest.mark.parametrize("norm", ["mean", "gcn"])
@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_sampled_plain_matches_jax_sspmm_backward(kind, norm):
    """csr_sspmm (_out) on the messages bf16(dst_f ⊙ g) with post src_f at
    MaxK's kept channels, on a windowed plan of 3 source blocks, against
    JAX `sspmm_backward(stream_dtype=bfloat16)` on its windowed plans
    (interpret), which rounds its bf16 dvalues as the bf16 output does:
    within 1 ulp, at most 0.5 % off; zeros at the other channels."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels import planned as jplanned

    jg, tg = _graphs(kind)
    n, dim, k = tg.num_nodes, 32, 8
    rng = np.random.default_rng(len(kind) + len(norm))
    _, _, ch = maxk_fwd(torch.tensor(rng.standard_normal((n, dim)).astype(
        np.float32)), k, with_ids=True)
    g_ct = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32))
    src_f, dst_f = node_factors(tg, norm)
    jpg = jplanned.plan_graph(jg, **JPLAN)
    dv_j = jplanned.sspmm_backward(
        jnp.asarray(g_ct.numpy()), jnp.asarray(ch.int().numpy()),
        _j(src_f), _j(dst_f), (jpg.fwd_plan, jpg.bwd_plan),
        stream_dtype=jnp.bfloat16)

    plan = CSRPlan(tg.t_indptr, tg.t_indices, 3, 16)
    assert dv_j.dtype == jnp.bfloat16
    dx = csr_sspmm(plan, round_rows(g_ct, dst_f), ch, src_f, BF16)
    assert dx.dtype == BF16 and dx.shape == (n, dim)
    near16(torch.gather(dx, 1, ch.long()).float().numpy(),
           np.asarray(dv_j, np.float32))
    np.testing.assert_array_equal(bits(dx), bits(kept(dx, ch)))


@pytest.mark.parametrize("norm", ["mean", "gcn"])
def test_sampled_plain_matches_jax_aggregate_bwd_bf16(norm):
    """bf16 activations: csr_sspmm_out on the messages dst_f ⊙ g in bf16
    against JAX `_planned_aggregate_bwd` (the dense bf16 backward on its
    windowed plans) then `sample_channels` (interpret) at MaxK's channels:
    within 1 ulp, at most 0.5 % off."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels import planned as jplanned
    from spgemm_gnn_tpu.kernels.spgemm_pallas import sample_channels

    jg, tg = _graphs("directed")
    n, dim, k = tg.num_nodes, 32, 8
    rng = np.random.default_rng(len(norm))
    _, _, ch = maxk_fwd(torch.tensor(rng.standard_normal((n, dim)).astype(
        np.float32)).to(BF16), k, with_ids=True)
    g_ct = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32)).to(
        BF16)
    src_f, dst_f = node_factors(tg, norm)
    jpg = jplanned.plan_graph(jg, **JPLAN)
    res = (jnp.zeros((0,), jnp.bfloat16), _j(src_f), _j(dst_f),
           (jpg.fwd_plan, jpg.bwd_plan))
    dx_j = jplanned._planned_aggregate_bwd(
        (None, k), res, jnp.asarray(g_ct.float().numpy()).astype(
            jnp.bfloat16))[0]
    dv_j = sample_channels(dx_j, jnp.asarray(ch.int().numpy()),
                           interpret=True)

    tpg = tplanned.plan_graph(tg, kind="windowed", dtype=BF16, dim=dim)
    dx = csr_sspmm(tpg.bwd_plan, _scale(g_ct, dst_f).contiguous(), ch, src_f,
                   BF16)
    assert dx.dtype == BF16
    near16(torch.gather(dx, 1, ch.long()).float().numpy(),
           np.asarray(dv_j, np.float32))


# ---------------------------------------------------------------------------
# CPU: the rule, a model and the Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", [None, True, False])
@pytest.mark.parametrize("acts", ["f32", "bf16x2", "bf16", "bf16-bf16x2"])
@pytest.mark.parametrize("dim,k", [(256, 32), (256, 256), (384, 32),
                                   (256, None)])
def test_windowed_rule(dim, k, acts, flag, monkeypatch):
    """sampled_backward on a windowed plan: bf16 messages (bf16
    activations under either stream, or f32 activations under bf16x2) and
    f32 messages (f32 activations, f32 stream) alike, MaxK's ids given and
    k < dim; None also dim <= 256, True regardless (the wrapper then
    raises above 256), False never."""
    g = tplanned.plan_graph(tsyn.random_graph(40, 200, seed=3),
                            kind="windowed")
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM",
                        "bf16x2" if acts.endswith("bf16x2") else "f32")
    monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", flag)
    dtype = BF16 if acts.startswith("bf16-") or acts == "bf16" else \
        torch.float32
    want = k is not None and k < dim and (
        flag is True or flag is None and dim <= 256)
    assert tplanned.sampled_backward(g.bwd_plan, k, dim, dtype) == want
    x = torch.zeros((40, dim), dtype=dtype, requires_grad=True)
    assert tplanned.wants_channel_ids(g, k, x) == want
    with torch.no_grad():
        assert not tplanned.wants_channel_ids(g, k, x)


def _count(monkeypatch) -> list:
    calls = []
    plain = csr_sspmm_plain

    def counting(*a, **kw):
        calls.append(1)
        return plain(*a, **kw)
    monkeypatch.setattr("spgemm_gnn_tpu_torch.kernels.spmm.csr_sspmm_plain",
                        counting)
    return calls


def _zero_topk(model) -> None:
    """lin_in: channels 20..25 exactly 0 and 0..19 below -10, so that most
    rows' top-8 after it holds kept zeros."""
    with torch.no_grad():
        model.lin_in.weight[20:26] = 0.0
        model.lin_in.weight[:20] *= 0.01
        model.lin_in.bias[:20] = -10.0


@pytest.mark.parametrize("model", ["sage", "gcn"])
@pytest.mark.parametrize("stream,dtype", [("bf16x2", None),
                                          ("f32", "bfloat16")])
def test_model_sampled_backward_bit_equal(model, stream, dtype,
                                          monkeypatch):
    """A SAGE (first layer's top-k holding exact zeros) or GCN MaxK model
    (feat_drop 0.5, LayerNorm) on a windowed plan of 3 source blocks with
    split runs: with the rule on, the logits and the input gradient bit
    for bit the rule off's, and the sampled form taken by every layer's
    backward."""
    from spgemm_gnn_tpu_torch.models.models import build_model
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", stream)
    g = hub_graph()
    dt = BF16 if dtype else torch.float32
    fwd = CSRPlan(g.indptr, g.indices, 3, 16)
    bwd = CSRPlan(g.t_indptr, g.t_indices, 3, 16)
    pg = tplanned.PlannedGraph(graph=g, fwd_plan=fwd, bwd_plan=bwd)
    calls = _count(monkeypatch)
    out = {}
    for flag in (None, False):
        monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", flag)
        net = build_model(model, in_dim=16, hidden_dim=32, num_layers=2,
                          out_dim=5, maxk=8, feat_drop=0.5, use_norm=True,
                          dtype=dtype)
        net.reset_parameters(torch.Generator().manual_seed(1))
        if model == "sage":
            _zero_topk(net)
        x = torch.tensor(np.random.default_rng(2).standard_normal(
            (N, 16)).astype(np.float32), requires_grad=True)
        logits = net(pg, x, torch.Generator().manual_seed(3))
        (logits * logits).sum().backward()
        out[flag] = (bits(logits), bits(x.grad))
        assert len(calls) == 2
        if model == "sage" and flag is None:
            h = net.lin_in(x)
            _, _, ids = maxk_fwd(h.detach().to(dt), 8, with_ids=True)
            assert (torch.gather(h.detach().to(dt), 1, ids.long())
                    == 0).any()
    np.testing.assert_array_equal(out[None][0], out[False][0])
    np.testing.assert_array_equal(out[None][1], out[False][1])


@pytest.mark.parametrize("model", ["sage", "gcn"])
@pytest.mark.parametrize("stream,dtype", [("bf16x2", "float32"),
                                          ("f32", "bfloat16")])
def test_trainer_sampled_backward_losses_bit_equal(model, stream, dtype,
                                                   monkeypatch,
                                                   one_torch_thread):
    """Two epochs of the Trainer on the Reddit stand-in at scale 0.004
    (windowed by the plan-kind rule), MaxK k 8, dropout 0.5: the losses
    with the rule on (the MaxK backwards on csr_sspmm, once a layer a
    step) bit for bit the rule off's."""
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    cfg = TrainConfig(dataset="reddit", model=model, epochs=2, hidden_dim=32,
                      hidden_layers=2, maxk=8, dropout=0.5, w_lr=0.01,
                      nonlinear="maxk", norm=True, synthetic=True,
                      synthetic_scale=0.004, eval_every=1, log_every=0,
                      seed=3, device="cpu", stream=stream, dtype=dtype,
                      selfloop=model == "gcn")
    calls = _count(monkeypatch)
    losses = {}
    for flag in (None, False):
        monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", flag)
        calls.clear()
        tr = Trainer(cfg)
        assert tr.g.kind == "windowed"
        res = tr.run()
        losses[flag] = [r.loss for r in res["history"]]
        assert len(calls) == (2 * 2 if flag is None else 0)
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
@pytest.mark.parametrize("k", [8, 32, 255])
def test_csr_sspmm_is_the_dense_form_on_gpu(cuda, k, nb):
    """dim 256 on Aᵀ with rows without edges and a hub row of 3000 edges
    (pieces of 512 in each block, through the fix-up): both forms bit for
    bit csr_spmm_bf16 / csr_spmm_bf16_out at the kept channels and +0
    elsewhere, repeatable, one launch a call under their names; the f32
    output within 1e-5 of max |y| of the plain version, the bf16 output
    within 1 ulp; on integer messages, whose f32 sums are exact in any
    order, bit for bit the plain version."""
    dim = 256
    g = hub_graph(700, seed=k, hub_edges=3000).to(cuda)
    rng = np.random.default_rng(k)
    post = torch.tensor(rng.random(700).astype(np.float32) + 0.5,
                        device=cuda)
    plan = CSRPlan(g.t_indptr, g.t_indices, nb)
    s = plan.schedule(700, dim, 2)
    assert s.num_split_runs > 0
    for ints in (False, True):
        m, ch = messages(rng, 700, dim, k, cuda, ints)
        for od in (None, BF16):
            _build.launches.clear()
            y = csr_sspmm(plan, m, ch, post, od)
            assert dict(_build.launches) == {
                "csr_sspmm_bf16_out" if od else "csr_sspmm_bf16": 1}
            again = csr_sspmm(plan, m, ch, post, od)
            np.testing.assert_array_equal(bits(y), bits(again))
            np.testing.assert_array_equal(bits(y), bits(kept(
                csr_spmm(plan, m, None, post, out_dtype=od), ch)))
            plain = csr_sspmm_plain(s.block_indptr, s.indices, m, ch, post,
                                    od)
            if ints:
                np.testing.assert_array_equal(bits(y), bits(plain))
            elif od is None:
                near(y.cpu(), plain.cpu())
            else:
                near16(y.float().cpu(), plain.float().cpu())
            assert (y[g.t_indptr.diff() == 0] == 0).all()


@pytest.mark.gpu
def test_csr_sspmm_wrapper_raises_on_gpu(cuda, monkeypatch):
    """Bad inputs raise, and a kernel that refuses its launch raises: the
    plain version never runs for a CUDA tensor."""
    g = hub_graph(200).to(cuda)
    plan = CSRPlan(g.t_indptr, g.t_indices)
    m, ch = messages(np.random.default_rng(1), 200, 64, 8, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        csr_sspmm(plan, m, ch.t().contiguous().t())
    with pytest.raises(ValueError, match="is on cpu"):
        csr_sspmm(CSRPlan(g.t_indptr.cpu(), g.t_indices.cpu()), m, ch)
    real = _build.library

    class Refusing:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, fn):
            if fn == "csr_sspmm_bf16":
                return lambda *args: 1      # cudaErrorInvalidValue
            return getattr(self.inner, fn)

    monkeypatch.setattr(_build, "library", lambda w: Refusing(real(w)))
    _build.launches.clear()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        csr_sspmm(plan, m, ch)
    assert not _build.launches


@pytest.mark.gpu
@pytest.mark.parametrize("stream,dtype", [("bf16x2", None),
                                          ("f32", "bfloat16")])
def test_sage_sampled_backward_bit_equal_on_gpu(cuda, stream, dtype,
                                                monkeypatch):
    """On the card: a SAGE MaxK model on a windowed plan, its logits and
    input gradient with the rule on (csr_sspmm, once a layer) bit for bit
    the rule off's (csr_spmm on Aᵀ)."""
    from spgemm_gnn_tpu_torch.models.models import build_model
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", stream)
    g = hub_graph(700, seed=5, hub_edges=3000).to(cuda)
    pg = tplanned.plan_graph(g, kind="windowed", dim=64,
                             dtype=BF16 if dtype else torch.float32)
    out = {}
    for flag in (None, False):
        monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", flag)
        model = build_model("sage", in_dim=16, hidden_dim=64, num_layers=2,
                            out_dim=5, maxk=8, feat_drop=0.5, use_norm=True,
                            dtype=dtype)
        model.reset_parameters(torch.Generator().manual_seed(1))
        _zero_topk(model)
        model.to(cuda)
        x = torch.tensor(np.random.default_rng(2).standard_normal(
            (700, 16)).astype(np.float32), device=cuda, requires_grad=True)
        _build.launches.clear()
        logits = model(pg, x, torch.Generator(device=cuda).manual_seed(3))
        (logits * logits).sum().backward()
        sampled = sum(v for key, v in _build.launches.items()
                      if key.startswith("csr_sspmm"))
        assert sampled == (2 if flag is None else 0)
        out[flag] = (bits(logits), bits(x.grad))
    np.testing.assert_array_equal(out[None][0], out[False][0])
    np.testing.assert_array_equal(out[None][1], out[False][1])
