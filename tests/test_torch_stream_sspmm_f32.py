"""The f32 sampled backward on a stream plan (`kernels/stream.py::
stream_sspmm` on f32 messages, kernels `sspmm_slots_f32` and
`stream_sspmm_f32`: MaxK's backward on Aᵀ at each row's k kept channels,
the raw cotangent with the pre factor applied per edge), and the f32 side
of `kernels.planned.SAMPLED_BACKWARD` on stream plans.

CPU: the plain version bit for bit `stream_spmm_plain` on Aᵀ at the kept
channels (zeros elsewhere) under no, mean and gcn factors; the two passes
modelled in numpy (pass 1 puts g[u, ch[v, .]] of each edge u -> v at its
transpose position, pass 2 walks Aᵀ's spans, each term an FMA by the
edge's pre factor, read from Aᵀ's indices), bit-equal to the dense walk at the kept channels
and within 1e-5 of max |y| of the plain version; the plain version
against JAX `sspmm_backward(stream_dtype=float32)` and
`_planned_aggregate_bwd` then `sample_channels` on stream plans (Pallas in
interpret mode); the planner's transpose positions for f32 rows; a SAGE
model and the Trainer on a forced stream plan in f32 with the rule on and
off, bit-equal. GPU (marker `gpu`, skipped without a card; no JAX): the
kernel bit for bit `stream_spmm` f32 on Aᵀ at the kept channels, each pass
against its model, the wrappers' raises and one SAGE step's launches.

    python -m pytest tests/test_torch_stream_sspmm_f32.py
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_stream_sspmm_f32.py
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.kernels import stream as tstream
from spgemm_gnn_tpu_torch.kernels.maxk import maxk_fwd
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.ops.stream import (stream_spmm_plain,
                                             stream_sspmm_plain)

F32 = torch.float32


@pytest.fixture
def one_torch_thread():
    """One torch thread for the runs this file compares bit for bit (as
    tests/test_torch_stream.py::one_torch_thread)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def restore_flags(monkeypatch):
    """The planner's flags as they were after the test, starting from the
    port's defaults (the JAX package's stream "f32", its CBSR forward
    off)."""
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


def bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().view(torch.int32).numpy()


def kept(y: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
    """y at each row's channels ch, 0 elsewhere."""
    keep = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    keep.scatter_(1, ch.long(), True)
    return torch.where(keep, y, torch.zeros((), device=y.device))


def near(got, ref, frac: float = 1e-5) -> None:
    """Within `frac` of ref's largest magnitude: the same f32 values summed
    in another order."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= frac * max(float(np.abs(ref).max()), 1e-30), err


def zero_rows(rng, n: int, dim: int, k: int) -> torch.Tensor:
    """Random rows, and every third row with fewer than k positive values
    and exact zeros past them: its top-k keeps zeros."""
    x = rng.standard_normal((n, dim)).astype(np.float32)
    few = np.arange(0, n, 3)
    x[few] = -np.abs(x[few]) - 1.0
    x[few, dim - k:] = 0.0
    x[few, dim - 3:] = np.abs(x[few, dim - 3:]) + 0.5
    return torch.tensor(x)


def factors(g, norm: str):
    """(pre, post) of the backward of an aggregation under `norm`: the
    forward's (dst_f, src_f); "sum" has neither."""
    src_f, dst_f = node_factors(g, norm)
    return dst_f, src_f


def hub_graph(n: int, seed: int, symmetric: bool, hub: int = 3000):
    """Random edges among the first n - 20 nodes (the last 20 have none),
    and `hub` more of node 3: in-edges, and with `symmetric` out-edges too
    (a row of Aᵀ across many warp spans)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n - 20, 3 * hub),
                          np.full(hub, 3)])
    dst = np.concatenate([rng.integers(0, n - 20, 3 * hub),
                          rng.integers(0, n - 20, hub)])
    src, dst = src[src != dst], dst[src != dst]
    if symmetric:
        return from_edges(np.concatenate([src, dst]),
                          np.concatenate([dst, src]), n, symmetric=True)
    return from_edges(src, dst, n, symmetric=False)


def plans(g, chunk: int):
    fwd = build_stream_plan(g.indptr, g.indices, chunk=chunk)
    bwd = fwd if g.symmetric else build_stream_plan(g.t_indptr, g.t_indices,
                                                    chunk=chunk)
    return fwd, bwd


# ---------------------------------------------------------------------------
# CPU: the plain version and the two passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [7, 128])
@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
def test_f32_plain_is_the_dense_plain_at_kept_channels(norm, chunk):
    """stream_sspmm (CPU: its plain version) on the f32 cotangent with the
    norm's pre and post: `stream_spmm_plain` on Aᵀ at MaxK's kept channels
    bit for bit (kept zeros among them), 0 at the others."""
    g = hub_graph(160, 5, False, hub=300)
    fwd, bwd = plans(g, chunk)
    rng = np.random.default_rng(len(norm) + chunk)
    _, _, ch = maxk_fwd(zero_rows(rng, 160, 32, 8), 8, with_ids=True)
    gy = torch.tensor(rng.standard_normal((160, 32)).astype(np.float32))
    pre, post = factors(g, norm)
    dx = tstream.stream_sspmm(bwd, fwd, gy, ch, post, pre=pre)
    assert dx.dtype == F32 and dx.shape == (160, 32)
    np.testing.assert_array_equal(
        bits(dx), bits(kept(stream_spmm_plain(bwd, gy, pre, post), ch)))
    np.testing.assert_array_equal(
        bits(dx), bits(stream_sspmm_plain(bwd, gy, ch, post, None, pre)))


def fma(s, v, p):
    """f32 s · v + p with one rounding: the product is exact in float64
    (24 + 24 bits) and the sum rounds there before f32, the same
    arithmetic for both walks compared here."""
    return (np.float64(s) * np.asarray(v, np.float64)
            + np.asarray(p, np.float64)).astype(np.float32)


def walk32(plan, width: int, edge, post) -> dict:
    """B3's walk (csrc/stream.cu: stream_walk_kernel, sspmm_walk_kernel)
    in f32 over sums of `width` terms, `edge(e)` giving edge e's (factor,
    terms): a warp per span of warp_chunks chunks; each chunk segment
    summed from +0 by an FMA an edge, in edge order, and folded into the
    row's sum over the span (its first segment, then each later chunk's
    added); a row that ends in the span written times post, one that goes
    on past it kept as its first span's sum, a segment of a row that began
    before the span put in its chunk's carry slot; then the carry pass,
    the carry slots past the row's first span added in chunk order, times
    post; a row with no edges 0. Returns {row: f32 [width]}."""
    f32 = np.float32
    ip = plan.indptr.numpy().astype(np.int64)
    n_rows, n_edges, c = plan.num_rows, plan.num_edges, plan.chunk
    wc = plan.warp_chunks
    row = np.repeat(np.arange(n_rows), np.diff(ip))
    out, first, carry = {}, {}, {}
    for c0 in range(0, plan.num_chunks, wc):
        lo = c0 * c
        hi = min(min(c0 + wc, plan.num_chunks) * c, n_edges)
        acc, head = np.zeros(width, f32), None
        for e in range(lo, hi):
            s, v = edge(e)
            acc = fma(s, v, acc)
            r = row[e]
            rs, re = ip[r], ip[r + 1]
            q = e // c
            qlo, qhi = q * c, min(q * c + c, n_edges)
            if e + 1 != min(re, qhi):
                continue
            before = rs < lo
            head = acc if before or rs >= qlo else head + acc
            acc = np.zeros(width, f32)
            if before:
                carry[q] = head
            elif re <= qhi:
                out[r] = head * (f32(1) if post is None else post[r])
            elif qhi == hi:
                first[r] = head
    for r in plan.carry_rows.numpy():
        a, b = ip[r], ip[r + 1]
        if a == b:
            out[r] = np.zeros(width, f32)
            continue
        v = first[r]
        for q in range((a // c // wc + 1) * wc, (b - 1) // c + 1):
            v = v + carry[q]
        out[r] = v * (f32(1) if post is None else post[r])
    assert len(out) == n_rows
    return out


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("norm", ["sum", "gcn"])
@pytest.mark.parametrize("chunk", [3, 16])
def test_two_passes_are_the_dense_walk_bit_for_bit(chunk, norm, symmetric):
    """The kernels' two passes modelled on f32 slots: pass 1 puts the raw
    terms g[u, ch[v, .]] of each edge u -> v of A at its transpose
    position (k terms a slot); pass 2 walks Aᵀ's spans over the slots in
    order, each term an FMA by the edge's pre factor (from Aᵀ's indices).
    At the kept channels the bits of B3's dense walk (every channel, the
    same FMAs), and within 1e-5 of max |y| of the plain version; a hub row
    across spans (with `symmetric` a hub row of A too), rows without
    edges."""
    g = hub_graph(120, 7, symmetric, hub=150)
    n, dim, k = g.num_nodes, 32, 8
    fwd, bwd = plans(g, chunk)
    rng = np.random.default_rng(chunk + len(norm))
    _, _, ch = maxk_fwd(zero_rows(rng, n, dim, k), k, with_ids=True)
    gy = rng.standard_normal((n, dim)).astype(np.float32)
    pre, post = factors(g, norm)
    pre_np = np.ones(n, np.float32) if pre is None else pre.numpy()
    post_np = None if post is None else post.numpy()

    # pass 1: A's edges in order, each edge's slot at its position in Aᵀ
    pos = bwd.transpose_positions(fwd).numpy()
    slots = np.full((g.num_edges, k), np.nan, np.float32)
    chn = ch.long().numpy()
    a_rows = g.edge_dst.numpy()
    for e, v in enumerate(g.indices.numpy()):
        u = a_rows[e]
        slots[pos[e]] = gy[u, chn[v]]
    assert not np.isnan(slots).any()

    # pass 2 on the slots, and the dense walk on g, over Aᵀ's plan
    t_idx = bwd.indices.numpy()
    sampled = walk32(bwd, k, lambda e: (pre_np[t_idx[e]], slots[e]), post_np)
    dense = walk32(bwd, dim, lambda e: (pre_np[t_idx[e]], gy[t_idx[e]]),
                   post_np)
    got = np.zeros((n, dim), np.float32)
    want = np.zeros((n, dim), np.float32)
    for r in range(n):
        got[r, chn[r]] = sampled[r]
        want[r, chn[r]] = dense[r][chn[r]]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    plain = stream_sspmm_plain(bwd, torch.tensor(gy), ch, post, None, pre)
    near(got, plain.numpy())


def _graphs(kind: str):
    from spgemm_gnn_tpu.graphs import synthetic as jsyn
    if kind == "symmetric":
        return (jsyn.powerlaw_graph(250, 2500, seed=21),
                tsyn.powerlaw_graph(250, 2500, seed=21))
    return (jsyn.random_graph(200, 1500, seed=5, symmetric=False),
            tsyn.random_graph(200, 1500, seed=5, symmetric=False))


def _j(t: torch.Tensor | None):
    import jax.numpy as jnp
    return None if t is None else jnp.asarray(t.numpy())


def _jax_stream_plans(jg):
    from spgemm_gnn_tpu.kernels import planned as jplanned
    jpg = jplanned.plan_graph(jg, kind="stream", tile_slots=128,
                              dst_block=128)
    return jpg.fwd_plan, jpg.bwd_plan


@pytest.mark.parametrize("norm", ["mean", "gcn"])
@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_f32_sampled_matches_jax_sspmm_backward(kind, norm):
    """The port's sampled f32 backward (stream_sspmm on the raw cotangent,
    pre dst_f, post src_f) at MaxK's kept channels against JAX
    `sspmm_backward(stream_dtype=float32)` on its StreamPlan pair: within
    1e-5 of max |dvalues|; zeros at the other channels."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels import planned as jplanned

    jg, tg = _graphs(kind)
    n, dim, k = tg.num_nodes, 32, 8
    rng = np.random.default_rng(len(kind) + len(norm))
    _, _, ch = maxk_fwd(zero_rows(rng, n, dim, k), k, with_ids=True)
    g_ct = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32))
    src_f, dst_f = node_factors(tg, norm)
    dv_j = jplanned.sspmm_backward(
        jnp.asarray(g_ct.numpy()), jnp.asarray(ch.int().numpy()),
        _j(src_f), _j(dst_f), _jax_stream_plans(jg),
        stream_dtype=jnp.float32)
    assert dv_j.dtype == jnp.float32

    tpg = tplanned.plan_graph(tg, kind="stream", dim=dim)
    dx = tstream.stream_sspmm(tpg.bwd_plan, tpg.fwd_plan, g_ct, ch, src_f,
                              pre=dst_f)
    near(torch.gather(dx, 1, ch.long()).numpy(), np.asarray(dv_j))
    np.testing.assert_array_equal(bits(dx), bits(kept(dx, ch)))


@pytest.mark.parametrize("norm", ["mean", "gcn"])
def test_f32_sampled_matches_jax_aggregate_bwd(norm):
    """The models' route (`planned.plan_sspmm` on a stream plan, f32
    cotangent) against JAX `_planned_aggregate_bwd` (the dense backward
    of `planned_aggregate` on its stream plan, f32) then
    `sample_channels`: within 1e-5 of max |y| at the kept channels."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels import planned as jplanned
    from spgemm_gnn_tpu.kernels.spgemm_pallas import sample_channels

    jg, tg = _graphs("directed")
    n, dim, k = tg.num_nodes, 32, 8
    rng = np.random.default_rng(len(norm))
    _, _, ch = maxk_fwd(zero_rows(rng, n, dim, k), k, with_ids=True)
    g_ct = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32))
    src_f, dst_f = node_factors(tg, norm)
    res = (jnp.zeros((0,), jnp.float32), _j(src_f), _j(dst_f),
           _jax_stream_plans(jg))
    dx_j = jplanned._planned_aggregate_bwd((None, k), res,
                                           jnp.asarray(g_ct.numpy()))[0]
    assert dx_j.dtype == jnp.float32
    dv_j = sample_channels(dx_j, jnp.asarray(ch.int().numpy()),
                           interpret=True)

    tpg = tplanned.plan_graph(tg, kind="stream", dim=dim)
    # the backward's factors: pre dst_f, post src_f (Aggregate.backward)
    dx = tplanned.plan_sspmm(tpg.bwd_plan, tpg.fwd_plan, g_ct, ch, dst_f,
                             src_f)
    near(torch.gather(dx, 1, ch.long()).numpy(), np.asarray(dv_j))


def test_plan_graph_builds_positions_for_f32_rows(monkeypatch):
    """plan_graph on a stream plan with `dim`: the backward plan's
    transpose positions for f32 rows too where the caller names a MaxK of
    width k that the rule takes the sampled backward for (k < dim <= 256,
    SAMPLED_BACKWARD not False); none for f32 rows with no MaxK, at dim
    384 or with the flag off; for bf16 rows as before, with or without k.
    The Trainer names its MaxK."""
    g = tsyn.random_graph(100, 800, seed=3, symmetric=False)

    def has(pg):
        return "positions" in pg.bwd_plan._hot
    assert has(tplanned.plan_graph(g, kind="stream", dim=256, k=32))
    assert has(tplanned.plan_graph(g, kind="stream", dim=64, dtype=F32,
                                   k=8))
    assert not has(tplanned.plan_graph(g, kind="stream", dim=64, dtype=F32))
    assert not has(tplanned.plan_graph(g, kind="stream", dim=64, k=64))
    assert has(tplanned.plan_graph(g, kind="stream", dim=64,
                                   dtype=torch.bfloat16))
    assert not has(tplanned.plan_graph(g, kind="stream", dim=384, k=32))
    assert not has(tplanned.plan_graph(g, kind="stream", k=32))
    monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", False)
    assert not has(tplanned.plan_graph(g, kind="stream", dim=256, k=32))
    assert has(tplanned.plan_graph(g, kind="stream", dim=64,
                                   dtype=torch.bfloat16, k=8))


def test_f32_sampled_wrapper_checks_its_inputs():
    """f32 messages need dim % 4 == 0 and dim <= 256, uint8 ids of 1 <= k
    < dim, and a pre factor f32 [S]; the timing variants run on bf16
    messages only, at k 20 to 32; a slot holds k terms."""
    g = tsyn.random_graph(50, 300, seed=4, symmetric=False)
    pg = tplanned.plan_graph(g, kind="stream")
    p, f = pg.bwd_plan, pg.fwd_plan
    m = torch.zeros((50, 32))
    ch = torch.zeros((50, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="dim % 4 == 0"):
        tstream.stream_sspmm(p, f, torch.zeros((50, 30)), ch)
    with pytest.raises(ValueError, match="dim <= 256"):
        tstream.stream_sspmm(p, f, torch.zeros((50, 260)), ch)
    with pytest.raises(ValueError, match="k < 32"):
        tstream.stream_sspmm(p, f, m, torch.zeros((50, 32),
                                                  dtype=torch.uint8))
    with pytest.raises(ValueError, match="f32 or bf16 messages"):
        tstream.stream_sspmm(p, f, m.half(), ch)
    with pytest.raises(ValueError, match="bf16 output needs bf16"):
        tstream.stream_sspmm(p, f, m, ch, None, torch.bfloat16)
    with pytest.raises(ValueError, match="carry their pre"):
        tstream.stream_sspmm(p, f, m.bfloat16(), ch, pre=torch.ones(50))
    with pytest.raises(ValueError, match="variant"):
        tstream.stream_sspmm_at(p, f, m, ch, variant="no_store")
    with pytest.raises(ValueError, match="k 20, 24, 28 or 32"):
        tstream.stream_sspmm_at(p, f, m.bfloat16(), ch, passes=(1,),
                                variant="no_store")
    slots = tstream.new_slots(10, 31, torch.device("cpu"), F32)
    assert slots.shape == (10, 31) and slots.dtype == F32
    assert slots.untyped_storage().nbytes() == 10 * 31 * 4 + 16


# ---------------------------------------------------------------------------
# CPU: a model and the Trainer, the rule on against off
# ---------------------------------------------------------------------------

def _count_sampled(monkeypatch) -> list:
    calls = []
    plain = tstream.stream_sspmm_plain

    def counting(*a, **kw):
        calls.append(a[1].dtype)
        return plain(*a, **kw)
    monkeypatch.setattr(tstream, "stream_sspmm_plain", counting)
    return calls


def _zero_topk(model) -> None:
    """lin_in: channels 20..25 exactly 0 and 0..19 below -10, so that most
    rows' top-8 after it holds kept zeros."""
    with torch.no_grad():
        model.lin_in.weight[20:26] = 0.0
        model.lin_in.weight[:20] *= 0.01
        model.lin_in.bias[:20] = -10.0


def test_sage_f32_sampled_backward_bit_equal(monkeypatch, one_torch_thread):
    """A SAGE MaxK model (feat_drop 0.5, LayerNorm) in f32 on a forced
    stream plan whose first layer's top-k holds exact zeros: with the rule
    on, the logits and the input gradient bit-equal to the rule off, and
    the sampled form taken on f32 messages by every layer's backward."""
    from spgemm_gnn_tpu_torch.models.models import build_model
    g = tsyn.random_graph(300, 3000, seed=5, symmetric=False)
    pg = tplanned.plan_graph(g, kind="stream", chunk=7, dim=32, k=8)
    assert "positions" in pg.bwd_plan._hot
    calls = _count_sampled(monkeypatch)
    out = {}
    for flag in (None, False):
        monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", flag)
        model = build_model("sage", in_dim=16, hidden_dim=32, num_layers=2,
                            out_dim=5, maxk=8, feat_drop=0.5, use_norm=True)
        model.reset_parameters(torch.Generator().manual_seed(1))
        _zero_topk(model)
        x = torch.tensor(np.random.default_rng(2).standard_normal(
            (300, 16)).astype(np.float32), requires_grad=True)
        logits = model(pg, x, torch.Generator().manual_seed(3))
        (logits * logits).sum().backward()
        out[flag] = (bits(logits), bits(x.grad))
        if flag is None:
            assert calls == [F32, F32]
            h = model.lin_in(x)
            _, _, ids = maxk_fwd(h.detach(), 8, with_ids=True)
            assert (torch.gather(h.detach(), 1, ids.long()) == 0).any()
    assert calls == [F32, F32]
    np.testing.assert_array_equal(out[None][0], out[False][0])
    np.testing.assert_array_equal(out[None][1], out[False][1])


@pytest.mark.parametrize("model", ["sage", "gcn"])
def test_f32_trainer_on_stream_plan_losses_bit_equal(model, monkeypatch,
                                                     one_torch_thread):
    """Two epochs of the Trainer (dropout 0.5) in f32 on the flickr
    stand-in at scale 0.004, its graph planned with kind "stream": the
    losses with SAMPLED_BACKWARD at its default (the sampled form on f32
    messages, once a layer a train step) bit-equal to the rule off (the
    dense backward). The Trainer names its MaxK's k to plan_graph."""
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    cfg = TrainConfig(dataset="flickr", model=model, epochs=2, hidden_dim=32,
                      hidden_layers=2, maxk=8, dropout=0.5, w_lr=0.01,
                      nonlinear="maxk", norm=True, synthetic=True,
                      synthetic_scale=0.004, eval_every=1, log_every=0,
                      seed=3, device="cpu")
    calls = _count_sampled(monkeypatch)
    named, real = [], tplanned.plan_graph

    def spy(g, **kw):
        named.append(kw.get("k"))
        return real(g, **kw)
    monkeypatch.setattr(tplanned, "plan_graph", spy)
    losses = {}
    for flag in (None, False):
        monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", flag)
        tr = Trainer(cfg)
        assert named.pop() == 8
        tr.g = real(tr.g.graph, kind="stream", chunk=7, dim=32, k=8)
        state = tr.init_state()
        if model == "sage":
            _zero_topk(state["model"])
        gen = torch.Generator().manual_seed(4)
        losses[flag] = [float(tr.train_step(state, gen)) for _ in range(2)]
    assert calls == [F32] * 4
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


def _card_case(cuda, dim: int, k: int, chunk: int, symmetric: bool,
               norm: str):
    """A hub graph of 700 nodes on the card (node 3's 3000 edges across
    many warp spans, the last 20 rows without edges), its plan pair, MaxK's
    kept channels of rows with kept zeros, an f32 cotangent and the norm's
    (pre, post)."""
    g = hub_graph(700, dim + k, symmetric).to(cuda)
    fwd, bwd = plans(g, chunk)
    rng = np.random.default_rng(dim * k + chunk)
    h = zero_rows(rng, 700, dim, min(k, dim - 4)).to(cuda)
    _, _, ch = maxk_fwd(h, k, with_ids=True)
    gy = torch.tensor(rng.standard_normal((700, dim)).astype(np.float32),
                      device=cuda)
    pre, post = factors(g, norm)
    return g, fwd, bwd, ch, gy, pre, post


def _pass1_model(g, fwd, bwd, gy, ch):
    """Pass 1's slots, modelled: each edge u -> v of A's g[u, ch[v, .]] at
    its transpose position."""
    pos = bwd.transpose_positions(fwd).long()
    u, v = g.edge_dst.long(), g.indices.long()
    slots = torch.zeros((g.num_edges, ch.shape[1]), device=gy.device)
    slots[pos] = gy[u[:, None], ch.long()[v]]
    return slots


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [7, 128])
@pytest.mark.parametrize("dim,k", [(32, 8), (64, 20), (256, 32), (256, 48),
                                   (128, 100), (256, 255)])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
def test_stream_sspmm_f32_bitwise_dense_on_gpu(cuda, norm, symmetric, dim,
                                               k, chunk):
    """stream_sspmm on f32 messages bit-equal to stream_spmm f32 on Aᵀ
    (pre and post per the norm) at MaxK's kept channels and 0 elsewhere,
    across two runs; pass 1's slots those of the model (pure data
    movement, bit for bit); pass 2 alone on them the same dx; within
    1e-5 of max |y| of the plain version. One launch, counted as
    stream_sspmm."""
    g, fwd, bwd, ch, gy, pre, post = _card_case(cuda, dim, k, chunk,
                                                symmetric, norm)
    want = kept(tstream.stream_spmm(bwd, gy, pre, post), ch)
    _build.launches.clear()
    got = tstream.stream_sspmm(bwd, fwd, gy, ch, post, pre=pre)
    assert dict(_build.launches) == {"stream_sspmm": 1}
    np.testing.assert_array_equal(bits(got), bits(want))
    np.testing.assert_array_equal(bits(got), bits(tstream.stream_sspmm(
        bwd, fwd, gy, ch, post, pre=pre)))
    slots = tstream.stream_sspmm_at(bwd, fwd, gy, ch, pre=pre, passes=(1,))
    np.testing.assert_array_equal(bits(slots),
                                  bits(_pass1_model(g, fwd, bwd, gy, ch)))
    np.testing.assert_array_equal(bits(got), bits(tstream.stream_sspmm_at(
        bwd, fwd, gy, ch, post, pre=pre, passes=(2,), slots=slots)))
    plain = stream_sspmm_plain(bwd, gy, ch, post, None, pre)
    near(got.cpu().numpy(), plain.cpu().numpy())


@pytest.mark.gpu
def test_stream_sspmm_f32_wrappers_raise_on_gpu(cuda, monkeypatch):
    """Bad inputs raise (messages' dtype and width, ids, pre, the slot
    buffer), and a kernel that refuses its launch raises: the plain version
    never runs for a CUDA tensor, and nothing is counted."""
    g, fwd, bwd, ch, gy, pre, post = _card_case(cuda, 64, 8, 7, False,
                                                "gcn")
    with pytest.raises(ValueError, match="f32 or bf16 messages"):
        tstream.stream_sspmm(bwd, fwd, gy.double(), ch)
    with pytest.raises(ValueError, match="dim % 4 == 0"):
        tstream.stream_sspmm(bwd, fwd, gy[:, :62].contiguous(), ch)
    with pytest.raises(ValueError, match="uint8"):
        tstream.stream_sspmm(bwd, fwd, gy, ch.int())
    with pytest.raises(ValueError, match="is on cpu"):
        tstream.stream_sspmm(bwd, fwd, gy, ch, post, pre=pre.cpu())
    with pytest.raises(ValueError, match="shape"):
        tstream.stream_sspmm(bwd, fwd, gy, ch, post, pre=pre[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        tstream.stream_sspmm(bwd, fwd, gy.t().contiguous().t(), ch)
    short = tstream.new_slots(g.num_edges, 8, cuda, F32)
    with pytest.raises(ValueError, match="dtype"):
        tstream.stream_sspmm_at(bwd, fwd, gy, ch, passes=(2,),
                                slots=short.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        tstream.stream_sspmm_at(bwd, fwd, gy, ch, passes=(2,),
                                slots=short[:, :4].contiguous())
    with pytest.raises(ValueError, match="16 bytes past"):
        tstream.stream_sspmm_at(bwd, fwd, gy, ch, passes=(2,),
                                slots=short.clone())
    real = _build.library

    class Refusing:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, fn):
            if fn in ("sspmm_slots_f32", "stream_sspmm_f32"):
                return lambda *args: 1      # cudaErrorInvalidValue
            return getattr(self.inner, fn)

    monkeypatch.setattr(_build, "library", lambda w: Refusing(real(w)))
    _build.launches.clear()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tstream.stream_sspmm(bwd, fwd, gy, ch, post, pre=pre)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        tstream.stream_sspmm_at(bwd, fwd, gy, ch, post, pre=pre,
                                passes=(2,), slots=short)
    assert not _build.launches


@pytest.mark.gpu
def test_sage_step_launches_f32_sampled_on_gpu(cuda, monkeypatch):
    """One forward and backward of a 2-layer SAGE MaxK model in f32 on a
    stream plan on the card: at the default rule the backwards launch
    stream_sspmm twice and stream_spmm never; with the rule off
    stream_spmm twice; the logits and input gradient bit-equal."""
    from spgemm_gnn_tpu_torch.models.models import build_model
    g = hub_graph(700, 5, False).to(cuda)
    pg = tplanned.plan_graph(g, kind="stream", chunk=7, dim=64)
    out = {}
    for flag in (None, False):
        monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", flag)
        model = build_model("sage", in_dim=16, hidden_dim=64, num_layers=2,
                            out_dim=5, maxk=8, feat_drop=0.5, use_norm=True)
        model.reset_parameters(torch.Generator().manual_seed(1))
        _zero_topk(model)
        model.to(cuda)
        x = torch.tensor(np.random.default_rng(2).standard_normal(
            (700, 16)).astype(np.float32), device=cuda, requires_grad=True)
        _build.launches.clear()
        logits = model(pg, x, torch.Generator(device=cuda).manual_seed(3))
        _build.launches.clear()
        (logits * logits).sum().backward()
        launched = dict(_build.launches)
        assert launched.get("stream_sspmm", 0) == (2 if flag is None else 0)
        assert launched.get("stream_spmm", 0) == (0 if flag is None else 2)
        out[flag] = (bits(logits), bits(x.grad))
    np.testing.assert_array_equal(out[None][0], out[False][0])
    np.testing.assert_array_equal(out[None][1], out[False][1])
