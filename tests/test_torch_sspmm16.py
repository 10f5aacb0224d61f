"""The sampled backward of MaxK's aggregation on bf16 messages
(`kernels/stream.py::stream_sspmm`, `kernels.planned.SAMPLED_BACKWARD`):
its plain version against the JAX package's `sspmm_backward` and
`_planned_aggregate_bwd` then `sample_channels` (CPU, Pallas in interpret
mode), MaxK's kept-channel ids, the transpose positions of a stream plan,
the rule, and a SAGE model and Trainer with the rule on against off; then
the model on the card (GPU; the kernels against the dense form and their
plain versions are `tests/test_torch_kernels.py`'s GPU cases).

The JAX functions sum the same bf16 messages in f32 in another order and
round once to bf16 (the reference rounds a row across its groups' carries,
which one ulp covers here): held within 1 bf16 ulp, with at most 0.5 % of
the values off. With the rule on, a model's input gradients and losses are
those of the rule off bit for bit: the sampled form gives the dense form's
sums at the kept channels, and MaxK's backward zeroes the rest. The GPU
cases (marker `gpu`) skip without a card; they import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_sspmm16.py
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.stream_tiles import (build_stream_plan,
                                                      transpose_positions)
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.kernels import stream as tstream
from spgemm_gnn_tpu_torch.kernels.maxk import maxk_fwd
from spgemm_gnn_tpu_torch.kernels.round import round_rows
from spgemm_gnn_tpu_torch.ops import maxk as tmaxk
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.ops.spmm import _scale
from spgemm_gnn_tpu_torch.ops.stream import (stream_spmm_plain,
                                             stream_sspmm_plain)

BF16 = torch.bfloat16
AGG_ULPS, AGG_SHARE = 1, 0.005


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


def bf16_ulps(got, want) -> np.ndarray:
    """|got - want| in bf16 ulps at want (2^-7 of want's power of two)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    mag = np.maximum(np.abs(want), 2.0 ** -120)
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def near16(got, want) -> None:
    u = bf16_ulps(got, want)
    assert u.max(initial=0.0) <= AGG_ULPS, u.max()
    assert (u > 0).mean() <= AGG_SHARE, (u > 0).mean()


def f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32).numpy()


def zero_rows(rng, n: int, dim: int, k: int) -> torch.Tensor:
    """Random rows, and every third row with fewer than k positive values
    and exact zeros past them (negatives below): its top-k keeps zeros,
    which are not the lowest zero channels of MaxK's output (that holds -0
    at the dropped negatives)."""
    x = rng.standard_normal((n, dim)).astype(np.float32)
    few = np.arange(0, n, 3)
    x[few] = -np.abs(x[few]) - 1.0
    x[few, dim - k:] = 0.0
    x[few, dim - 3:] = np.abs(x[few, dim - 3:]) + 0.5
    return torch.tensor(x)


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


# ---------------------------------------------------------------------------
# CPU: MaxK's kept channels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("dim,k", [(32, 8), (256, 32), (256, 255)])
def test_maxk_ids_are_the_masks_channels(dim, k, dtype):
    """maxk_fwd(..., with_ids=True): uint8 [N, k], ascending, the channels
    where MaxK's mask holds (kept zeros included), with y and meta those of
    the plain forward; the same set as JAX maxk_pallas's nonzero mask on
    rows without zeros."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.maxk_pallas import maxk_pallas
    rng = np.random.default_rng(dim + k)
    x = zero_rows(rng, 60, dim, min(k, dim - 4)).to(dtype)
    y, meta, ids = maxk_fwd(x, k, with_ids=True)
    y0, meta0 = tmaxk.maxk_forward(x, k)
    assert torch.equal(meta, meta0) and np.array_equal(bits(y), bits(y0))
    assert ids.dtype == torch.uint8 and ids.shape == (60, k)
    assert (ids[:, 1:] > ids[:, :-1]).all()
    mask = tmaxk.mask_from_meta(x, meta)
    np.testing.assert_array_equal(
        np.sort(np.nonzero(mask.numpy())[1].reshape(60, k), 1),
        ids.long().numpy())
    # rows with no zero in x: the JAX kernel's nonzero mask
    full = (x != 0).all(1).numpy()
    y_j = np.asarray(maxk_pallas(jnp.asarray(f32(x)).astype(
        jnp.bfloat16 if dtype == BF16 else jnp.float32), k, interpret=True),
        np.float32)
    np.testing.assert_array_equal(
        np.nonzero(y_j[full] != 0)[1].reshape(-1, k),
        ids.long().numpy()[full])
    # the compaction of MaxK's output misses a kept zero on the zero rows
    if dtype == torch.float32 and k == 32:
        _, ch = tmaxk.cbsr_compact_plain(y, k)
        assert not torch.equal(torch.sort(ch, 1).values.long(), ids.long())


def test_maxk_ids_need_dim_256():
    with pytest.raises(ValueError, match="dim <= 256"):
        maxk_fwd(torch.zeros((4, 264)), 8, with_ids=True)


# ---------------------------------------------------------------------------
# CPU: the transpose positions
# ---------------------------------------------------------------------------

def brute_positions(g) -> np.ndarray:
    """For each edge of g's in-CSR, the position of its transposed edge in
    the out-CSR, repeated pairs matched in order, by a Python walk."""
    rows = g.edge_dst.numpy()
    cols = g.indices.numpy()
    t_rows = g.t_edge_dst.numpy()
    t_cols = g.t_indices.numpy()
    slots: dict = {}
    for p, (v, u) in enumerate(zip(t_rows, t_cols)):
        slots.setdefault((int(v), int(u)), []).append(p)
    order = np.lexsort((np.arange(rows.size), rows, cols))
    out = np.empty(rows.size, np.int64)
    for e in order:
        out[e] = slots[(int(cols[e]), int(rows[e]))].pop(0)
    return out


@pytest.mark.parametrize("kind", ["directed", "symmetric", "empty_rows"])
def test_transpose_positions_against_brute_force(kind):
    """StreamPlan.transpose_positions on the transpose plan (a symmetric
    graph's own plan): each edge's position in the transpose order, equal
    to a brute-force matching; a permutation; kept on the plan."""
    rng = np.random.default_rng(len(kind))
    n = 90
    src = rng.integers(0, n, 700)
    dst = rng.integers(0, n, 700)
    if kind == "empty_rows":   # nodes 70.. have no edges; repeated pairs
        src, dst = src % 70, dst % 70
        src = np.concatenate([src, [3, 3, 3]])
        dst = np.concatenate([dst, [5, 5, 5]])
    if kind == "symmetric":
        g = from_edges(np.concatenate([src, dst]),
                       np.concatenate([dst, src]), n, symmetric=True)
    else:
        g = from_edges(src, dst, n, symmetric=False)
    fwd = build_stream_plan(g.indptr, g.indices, chunk=7)
    bwd = fwd if g.symmetric else build_stream_plan(g.t_indptr, g.t_indices,
                                                    chunk=7)
    pos = bwd.transpose_positions(fwd)
    assert pos.dtype == torch.int32 and pos.shape == (g.num_edges,)
    np.testing.assert_array_equal(pos.numpy(), brute_positions(g))
    assert torch.equal(torch.sort(pos).values,
                       torch.arange(g.num_edges, dtype=torch.int32))
    assert bwd.transpose_positions(fwd) is pos
    # the transposed edge: row = the edge's source, column = its destination
    p = pos.long()
    assert torch.equal(g.t_edge_dst[p], g.indices)
    assert torch.equal(g.t_indices[p], g.edge_dst)


def test_transpose_positions_refuse_another_csr():
    g = tsyn.random_graph(40, 200, seed=2, symmetric=False)
    with pytest.raises(ValueError, match="not the transpose"):
        transpose_positions(g.indptr, g.indices, g.indptr, g.indices)


@pytest.mark.parametrize("chunk", [7, 128])
def test_two_passes_compute_the_sampled_product(chunk, rng):
    """The kernels' two passes in torch: pass 1 puts m[u, ch[v, j]] of
    each edge u -> v at its transpose position, pass 2 sums each row's
    slots in the transpose order; equal to the plain version (f32 sums of
    the same bf16 terms, 1e-5 of max |y|), zeros past the kept channels."""
    g = tsyn.random_graph(150, 1400, seed=9, symmetric=False)
    n, dim, k = g.num_nodes, 32, 8
    fwd = build_stream_plan(g.indptr, g.indices, chunk=chunk)
    bwd = build_stream_plan(g.t_indptr, g.t_indices, chunk=chunk)
    m = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32)).to(
        BF16)
    _, _, ch = maxk_fwd(torch.tensor(rng.standard_normal((n, dim)).astype(
        np.float32)), k, with_ids=True)
    post = torch.tensor(rng.random(n).astype(np.float32) + 0.5)
    pos = bwd.transpose_positions(fwd).long()
    slots = torch.empty((g.num_edges, k), dtype=BF16)
    slots[pos] = m[g.edge_dst.long()[:, None], ch.long()[g.indices.long()]]
    sums = torch.zeros((n, k)).index_add_(0, g.t_edge_dst.long(),
                                          slots.float())
    want = torch.zeros((n, dim)).scatter_(1, ch.long(), sums * post[:, None])
    got = stream_sspmm_plain(bwd, m, ch, post)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    keep = torch.zeros((n, dim), dtype=torch.bool).scatter_(1, ch.long(),
                                                            True)
    assert not got[~keep].any()


# ---------------------------------------------------------------------------
# CPU: the plain sampled backward against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm", ["mean", "gcn"])
@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_sampled_plain_matches_jax_sspmm_backward(kind, norm):
    """stream_sspmm (_out) on the messages bf16(dst_f ⊙ g) with post src_f,
    at MaxK's kept channels, against JAX `sspmm_backward(stream_dtype=
    bfloat16)` on its StreamPlan pair: bf16 dvalues within 1 ulp, at most
    0.5 % off; zeros at the other channels."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels import planned as jplanned

    jg, tg = _graphs(kind)
    n, dim, k = tg.num_nodes, 32, 8
    rng = np.random.default_rng(len(kind) + len(norm))
    _, _, ch = maxk_fwd(zero_rows(rng, n, dim, k), k, with_ids=True)
    g_ct = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32))
    src_f, dst_f = node_factors(tg, norm)
    jpg = jplanned.plan_graph(jg, kind="stream", tile_slots=128,
                              dst_block=128)
    dv_j = jplanned.sspmm_backward(
        jnp.asarray(g_ct.numpy()), jnp.asarray(ch.int().numpy()),
        _j(src_f), _j(dst_f), (jpg.fwd_plan, jpg.bwd_plan),
        stream_dtype=jnp.bfloat16)
    assert dv_j.dtype == jnp.bfloat16

    tpg = tplanned.plan_graph(tg, kind="stream")
    dx = tstream.stream_sspmm(tpg.bwd_plan, tpg.fwd_plan,
                              round_rows(g_ct, dst_f), ch, src_f, BF16)
    assert dx.dtype == BF16 and dx.shape == (n, dim)
    near16(f32(torch.gather(dx, 1, ch.long())), np.asarray(dv_j, np.float32))
    keep = torch.zeros((n, dim), dtype=torch.bool).scatter_(1, ch.long(),
                                                            True)
    assert not dx[~keep].any()


@pytest.mark.parametrize("norm", ["mean", "gcn"])
def test_sampled_plain_matches_jax_aggregate_bwd_bf16(norm):
    """bf16 activations: stream_sspmm_out on the messages dst_f ⊙ g in bf16
    against JAX `_planned_aggregate_bwd` (the dense bf16 backward) then
    `sample_channels` (interpret) at MaxK's channels: within 1 ulp, at
    most 0.5 % off."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels import planned as jplanned
    from spgemm_gnn_tpu.kernels.spgemm_pallas import sample_channels

    jg, tg = _graphs("directed")
    n, dim, k = tg.num_nodes, 32, 8
    rng = np.random.default_rng(len(norm))
    _, _, ch = maxk_fwd(zero_rows(rng, n, dim, k).to(BF16), k,
                        with_ids=True)
    g_ct = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32)).to(
        BF16)
    src_f, dst_f = node_factors(tg, norm)
    jpg = jplanned.plan_graph(jg, kind="stream", tile_slots=128,
                              dst_block=128)
    res = (jnp.zeros((0,), jnp.bfloat16), _j(src_f), _j(dst_f),
           (jpg.fwd_plan, jpg.bwd_plan))
    dx_j = jplanned._planned_aggregate_bwd(
        (None, k), res, jnp.asarray(f32(g_ct)).astype(jnp.bfloat16))[0]
    assert dx_j.dtype == jnp.bfloat16
    dv_j = sample_channels(dx_j, jnp.asarray(ch.int().numpy()),
                           interpret=True)

    tpg = tplanned.plan_graph(tg, kind="stream", dtype=BF16, dim=dim)
    dx = tstream.stream_sspmm(tpg.bwd_plan, tpg.fwd_plan,
                              _scale(g_ct, dst_f).contiguous(), ch, src_f,
                              BF16)
    near16(f32(torch.gather(dx, 1, ch.long())), np.asarray(dv_j, np.float32))
    # the plain version is the dense plain backward at those channels
    dense = stream_spmm_plain(tpg.bwd_plan, _scale(g_ct, dst_f), None, src_f,
                              BF16)
    np.testing.assert_array_equal(bits(torch.gather(dx, 1, ch.long())),
                                  bits(torch.gather(dense, 1, ch.long())))


# ---------------------------------------------------------------------------
# CPU: the rule
# ---------------------------------------------------------------------------

def test_sampled_backward_rule(monkeypatch):
    """SAMPLED_BACKWARD's rule, both sides: a stream or a windowed plan
    with bf16 messages (bf16 activations, or the bf16x2 stream) and MaxK's
    k < dim <= 256 takes the sampled form under None and True; so does the
    f32 stream on f32 activations, on either plan kind (`stream_sspmm` and
    `csr_sspmm` on f32 messages); no ids or k = dim never do; False never
    does; dim 384 only under True. `wants_channel_ids` asks MaxK for its
    ids only where the rule holds and a backward runs."""
    g = tsyn.random_graph(100, 800, seed=3, symmetric=False)
    stream = tplanned.plan_graph(g, kind="stream")
    windowed = tplanned.plan_graph(g, kind="windowed")
    rule = tplanned.sampled_backward
    for flag in (None, True, False):
        monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", flag)
        on = flag is not False
        for stream16 in ("f32", "bf16x2"):
            monkeypatch.setattr(tplanned, "DEFAULT_STREAM", stream16)
            bf16_msgs = (BF16, torch.float32) if stream16 == "bf16x2" else (
                BF16,)
            for dt in bf16_msgs:
                assert rule(stream.bwd_plan, 32, 256, dt) is on
                assert rule(windowed.bwd_plan, 32, 256, dt) is on
                assert rule(stream.bwd_plan, None, 256, dt) is False
                assert rule(stream.bwd_plan, 256, 256, dt) is False
                assert rule(stream.bwd_plan, 32, 384, dt) is (flag is True)
        monkeypatch.setattr(tplanned, "DEFAULT_STREAM", "f32")
        assert rule(stream.bwd_plan, 32, 256, torch.float32) is on
        assert rule(windowed.bwd_plan, 32, 256, torch.float32) is on
        assert rule(stream.bwd_plan, None, 256, torch.float32) is False
        assert rule(stream.bwd_plan, 256, 256, torch.float32) is False
        assert rule(stream.bwd_plan, 32, 384, torch.float32) is (
            flag is True)
    monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", None)
    x = torch.zeros((100, 256), dtype=BF16, requires_grad=True)
    assert tplanned.wants_channel_ids(stream, 32, x)
    assert tplanned.wants_channel_ids(windowed, 32, x)
    assert tplanned.wants_channel_ids(stream, 32, x.detach().float()
                                      .requires_grad_(True))
    assert not tplanned.wants_channel_ids(g, 32, x)
    assert not tplanned.wants_channel_ids(stream, 32, x.detach())
    with torch.no_grad():
        assert not tplanned.wants_channel_ids(stream, 32, x)


def test_sampled_wrapper_checks_its_inputs():
    g = tsyn.random_graph(50, 300, seed=4, symmetric=False)
    pg = tplanned.plan_graph(g, kind="stream")
    m = torch.zeros((50, 32), dtype=BF16)
    ch = torch.zeros((50, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="bf16 messages"):
        tstream.stream_sspmm(pg.bwd_plan, pg.fwd_plan, m.double(), ch)
    with pytest.raises(ValueError, match="uint8"):
        tstream.stream_sspmm(pg.bwd_plan, pg.fwd_plan, m, ch.int())
    with pytest.raises(ValueError, match="k < 32"):
        tstream.stream_sspmm(pg.bwd_plan, pg.fwd_plan, m,
                             torch.zeros((50, 32), dtype=torch.uint8))
    with pytest.raises(ValueError, match="dim <= 256"):
        tstream.stream_sspmm(pg.bwd_plan, pg.fwd_plan,
                             torch.zeros((50, 264), dtype=BF16), ch)


# ---------------------------------------------------------------------------
# CPU: a model and the Trainer, the rule on against off
# ---------------------------------------------------------------------------

def _count_sampled(monkeypatch) -> list:
    calls = []
    plain = tstream.stream_sspmm_plain

    def counting(*a, **kw):
        calls.append(1)
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


@pytest.mark.parametrize("stream,dtype", [("bf16x2", None),
                                          ("f32", "bfloat16")])
def test_sage_sampled_backward_bit_equal(stream, dtype, monkeypatch):
    """A SAGE MaxK model (feat_drop 0.5, LayerNorm) on a stream plan whose
    first layer's top-k holds exact zeros: with the rule on, the input
    gradient and the logits bit-equal to the rule off, and the sampled
    form taken by every layer's backward."""
    from spgemm_gnn_tpu_torch.models.models import build_model
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", stream)
    g = tsyn.random_graph(300, 3000, seed=5, symmetric=False)
    pg = tplanned.plan_graph(g, kind="stream", chunk=7, dim=32,
                             dtype=BF16 if dtype else torch.float32)
    calls = _count_sampled(monkeypatch)
    out = {}
    for flag in (None, False):
        monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", flag)
        model = build_model("sage", in_dim=16, hidden_dim=32, num_layers=2,
                            out_dim=5, maxk=8, feat_drop=0.5, use_norm=True,
                            dtype=dtype)
        model.reset_parameters(torch.Generator().manual_seed(1))
        _zero_topk(model)
        x = torch.tensor(np.random.default_rng(2).standard_normal(
            (300, 16)).astype(np.float32), requires_grad=True)
        logits = model(pg, x, torch.Generator().manual_seed(3))
        (logits * logits).sum().backward()
        out[flag] = (bits(logits), bits(x.grad))
        if flag is None:
            assert len(calls) == 2
            # the first layer's kept channels include zeros
            h = model.lin_in(x)
            _, _, ids = maxk_fwd(h.detach(), 8, with_ids=True)
            assert (torch.gather(h.detach(), 1, ids.long()) == 0).any()
    assert len(calls) == 2
    np.testing.assert_array_equal(out[None][0], out[False][0])
    np.testing.assert_array_equal(out[None][1], out[False][1])


@pytest.mark.parametrize("model", ["sage", "gcn"])
@pytest.mark.parametrize("stream,dtype", [("bf16x2", None),
                                          ("f32", "bfloat16")])
def test_trainer_sampled_backward_losses_bit_equal(model, stream, dtype,
                                                   monkeypatch,
                                                   one_torch_thread):
    """Two Trainer steps (dropout 0.5) on a stream plan, the first layer's
    top-k holding zeros (SAGE): the losses with the rule on bit-equal to
    the rule off, the sampled form run once a layer a step."""
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    cfg = TrainConfig(dataset="flickr", model=model, epochs=2, hidden_dim=32,
                      hidden_layers=2, maxk=8, dropout=0.5, w_lr=0.01,
                      nonlinear="maxk", norm=True, synthetic=True,
                      synthetic_scale=0.004, eval_every=1, log_every=0,
                      seed=3, device="cpu", stream=stream,
                      dtype=dtype or "float32")
    calls = _count_sampled(monkeypatch)
    losses = {}
    for flag in (None, False):
        monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", flag)
        tr = Trainer(cfg)
        tr.g = tplanned.plan_graph(tr.g.graph, kind="stream", chunk=7,
                                   dim=32, dtype=BF16 if dtype else
                                   torch.float32)
        state = tr.init_state()
        if model == "sage":
            _zero_topk(state["model"])
        gen = torch.Generator().manual_seed(4)
        losses[flag] = [float(tr.train_step(state, gen)) for _ in range(2)]
    assert len(calls) == 4
    assert losses[None] == losses[False]


# ---------------------------------------------------------------------------
# GPU: the kernels against the dense form and the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def hub_graph(n: int, seed: int, symmetric: bool):
    """Random edges among the first n - 20 nodes (the last 20 have none),
    and 3000 more of node 3: in-edges, and with `symmetric` out-edges too
    (a row of Aᵀ across many warp spans)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n - 20, 9000), np.full(3000, 3)])
    dst = np.concatenate([rng.integers(0, n - 20, 9000),
                          rng.integers(0, n - 20, 3000)])
    src, dst = src[src != dst], dst[src != dst]
    if symmetric:
        return from_edges(np.concatenate([src, dst]),
                          np.concatenate([dst, src]), n, symmetric=True)
    return from_edges(src, dst, n, symmetric=False)


@pytest.mark.gpu
@pytest.mark.parametrize("stream,dtype", [("bf16x2", None),
                                          ("f32", "bfloat16")])
def test_sage_sampled_backward_bit_equal_on_gpu(cuda, stream, dtype,
                                                monkeypatch):
    """On the card: a SAGE MaxK model's logits and input gradient with the
    rule on (stream_sspmm, once a layer) bit-equal to the rule off."""
    from spgemm_gnn_tpu_torch.models.models import build_model
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", stream)
    g = hub_graph(700, 5, False).to(cuda)
    pg = tplanned.plan_graph(g, kind="stream", chunk=7, dim=64,
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
                      if key.startswith("stream_sspmm"))
        assert sampled == (2 if flag is None else 0)
        out[flag] = (bits(logits), bits(x.grad))
    np.testing.assert_array_equal(out[None][0], out[False][0])
    np.testing.assert_array_equal(out[None][1], out[False][1])
