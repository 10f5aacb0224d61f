"""The 16-bit feature stream (`--stream bf16x2`, `kernels.planned.
DEFAULT_STREAM`): `round_rows`, the bf16 forms of `csr_spmm`, `stream_spmm`
and `stream_cbsr_spmm`, the bf16 CBSR record, the planner, the autograd pair
and the Trainer against the JAX package's bf16x2 / bf16 streams (CPU), and
each bf16 kernel against its plain version (GPU).

On the CPU the kernel wrappers take their plain versions, which sum the same
bf16 messages in f32. The JAX functions run their Pallas kernels in
interpret mode. Both sides sum the same bf16 values in f32 and differ only
in order, so the products are held within 1e-5 of their largest magnitude.
A fixture restores both packages' DEFAULT_STREAM after each test. The GPU
cases (marker `gpu`) skip without a card; they import no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_stream16.py
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.stream_tiles import (HOT_BUDGET,
                                                      build_stream_plan)
from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan, auto_src_blocks
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels import api as tapi
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.kernels.round import round_rows
from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm
from spgemm_gnn_tpu_torch.kernels.stream import stream_cbsr_spmm, stream_spmm
from spgemm_gnn_tpu_torch.ops import maxk as tmaxk
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.ops.spmm import csr_spmm_plain, round_rows_plain
from spgemm_gnn_tpu_torch.ops.stream import (stream_cbsr_spmm_plain,
                                             stream_spmm_plain)

BF16 = torch.bfloat16


@pytest.fixture(autouse=True)
def restore_streams(monkeypatch):
    """Both packages' DEFAULT_STREAM as they were after the test (a Trainer
    sets its own), starting from "f32"."""
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", "f32")
    try:
        import importlib
        jplanned = importlib.import_module("spgemm_gnn_tpu.kernels.planned")
    except ImportError:     # the card's machine has no JAX
        return
    monkeypatch.setattr(jplanned, "DEFAULT_STREAM", "f32")


def near(got, ref, frac: float = 1e-5) -> None:
    """Within `frac` of ref's largest magnitude: the same bf16 messages
    summed in f32 in another order."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= frac * max(float(np.abs(ref).max()), 1e-30), err


def _graphs(kind: str):
    from spgemm_gnn_tpu.graphs import synthetic as jsyn
    if kind == "symmetric":
        return (jsyn.powerlaw_graph(250, 2500, seed=21),
                tsyn.powerlaw_graph(250, 2500, seed=21))
    return (jsyn.random_graph(200, 1500, seed=5, symmetric=False),
            tsyn.random_graph(200, 1500, seed=5, symmetric=False))


def sparse_ints(rng, n: int, dim: int, k: int) -> np.ndarray:
    """k-sparse rows of bf16-exact values (small integers ± 1/8): the 16-bit
    stream loses nothing on them."""
    x = rng.integers(-8, 9, size=(n, dim)).astype(np.float32)
    x = x + np.float32(0.125) * np.sign(x)
    keep = np.argsort(rng.random((n, dim)), axis=1)[:, :k]
    mask = np.zeros((n, dim), bool)
    np.put_along_axis(mask, keep, True, axis=1)
    return (x * mask).astype(np.float32)


# ---------------------------------------------------------------------------
# CPU: round_rows and the bf16 record
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [8, 30, 64])
@pytest.mark.parametrize("with_pre", [False, True])
def test_round_rows_is_one_rounding_of_the_scaled_rows(width, with_pre, rng):
    """bf16(pre ⊙ x): the f32 product rounded to nearest even, bit-equal to
    JAX's `(x * pre[:, None]).astype(bfloat16)`."""
    import jax.numpy as jnp
    x = rng.standard_normal((40, width)).astype(np.float32)
    pre = (rng.random(40).astype(np.float32) + 0.3) if with_pre else None
    got = round_rows(torch.tensor(x),
                     None if pre is None else torch.tensor(pre))
    assert got.dtype == BF16 and got.shape == (40, width)
    want = jnp.asarray(x if pre is None else x * pre[:, None]).astype(
        jnp.bfloat16)
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy(),
        np.asarray(want).view(np.int16))


@pytest.mark.parametrize("k", [8, 31, 32])
@pytest.mark.parametrize("dim", [32, 256])
def test_bf16_records_round_trip(dim, k, rng):
    """cbsr_records on bf16 values: int32 [N, 32 lines], lines the power of
    two from ceil(k/32), word j the bf16 bits of value j in its high half
    and channel j in its low, zero words past k (128 B at k 32, dim 256:
    one aligned line); split_records gives the values' bits and the
    channels back."""
    if k >= dim:
        pytest.skip("k < dim")
    vals = torch.tensor(rng.standard_normal((30, k)).astype(np.float32)).to(
        BF16)
    vals[3] = 0.0
    vals[4, ::2] = -0.0
    ch = torch.tensor(np.argsort(rng.random((30, dim)), axis=1)[:, :k]
                      .astype(np.int32))
    rec = tmaxk.cbsr_records(vals, ch, dim)
    width = tmaxk.record_words(k, dim, BF16)
    assert width == 32 * 2 ** int(np.ceil(np.log2(-(-k // 32))))
    assert rec.dtype == torch.int32 and rec.shape == (30, width)
    if (k, dim) == (32, 256):
        assert rec.shape[1] * 4 == 128
    words = rec.numpy().view(np.uint32)
    np.testing.assert_array_equal(words[:, :k] >> 16,
                                  vals.view(torch.int16).numpy()
                                  .view(np.uint16))
    np.testing.assert_array_equal(words[:, :k] & 0xffff, ch.numpy())
    assert not words[:, k:].any()
    v2, c2 = tmaxk.split_records(rec, k, dim, BF16)
    assert v2.dtype == BF16
    np.testing.assert_array_equal(v2.view(torch.int16).numpy(),
                                  vals.view(torch.int16).numpy())
    np.testing.assert_array_equal(c2.numpy(), ch.numpy())
    # the f32 layout is as before
    rec32 = tmaxk.cbsr_records(vals.float(), ch, dim)
    assert rec32.shape[1] == k + tmaxk.packed_channel_words(k, dim)
    assert rec32.shape[1] == tmaxk.record_words(k, dim)


@pytest.mark.parametrize("k", [33, 64, 65, 100, 129, 200, 255])
def test_bf16_records_of_several_lines(k, rng):
    """Past k 32 a bf16 record takes 2, 4 or 8 whole lines (the kernel's
    lines a record, `kernels/stream.py::_slices`), and round-trips."""
    from spgemm_gnn_tpu_torch.kernels.stream import _slices
    dim = 256
    vals = torch.tensor(rng.standard_normal((20, k)).astype(np.float32)).to(
        BF16)
    ch = torch.tensor(np.argsort(rng.random((20, dim)), axis=1)[:, :k]
                      .astype(np.int32))
    rec = tmaxk.cbsr_records(vals, ch, dim)
    assert rec.shape == (20, 32 * _slices(k))
    assert not rec[:, k:].any()
    v2, c2 = tmaxk.split_records(rec, k, dim, BF16)
    np.testing.assert_array_equal(v2.view(torch.int16).numpy(),
                                  vals.view(torch.int16).numpy())
    np.testing.assert_array_equal(c2.numpy(), ch.numpy())


def test_source_blocks_sized_by_row_bytes():
    """bf16 rows take half the bytes of f32 ones, so a block of half of L2
    holds twice the rows: Reddit at dim 256 takes 5 blocks instead of 10."""
    from spgemm_gnn_tpu_torch.graphs.datasets import SYNTH_SPECS
    r = SYNTH_SPECS["reddit"]
    assert auto_src_blocks(r["n"], r["e"], 256) == 10
    assert auto_src_blocks(r["n"], r["e"], 256, elem_bytes=2) == 5
    g = tsyn.random_graph(100, 2000, seed=2)
    plan = CSRPlan(g.indptr, g.indices)
    a, b = plan.schedule(100, 8), plan.schedule(100, 8, 2)
    assert plan.schedule(100, 8) is a and plan.schedule(100, 8, 2) is b


# ---------------------------------------------------------------------------
# CPU: each product against the JAX package's 16-bit stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [None, 3])
@pytest.mark.parametrize("dim", [32, 64])
@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_windowed_bf16_matches_jax_planned_spmm(kind, dim, nb):
    """csr_spmm on round_rows(x) against `planned_spmm(stream="bf16x2")`
    (its packed branch in interpret mode), under the rule's schedule and a
    forced one of 3 source blocks."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.planned import plan_graph
    from spgemm_gnn_tpu.kernels.spgemm_pallas import planned_spmm

    jg, tg = _graphs(kind)
    n = tg.num_nodes
    rng = np.random.default_rng(dim + len(kind))
    x = rng.standard_normal((n, dim)).astype(np.float32)
    plan = plan_graph(jg, kind="windowed", tile_slots=128,
                      src_block=128, dst_block=128, window=8).fwd_plan
    xt = np.zeros((dim, plan.padded_src), np.float32)
    xt[:, :n] = x.T
    want = np.asarray(planned_spmm(plan, jnp.asarray(xt), stream="bf16x2",
                                   interpret=True))[:n]
    got = csr_spmm(CSRPlan(tg.indptr, tg.indices, nb), round_rows(
        torch.tensor(x)))
    assert got.dtype == torch.float32
    near(got.numpy(), want)


@pytest.mark.parametrize("chunk", [7, 128])
@pytest.mark.parametrize("dim", [32, 40])
@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_stream_bf16_matches_jax_stream_spmm(kind, dim, chunk):
    """stream_spmm on round_rows(x) against the JAX `stream_spmm(stream=
    "bf16")` (dim 40: a multiple of 8, not of 16, which the stream takes)."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.planned import plan_graph
    from spgemm_gnn_tpu.kernels.stream_pallas import stream_spmm as jstream

    jg, tg = _graphs(kind)
    n = tg.num_nodes
    rng = np.random.default_rng(dim + chunk)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    jplan = plan_graph(jg, kind="stream", tile_slots=128,
                       dst_block=128).fwd_plan
    want = np.asarray(jstream(jplan, jnp.asarray(x), stream="bf16",
                              interpret=True))[:n]
    plan = build_stream_plan(tg.indptr, tg.indices, chunk=chunk)
    near(stream_spmm(plan, round_rows(torch.tensor(x))).numpy(), want)


@pytest.mark.parametrize("dim,k", [(32, 8), (256, 32)])
def test_stream_cbsr_bf16_matches_jax(dim, k):
    """stream_cbsr_spmm on the bf16 record against the JAX
    `stream_spmm_cbsr(stream="bf16x2")`; dim 256 puts channel ids >= 128 in
    every byte of the packed words."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.graphs.stream_tiles import stream_plan_for_graph
    from spgemm_gnn_tpu.graphs.synthetic import powerlaw_graph as jpowerlaw
    from spgemm_gnn_tpu.kernels.stream_pallas import stream_spmm_cbsr
    from spgemm_gnn_tpu.ops.maxk import pack_channels

    jg = jpowerlaw(300, 2400, seed=4)
    tg = tsyn.powerlaw_graph(300, 2400, seed=4)
    n = tg.num_nodes
    rng = np.random.default_rng(dim)
    x = tmaxk.maxk(torch.tensor(rng.standard_normal((n, dim)).astype(
        np.float32)), k)
    vals, ch = tmaxk.cbsr_from_masked(x, k)
    if dim == 256:
        assert int(ch.max()) >= 200
    jplan = stream_plan_for_graph(jg, tile_slots=128, dst_block=128)
    want = np.asarray(stream_spmm_cbsr(
        jplan, jnp.asarray(vals.numpy()), pack_channels(jnp.asarray(
            ch.numpy()), dim), dim, stream="bf16x2", interpret=True))[:n]
    rec = tmaxk.cbsr_records(round_rows(vals), ch, dim)
    plan = build_stream_plan(tg.indptr, tg.indices)
    got = stream_cbsr_spmm(plan, rec, k, dim, value_dtype=BF16)
    near(got.numpy(), want)
    # equal by value to the dense bf16 stream on the same rows
    dense = tmaxk.cbsr_to_dense(round_rows(vals).float(), ch, dim)
    assert torch.equal(got, stream_spmm(plan, dense.to(BF16)))


# ---------------------------------------------------------------------------
# CPU: the planner and the autograd pair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cbsr_forward", [False, True])
@pytest.mark.parametrize("plan_kind", ["windowed", "stream"])
def test_planned_aggregate_bf16_matches_jax(plan_kind, cbsr_forward,
                                            monkeypatch):
    """planned_aggregate forward and input gradient under gcn factors (pre
    and post), with both packages' DEFAULT_STREAM "bf16x2" (and, on the
    stream plan, both STREAM_CBSR_FORWARD flags set, k 8), within 1e-5 of
    max. Rounding x alone and then applying pre differs from the reference
    far beyond that, so this holds the rounding point at pre ⊙ x, in the
    backward at post ⊙ g."""
    import importlib

    import jax
    import jax.numpy as jnp
    jplanned = importlib.import_module("spgemm_gnn_tpu.kernels.planned")

    if cbsr_forward and plan_kind == "windowed":
        pytest.skip("the flag reads stream plans only")
    jg, tg = _graphs("directed")
    n, dim, k = tg.num_nodes, 32, 8
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    x = np.asarray(tmaxk.maxk(torch.tensor(x), k))
    ct = rng.standard_normal((n, dim)).astype(np.float32)
    for mod in (tplanned, jplanned):
        monkeypatch.setattr(mod, "DEFAULT_STREAM", "bf16x2")
        monkeypatch.setattr(mod, "STREAM_CBSR_FORWARD", cbsr_forward)
    jargs = (dict(kind="stream", tile_slots=128, dst_block=128)
             if plan_kind == "stream" else
             dict(kind="windowed", tile_slots=128, src_block=128,
                  dst_block=128, window=8))
    jpg = jplanned.plan_graph(jg, **jargs)
    y_ref, vjp = jax.vjp(lambda v: jplanned.planned_aggregate(
        jpg, v, "gcn", k=k), jnp.asarray(x))
    y_ref, dx_ref = np.asarray(y_ref), np.asarray(vjp(jnp.asarray(ct))[0])

    tpg = tplanned.plan_graph(tg, kind=plan_kind, dim=dim)
    xt = torch.tensor(x, requires_grad=True)
    y = tapi.aggregate(tpg, xt, norm="gcn", k=k, impl="auto")
    (y * torch.tensor(ct)).sum().backward()
    near(y.detach().numpy(), y_ref)
    near(xt.grad.numpy(), dx_ref)
    assert xt.grad.dtype == torch.float32

    # the wrong rounding point: bf16(x), then pre in f32
    pre, post = node_factors(tg, "gcn")
    wrong = csr_spmm_plain(tg.indptr, tg.indices,
                           torch.tensor(x).to(BF16).float(), pre, post)
    err = float(np.abs(wrong.numpy() - y_ref).max())
    assert err > 100 * 1e-5 * float(np.abs(y_ref).max()), err


@pytest.mark.parametrize("plan_kind", ["windowed", "stream"])
def test_bf16_exact_inputs_give_the_f32_result(plan_kind, rng):
    """k-sparse bf16-exact inputs under the sum norm (no factor to round):
    the 16-bit stream loses nothing, so y and dx equal the f32 stream's
    (mirrors the JAX package's test_bf16x2_maxk_sparse_stream)."""
    tg = tsyn.random_graph(200, 1500, seed=5, symmetric=False)
    pg = tplanned.plan_graph(tg, kind=plan_kind)
    x = sparse_ints(rng, 200, 32, 8)
    ct = sparse_ints(rng, 200, 32, 32)
    out = {}
    for stream in ("f32", "bf16x2"):
        tplanned.DEFAULT_STREAM = stream
        xt = torch.tensor(x, requires_grad=True)
        y = tplanned.planned_aggregate(pg, xt, "sum", k=8)
        (y * torch.tensor(ct)).sum().backward()
        out[stream] = (y.detach().numpy(), xt.grad.numpy())
    for a, b in zip(out["f32"], out["bf16x2"]):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_windowed_bf16x2_needs_dim_multiple_of_16(monkeypatch):
    """As the reference's packed stream: dim % 16 != 0 raises on a windowed
    plan (the stream plan takes dim % 8)."""
    import importlib

    import jax.numpy as jnp
    jplanned = importlib.import_module("spgemm_gnn_tpu.kernels.planned")
    from spgemm_gnn_tpu.kernels.spgemm_pallas import planned_spmm

    jg, tg = _graphs("directed")
    jplan = jplanned.plan_graph(jg, kind="windowed", tile_slots=128,
                                src_block=128, dst_block=128,
                                window=8).fwd_plan
    with pytest.raises(ValueError, match="dim % 16"):
        planned_spmm(jplan, jnp.zeros((24, jplan.padded_src)),
                     stream="bf16x2", interpret=True)
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", "bf16x2")
    x = torch.zeros((tg.num_nodes, 24))
    with pytest.raises(ValueError, match="dim % 16"):
        tplanned.planned_aggregate(tplanned.plan_graph(tg, kind="windowed"),
                                   x, "mean")
    y = tplanned.planned_aggregate(tplanned.plan_graph(tg, kind="stream"),
                                   x, "mean")
    assert y.shape == x.shape
    with pytest.raises(ValueError, match="dim % 8"):
        stream_spmm(build_stream_plan(tg.indptr, tg.indices),
                    torch.zeros((tg.num_nodes, 12), dtype=BF16))
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", "f16")
    with pytest.raises(ValueError, match="unknown stream"):
        tplanned.planned_aggregate(tg, x, "mean")


def test_plan_graph_builds_for_the_stream_row_size(monkeypatch):
    """plan_graph(dim=...) builds the hot set at 2 · dim bytes and the
    schedule at 2-byte channels under the 16-bit stream; the f32 ones stay
    as they are, side by side."""
    g = tsyn.random_graph(300, 3000, seed=3)
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", "bf16x2")
    spg = tplanned.plan_graph(g, kind="stream", dim=64)
    hot = spg.fwd_plan.hot_set(128)
    assert spg.fwd_plan._hot[(128, HOT_BUDGET)] is hot
    assert (256, HOT_BUDGET) not in spg.fwd_plan._hot
    f32 = spg.fwd_plan.hot_set(256)
    assert f32 is not hot and spg.fwd_plan.hot_set(128) is hot
    built = []
    real = CSRPlan.schedule

    def counting(self, n, dim, elem_bytes=4):
        built.append(elem_bytes)
        return real(self, n, dim, elem_bytes)

    monkeypatch.setattr(CSRPlan, "schedule", counting)
    tplanned.plan_graph(g, kind="windowed", dim=64)
    assert built == [2]


# ---------------------------------------------------------------------------
# CPU: the slice as a whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nonlinear,epochs", [("relu", 4), ("maxk", 1)])
def test_trainer_bf16x2_matches_jax_trainer(nonlinear, epochs):
    """The port's Trainer against the JAX Trainer (impl "pallas", its
    kernels in interpret mode), both with `stream="bf16x2"`, on the flickr
    stand-in at scale 0.004 (a windowed plan), feat_drop 0, the JAX initial
    weights: per-epoch loss within 1e-4 relative (ReLU over 4 epochs, MaxK
    over the first).

    ReLU is held over 4 epochs, not the 5 of the f32 test
    (tests/test_torch_train.py): the two frameworks' f32 matmuls differ in
    the last bit, and where that moves a message across a bf16 rounding
    boundary the message changes by a bf16 step (2^-8), which Adam then
    carries. At this seed the 5th epoch reads 1.4e-4 (seed 1: 6.6e-4 at the
    5th; seeds 2 and 4 stay under 1.2e-5 over 6), where the f32 stream stays
    under 4e-6 over 8 epochs (CPU; ROADMAP, divergences recorded)."""
    import jax
    from spgemm_gnn_tpu.graphs.datasets import load_dataset as jload
    from spgemm_gnn_tpu.train.config import TrainConfig as JConfig
    from spgemm_gnn_tpu.train.loop import Trainer as JTrainer
    from spgemm_gnn_tpu_torch.convert import params_from_flax
    from spgemm_gnn_tpu_torch.graphs.datasets import Dataset
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    common = dict(dataset="flickr", model="sage", epochs=epochs,
                  hidden_dim=32, hidden_layers=2, maxk=8, dropout=0.0,
                  w_lr=0.01, nonlinear=nonlinear, norm=True, synthetic=True,
                  synthetic_scale=0.004, eval_every=1, log_every=0, seed=3,
                  stream="bf16x2")
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
    assert tplanned.DEFAULT_STREAM == "bf16x2" and tt.g.kind == "windowed"
    weights = params_from_flax(jax.device_get(jt.init_state()["params"]))
    tres = tt.run(state=tt.init_state(weights=weights))
    jl = np.array([r.loss for r in jres["history"]])
    tl = np.array([r.loss for r in tres["history"]])
    assert len(tl) == len(jl) == epochs
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)


def test_cli_trains_bf16x2_on_cpu(tmp_path):
    """`python -m spgemm_gnn_tpu_torch.train --stream bf16x2 --device cpu`
    runs the plain versions of the 16-bit stream."""
    from spgemm_gnn_tpu_torch.train.__main__ import main as tmain
    res = tmain(["--dataset", "flickr", "--synthetic", "--synthetic_scale",
                 "0.003", "--epochs", "3", "--hidden_dim", "16",
                 "--hidden_layers", "1", "--maxk", "4", "--device", "cpu",
                 "--stream", "bf16x2", "--path", str(tmp_path)])
    assert len(res["history"]) == 3
    assert all(np.isfinite(r.loss) for r in res["history"])
    assert tplanned.DEFAULT_STREAM == "bf16x2"


# ---------------------------------------------------------------------------
# GPU: the bf16 kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return t.view(torch.int16 if t.dtype == BF16 else torch.int32).numpy()


def hub_graph(n: int = 700, seed: int = 0):
    """Directed, with rows without edges and a hub row of 3000 edges."""
    rng = np.random.default_rng(seed)
    degrees = rng.integers(0, 12, n)
    degrees[::50] = 0
    degrees[3] = 3000
    dst = np.repeat(np.arange(n), degrees)
    return from_edges(rng.integers(0, n, dst.size), dst, n, symmetric=False)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [8, 30, 256])
@pytest.mark.parametrize("with_pre", [False, True])
def test_round_rows_bitwise_plain_on_gpu(cuda, width, with_pre):
    rng = np.random.default_rng(width)
    x = torch.tensor(rng.standard_normal((1000, width)).astype(np.float32),
                     device=cuda)
    x[::7] *= 1e-39       # f32 subnormals
    pre = (torch.tensor(rng.random(1000).astype(np.float32), device=cuda)
           if with_pre else None)
    np.testing.assert_array_equal(_bits(round_rows(x, pre)),
                                  _bits(round_rows_plain(x, pre)))


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [None, 1, 4])
@pytest.mark.parametrize("dim", [16, 256, 264])
def test_csr_spmm_bf16_matches_plain_on_gpu(cuda, dim, nb):
    """On A and Aᵀ with a post factor: within 1e-5 of max |y| of the plain
    version in float64 on the same bf16 rows, bitwise equal across two runs
    and launched as csr_spmm_bf16."""
    g = hub_graph().to(cuda)
    rng = np.random.default_rng(dim)
    x = torch.tensor(rng.standard_normal((700, dim)).astype(np.float32),
                     device=cuda)
    post = torch.tensor(rng.random(700).astype(np.float32) + 0.5, device=cuda)
    xr = round_rows(x, post.flip(0))
    for indptr, indices in ((g.indptr, g.indices), (g.t_indptr, g.t_indices)):
        plan = CSRPlan(indptr, indices, nb, 64)
        _build.launches.clear()
        y = csr_spmm(plan, xr, None, post)
        again = csr_spmm(plan, xr, None, post)
        assert dict(_build.launches) == {"csr_spmm_bf16": 2}
        ref = csr_spmm_plain(indptr, indices, xr.double(), None, post)
        near(y.cpu(), ref.cpu())
        np.testing.assert_array_equal(_bits(y), _bits(again))


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [7, 128])
@pytest.mark.parametrize("dim", [8, 256, 520])
def test_stream_spmm_bf16_matches_plain_on_gpu(cuda, dim, chunk):
    """On A and Aᵀ: within 1e-5 of max |y| of the plain version in float64
    on the same bf16 rows, bitwise equal across two runs, hot budgets (none,
    a few rows, every row), fetch depths and warp spans of 1 and 3 chunks."""
    from spgemm_gnn_tpu_torch.kernels import stream as tstream
    g = hub_graph(seed=1).to(cuda)
    rng = np.random.default_rng(dim + chunk)
    x = torch.tensor(rng.standard_normal((700, dim)).astype(np.float32),
                     device=cuda)
    f = torch.tensor(rng.random(700).astype(np.float32) + 0.5, device=cuda)
    xr = round_rows(x, f)
    row = 2 * dim
    for indptr, indices in ((g.indptr, g.indices), (g.t_indptr, g.t_indices)):
        plan = build_stream_plan(indptr, indices, chunk=chunk)
        _build.launches.clear()
        y = stream_spmm(plan, xr, None, f.flip(0))
        assert dict(_build.launches) == {"stream_spmm_bf16": 1}
        ref = stream_spmm_plain(plan, xr.double(), None, f.flip(0))
        near(y.cpu(), ref.cpu())
        depths = tstream.DEPTHS[tstream._slices(row // 16)]
        for budget, depth in ((0, None), (5 * row, None), (700 * row, None),
                              *((None, d) for d in depths)):
            other = tstream.stream_spmm_at(plan, xr, None, f.flip(0),
                                           hot_budget=budget, depth=depth)
            np.testing.assert_array_equal(_bits(y), _bits(other))
        for wc in (1, 3):
            span = build_stream_plan(indptr, indices, chunk=chunk,
                                     warp_chunks=wc)
            np.testing.assert_array_equal(
                _bits(y), _bits(stream_spmm(span, xr, None, f.flip(0))))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 31, 32, 64, 100, 200])
def test_stream_cbsr_spmm_bf16_matches_plain_on_gpu(cuda, k):
    """dim 256, gcn-like factors folded into the values: within 1e-5 of max
    |y| of the plain version in float64, equal by value to stream_spmm_bf16
    on the densified bf16 rows, bitwise equal across runs, hot budgets and
    batches. k 100 and 200 put a record's ids across two of a lane's
    loaded words."""
    from spgemm_gnn_tpu_torch.kernels import stream as tstream
    dim = 256
    g = hub_graph(seed=2).to(cuda)
    rng = np.random.default_rng(k)
    x = tmaxk.maxk(torch.tensor(rng.standard_normal((700, dim)).astype(
        np.float32), device=cuda), k)
    pre = torch.tensor(rng.random(700).astype(np.float32) + 0.5, device=cuda)
    post = pre.flip(0)
    vals, ch = tmaxk.cbsr_compact_plain(x, k)
    v16 = round_rows(vals.contiguous(), pre)
    rec = tmaxk.cbsr_records(v16, ch, dim)
    dense = tmaxk.cbsr_to_dense(v16.float(), ch, dim).to(BF16)
    row = 4 * rec.shape[1]
    plan = build_stream_plan(g.indptr, g.indices)
    _build.launches.clear()
    y = stream_cbsr_spmm(plan, rec, k, dim, None, post, BF16)
    assert dict(_build.launches) == {"stream_cbsr_spmm_bf16": 1}
    ref = stream_cbsr_spmm_plain(plan, rec, k, dim, None, post, BF16)
    near(y.cpu(), stream_spmm_plain(plan, dense.double(), None, post).cpu())
    near(y.cpu(), ref.cpu())
    assert torch.equal(y, stream_spmm(plan, dense, None, post))
    batches = tstream.BATCHES16[tstream._slices(k)]
    for budget, batch in ((0, None), (5 * row, None), (700 * row, None),
                          *((None, b) for b in batches)):
        other = tstream.stream_cbsr_spmm_at(plan, rec, k, dim, None, post,
                                            hot_budget=budget, batch=batch,
                                            value_dtype=BF16)
        np.testing.assert_array_equal(_bits(y), _bits(other))


@pytest.mark.gpu
@pytest.mark.parametrize("out", ["f32", "bf16"])
@pytest.mark.parametrize("k", [8, 32, 64, 100, 200])
def test_stream_cbsr16_across_spans_on_gpu(cuda, k, out):
    """The bf16-record kernel (stream_cbsr16_kernel, both outputs) across
    warp spans of 1, 3 and 8 chunks of 7 edges, every batch of edges in
    flight and hot budgets of 0, a few records and every record: the f32
    output equal by value to stream_spmm_bf16 on the densified rows, the
    bf16 output bitwise equal to stream_spmm_bf16_out's, each run bitwise
    equal to the default and to a second run."""
    from spgemm_gnn_tpu_torch.kernels import stream as tstream
    dim = 256
    g = hub_graph(seed=4).to(cuda)
    rng = np.random.default_rng(k + 1)
    x = tmaxk.maxk(torch.tensor(rng.standard_normal((700, dim)).astype(
        np.float32), device=cuda), k).to(BF16)
    post = torch.tensor(rng.random(700).astype(np.float32) + 0.5,
                        device=cuda)
    vals, ch = tmaxk.cbsr_compact_plain(x, k)
    rec = tmaxk.cbsr_records(vals, ch, dim)
    od = BF16 if out == "bf16" else None
    row = 4 * rec.shape[1]
    for wc in (1, 3, 8):
        plan = build_stream_plan(g.indptr, g.indices, chunk=7,
                                 warp_chunks=wc)
        y = stream_cbsr_spmm(plan, rec, k, dim, None, post, BF16, od)
        dense = stream_spmm(plan, x, None, post, out_dtype=od)
        if od is None:
            assert torch.equal(y, dense)
        else:
            np.testing.assert_array_equal(_bits(y), _bits(dense))
        np.testing.assert_array_equal(_bits(y), _bits(stream_cbsr_spmm(
            plan, rec, k, dim, None, post, BF16, od)))
        for budget, batch in ((0, None), (5 * row, None), (700 * row, None),
                              *((None, b) for b in
                                tstream.BATCHES16[tstream._slices(k)])):
            other = tstream.stream_cbsr_spmm_at(
                plan, rec, k, dim, None, post, hot_budget=budget,
                batch=batch, value_dtype=BF16, out_dtype=od)
            np.testing.assert_array_equal(_bits(y), _bits(other))


@pytest.mark.gpu
@pytest.mark.parametrize("plan_kind,flag", [("windowed", False),
                                            ("stream", False),
                                            ("stream", True)])
def test_bf16x2_aggregate_launches_only_bf16_kernels_on_gpu(
        cuda, plan_kind, flag, monkeypatch):
    """Under DEFAULT_STREAM "bf16x2" a k-sparse aggregation forward and
    backward launches round_rows and the bf16 kernels, and no f32
    aggregation kernel; y and dx within 1e-5 of max of the same path
    through the plain versions."""
    g = tsyn.powerlaw_graph(600, 6000, seed=9).to(cuda)
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", "bf16x2")
    pg = tplanned.plan_graph(g, kind=plan_kind, dim=256)
    x = tmaxk.maxk(torch.randn((600, 256), device=cuda), 32)
    ct = torch.randn((600, 256), device=cuda)
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", flag)
    out = {}
    for plain in (False, True):
        if plain:   # every wrapper takes its plain version
            monkeypatch.setattr(_build, "on_cpu", lambda t: True)
        xt = x.clone().requires_grad_(True)
        _build.launches.clear()
        y = tapi.aggregate(pg, xt, "gcn", k=32, impl="auto")
        (y * ct).sum().backward()
        out[plain] = (y.detach(), xt.grad, dict(_build.launches))
    kernel = {"windowed": "csr_spmm_bf16", "stream": "stream_spmm_bf16"}
    want = ({"cbsr_compact": 1, "round_rows": 2,
             "stream_cbsr_spmm_bf16": 1, "stream_spmm_bf16": 1} if flag else
            {"round_rows": 2, kernel[plan_kind]: 2})
    assert out[False][2] == want
    assert out[True][2] == {}
    for a, b in zip(out[False][:2], out[True][:2]):
        near(a.cpu(), b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("plan_kind", ["windowed", "stream"])
def test_bf16x2_missing_or_failing_kernel_raises_on_gpu(cuda, plan_kind,
                                                        monkeypatch):
    """No fallback: under the 16-bit stream a CUDA tensor whose kernel
    library does not build, or whose bf16 kernel refuses the launch, raises;
    neither the plain version nor the f32 kernel runs instead."""
    g = tsyn.powerlaw_graph(300, 3000, seed=5).to(cuda)
    pg = tplanned.plan_graph(g, kind=plan_kind)
    x = torch.randn((300, 64), device=cuda)
    monkeypatch.setattr(tplanned, "DEFAULT_STREAM", "bf16x2")
    name = "csr_spmm_bf16" if plan_kind == "windowed" else "stream_spmm_bf16"
    lib = "spmm" if plan_kind == "windowed" else "stream"
    real = _build.library

    def missing(which):
        if which == lib:
            raise RuntimeError("kernel build failed: (missing)")
        return real(which)

    class Refusing:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, fn):
            if fn == name:
                return lambda *args: 1      # cudaErrorInvalidValue
            return getattr(self.inner, fn)

    for fake, match in ((missing, "build failed"),
                        (lambda which: Refusing(real(which))
                         if which == lib else real(which), "CUDA error 1")):
        monkeypatch.setattr(_build, "library", fake)
        _build.launches.clear()
        with pytest.raises(RuntimeError, match=match):
            tplanned.planned_aggregate(pg, x, "mean")
        assert set(_build.launches) <= {"round_rows"}
