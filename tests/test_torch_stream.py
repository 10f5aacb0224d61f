"""The port's low-degree path (StreamPlan, `stream_spmm`, the plan-kind rule,
the planned Trainer) against the JAX package (CPU), and the `stream_spmm`
kernel against its plain version (GPU).

On the CPU the kernel wrapper takes its plain version (ops/stream.py), which
follows the plan as the kernel does. The GPU cases (marker `gpu`) skip
without a card; they import no JAX, so that they run where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_stream.py
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs import tiles as ttiles
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.stream_tiles import (StreamPlan,
                                                      build_stream_plan)
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels import api as tapi
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.kernels.stream import stream_spmm, stream_spmm_at
from spgemm_gnn_tpu_torch.ops import spmm as tspmm_plain
from spgemm_gnn_tpu_torch.ops.stream import stream_spmm_plain

# in-degrees with empty rows at the start, in the middle and at the end, a
# hub row of 20 edges, and rows that end on multiples of 4 and 8
DEGREES = [0, 0, 3, 5, 0, 20, 4, 0, 1, 2, 0, 0]


def degree_graph(degrees, seed: int = 0):
    """A directed graph with the given in-degrees (sources at random)."""
    rng = np.random.default_rng(seed)
    n = len(degrees)
    dst = np.repeat(np.arange(n), degrees)
    src = rng.integers(0, n, dst.size)
    return from_edges(src, dst, n, symmetric=False)


# ---------------------------------------------------------------------------
# CPU: the plan-kind rule against the JAX package's
# ---------------------------------------------------------------------------

SPECS = ("reddit", "flickr", "yelp", "ogbn-arxiv", "ogbn-products",
         "ogbn-proteins")


@pytest.mark.parametrize("name", SPECS)
def test_plan_kind_matches_jax_at_full_size(name):
    """The stand-ins' N and E at scale 1.0: every sizing helper and the kind
    equal the JAX package's (flickr, yelp, arxiv and products take the
    stream plan, reddit and proteins the windowed one)."""
    from spgemm_gnn_tpu.graphs import stream_tiles as jstream
    from spgemm_gnn_tpu.graphs import tiles as jtiles
    from spgemm_gnn_tpu.graphs.datasets import SYNTH_SPECS as JSPECS
    from spgemm_gnn_tpu.kernels.planned import WINDOWED_FILL_CUTOVER
    from spgemm_gnn_tpu_torch.graphs.datasets import SYNTH_SPECS

    assert SYNTH_SPECS[name] == JSPECS[name]
    n, e = SYNTH_SPECS[name]["n"], SYNTH_SPECS[name]["e"]
    for b in (128, 256, 512):
        assert ttiles.auto_window(n, e, b) == jtiles.auto_window(n, e, b)
    rw = jtiles.auto_window(n, e, 256)
    fill = jstream.predicted_windowed_fill(n, e, 256, n, rw)
    assert ttiles.predicted_windowed_fill(n, e, 256, n, rw) == fill
    want = "windowed" if fill >= WINDOWED_FILL_CUTOVER else "stream"
    assert tplanned.plan_kind(n, e) == want
    assert want == ("windowed" if name in ("reddit", "ogbn-proteins")
                    else "stream")


@pytest.mark.parametrize("name,scale,kind,fill", [
    ("flickr", 0.3, "stream", 0.1918), ("flickr", 0.004, "windowed", 1.0),
    ("ogbn-products", 0.01, "windowed", 1.0)])
def test_plan_kind_of_built_stand_ins(name, scale, kind, fill):
    """Built stand-ins: the realised N and E give the JAX rule's fill
    (within 1e-4, the digits stated) and plan_graph picks its kind."""
    from spgemm_gnn_tpu.graphs.stream_tiles import predicted_windowed_fill
    from spgemm_gnn_tpu.graphs.tiles import auto_window
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset

    g = load_dataset(name, "/nonexistent", allow_synthetic=True,
                     synthetic_scale=scale, seed=97).graph
    n, e = g.num_nodes, g.num_edges
    got = predicted_windowed_fill(n, e, 256, n, auto_window(n, e, 256))
    assert abs(got - fill) < 1e-4
    pg = tplanned.plan_graph(g)
    assert pg.kind == kind
    assert isinstance(pg.fwd_plan, StreamPlan) == (kind == "stream")


def test_plan_graph_kinds_and_aliasing():
    sym = tsyn.powerlaw_graph(100, 600, seed=1)
    directed = tsyn.random_graph(100, 600, seed=2, symmetric=False)
    for kind in ("windowed", "stream"):
        pg = tplanned.plan_graph(sym, kind=kind)
        assert pg.kind == kind and pg.bwd_plan is pg.fwd_plan
        pd = tplanned.plan_graph(directed, kind=kind)
        assert pd.bwd_plan is not pd.fwd_plan
        assert torch.equal(pd.bwd_plan.indices, directed.t_indices)
    assert pg.num_nodes == sym.num_nodes and pg.indices is sym.indices
    with pytest.raises(ValueError, match="unknown plan kind"):
        tplanned.plan_graph(sym, kind="windowed_classes")
    with pytest.raises(ValueError, match="chunk"):
        tplanned.plan_graph(sym, kind="stream", chunk=0)


# ---------------------------------------------------------------------------
# CPU: the plan's contract
# ---------------------------------------------------------------------------

def walk_plan(plan: StreamPlan):
    """The kernel's walk, in Python: a warp per span of `warp_chunks`
    chunks. Per row the edges its segments cover and the spans whose warp
    writes it (and whether whole), and each chunk's carry row."""
    ip = plan.indptr.numpy().astype(np.int64)
    n_edges, c, wc = plan.num_edges, plan.chunk, plan.warp_chunks
    covered = np.zeros(plan.num_rows, np.int64)
    writes: dict[int, list[tuple[int, bool]]] = {}
    carry_of: dict[int, int] = {}
    row0 = plan.chunk_row0.numpy().astype(np.int64)
    for s0 in range(0, plan.num_chunks, wc):
        span_lo = s0 * c
        span_hi = min(min(s0 + wc, plan.num_chunks) * c, n_edges)
        for q in range(s0, min(s0 + wc, plan.num_chunks)):
            lo, hi, r, e = q * c, min(q * c + c, n_edges), row0[q], q * c
            while e < hi:
                rs, re = ip[r], ip[r + 1]
                if rs == re:
                    r += 1
                    continue
                assert rs <= e < re          # the walk stands inside row r
                end = min(re, hi)
                covered[r] += end - e
                if rs < span_lo:             # began before the span
                    assert e == lo and q not in carry_of
                    carry_of[q] = r
                elif re <= hi or hi == span_hi:   # the warp writes it here
                    writes.setdefault(r, []).append((s0, re <= span_hi))
                e, r = end, r + 1
    return covered, writes, carry_of


@pytest.mark.parametrize("chunk", [1, 3, 4, 5, 8, 35, 128])
def test_stream_plan_conserves_edges_and_covers_rows(chunk):
    """Every edge is summed once; every row is written once by the chunk pass
    or is a carry row; a carry row is empty or reaches past the span of
    warp_chunks chunks where it starts, and the carry slots of its chunks
    past that span all belong to it. Chunk 4 ends chunks mid-row (edge 4)
    and at a row end (edge 8), and chunk 3 inside the hub row; spans of 1
    chunk are the first design's per-chunk rule."""
    g = degree_graph(DEGREES)
    ip = g.indptr.numpy().astype(np.int64)
    n_edges = g.num_edges
    for wc in (1, 2, 3, 8):
        plan = build_stream_plan(g.indptr, g.indices, chunk=chunk,
                                 warp_chunks=wc)
        assert plan.num_chunks == -(-n_edges // chunk)
        np.testing.assert_array_equal(
            plan.chunk_row0.numpy(),
            np.searchsorted(ip, np.arange(0, n_edges, chunk), side="right")
            - 1)
        covered, writes, carry_of = walk_plan(plan)
        np.testing.assert_array_equal(covered, np.diff(ip))
        carry = set(plan.carry_rows.tolist())
        assert plan.carry_rows.tolist() == sorted(carry)
        span = chunk * wc
        for r in range(g.num_nodes):
            a, b = ip[r], ip[r + 1]
            if a == b:
                assert r in carry and r not in writes
                continue
            (s0, whole), = writes[r]         # one direct write per row
            assert s0 == a // span * wc
            assert (r in carry) == (not whole) == (a // span != (b - 1) // span)
            for q2 in range((a // span + 1) * wc, (b - 1) // chunk + 1):
                assert carry_of[q2] == r
        assert len(carry_of) == sum(
            max((b - 1) // chunk - (a // span + 1) * wc + 1, 0)
            for a, b in zip(ip[:-1], ip[1:]) if a < b)


def test_stream_plan_without_edges():
    g = degree_graph([0, 0, 0])
    plan = build_stream_plan(g.indptr, g.indices, chunk=4)
    assert plan.num_chunks == 0 and plan.carry_rows.tolist() == [0, 1, 2]
    y = stream_spmm(plan, torch.ones((3, 8)))
    assert torch.equal(y, torch.zeros((3, 8)))


@pytest.mark.parametrize("chunk", [1, 3, 8, 128])
def test_stream_plain_matches_csr_plain(chunk, rng):
    """Float64, so the check reads the plan, not the summation order: to
    1e-12. Rows with no in-edges come out exactly 0."""
    g = degree_graph(DEGREES, seed=chunk)
    x = torch.tensor(rng.standard_normal((g.num_nodes, 12)))
    pre = torch.tensor(rng.random(g.num_nodes))
    post = torch.tensor(rng.random(g.num_nodes))
    for indptr, indices in ((g.indptr, g.indices),
                            (g.t_indptr, g.t_indices)):
        plan = build_stream_plan(indptr, indices, chunk=chunk)
        y = stream_spmm_plain(plan, x, pre, post)
        ref = tspmm_plain.csr_spmm_plain(indptr, indices, x, pre, post)
        np.testing.assert_allclose(y.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-12)
        empty = (indptr.diff() == 0).numpy()
        assert (y.numpy()[empty] == 0).all()
    assert (g.indptr.diff() == 0).any()      # DEGREES has empty rows


def test_stream_plain_chunks_edges(monkeypatch, rng):
    """Segment sums in edge chunks under the byte cap give the unchunked
    result (to 1e-6: the same f32 terms in the same order)."""
    g = tsyn.random_graph(60, 400, seed=3, symmetric=False)
    plan = build_stream_plan(g.indptr, g.indices, chunk=5)
    x = torch.tensor(rng.standard_normal((60, 8)).astype(np.float32))
    whole = stream_spmm_plain(plan, x)
    monkeypatch.setattr(tspmm_plain, "_MSG_BYTES_CAP", 7 * 8 * 4)
    chunked = stream_spmm_plain(plan, x)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# CPU: the stream pair against JAX planned_aggregate (stream kind) and spmm
# ---------------------------------------------------------------------------

DIM = 128


def _graphs(kind: str):
    from spgemm_gnn_tpu.graphs import synthetic as jsyn
    if kind == "symmetric":
        return (jsyn.powerlaw_graph(250, 2500, seed=21),
                tsyn.powerlaw_graph(250, 2500, seed=21))
    return (jsyn.random_graph(200, 1500, seed=5, symmetric=False),
            tsyn.random_graph(200, 1500, seed=5, symmetric=False))


@pytest.mark.parametrize("chunk", [7, 128])
@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_stream_aggregate_matches_jax(kind, norm, chunk):
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.graphs.stream_tiles import StreamPlan as JStreamPlan
    from spgemm_gnn_tpu.kernels.planned import plan_graph, planned_aggregate
    from spgemm_gnn_tpu.ops.spmm import spmm as jspmm

    jg, tg = _graphs(kind)
    rng = np.random.default_rng(len(kind) + len(norm) + chunk)
    x = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)
    ct = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)

    def jax_pair(fn):
        y, vjp = jax.vjp(fn, jnp.asarray(x))
        return np.asarray(y), np.asarray(vjp(jnp.asarray(ct))[0])

    jpg = plan_graph(jg, kind="stream", tile_slots=128, dst_block=128)
    assert isinstance(jpg.fwd_plan, JStreamPlan)
    refs = [jax_pair(lambda v: planned_aggregate(jpg, v, norm)),
            jax_pair(lambda v: jspmm(jg, v, norm))]
    tpg = tplanned.plan_graph(tg, kind="stream", chunk=chunk)
    for impl in ("auto", "torch"):      # stream pair (plain on CPU), oracle
        xt = torch.tensor(x, requires_grad=True)
        y = tapi.aggregate(tpg, xt, norm=norm, k=None, impl=impl)
        (y * torch.tensor(ct)).sum().backward()
        for y_ref, dx_ref in refs:
            # only the f32 summation order differs: rtol 1e-5, and atol 1e-6
            # of the output's scale (as tests/test_torch_kernels.py)
            for got, ref in ((y.detach().numpy(), y_ref),
                             (xt.grad.numpy(), dx_ref)):
                np.testing.assert_allclose(
                    got, ref, rtol=1e-5,
                    atol=1e-6 * max(1.0, float(np.abs(ref).max())))


def test_stream_cotangent_keeps_primal_dtype(rng):
    g = tsyn.random_graph(30, 120, seed=4)
    pg = tplanned.plan_graph(g, kind="stream", chunk=8)
    x = torch.tensor(rng.standard_normal((30, 8)), requires_grad=True)
    tplanned.planned_aggregate(pg, x, "gcn").sum().backward()
    assert x.grad.dtype == torch.float64 and x.grad.shape == x.shape


# ---------------------------------------------------------------------------
# CPU: the slice as a whole
# ---------------------------------------------------------------------------

TRAIN = dict(dataset="flickr", model="sage", epochs=5, hidden_dim=32,
             hidden_layers=2, maxk=8, dropout=0.0, w_lr=0.01,
             nonlinear="maxk", norm=True, synthetic=True,
             synthetic_scale=0.3, eval_every=1, log_every=0, seed=3)


def _jax_and_port_histories(cfg: dict, stream_chunk: int | None = None):
    """The JAX Trainer (impl "xla") and the port's Trainer (impl "auto", the
    CPU, the JAX initial weights) on one dataset's numpy arrays: (JAX
    history, port history, number of val nodes). `stream_chunk` replaces the
    port's planned graph by a stream plan of that chunk size (the rule
    itself would pick the windowed kind)."""
    import jax
    from spgemm_gnn_tpu.graphs.datasets import load_dataset as jload
    from spgemm_gnn_tpu.train.config import TrainConfig as JConfig
    from spgemm_gnn_tpu.train.loop import Trainer as JTrainer
    from spgemm_gnn_tpu_torch.convert import params_from_flax
    from spgemm_gnn_tpu_torch.graphs.datasets import Dataset
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    jd = jload(cfg["dataset"], "/nonexistent", allow_synthetic=True,
               synthetic_scale=cfg["synthetic_scale"], seed=cfg["seed"])
    jt = JTrainer(JConfig(impl="xla", **cfg), dataset=jd)
    jres = jt.run()

    td = Dataset(name=jd.name,
                 graph=from_edges(np.asarray(jd.graph.indices),
                                  np.asarray(jd.graph.edge_dst),
                                  jd.graph.num_nodes),
                 features=jd.features, labels=jd.labels,
                 train_mask=jd.train_mask, val_mask=jd.val_mask,
                 test_mask=jd.test_mask, num_classes=jd.num_classes,
                 multilabel=jd.multilabel)
    tt = Trainer(TrainConfig(impl="auto", device="cpu", **cfg), dataset=td)
    assert isinstance(tt.g, tplanned.PlannedGraph)
    if stream_chunk is not None:
        assert tt.g.kind == "windowed"
        tt.g = tplanned.plan_graph(tt.g.graph, kind="stream",
                                   chunk=stream_chunk)
    assert tt.g.kind == "stream"
    weights = params_from_flax(jax.device_get(jt.init_state()["params"]))
    tres = tt.run(state=tt.init_state(weights=weights))
    return jres["history"], tres["history"], int(jd.val_mask.sum())


def _assert_follows(jh, th, epochs: int, val_nodes: int, n_val: int):
    """Per-epoch loss within 1e-4 (as tests/test_torch_train.py) and val
    accuracy within `val_nodes` nodes."""
    jl = np.array([r.loss for r in jh])
    tl = np.array([r.loss for r in th])
    assert len(tl) == len(jl) == epochs
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    for rj, rt in zip(jh, th):
        assert abs(rj.val_acc - rt.val_acc) * n_val <= val_nodes + 1e-6


@pytest.mark.parametrize("nonlinear,epochs,val_nodes",
                         [("relu", 5, 1), ("maxk", 1, 5)])
def test_trainer_on_stream_plan_matches_jax_trainer(nonlinear, epochs,
                                                    val_nodes):
    """The flickr stand-in at scale 0.3, where the rule picks the stream
    plan: the port's planned Trainer follows the JAX Trainer's per-epoch
    loss within 1e-4 and its val accuracy within `val_nodes` nodes.

    MaxK is held over its first epoch only here, and its val accuracy to 5
    of the 5355 val nodes: at this size (53k rows through MaxK per step) a
    near-tie at the k-th value flips on the last bit in which XLA's and
    PyTorch's f32 matmuls differ (PERF.md, Findings). Five MaxK epochs on the
    stream kernel pair are held at a smaller size in the next test."""
    cfg = {**TRAIN, "nonlinear": nonlinear, "epochs": epochs}
    jh, th, n_val = _jax_and_port_histories(cfg)
    _assert_follows(jh, th, epochs, val_nodes, n_val)


@pytest.mark.parametrize("chunk", [7, 128])
def test_trainer_on_forced_stream_plan_follows_jax_maxk(chunk):
    """MaxK for 5 epochs on the stream kernel pair: the flickr stand-in at
    scale 0.004 (the size at which tests/test_torch_train.py holds the
    windowed Trainer), its graph planned with kind "stream" (chunks of 7
    edges end inside most rows; 128 is the default chunk). Per-epoch loss
    within 1e-4 of the JAX Trainer's, val accuracy within one node."""
    cfg = {**TRAIN, "synthetic_scale": 0.004}
    jh, th, n_val = _jax_and_port_histories(cfg, stream_chunk=chunk)
    _assert_follows(jh, th, cfg["epochs"], 1, n_val)


def test_stream_trainer_follows_plain_trainer_maxk():
    """MaxK for 5 epochs at the flickr 0.3 size, where the rule picks the
    stream plan: the port's Trainer through the stream kernel pair (impl
    "auto") against the port's Trainer on the plain ops and the raw graph
    (impl "torch"), the same initial weights. Per-epoch loss within 1e-4,
    val accuracy within one node. Against the JAX Trainer both paths drift
    alike (the near-tie flips above), so the drift is not the stream
    pair's."""
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    ds = load_dataset("flickr", "/nonexistent", allow_synthetic=True,
                      synthetic_scale=TRAIN["synthetic_scale"],
                      seed=TRAIN["seed"])
    cfg = TrainConfig(device="cpu", **TRAIN)
    stream = Trainer(cfg.replace(impl="auto"), dataset=ds)
    plain = Trainer(cfg.replace(impl="torch"), dataset=ds)
    assert stream.g.kind == "stream"
    assert not isinstance(plain.g, tplanned.PlannedGraph)
    _assert_follows(plain.run()["history"], stream.run()["history"],
                    TRAIN["epochs"], 1, int(ds.val_mask.sum()))


def test_trainer_plans_for_kernel_impls_only():
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    cfg = TrainConfig(**{**TRAIN, "synthetic_scale": 0.004}, device="cpu")
    assert isinstance(Trainer(cfg.replace(impl="auto")).g,
                      tplanned.PlannedGraph)
    assert not isinstance(Trainer(cfg.replace(impl="torch")).g,
                          tplanned.PlannedGraph)


@pytest.mark.parametrize("nonlinear", ["maxk", "relu"])
def test_sage_on_stream_plan_matches_jax(nonlinear):
    """SAGE forward and input gradient on a stream-planned graph against the
    flax SAGE (tolerance 2e-4, as tests/test_torch_model.py)."""
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.graphs.synthetic import powerlaw_graph as jpowerlaw
    from spgemm_gnn_tpu.models.models import build_model as jbuild
    from spgemm_gnn_tpu_torch.convert import params_from_flax
    from spgemm_gnn_tpu_torch.models.models import build_model as tbuild

    n, in_dim, out = 80, 12, 5
    jg = jpowerlaw(n, 400, seed=7)
    tg = tplanned.plan_graph(tsyn.powerlaw_graph(n, 400, seed=7),
                             kind="stream", chunk=6)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((n, in_dim)).astype(np.float32)
    ct = rng.standard_normal((n, out)).astype(np.float32)
    kw = dict(hidden_dim=16, num_layers=2, out_dim=out, maxk=4,
              feat_drop=0.0, use_norm=True, nonlinear=nonlinear)
    jm = jbuild("sage", impl="xla", **kw)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jg, jnp.asarray(x),
                     train=False)["params"]
    out_j, vjp = jax.vjp(
        lambda v: jm.apply({"params": params}, jg, v, train=False),
        jnp.asarray(x))
    gx_j = vjp(jnp.asarray(ct))[0]

    tm = tbuild("sage", in_dim=in_dim, impl="auto", **kw)
    tm.load_state_dict(params_from_flax(jax.device_get(params)))
    xt = torch.tensor(x, requires_grad=True)
    out_t = tm(tg, xt)
    (out_t * torch.tensor(ct)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=2e-4,
                               atol=2e-4)


def test_cli_trains_products_recipe_on_cpu(tmp_path):
    """The products recipe's flags, with no new one, at a small size."""
    from spgemm_gnn_tpu_torch.train.__main__ import main as tmain
    res = tmain(["--dataset", "ogbn-products", "--synthetic",
                 "--synthetic_scale", "0.001", "--model", "sage",
                 "--nonlinear", "maxk", "--maxk", "8", "--hidden_layers", "3",
                 "--hidden_dim", "32", "--dropout", "0.5", "--norm",
                 "--w_lr", "0.003", "--epochs", "2", "--device", "cpu",
                 "--path", str(tmp_path)])
    assert len(res["history"]) == 2
    assert all(np.isfinite(r.loss) for r in res["history"])


# ---------------------------------------------------------------------------
# GPU: the stream_spmm kernel against its plain version (skip without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().view(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [4, 36, 256, 1024])
@pytest.mark.parametrize("chunk", [1, 7, 128, 512])
@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
def test_stream_spmm_matches_plain_on_gpu(cuda, dim, chunk, norm):
    """Within 1e-5 of the largest |y| of the plain version run in float64,
    on A and Aᵀ of a directed graph with empty rows and a hub row of 3000
    edges; bitwise equal across two runs, and across hot budgets (none, a
    few rows, every row), fetch depths and warp spans (1 and 3 chunks)."""
    from spgemm_gnn_tpu_torch.kernels import stream as tstream
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    rng = np.random.default_rng(dim + chunk)
    degrees = rng.integers(0, 12, 700)
    degrees[::50] = 0
    degrees[3] = 3000
    g = degree_graph(degrees.tolist(), seed=dim).to(cuda)
    x = torch.tensor(rng.standard_normal((700, dim)).astype(np.float32),
                     device=cuda)
    pre, post = node_factors(g, norm)
    for indptr, indices, a, b in ((g.indptr, g.indices, pre, post),
                                  (g.t_indptr, g.t_indices, post, pre)):
        plan = build_stream_plan(indptr, indices, chunk=chunk)
        y = stream_spmm(plan, x, a, b)
        again = stream_spmm(plan, x, a, b)
        ref = stream_spmm_plain(plan, x.double(), a, b)
        err = float((y.double() - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), err
        np.testing.assert_array_equal(_bits(y), _bits(again))
        assert (y[indptr.diff() == 0] == 0).all()
        depths = tstream.DEPTHS[tstream._slices(dim // 4)]
        for budget, depth in ((0, None), (5 * 4 * dim, None),
                              (700 * 4 * dim, None),
                              *((None, d) for d in depths)):
            other = tstream.stream_spmm_at(plan, x, a, b, hot_budget=budget,
                                           depth=depth)
            np.testing.assert_array_equal(_bits(y), _bits(other))
        for wc in (1, 3):
            span_plan = build_stream_plan(indptr, indices, chunk=chunk,
                                          warp_chunks=wc)
            np.testing.assert_array_equal(
                _bits(y), _bits(stream_spmm(span_plan, x, a, b)))


@pytest.mark.gpu
def test_planned_stream_aggregate_launches_on_gpu(cuda):
    g = tsyn.powerlaw_graph(600, 6000, seed=9).to(cuda)
    pg = tplanned.plan_graph(g, kind="stream")
    x = torch.randn((600, 64), device=cuda, requires_grad=True)
    before = _build.launches["stream_spmm"]
    out = tapi.aggregate(pg, x, "mean", impl="cuda")
    (out * out).sum().backward()
    assert _build.launches["stream_spmm"] == before + 2
    x_ref = x.detach().clone().requires_grad_(True)
    ref = tspmm_plain.spmm(g, x_ref, "mean")
    (ref * ref).sum().backward()
    for got, want in ((out, ref), (x.grad, x_ref.grad)):
        err = float((got - want).detach().abs().max())
        assert err <= 1e-5 * float(want.detach().abs().max()), err


@pytest.mark.gpu
def test_stream_wrapper_raises_on_bad_input(cuda):
    g = tsyn.random_graph(50, 200, seed=1).to(cuda)
    plan = build_stream_plan(g.indptr, g.indices)
    with pytest.raises(ValueError, match="dim % 4"):
        stream_spmm(plan, torch.zeros((50, 6), device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        stream_spmm(plan, torch.zeros((50, 8), device=cuda,
                                      dtype=torch.float64))
    with pytest.raises(ValueError, match="is on cpu"):
        stream_spmm(build_stream_plan(g.indptr.cpu(), g.indices.cpu()),
                    torch.zeros((50, 8), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        stream_spmm(plan, torch.zeros((8, 50), device=cuda).t())
    with pytest.raises(ValueError, match="aligned"):
        stream_spmm(plan, torch.zeros(50 * 8 + 1, device=cuda)[1:].view(50, 8))
    with pytest.raises(ValueError, match="depth"):
        stream_spmm_at(plan, torch.zeros((50, 8), device=cuda), depth=5)
