"""The port's sharded plan path (parallel/planned_sharded.py) against the JAX
package on the CPU: the host build bit for bit against JAX `_shard_host`
(D = 2, 4, 8; symmetric and directed), `comm_stats` key for key, the
sharded aggregation and its input gradient against JAX `spmm` /
`spmm_transpose` (XLA), the rectangular plan pairs of both kinds against
the plain product (empty roles, shards past N, a halo of MIN_HALO rows),
the source-bound checks of the wrappers, and the sharded plan cache.

JAX's sharded Pallas path (interpret mode) is not run here: the port is
held to the XLA oracle, and the host build to JAX `_shard_host`, whose
per-shard CSRs are captured on their way into its plan builder."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu.graphs import synthetic as jsyn
from spgemm_gnn_tpu.ops.spmm import spmm as jspmm
from spgemm_gnn_tpu.ops.spmm import spmm_transpose as jspmm_t
from spgemm_gnn_tpu.parallel import mesh as jmesh
from spgemm_gnn_tpu.parallel import planned_sharded as jps
from spgemm_gnn_tpu_torch.graphs import native, plan_cache
from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
from spgemm_gnn_tpu_torch.kernels import planned
from spgemm_gnn_tpu_torch.kernels.planned import Aggregate
from spgemm_gnn_tpu_torch.kernels.spmm import csr_cbsr_spmm, csr_spmm
from spgemm_gnn_tpu_torch.kernels.stream import stream_cbsr_spmm, stream_spmm
from spgemm_gnn_tpu_torch.ops.maxk import cbsr_records, maxk
from spgemm_gnn_tpu_torch.ops.spmm import csr_spmm_plain
from spgemm_gnn_tpu_torch.parallel import planned_sharded as tps
from spgemm_gnn_tpu_torch.parallel.mesh import make_mesh

DIM = 128
KW = dict(src_block=128, dst_block=128, window=8)
# the JAX package's arguments: its TPU tiles' slot count besides
JKW = dict(tile_slots=128, **KW)
RTOL, ATOL = 1e-4, 1e-5
JKIND = {"StackedWindowed": "windowed", "StackedStream": "stream"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for this module's many small ops: with the
    suite's parallel workers on the host's cores, a thread a core each
    makes every small op wait on the other workers' threads."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _graphs(kind: str):
    """(JAX graph, the port's) of the same generator and seed."""
    if kind == "symmetric":
        jg, tg = (jsyn.powerlaw_graph(300, 3000, seed=31),
                  tsyn.powerlaw_graph(300, 3000, seed=31))
    else:
        jg = jsyn.random_graph(200, 1500, seed=41, symmetric=False)
        tg = tsyn.random_graph(200, 1500, seed=41, symmetric=False)
    np.testing.assert_array_equal(tg.indices.numpy(), np.asarray(jg.indices))
    assert tg.symmetric == jg.symmetric == (kind == "symmetric")
    return jg, tg


@pytest.fixture(scope="module")
def setup():
    jg, tg = _graphs("symmetric")
    spg = tps.shard_planned_graph(tg, make_mesh(4, "cpu"), **KW)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)
    return jg, tg, spg, x


def _pad(a: np.ndarray, n_pad: int) -> torch.Tensor:
    out = np.zeros((n_pad,) + a.shape[1:], a.dtype)
    out[:a.shape[0]] = a
    return torch.from_numpy(out)


def _jax_host(jg, d: int, monkeypatch, **kw):
    """JAX `_shard_host(jg, d)` and, per role call in its order, the
    (csrs, rows, num_src) its plan builder was given."""
    calls = []
    build = jps._build_role

    def capture(csrs, rows, num_src, **kwargs):
        role = build(csrs, rows, num_src, **kwargs)
        calls.append((csrs, rows, num_src, role["kind"]))
        return role

    monkeypatch.setattr(jps, "_build_role", capture)
    host = jps._shard_host(jg, d, **kw)
    monkeypatch.setattr(jps, "_build_role", build)
    return host, calls


def _assert_role(role: dict, call) -> None:
    csrs, rows, num_src, kind = call
    assert role["kind"] == kind
    assert role["statics"] == dict(rows=rows, num_src=num_src,
                                   shards=len(csrs))
    for i, (p, ix) in enumerate(csrs):
        a, b = role["arrays"][f"indptr{i}"], role["arrays"][f"indices{i}"]
        assert a.dtype == p.dtype and b.dtype == ix.dtype
        np.testing.assert_array_equal(a, p)
        np.testing.assert_array_equal(b, ix)


@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_shard_host_matches_jax(kind, d, monkeypatch):
    """The statics, every send_idx array and each role's per-shard CSR
    bit for bit; each role's kind by the same rule."""
    jg, tg = _graphs(kind)
    jhost, calls = _jax_host(jg, d, monkeypatch, **JKW)
    thost = tps._shard_host(tg, d, **KW)
    assert thost["statics"] == jhost["statics"]
    assert len(thost["send_idx"]) == len(jhost["send_idx"])
    for a, b in zip(thost["send_idx"], jhost["send_idx"]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    names = [n for n in tps.ROLES if isinstance(jhost["roles"][n], dict)]
    assert len(names) == len(calls)
    for name, call in zip(names, calls):
        _assert_role(thost["roles"][name], call)
        assert thost["roles"][name]["kind"] == jhost["roles"][name]["kind"]
    for name in tps.ROLES:
        if not isinstance(jhost["roles"][name], dict):
            assert thost["roles"][name] == jhost["roles"][name]


def test_shard_host_numpy_path_matches_native(monkeypatch):
    """Without the native graph core the host build is the same, bit for
    bit (the lexsort path)."""
    if not native.available():
        pytest.skip("the native graph core did not build here")
    _, tg = _graphs("directed")
    a = tps._shard_host(tg, 4, **KW)
    monkeypatch.setattr(native, "available", lambda: False)
    b = tps._shard_host(tg, 4, **KW)
    _assert_host_equal(a, b)


def _assert_host_equal(a: dict, b: dict) -> None:
    assert a["statics"] == b["statics"]
    for x, y in zip(a["send_idx"], b["send_idx"], strict=True):
        np.testing.assert_array_equal(x, y)
    for name in tps.ROLES:
        ra, rb = a["roles"][name], b["roles"][name]
        if not isinstance(ra, dict):
            assert ra == rb
            continue
        assert (ra["kind"], ra["statics"]) == (rb["kind"], rb["statics"])
        assert set(ra["arrays"]) == set(rb["arrays"])
        for f in ra["arrays"]:
            np.testing.assert_array_equal(ra["arrays"][f], rb["arrays"][f])


@pytest.mark.parametrize("d", [2, 4, 8])
def test_comm_stats_match_jax(d):
    jg, tg = _graphs("symmetric")
    jspg = jps.shard_planned_graph(jg, jmesh.make_mesh(d), **JKW)
    spg = tps.shard_planned_graph(tg, make_mesh(d, "cpu"), **KW)
    assert spg.padded_nodes == jspg.padded_nodes
    assert spg.halo_round_sizes == jspg.halo_round_sizes
    assert spg.kinds == {n: JKIND[type(r).__name__] for n, r in (
        ("fwd_local", jspg.fwd_local), ("bwd_local", jspg.bwd_local),
        ("fwd_halo", jspg.fwd_halo), ("bwd_halo", jspg.bwd_halo))
        if r is not None}
    for dim, k, vb in ((DIM, None, 4), (DIM, 8, 4), (256, 32, 2),
                       (384, 8, 4)):
        assert spg.comm_stats(dim, k, vb) == jspg.comm_stats(dim, k, vb)


@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
def test_forward_and_gradient_match_jax(setup, norm):
    jg, tg, spg, x = setup
    xp = _pad(x, spg.padded_nodes).requires_grad_()
    ct = np.random.default_rng(1).standard_normal(
        (spg.padded_nodes, DIM)).astype(np.float32)
    y = tps.sharded_planned_aggregate(spg, xp, norm)
    (y * torch.from_numpy(ct)).sum().backward()
    n = tg.num_nodes
    np.testing.assert_allclose(y.detach()[:n].numpy(),
                               np.asarray(jspmm(jg, jnp.asarray(x), norm)),
                               rtol=RTOL, atol=ATOL)
    assert not y.detach()[n:].any()          # padded rows zero
    np.testing.assert_allclose(
        xp.grad[:n].numpy(),
        np.asarray(jspmm_t(jg, jnp.asarray(ct[:n]), norm)),
        rtol=RTOL, atol=ATOL)


def _maxk_grads(jg, spg, x, ct, k, norm, halo_dtype=None):
    """(the port's y and dx through MaxK and the CBSR exchange, JAX's y and
    dx through MaxK and `spmm`), on the real rows."""
    from spgemm_gnn_tpu.ops.maxk import maxk as jmaxk
    n = x.shape[0]
    xp = _pad(x, spg.padded_nodes).requires_grad_()
    y = tps.sharded_planned_aggregate(spg, maxk(xp, k), norm, k=k,
                                      halo_dtype=halo_dtype)
    (y * torch.from_numpy(ct)).sum().backward()

    def ref(xv):
        return jspmm(jg, jmaxk(xv, k), norm)

    jy = np.asarray(ref(jnp.asarray(x)))
    jdx = np.asarray(jax.grad(lambda xv: (ref(xv) * ct[:n]).sum())(
        jnp.asarray(x)))
    return y.detach()[:n].numpy(), xp.grad[:n].numpy(), jy, jdx


@pytest.mark.parametrize("norm", ["mean", "gcn"])
def test_cbsr_exchange_matches_jax(setup, norm):
    """The CBSR halo (k values and packed ids a boundary row) against the
    single-device oracle, forward and input gradient through MaxK."""
    jg, tg, spg, x = setup
    ct = np.random.default_rng(3).standard_normal(
        (spg.padded_nodes, DIM)).astype(np.float32)
    y, dx, jy, jdx = _maxk_grads(jg, spg, x, ct, 4, norm)
    np.testing.assert_allclose(y, jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dx, jdx, rtol=RTOL, atol=ATOL)


def test_cbsr_exchange_dim384_matches_jax():
    """Hidden 384 (yelp's): the ids ride the uint16×2 pack."""
    jg, tg = _graphs("symmetric")
    spg = tps.shard_planned_graph(tg, make_mesh(2, "cpu"), **KW)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((tg.num_nodes, 384)).astype(np.float32)
    ct = rng.standard_normal((spg.padded_nodes, 384)).astype(np.float32)
    y, dx, jy, jdx = _maxk_grads(jg, spg, x, ct, 8, "mean")
    np.testing.assert_allclose(y, jy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dx, jdx, rtol=RTOL, atol=ATOL)


def test_bf16_halo_within_jax_tolerance(setup):
    """The CBSR values in bf16 on the wire: within 3e-2 of max |y| (the
    JAX sweep's bf16 tolerance), and not the exact exchange's bits."""
    jg, tg, spg, x = setup
    ct = np.random.default_rng(4).standard_normal(
        (spg.padded_nodes, DIM)).astype(np.float32)
    y, dx, jy, jdx = _maxk_grads(jg, spg, x, ct, 8, "mean", torch.bfloat16)
    assert np.abs(y - jy).max() / np.abs(jy).max() < 3e-2
    assert np.abs(dx - jdx).max() / np.abs(jdx).max() < 3e-2
    assert np.abs(y - jy).max() > 0


def test_directed_forward_and_gradient_match_jax():
    jg, tg = _graphs("directed")
    spg = tps.shard_planned_graph(tg, make_mesh(4, "cpu"), **KW)
    assert spg.bwd_local is not spg.fwd_local
    rng = np.random.default_rng(5)
    x = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)
    ct = rng.standard_normal((spg.padded_nodes, DIM)).astype(np.float32)
    xp = _pad(x, spg.padded_nodes).requires_grad_()
    y = tps.sharded_planned_aggregate(spg, xp, "gcn")
    (y * torch.from_numpy(ct)).sum().backward()
    n = tg.num_nodes
    np.testing.assert_allclose(y.detach()[:n].numpy(),
                               np.asarray(jspmm(jg, jnp.asarray(x), "gcn")),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        xp.grad[:n].numpy(),
        np.asarray(jspmm_t(jg, jnp.asarray(ct[:n]), "gcn")),
        rtol=RTOL, atol=ATOL)


def test_bf16_activations_keep_jax_rounding_points(setup):
    """bf16 x: each pair's output bf16, their sum bf16, then ⊙ dst_f in
    bf16 (the JAX package's rounding points), built here from the port's
    own pieces on the same plans; and within bf16 rounding of f32."""
    _, tg, spg, x = setup
    xp = _pad(x, spg.padded_nodes).to(torch.bfloat16)
    y = tps.sharded_planned_aggregate(spg, xp, "mean")
    assert y.dtype == torch.bfloat16
    _, dst_f = planned.node_factors(spg, "mean")
    halo = xp.index_select(0, spg.recv_idx).view(spg.num_shards, -1, DIM)
    want = []
    for c, blk in enumerate(xp.view(spg.num_shards, -1, DIM)):
        loc = planned.plan_spmm(spg.fwd_local[c], blk)
        hal = planned.plan_spmm(spg.fwd_halo[c], halo[c])
        assert loc.dtype == hal.dtype == torch.bfloat16
        want.append(loc + hal)
    want = torch.cat(want) * dst_f[:, None].to(torch.bfloat16)
    assert torch.equal(y, want)
    y32 = tps.sharded_planned_aggregate(spg, xp.float(), "mean")
    assert (y.float() - y32).abs().max() <= 2e-2 * y32.abs().max()


def _edge_case_graph():
    """Edges inside shard 0 and two into shard 1 from shard 0 (a halo
    round of MIN_HALO rows), nodes past the last edge: at D = 4 and
    dst_block 64 shard 3 lies past N, and shards 2 and 3 have no edge."""
    src = np.array([0, 1, 2, 3, 5, 7, 1, 3])
    dst = np.array([1, 2, 3, 0, 6, 8, 70, 71])
    return from_edges(np.concatenate([src, dst]), np.concatenate([dst, src]),
                      150)


@pytest.mark.parametrize("force", ["windowed", "stream"])
def test_rectangular_pairs_edge_cases(force, monkeypatch):
    """Each role's per-shard pair of either kind against the plain product
    (and its transpose): rows with no edges and whole shards past N come
    out 0, the halo space is MIN_HALO rows, and a role with no edges at
    all (no halo on a graph of local edges) is absent."""
    monkeypatch.setattr(tps, "_choose_kind", lambda *a: force)
    g = _edge_case_graph()
    spg = tps.shard_planned_graph(g, make_mesh(4, "cpu"), dst_block=64)
    assert spg.nodes_per_shard == 64 and spg.padded_nodes > 3 * 64 >= 150
    assert spg.halo_round_sizes == (tps.MIN_HALO, 0, tps.MIN_HALO)
    assert set(spg.kinds.values()) == {force}
    rng = np.random.default_rng(7)
    for fwd, bwd in ((spg.fwd_local, spg.bwd_local),
                     (spg.fwd_halo, spg.bwd_halo)):
        for c in range(4):
            n_src = fwd[c].num_src
            assert bwd[c].num_src == fwd[c].num_rows
            x = torch.from_numpy(rng.standard_normal(
                (n_src, 16)).astype(np.float32)).requires_grad_()
            y = Aggregate.apply(x, fwd[c], bwd[c], None, None, None, None)
            want = csr_spmm_plain(fwd[c].indptr, fwd[c].indices, x.detach())
            assert y.shape == (fwd[c].num_rows, 16)
            torch.testing.assert_close(y, want)
            gy = torch.randn_like(y)
            y.backward(gy)
            torch.testing.assert_close(x.grad, csr_spmm_plain(
                bwd[c].indptr, bwd[c].indices, gy))
        assert fwd[3].indices.numel() == 0      # the shard past N
    x = torch.randn(spg.padded_nodes, 16)
    torch.testing.assert_close(
        tps.sharded_planned_aggregate(spg, x, "sum")[:150],
        csr_spmm_plain(g.indptr, g.indices, x[:150]))
    local = from_edges(np.array([0, 1, 65]), np.array([1, 0, 66]), 150)
    spl = tps.shard_planned_graph(local, make_mesh(4, "cpu"), dst_block=64)
    assert spl.fwd_halo is None and spl.halo_round_sizes == (0, 0, 0)
    assert spl.recv_idx.numel() == 0 and spl.comm_stats(16)[
        "exchange_bytes"] == 0


@pytest.mark.parametrize("kind", ["windowed", "stream"])
def test_rectangular_plan_records_its_sources(kind):
    """A plan over num_src sources: its gather order and hot set are sized
    by sources, not rows, and `max_src` is the largest source id."""
    indptr = torch.tensor([0, 2, 3, 3], dtype=torch.int32)
    indices = torch.tensor([9, 4, 9], dtype=torch.int32)
    plan = planned.build_plan(indptr, indices, kind, num_src=12)
    assert (plan.num_rows, plan.num_src, plan.max_src) == (3, 12, 9)
    if kind == "stream":
        ids, counts = plan.gather_order()
        assert ids.numel() == 12 and ids[:2].tolist() == [9, 4]
        assert plan.hot_set(64).rows == 2
    square = CSRPlan(indptr, torch.tensor([1, 2, 0], dtype=torch.int32))
    assert (square.num_src, square.max_src) == (3, 2)
    empty = build_stream_plan(torch.zeros(4, dtype=torch.int32),
                              torch.zeros(0, dtype=torch.int32), num_src=8)
    assert (empty.max_src, empty.num_chunks) == (-1, 0)
    y = stream_spmm(empty, torch.randn(8, 4))
    assert y.shape == (3, 4) and not y.any()


def test_wrappers_raise_on_too_few_source_rows():
    """x with fewer rows than the plan's largest source id + 1 raises in
    every product wrapper, on the CPU as on the card."""
    indptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    indices = torch.tensor([0, 7, 3], dtype=torch.int32)
    windowed, stream = CSRPlan(indptr, indices, num_src=8), \
        build_stream_plan(indptr, indices, num_src=8)
    short, full = torch.randn(7, 16), torch.randn(8, 16)
    for kernel, plan in ((csr_spmm, windowed), (stream_spmm, stream)):
        assert kernel(plan, full).shape == (2, 16)
        with pytest.raises(ValueError, match="source row 7"):
            kernel(plan, short)
    vals, ch = torch.randn(7, 4).to(torch.bfloat16), torch.zeros(
        7, 4, dtype=torch.int32) + torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="source row 7"):
        csr_cbsr_spmm(windowed, cbsr_records(vals, ch, 16), 4, 16)
    with pytest.raises(ValueError, match="source row 7"):
        stream_cbsr_spmm(stream, cbsr_records(vals.float(), ch, 16), 4, 16)
    with pytest.raises(ValueError, match="source row 7"):
        Aggregate.apply(short, windowed, windowed, None, None, None, None)


def test_shard_cache_round_trip(tmp_path):
    """save/load give the build array for array; the cache_dir path stores
    one entry, loads it on the second build, and both aggregate alike; a
    corrupt entry is deleted and rebuilt."""
    _, tg = _graphs("directed")
    host = tps._shard_host(tg, 4, **KW)
    plan_cache.save_shard_host(str(tmp_path / "manual"), host)
    _assert_host_equal(host, plan_cache.load_shard_host(
        str(tmp_path / "manual")))
    cache = tmp_path / "cache"
    mesh = make_mesh(4, "cpu")
    spg1 = tps.shard_planned_graph(tg, mesh, cache_dir=str(cache), **KW)
    entries = list(cache.glob("shard_*"))
    assert len(entries) == 1 and entries[0].is_dir()
    assert "_v%d_shard_d4_" % plan_cache.PLANNER_VERSION in entries[0].name
    spg2 = tps.shard_planned_graph(tg, mesh, cache_dir=str(cache), **KW)
    x = torch.randn(spg1.padded_nodes, DIM)
    assert torch.equal(tps.sharded_planned_aggregate(spg1, x, "gcn"),
                       tps.sharded_planned_aggregate(spg2, x, "gcn"))
    (entries[0] / "meta.json").write_text("{not json")
    spg3 = tps.shard_planned_graph(tg, mesh, cache_dir=str(cache), **KW)
    assert torch.equal(tps.sharded_planned_aggregate(spg3, x, "gcn"),
                       tps.sharded_planned_aggregate(spg1, x, "gcn"))
    _assert_host_equal(plan_cache.load_shard_host(str(entries[0])), host)


def test_sharded_graphs_take_no_channel_ids(setup):
    """`wants_channel_ids` is False for a sharded graph: the shard pairs
    get no k and no ids (the sampled backward stays off this path)."""
    _, _, spg, _ = setup
    x = torch.randn(4, DIM, requires_grad=True)
    for stream in ("f32", "bf16x2"):
        planned.DEFAULT_STREAM = stream
        try:
            assert not planned.wants_channel_ids(spg, 8, x.bfloat16())
        finally:
            planned.DEFAULT_STREAM = "f32"
