"""The port's kernels against the JAX package (CPU) and against their plain
versions (GPU).

On the CPU each kernel wrapper takes its plain PyTorch version, so the CPU
cases hold the plain versions and the autograd Functions around the kernels
to the JAX kernels (`maxk_pallas` in interpret mode, `planned_aggregate` on a
small plan) and to the JAX oracles. The GPU cases (marker `gpu`) hold the
CUDA kernels to the plain versions and skip without a card. This module
imports JAX only inside the CPU cases, so that the GPU cases run where JAX
is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
from spgemm_gnn_tpu_torch.graphs.tiles import SEGMENT, CSRPlan
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels import api as tapi
from spgemm_gnn_tpu_torch.kernels import maxk as tmaxk
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.kernels import spmm as tspmm
from spgemm_gnn_tpu_torch.kernels import stream as tstream
from spgemm_gnn_tpu_torch.kernels.round import round_rows
from spgemm_gnn_tpu_torch.ops import maxk as tmaxk_plain
from spgemm_gnn_tpu_torch.ops import spmm as tspmm_plain
from spgemm_gnn_tpu_torch.ops.stream import stream_sspmm_plain
from spgemm_gnn_tpu_torch.utils.rows import with_families

SIGNED_ZERO_ROW = 5
BF16 = torch.bfloat16


def special_rows(rng, n: int, dim: int) -> np.ndarray:
    """Random rows plus rows that stress the selection order."""
    x = rng.standard_normal((n, dim)).astype(np.float32)
    x[1] = 0.0                                   # all ties
    x[2] = -np.abs(x[2])                         # all negative
    x[3] = np.round(x[3])                        # many repeated values
    x[4, ::2] = 1.0                              # equal candidates spread out
    x[SIGNED_ZERO_ROW] = np.where(rng.random(dim) < 0.5, 0.0, -0.0)
    x[6] = np.round(x[6], 1)
    return x


def ints(t: torch.Tensor) -> np.ndarray:
    """The bits of an f32 or bf16 tensor."""
    return t.view(torch.int16 if t.element_size() == 2
                  else torch.int32).cpu().numpy()


def bits(a) -> np.ndarray:
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# CPU: MaxK against maxk_pallas (interpret) and ops.maxk.maxk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [48, 256])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_maxk_matches_jax_exactly(k, dim):
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.maxk_pallas import maxk_pallas
    from spgemm_gnn_tpu.ops.maxk import maxk as jmaxk

    rng = np.random.default_rng(k * 1000 + dim)
    x = special_rows(rng, 40, dim)
    ct = rng.standard_normal(x.shape).astype(np.float32)

    def jax_pair(fn):
        y, vjp = jax.vjp(fn, jnp.asarray(x))
        return np.asarray(y), np.asarray(vjp(jnp.asarray(ct))[0])

    y_pl, g_pl = jax_pair(lambda v: maxk_pallas(v, k, 8, True))
    y_or, g_or = jax_pair(lambda v: jmaxk(v, k))

    for impl in ("auto", "torch"):       # autograd Function, plain op
        xt = torch.tensor(x, requires_grad=True)
        y = tapi.maxk_op(xt, k, impl=impl)
        (y * torch.tensor(ct)).sum().backward()
        # maxk_pallas is the reference on every row, signed-zero inputs
        # included. Its interpret mode writes +0.0 where a negative entry is
        # dropped and the oracle writes x * 0 = -0.0; the port writes
        # x * mask as both sources say, so y matches maxk_pallas by value
        np.testing.assert_array_equal(y.detach().numpy(), y_pl)
        np.testing.assert_array_equal(bits(xt.grad), bits(g_pl))
        # lax.top_k ranks -0.0 and +0.0 equal: the oracle off that row
        rows = np.arange(x.shape[0]) != SIGNED_ZERO_ROW
        np.testing.assert_array_equal(bits(y)[rows], bits(y_or)[rows])
        np.testing.assert_array_equal(bits(xt.grad)[rows], bits(g_or)[rows])
    # bit keys put -0.0 below +0.0: the +0.0 entries of that row win first
    row = x[SIGNED_ZERO_ROW]
    kept = np.flatnonzero(tmaxk_plain.maxk_mask(torch.tensor(x), k)
                          .numpy()[SIGNED_ZERO_ROW])
    order = sorted(range(dim), key=lambda c: (np.signbit(row[c]), c))
    np.testing.assert_array_equal(kept, np.sort(order[:k]))


def test_maxk_meta_rebuilds_the_mask(rng):
    x = torch.tensor(special_rows(rng, 30, 64))
    y, meta = tmaxk.maxk_fwd(x, 8)
    assert meta.dtype == torch.int32 and meta.shape == (30, 2)
    mask = tmaxk_plain.mask_from_meta(x, meta)
    assert (mask.sum(1) == 8).all()
    np.testing.assert_array_equal(bits(y), bits(x * mask))


def test_maxk_op_passthrough_and_impl_checks(rng):
    x = torch.tensor(rng.standard_normal((8, 16)).astype(np.float32))
    assert tapi.maxk_op(x, None) is x
    assert tapi.maxk_op(x, 16) is x
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        tapi.maxk_op(x, 4, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tapi.maxk_op(x, 4, impl="pallas")


# ---------------------------------------------------------------------------
# CPU: aggregation pair against planned_aggregate and ops.spmm.spmm
# ---------------------------------------------------------------------------

PLAN = dict(tile_slots=128, src_block=128, dst_block=128, window=8)
DIM = 128


def _graphs(kind: str):
    from spgemm_gnn_tpu.graphs import synthetic as jsyn
    if kind == "symmetric":
        return (jsyn.powerlaw_graph(250, 2500, seed=21),
                tsyn.powerlaw_graph(250, 2500, seed=21))
    return (jsyn.random_graph(200, 1500, seed=5, symmetric=False),
            tsyn.random_graph(200, 1500, seed=5, symmetric=False))


@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_aggregate_matches_jax(kind, norm):
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.planned import plan_graph, planned_aggregate
    from spgemm_gnn_tpu.ops.spmm import spmm as jspmm

    jg, tg = _graphs(kind)
    assert tg.symmetric == (kind == "symmetric")
    rng = np.random.default_rng(len(kind) + len(norm))
    x = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)
    ct = rng.standard_normal((tg.num_nodes, DIM)).astype(np.float32)

    def jax_pair(fn):
        y, vjp = jax.vjp(fn, jnp.asarray(x))
        return np.asarray(y), np.asarray(vjp(jnp.asarray(ct))[0])

    pg = plan_graph(jg, **PLAN)
    refs = [jax_pair(lambda v: planned_aggregate(pg, v, norm)),
            jax_pair(lambda v: jspmm(jg, v, norm))]
    for impl in ("auto", "torch"):      # kernel pair (plain on CPU), oracle
        xt = torch.tensor(x, requires_grad=True)
        y = tapi.aggregate(tg, xt, norm=norm, k=None, impl=impl)
        (y * torch.tensor(ct)).sum().backward()
        for y_ref, dx_ref in refs:
            # only the f32 summation order differs: rtol 1e-5, and atol 1e-6
            # of the output's scale (norm "sum" sums ~150 terms on hub rows,
            # to magnitudes ~14, where reordering moves the result ~2e-6)
            for got, ref in ((y.detach().numpy(), y_ref),
                             (xt.grad.numpy(), dx_ref)):
                np.testing.assert_allclose(
                    got, ref, rtol=1e-5,
                    atol=1e-6 * max(1.0, float(np.abs(ref).max())))


def test_csr_spmm_plain_chunks_edges(monkeypatch, rng):
    """Edge chunks under the byte cap give the unchunked result."""
    g = tsyn.random_graph(60, 400, seed=3, symmetric=False)
    x = torch.tensor(rng.standard_normal((60, 8)).astype(np.float32))
    post = torch.rand(60, dtype=torch.float32)
    whole = tspmm_plain.csr_spmm_plain(g.indptr, g.indices, x, None, post)
    monkeypatch.setattr(tspmm_plain, "_MSG_BYTES_CAP", 7 * 8 * 4)
    chunked = tspmm_plain.csr_spmm_plain(g.indptr, g.indices, x, None, post)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-7)


def test_aggregate_cotangent_keeps_primal_dtype(rng):
    g = tsyn.random_graph(30, 120, seed=4)
    x = torch.tensor(rng.standard_normal((30, 8)).astype(np.float32),
                     requires_grad=True)
    tplanned.planned_aggregate(g, x, "gcn").sum().backward()
    assert x.grad.dtype == x.dtype and x.grad.shape == x.shape


def test_aggregate_cuda_impl_on_cpu_raises(rng):
    g = tsyn.random_graph(30, 120, seed=4)
    x = torch.zeros((30, 8))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        tapi.aggregate(g, x, "mean", impl="cuda")


# ---------------------------------------------------------------------------
# GPU: the CUDA kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 333, 100_003])
@pytest.mark.parametrize("dim,k", [(48, 8), (100, 7), (256, 1), (256, 32),
                                   (1024, 64)])
def test_maxk_kernels_bitwise_plain_on_gpu(cuda, dim, k, n, dtype):
    """maxk_fwd (y and meta) and maxk_bwd bit-equal to the plain versions on
    f32 and bf16 rows: the special rows, then the families of
    `utils/rows.py` on every other row; N of 1, 7, 333 and 100,003 (a
    ragged tail past many sweeps of the forward's persistent grid)."""
    rng = np.random.default_rng(dim + k)
    x = torch.tensor(special_rows(rng, max(n, 7), dim)[:n])
    if n > 7:
        with_families(x[7:], k, torch.Generator().manual_seed(n), 2)
    x = x.to(device=cuda, dtype=dtype)
    g = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32),
                     device=cuda).to(dtype)
    y, meta = tmaxk.maxk_fwd(x, k)
    y_p, meta_p = tmaxk_plain.maxk_forward(x, k)
    np.testing.assert_array_equal(meta.cpu().numpy(), meta_p.cpu().numpy())
    dx = tmaxk.maxk_bwd(x, meta, g)
    dx_p = tmaxk_plain.maxk_backward(x, meta, g)
    for got, want in ((y, y_p), (dx, dx_p)):   # NaN: a dropped infinity
        nan = (got.isnan() & want.isnan()).cpu().numpy()
        np.testing.assert_array_equal(np.where(nan, 0, ints(got)),
                                      np.where(nan, 0, ints(want)))


def hub_graph(n: int, n_edges: int, hub_edges: int, seed: int,
              symmetric: bool):
    """Random edges among the first n - 20 nodes (the last 20 have none),
    plus `hub_edges` in-edges of node 3 from random sources."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n - 20, n_edges),
                          rng.integers(0, n - 20, hub_edges)])
    dst = np.concatenate([rng.integers(0, n - 20, n_edges),
                          np.full(hub_edges, 3)])
    src, dst = src[src != dst], dst[src != dst]
    if symmetric:   # repeats kept, so the hub keeps its 3000 edges
        return from_edges(np.concatenate([src, dst]),
                          np.concatenate([dst, src]), n, symmetric=True)
    return from_edges(src, dst, n, symmetric=False)


# (source blocks, segment): the rule's, and forced ones that split the hub
# row (3000 edges) into pieces of 64 in one, two and five blocks
SCHEDULES = {"auto": (None, SEGMENT), "nb1_s64": (1, 64), "nb2_s64": (2, 64),
             "nb5_s64": (5, 64)}


@pytest.mark.gpu
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("dim", [4, 36, 256, 1024])
@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_csr_spmm_matches_plain_on_gpu(cuda, dim, norm, symmetric, schedule):
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    nb, segment = SCHEDULES[schedule]
    g = hub_graph(700, 9000, 3000, seed=dim, symmetric=symmetric).to(cuda)
    rng = np.random.default_rng(dim)
    x = torch.tensor(rng.standard_normal((700, dim)).astype(np.float32),
                     device=cuda, requires_grad=True)
    pre, post = node_factors(g, norm)
    plan = CSRPlan(g.indptr, g.indices, nb, segment)
    y = tspmm.csr_spmm(plan, x.detach(), pre, post)
    again = tspmm.csr_spmm(plan, x.detach(), pre, post)
    # the sum's order is fixed: two runs give the same bits
    np.testing.assert_array_equal(bits(again), bits(y))
    y_p = tspmm_plain.csr_spmm_plain(g.indptr, g.indices, x.detach().double(),
                                     pre, post)
    bwd = plan if symmetric else CSRPlan(g.t_indptr, g.t_indices, nb,
                                         segment)
    pg = tplanned.PlannedGraph(graph=g, fwd_plan=plan, bwd_plan=bwd)
    before = _build.launches["csr_spmm"]
    out = tplanned.planned_aggregate(pg, x, norm)
    (out * out).sum().backward()
    assert _build.launches["csr_spmm"] == before + 2
    x_ref = x.detach().clone().requires_grad_(True)
    ref = tspmm_plain.spmm(g, x_ref, norm)
    (ref * ref).sum().backward()
    # the kernel sums in a fixed order, the plain version with atomics (or
    # in float64): within 1e-5 of the output's largest magnitude
    # (elementwise relative error is unbounded where a sum cancels)
    for got, want in ((y, y_p), (out, ref), (x.grad, x_ref.grad)):
        err = float((got - want).detach().abs().max())
        assert err <= 1e-5 * float(want.detach().abs().max()), err


@pytest.mark.gpu
def test_kernel_wrappers_raise_on_bad_input(cuda):
    g = tsyn.random_graph(50, 200, seed=1).to(cuda)
    with pytest.raises(ValueError, match="dim % 4"):
        tspmm.csr_spmm(CSRPlan(g.indptr, g.indices),
                       torch.zeros((50, 6), device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        tspmm.csr_spmm(CSRPlan(g.indptr, g.indices),
                       torch.zeros((50, 8), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        tmaxk.maxk_fwd(torch.zeros((16, 50), device=cuda).t(), 4)
    with pytest.raises(ValueError, match="dim <= 1024"):
        tmaxk.maxk_fwd(torch.zeros((4, 2048), device=cuda), 4)


def zero_rows(rng, n: int, dim: int, k: int) -> torch.Tensor:
    """Random rows, and every third row with fewer than k positive values
    and exact zeros past them (negatives below): its top-k keeps zeros."""
    x = rng.standard_normal((n, dim)).astype(np.float32)
    few = np.arange(0, n, 3)
    x[few] = -np.abs(x[few]) - 1.0
    x[few, dim - k:] = 0.0
    x[few, dim - 3:] = np.abs(x[few, dim - 3:]) + 0.5
    return torch.tensor(x)


def near16(got, want) -> None:
    """Within 1 bf16 ulp of want (2^-7 of its power of two), and off at
    most 0.5 % of the values: the same bf16 terms summed in f32 in another
    order, rounded once."""
    got = got.detach().float().cpu().numpy().astype(np.float64)
    want = want.detach().float().cpu().numpy().astype(np.float64)
    mag = np.maximum(np.abs(want), 2.0 ** -120)
    u = np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert u.max(initial=0.0) <= 1, u.max()
    assert (u > 0).mean() <= 0.005, (u > 0).mean()


@pytest.mark.gpu
@pytest.mark.parametrize("out16", [False, True])
@pytest.mark.parametrize("chunk", [7, 128])
@pytest.mark.parametrize("dim,k", [(32, 8), (256, 32), (256, 48),
                                   (128, 100), (256, 255)])
@pytest.mark.parametrize("symmetric", [False, True])
def test_stream_sspmm_bitwise_dense_on_gpu(cuda, symmetric, dim, k, chunk,
                                           out16):
    """stream_sspmm (_out) bit-equal to stream_spmm_bf16 (_out) on Aᵀ at
    MaxK's kept channels (rows with kept zeros among them) and 0 elsewhere,
    across two runs, with its passes run apart and, at k <= 32, the gather
    probe; within 1e-5 of max |y| of the plain version (f32), or (bf16)
    bitwise bf16(bf16(Σ) · bf16(post)) of the f32 form's sums Σ, bf16(Σ)
    within 1 bf16 ulp of the plain version's."""
    g = hub_graph(700, 9000, 3000, seed=dim + k,
                  symmetric=symmetric).to(cuda)
    fwd = build_stream_plan(g.indptr, g.indices, chunk=chunk)
    plan = fwd if symmetric else build_stream_plan(g.t_indptr, g.t_indices,
                                                   chunk=chunk)
    rng = np.random.default_rng(dim * k + chunk)
    h = zero_rows(rng, 700, dim, min(k, dim - 4)).to(cuda).to(BF16)
    _, _, ch = tmaxk.maxk_fwd(h, k, with_ids=True)
    pre = torch.tensor(rng.random(700).astype(np.float32) + 0.5, device=cuda)
    post = torch.tensor(rng.random(700).astype(np.float32) + 0.5,
                        device=cuda)
    m = round_rows(torch.tensor(rng.standard_normal((700, dim)).astype(
        np.float32), device=cuda), pre)
    od = BF16 if out16 else None
    keep = torch.zeros((700, dim), dtype=torch.bool, device=cuda)
    keep.scatter_(1, ch.long(), True)
    dense = tstream.stream_spmm(plan, m, None, post, out_dtype=od)
    want = torch.where(keep, dense, torch.zeros((), dtype=dense.dtype,
                                                device=cuda))
    _build.launches.clear()
    got = tstream.stream_sspmm(plan, fwd, m, ch, post, od)
    name = "stream_sspmm_bf16_out" if out16 else "stream_sspmm_bf16"
    assert dict(_build.launches) == {name: 1}
    np.testing.assert_array_equal(ints(got), ints(want))
    np.testing.assert_array_equal(ints(got), ints(tstream.stream_sspmm(
        plan, fwd, m, ch, post, od)))
    slots = tstream.stream_sspmm_at(plan, fwd, m, ch, passes=(1,))
    np.testing.assert_array_equal(ints(got), ints(tstream.stream_sspmm_at(
        plan, fwd, m, ch, post, out_dtype=od, passes=(2,), slots=slots)))
    if k <= 32:
        probe = tstream.stream_ksample_at(plan, m, ch, g.t_edge_dst, post,
                                          out_dtype=od)
        np.testing.assert_array_equal(ints(got), ints(probe))
    if out16:
        # bf16(bf16(Σ) · bf16(post)): bitwise the rounding of the f32
        # form's sums, and the sums' rounding within 1 ulp of the plain
        # version's (a second rounding can move a last-bit difference of
        # the f32 sums by one more ulp)
        sums = tstream.stream_sspmm(plan, fwd, m, ch)
        np.testing.assert_array_equal(ints(got), ints(
            sums.to(BF16) * post.to(BF16)[:, None]))
        near16(tstream.stream_sspmm(plan, fwd, m, ch, None, od),
               stream_sspmm_plain(plan, m, ch, None, od))
    else:
        plain = stream_sspmm_plain(plan, m, ch, post, od)
        err = float((got - plain).abs().max())
        assert err <= 1e-5 * float(plain.abs().max()), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("n", [7, 333, 100_003])
@pytest.mark.parametrize("dim,k", [(48, 8), (100, 7), (256, 1), (256, 32),
                                   (256, 255)])
def test_maxk_ids_bitwise_plain_on_gpu(cuda, dim, k, n, dtype):
    """maxk_fwd(..., with_ids=True) on the card: y and meta those of the
    form without ids, the ids those of the plain version (kept zeros
    included), on rows with kept zeros and the families of
    utils/rows.py."""
    rng = np.random.default_rng(dim + k + n)
    x = zero_rows(rng, n, dim, min(k, dim - 4))
    if n > 7:
        with_families(x[n // 2:], k, torch.Generator().manual_seed(n), 2)
    x = x.to(device=cuda, dtype=dtype)
    y, meta, ids = tmaxk.maxk_fwd(x, k, with_ids=True)
    y0, meta0 = tmaxk.maxk_fwd(x, k)
    assert torch.equal(meta, meta0)
    np.testing.assert_array_equal(ints(y), ints(y0))
    np.testing.assert_array_equal(
        ids.cpu().numpy(),
        tmaxk_plain.maxk_channel_ids(x, meta, k).cpu().numpy())




def _edge_case_shards(device, kind: str):
    """A mesh of 4 shards of 64 rows over a 150-node graph whose edges lie
    in shards 0 and 1 (two cross the boundary: halo rounds of MIN_HALO
    rows), so shards 2 and 3 (the last past N) have no edge, every role
    forced to `kind`."""
    from spgemm_gnn_tpu_torch.parallel import make_mesh
    from spgemm_gnn_tpu_torch.parallel import planned_sharded as tps
    src = np.array([0, 1, 2, 3, 5, 7, 1, 3])
    dst = np.array([1, 2, 3, 0, 6, 8, 70, 71])
    g = from_edges(np.concatenate([src, dst]), np.concatenate([dst, src]),
                   150)
    rule = tps._choose_kind
    tps._choose_kind = lambda *a: kind
    try:
        return g, tps.shard_planned_graph(g, make_mesh(4, device),
                                          tile_slots=128, dst_block=64)
    finally:
        tps._choose_kind = rule


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["windowed", "stream"])
def test_rectangular_shard_plans_on_gpu(cuda, kind):
    """Each shard's rectangular plan of either kind through its kernel (f32
    rows, bf16 rows, bf16 output) against the plain version on the same
    rows: rows with no edge and whole shards with none come out 0 though
    the output memory held NaN before; the sharded aggregation equals the
    CPU's; too few source rows raise."""
    from spgemm_gnn_tpu_torch.parallel import planned_sharded as tps
    g, spg = _edge_case_shards(cuda, kind)
    assert spg.halo_round_sizes == (8, 0, 8) and set(spg.kinds.values()) \
        == {kind}
    kernel = tspmm.csr_spmm if kind == "windowed" else tstream.stream_spmm
    gen = torch.Generator(device=cuda).manual_seed(0)
    for plans in (spg.fwd_local, spg.fwd_halo, spg.bwd_halo):
        for plan in plans:
            x = torch.randn((plan.num_src, 64), generator=gen, device=cuda)
            for m, out in ((x, None), (round_rows(x), None),
                           (x.to(BF16), BF16)):
                poison = torch.full((plan.num_rows * 64 * 4,), float("nan"),
                                    device=cuda)
                del poison
                y = kernel(plan, m, out_dtype=out)
                want = tspmm_plain.csr_spmm_plain(plan.indptr, plan.indices,
                                                  m, out_dtype=out)
                assert not y.isnan().any()
                torch.testing.assert_close(y.float(), want.float(),
                                           rtol=1e-5 if out is None else 1e-2,
                                           atol=1e-5)
            if plan.max_src >= 0:
                with pytest.raises(ValueError, match="source row"):
                    kernel(plan, x[:plan.max_src])
    x = torch.randn((spg.padded_nodes, 64), generator=gen, device=cuda)
    _, cpu = _edge_case_shards("cpu", kind)
    for k in (None, 8):
        xk = x if k is None else tmaxk_plain.maxk(x, k)
        y = tps.sharded_planned_aggregate(spg, xk, "gcn", k=k)
        want = tps.sharded_planned_aggregate(cpu, xk.cpu(), "gcn", k=k)
        torch.testing.assert_close(y.cpu(), want, rtol=1e-5, atol=1e-6)
