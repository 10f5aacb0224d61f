"""The `csr_spmm` schedule (graphs/tiles.py: source blocks and row segments)
and the windowed path over it, on the CPU: the schedule's structure, the
kernel's summation rules followed step by step in numpy, the blocked plain
sum, the source-block rule, and `aggregate` on a forced schedule against the
JAX package's `planned_aggregate`. The kernel itself is held to these on the
card by the `gpu` cases of tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import tiles as ttiles
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.tiles import (FIRST, LAST, CSRPlan,
                                               auto_src_blocks,
                                               build_csr_schedule)
from spgemm_gnn_tpu_torch.kernels import api as tapi
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.ops.spmm import csr_blocked_plain, csr_spmm_plain

N, EDGES, HUB, HUB_EDGES, ISOLATED = 300, 2400, 3, 3000, 20
SEGMENT = 64


def hub_edges(seed: int):
    """Random edges among the first N - ISOLATED nodes (the rest have none)
    and HUB_EDGES in-edges of node HUB: the hub's run is longer than SEGMENT
    in every block, and most rows have no edges in some blocks."""
    rng = np.random.default_rng(seed)
    m = N - ISOLATED
    src = np.concatenate([rng.integers(0, m, EDGES),
                          rng.integers(0, m, HUB_EDGES)])
    dst = np.concatenate([rng.integers(0, m, EDGES), np.full(HUB_EDGES, HUB)])
    keep = src != dst
    return src[keep], dst[keep]


def both_ways(src, dst):
    """The edges and their reverses, repeats kept (a symmetric multigraph:
    to_undirected would cut the hub's 3000 edges to its distinct sources)."""
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def hub_graph(symmetric: bool, seed: int = 11):
    src, dst = hub_edges(seed)
    if symmetric:
        g = from_edges(*both_ways(src, dst), N)
        assert g.symmetric
        return g
    return from_edges(src, dst, N, symmetric=False)


def numpy_csr(g):
    return g.indptr.numpy().astype(np.int64), g.indices.numpy()


@pytest.mark.parametrize("nb", [1, 2, 5])
@pytest.mark.parametrize("symmetric", [True, False])
def test_schedule_covers_each_edge_once_in_order(nb, symmetric):
    g = hub_graph(symmetric)
    ip, ix = numpy_csr(g)
    s = build_csr_schedule(g.indptr, g.indices, N, nb, SEGMENT)
    br = s.block_rows
    assert s.nb == nb and br == -(-N // nb)
    bptr = s.block_indptr.numpy().astype(np.int64)
    sx = s.indices.numpy()
    assert bptr.shape == (nb, N + 1) and sx.shape == ix.shape
    assert bptr[0, 0] == 0 and bptr[-1, -1] == ix.size
    assert (bptr[1:, 0] == bptr[:-1, -1]).all()          # blocks abut
    for r in range(N):
        row = ix[ip[r]:ip[r + 1]]
        for b in range(nb):
            # block b's run of row r: the row's sources in the block, in
            # CSR order
            want = row[row // br == b]
            np.testing.assert_array_equal(sx[bptr[b, r]:bptr[b, r + 1]],
                                          want)
    if nb == 1:
        assert s.indices is g.indices


@pytest.mark.parametrize("nb", [1, 2, 5])
@pytest.mark.parametrize("symmetric", [True, False])
def test_segments_tile_runs_heaviest_first(nb, symmetric):
    g = hub_graph(symmetric)
    s = build_csr_schedule(g.indptr, g.indices, N, nb, SEGMENT)
    bptr = s.block_indptr.numpy().astype(np.int64)
    seg, fix = s.seg.numpy(), s.fix.numpy()
    ps, pf = s.pass_seg.numpy(), s.pass_fix.numpy()
    assert ps[0] == 0 and ps[-1] == len(seg) and pf[-1] == len(fix)
    cnt = bptr[:, 1:] - bptr[:, :-1]
    has = cnt > 0
    slots_used = 0
    for b in range(nb):
        part = seg[ps[b]:ps[b + 1]]
        lengths = part[:, 2] - part[:, 1]
        assert (np.diff(lengths) <= 0).all()             # heaviest first
        assert (lengths <= SEGMENT).all()
        fixes = {int(f[0]): f for f in fix[pf[b]:pf[b + 1]]}
        slots = part[part[:, 3] >= 0, 3]
        assert sorted(slots) == list(range(len(slots)))  # per-pass slots
        slots_used = max(slots_used, len(slots))
        for r in range(N):
            mine = part[part[:, 0] == r]
            mine = mine[np.argsort(mine[:, 1], kind="stable")]
            flags = ((FIRST if has[:b, r].sum() == 0 else 0)
                     | (LAST if has[b + 1:, r].sum() == 0 else 0))
            if not has[b, r]:
                # only a row without edges anywhere gets an (empty) segment,
                # in pass 0
                if b == 0 and not has[:, r].any():
                    np.testing.assert_array_equal(
                        mine, [[r, 0, 0, -1 - (FIRST | LAST)]])
                else:
                    assert len(mine) == 0
                continue
            # the pieces tile the run in order
            assert mine[0, 1] == bptr[b, r] and mine[-1, 2] == bptr[b, r + 1]
            assert (mine[1:, 1] == mine[:-1, 2]).all()
            if cnt[b, r] <= SEGMENT:
                assert len(mine) == 1 and mine[0, 3] == -1 - flags
                assert r not in fixes
            else:
                assert len(mine) == -(-cnt[b, r] // SEGMENT)
                lo = mine[0, 3]
                np.testing.assert_array_equal(mine[:, 3],
                                              lo + np.arange(len(mine)))
                np.testing.assert_array_equal(fixes[r],
                                              [r, lo, lo + len(mine), flags])
    assert s.n_slots == slots_used
    # the hub's run is split in every block
    assert s.num_split_runs >= nb


def emulate(s, x, pre, post):
    """The kernel's rules step by step in float64, from the schedule alone:
    per pass, each segment's sum goes to y (write on FIRST, else add; times
    post on LAST) or to its scratch slot; then each fix-up adds its slots in
    order and writes the row the same way. Unwritten rows stay NaN."""
    ix = s.indices.numpy()
    seg, fix = s.seg.numpy(), s.fix.numpy()
    ps, pf = s.pass_seg.numpy(), s.pass_fix.numpy()
    xs = x * pre[:, None]
    y = np.full((post.size, x.shape[1]), np.nan)

    def store(r, flags, acc):
        v = acc if flags & FIRST else y[r] + acc
        y[r] = v * post[r] if flags & LAST else v

    for b in range(s.nb):
        scratch = np.full((s.n_slots, x.shape[1]), np.nan)
        for r, lo, hi, out in seg[ps[b]:ps[b + 1]]:
            acc = xs[ix[lo:hi]].sum(0)
            if out >= 0:
                scratch[out] = acc
            else:
                store(r, -1 - out, acc)
        for r, a, c, flags in fix[pf[b]:pf[b + 1]]:
            store(r, flags, scratch[a:c].sum(0))
    return y


@pytest.mark.parametrize("nb", [1, 2, 5])
@pytest.mark.parametrize("symmetric", [True, False])
def test_kernel_rules_over_schedule_give_the_product(nb, symmetric):
    g = hub_graph(symmetric)
    rng = np.random.default_rng(nb)
    x = rng.standard_normal((N, 12))
    pre, post = rng.random(N) + 0.5, rng.random(N) + 0.5
    s = build_csr_schedule(g.indptr, g.indices, N, nb, SEGMENT)
    got = emulate(s, x, pre, post)
    want = csr_spmm_plain(g.indptr, g.indices, torch.tensor(x),
                          torch.tensor(pre), torch.tensor(post)).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert (got[N - ISOLATED:] == 0).all()


@pytest.mark.parametrize("nb", [1, 2, 5])
def test_blocked_plain_sum_equals_whole(nb):
    """In float64, so that what is held is the re-bucketing and not the
    f32 rounding of a 3000-term row summed in another order: within 1e-12
    of max."""
    g = hub_graph(False)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.standard_normal((N, 16)))
    pre, post = torch.tensor(rng.random(N)), torch.tensor(rng.random(N))
    s = build_csr_schedule(g.indptr, g.indices, N, nb, SEGMENT)
    got = csr_blocked_plain(s.block_indptr, s.indices, x, pre, post)
    want = csr_spmm_plain(g.indptr, g.indices, x, pre, post)
    err = float((got - want).abs().max())
    assert err <= 1e-12 * float(want.abs().max()), err
    if nb == 1:
        assert torch.equal(got, want)


def test_src_block_rule_at_full_size():
    """The stand-ins' N and E at width 256: Reddit takes L2-sized blocks
    (233k rows × 1 KB over 24 MiB: 10), ogbn-products one block (an L2-sized
    block holds about 0.5 of a row's edges)."""
    from spgemm_gnn_tpu_torch.graphs.datasets import SYNTH_SPECS
    r, p = SYNTH_SPECS["reddit"], SYNTH_SPECS["ogbn-products"]
    assert auto_src_blocks(r["n"], r["e"], 256) == 10
    assert auto_src_blocks(p["n"], p["e"], 256) == 1
    # blocks grow with the width, and a small x is one block
    assert auto_src_blocks(r["n"], r["e"], 1024) == 38
    assert auto_src_blocks(N, 50 * N, 256) == 1
    # at or above the threshold of edges per (row, block) blocking stays
    n = 200_000
    nb = -(-n * 1024 // ttiles.L2_BLOCK_BYTES)
    e = int(n * nb * ttiles.MIN_EDGES_PER_BLOCK_ROW)
    assert auto_src_blocks(n, e, 256) == nb
    assert auto_src_blocks(n, e - n, 256) == 1


def _jax_graph(symmetric: bool):
    from spgemm_gnn_tpu.graphs import csr as jcsr
    src, dst = hub_edges(11)
    if symmetric:
        return jcsr.from_edges(*both_ways(src, dst), N, symmetric=True)
    return jcsr.from_edges(src, dst, N, symmetric=False)


@pytest.mark.parametrize("nb", [1, 2, 5])
@pytest.mark.parametrize("norm", ["sum", "mean", "gcn"])
@pytest.mark.parametrize("kind", ["symmetric", "directed"])
def test_aggregate_on_forced_schedule_matches_jax(kind, norm, nb):
    """As test_torch_kernels.py::test_aggregate_matches_jax, on a windowed
    plan with a forced schedule (nb blocks, segments of 64)."""
    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels.planned import plan_graph, planned_aggregate

    sym = kind == "symmetric"
    jg, tg = _jax_graph(sym), hub_graph(sym)
    np.testing.assert_array_equal(np.asarray(jg.indices), tg.indices.numpy())
    rng = np.random.default_rng(len(norm) + nb)
    x = rng.standard_normal((N, 32)).astype(np.float32)
    ct = rng.standard_normal((N, 32)).astype(np.float32)
    pg = plan_graph(jg, tile_slots=128, src_block=128, dst_block=128,
                    window=8)
    y_ref, vjp = jax.vjp(lambda v: planned_aggregate(pg, v, norm),
                         jnp.asarray(x))
    dx_ref = np.asarray(vjp(jnp.asarray(ct))[0])
    fwd = CSRPlan(tg.indptr, tg.indices, nb, SEGMENT)
    bwd = fwd if sym else CSRPlan(tg.t_indptr, tg.t_indices, nb, SEGMENT)
    tpg = tplanned.PlannedGraph(graph=tg, fwd_plan=fwd, bwd_plan=bwd)
    assert fwd.schedule(N, 32).nb == bwd.schedule(N, 32).nb == nb
    xt = torch.tensor(x, requires_grad=True)
    y = tapi.aggregate(tpg, xt, norm=norm, impl="auto")
    (y * torch.tensor(ct)).sum().backward()
    # within 1e-5 of the output's largest magnitude, as on the card: the
    # plain version sums the hub's 3000 terms with one running f32 sum per
    # block, which reads up to 4.9e-6 of max against the JAX package (whose
    # tiled sums come within 5e-7 of float64)
    for got, ref in ((y.detach().numpy(), np.asarray(y_ref)),
                     (xt.grad.numpy(), dx_ref)):
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("symmetric", [True, False])
def test_schedules_built_once(monkeypatch, symmetric):
    """A plain Graph's plans are made once and kept (`graph_plans`), so the
    second aggregation builds no schedule; plan_graph with `dim` builds
    them up front, one for a symmetric graph (A is Aᵀ), else two."""
    builds = []
    real = ttiles.build_csr_schedule

    def counting(*args, **kw):
        builds.append(args[3])
        return real(*args, **kw)

    monkeypatch.setattr(ttiles, "build_csr_schedule", counting)
    g = hub_graph(symmetric)
    x = torch.randn(N, 8, requires_grad=True)
    for _ in range(2):
        tplanned.planned_aggregate(g, x, "mean").sum().backward()
    assert len(builds) == (1 if symmetric else 2)
    assert tplanned.graph_plans(g)[0] is tplanned.graph_plans(g)[0]
    builds.clear()
    pg = tplanned.plan_graph(g, kind="windowed", dim=8)
    assert len(builds) == (1 if symmetric else 2)
    tplanned.planned_aggregate(pg, x, "mean").sum().backward()
    assert len(builds) == (1 if symmetric else 2)
    # a moved graph starts with no plans of its own
    assert g.to("cpu").plans is None
