"""The stream plan's hot set (`StreamPlan.hot_set`), the CBSR records that
`stream_cbsr_spmm` gathers (`ops.maxk.cbsr_records`), and the stream
kernels' warp walk emulated in numpy (CPU; no card, no JAX).

The hot set must follow gather counts, not node ids: the synthetic
stand-ins draw sources by rank, so their most-gathered rows are their lowest
ids, and a hot set that took a window of ids would look right on them and
be worthless on a real graph. The relabelling tests guard against that.
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs import stream_tiles
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.ops import maxk as tmaxk
from spgemm_gnn_tpu_torch.ops.stream import (stream_cbsr_spmm_plain,
                                             stream_spmm_plain)

DIM_ROW = 256 * 4          # stream_spmm's row at the recipes' width
RECORD_ROW = (32 + 8) * 4  # stream_cbsr_spmm's record at k 32, dim 256


def hot_ids(hot, n: int) -> np.ndarray:
    """The ids whose bits are set in a HotSet's mask, ascending."""
    if hot.mask is None:
        return np.zeros(0, dtype=np.int64)
    words = hot.mask.numpy().view(np.uint32).astype(np.int64)
    bits = (words[:, None] >> np.arange(32)) & 1
    return np.nonzero(bits.reshape(-1)[:n])[0]


def top_by_count(indices: np.ndarray, n: int, rows: int) -> np.ndarray:
    """The `rows` ids gathered most, count descending then id ascending,
    among those gathered at all (numpy, independent of the plan)."""
    counts = np.bincount(indices, minlength=n)
    order = np.lexsort((np.arange(n), -counts))
    order = order[counts[order] > 0]
    return np.sort(order[:rows])


def power_plan(seed: int = 3, n: int = 400, e: int = 6000):
    g = tsyn.powerlaw_graph(n, e, seed=seed)
    return g, build_stream_plan(g.indptr, g.indices, chunk=16)


def relabelled(g, perm: np.ndarray):
    """g with node u renamed perm[u] (edges and direction kept)."""
    src, dst = g.indices.numpy(), g.edge_dst.numpy()
    return from_edges(perm[src], perm[dst], g.num_nodes, symmetric=False)


# ---------------------------------------------------------------------------
# the hot set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("row_bytes", [DIM_ROW, RECORD_ROW, 4])
@pytest.mark.parametrize("rows", [1, 7, 40, 399, 10_000])
def test_hot_set_is_the_top_rows_by_gather_count(rows, row_bytes):
    """floor(budget / row bytes) rows, the most gathered first, ties by id;
    never a row that no edge gathers; its edge share is their count."""
    g, plan = power_plan()
    n, idx = g.num_nodes, g.indices.numpy()
    hot = plan.hot_set(row_bytes, rows * row_bytes)
    want = top_by_count(idx, n, rows)
    np.testing.assert_array_equal(hot_ids(hot, n), want)
    assert hot.rows == want.size
    assert hot.edge_share == pytest.approx(np.isin(idx, want).mean(),
                                           abs=1e-12)
    assert (hot.row_bytes, hot.budget) == (row_bytes, rows * row_bytes)


def test_hot_set_ties_go_to_the_lowest_ids():
    """Rows 5, 2 and 7 each gathered twice, 1 once: a hot set of two takes
    2 and 5."""
    src = np.array([5, 2, 7, 5, 2, 7, 1])
    dst = np.array([0, 0, 1, 1, 2, 3, 3])
    g = from_edges(src, dst, 8, symmetric=False)
    plan = build_stream_plan(g.indptr, g.indices, chunk=4)
    np.testing.assert_array_equal(hot_ids(plan.hot_set(10, 20), 8), [2, 5])
    np.testing.assert_array_equal(hot_ids(plan.hot_set(10, 30), 8), [2, 5, 7])


def test_hot_sets_are_nested():
    """Larger budgets and smaller rows only add rows: one order serves
    every row size."""
    g, plan = power_plan(seed=4)
    prev = set()
    for budget in (0, 1 << 12, 5 << 12, 20 << 12, 60 << 12, 1 << 30):
        for row_bytes in (DIM_ROW, RECORD_ROW):
            cur = set(hot_ids(plan.hot_set(row_bytes, budget), g.num_nodes))
            if row_bytes == DIM_ROW:
                assert prev <= cur
                prev = cur
            else:
                assert prev <= cur     # the record is smaller than the row


@pytest.mark.parametrize("budget", [0, 1, 1023, 1024, 20 << 20, 40 << 20])
@pytest.mark.parametrize("row_bytes", [DIM_ROW, RECORD_ROW])
def test_hot_set_fits_its_budget(budget, row_bytes):
    g = tsyn.powerlaw_graph(30_000, 200_000, seed=5)
    plan = build_stream_plan(g.indptr, g.indices)
    hot = plan.hot_set(row_bytes, budget)
    assert hot.rows * row_bytes <= budget
    assert hot.rows == min(budget // row_bytes,
                           int((torch.bincount(g.indices) > 0).sum()))
    assert hot_ids(hot, g.num_nodes).size == hot.rows


def test_hot_set_is_empty_at_budget_0():
    _, plan = power_plan()
    for row_bytes in (DIM_ROW, RECORD_ROW, 1):
        hot = plan.hot_set(row_bytes, 0)
        assert hot.rows == 0 and hot.mask is None and hot.edge_share == 0.0


def test_default_budget():
    _, plan = power_plan()
    assert plan.hot_set(DIM_ROW) is plan.hot_set(DIM_ROW,
                                                 stream_tiles.HOT_BUDGET)
    with pytest.raises(ValueError, match="budget"):
        plan.hot_set(DIM_ROW, -1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hot_set_follows_a_relabelling(seed):
    """Rename the nodes at random: the hot set is the renamed hot set. The
    budget ends where the sorted counts drop, so no tie decides it. On the
    stand-in the hot rows are the lowest ids; after the renaming they are
    not, so a window of ids would fail here."""
    g = tsyn.powerlaw_graph(2000, 30_000, seed=7 + seed)
    n = g.num_nodes
    counts = np.sort(np.bincount(g.indices.numpy(), minlength=n))[::-1]
    drops = np.nonzero(counts[:-1] > counts[1:])[0] + 1
    rows = int(drops[drops >= 50][0])
    perm = np.random.default_rng(seed).permutation(n)
    g2 = relabelled(g, perm)
    for row_bytes in (DIM_ROW, RECORD_ROW):
        budget = rows * row_bytes
        a = build_stream_plan(g.indptr, g.indices).hot_set(row_bytes, budget)
        b = build_stream_plan(g2.indptr, g2.indices).hot_set(row_bytes,
                                                             budget)
        ids, ids2 = hot_ids(a, n), hot_ids(b, n)
        assert ids.size == ids2.size == rows
        np.testing.assert_array_equal(np.sort(perm[ids]), ids2)
        assert a.edge_share == pytest.approx(b.edge_share, abs=1e-12)
    # the stand-in's trap: its hot rows are its lowest ids, the renamed not
    assert ids.max() < 2 * rows
    assert ids2.max() > 2 * rows


def test_hot_set_is_built_once_per_row_size():
    """Kept on the plan per (row bytes, budget), like a CSR schedule."""
    _, plan = power_plan()
    a = plan.hot_set(DIM_ROW)
    assert plan.hot_set(DIM_ROW) is a
    b = plan.hot_set(RECORD_ROW)
    assert b is not a and plan.hot_set(RECORD_ROW) is b
    assert plan.gather_order()[0] is plan.gather_order()[0]


def test_plans_of_both_directions():
    """A symmetric graph's one plan serves A and Aᵀ with one hot set; a
    directed graph's transpose plan counts its own indices (out-edges)."""
    g = tsyn.powerlaw_graph(500, 8000, seed=11)
    pg = tplanned.plan_graph(g, kind="stream", dim=256)
    assert pg.fwd_plan is pg.bwd_plan
    assert pg.fwd_plan._hot[(DIM_ROW, stream_tiles.HOT_BUDGET)] is \
        pg.bwd_plan.hot_set(DIM_ROW)
    d = tsyn.random_graph(500, 8000, seed=11, symmetric=False)
    pd = tplanned.plan_graph(d, kind="stream")
    assert pd.fwd_plan is not pd.bwd_plan
    for plan, idx in ((pd.fwd_plan, d.indices), (pd.bwd_plan, d.t_indices)):
        hot = plan.hot_set(DIM_ROW, 30 * DIM_ROW)
        np.testing.assert_array_equal(
            hot_ids(hot, 500), top_by_count(idx.numpy(), 500, 30))


def test_hot_mask_covers_every_gathered_id():
    """A rectangular plan (sources beyond its rows): the mask has a bit for
    every id its indices hold."""
    indptr = torch.tensor([0, 2, 5], dtype=torch.int32)
    indices = torch.tensor([70, 3, 70, 64, 3], dtype=torch.int32)
    plan = build_stream_plan(indptr, indices, chunk=2)
    hot = plan.hot_set(4, 8)
    assert hot.mask.numel() * 32 >= 71
    np.testing.assert_array_equal(hot_ids(hot, 71), [3, 70])


# ---------------------------------------------------------------------------
# CBSR records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 7, 32])
@pytest.mark.parametrize("dim", [32, 256])
def test_cbsr_records_round_trip(dim, k):
    """k values' bits then the packed ids: back to the same dense rows, and
    160 B per node at k 32, dim 256."""
    rng = np.random.default_rng(dim + k)
    x = rng.standard_normal((50, dim)).astype(np.float32)
    x[3] = 0.0
    x[4, ::2] = -0.0
    vals, ch = tmaxk.cbsr_compact_plain(torch.tensor(x), k)
    rec = tmaxk.cbsr_records(vals, ch, dim)
    kp = tmaxk.packed_channel_words(k, dim)
    assert rec.dtype == torch.int32 and rec.shape == (50, k + kp)
    if (k, dim) == (32, 256):
        assert rec.shape[1] * 4 == 160
    v2, ch2 = tmaxk.split_records(rec, k, dim)
    np.testing.assert_array_equal(v2.numpy().view(np.int32),
                                  vals.numpy().view(np.int32))
    np.testing.assert_array_equal(ch2.numpy(), ch.numpy())
    np.testing.assert_array_equal(
        tmaxk.cbsr_to_dense(v2, ch2, dim).numpy().view(np.int32),
        tmaxk.cbsr_to_dense(vals, ch, dim).numpy().view(np.int32))
    np.testing.assert_array_equal(rec[:, k:].numpy(),
                                  tmaxk.pack_channels(ch, dim).numpy())


@pytest.mark.parametrize("chunk", [3, 128])
@pytest.mark.parametrize("k", [7, 32])
def test_stream_cbsr_plain_on_records(k, chunk):
    """The plain version on records gives the bits it gave on (values,
    packed channels): densified and summed over the plan."""
    dim = 256
    g = tsyn.random_graph(300, 3000, seed=k, symmetric=False)
    plan = build_stream_plan(g.indptr, g.indices, chunk=chunk)
    x = tmaxk.maxk(torch.randn(300, dim, generator=torch.Generator()
                               .manual_seed(k)), k)
    vals, ch = tmaxk.cbsr_compact_plain(x, k)
    post = torch.rand(300, generator=torch.Generator().manual_seed(1)) + 0.5
    got = stream_cbsr_spmm_plain(plan, tmaxk.cbsr_records(vals, ch, dim), k,
                                 dim, None, post)
    unpacked = tmaxk.unpack_channels(tmaxk.pack_channels(ch, dim), k, dim)
    want = stream_spmm_plain(plan, tmaxk.cbsr_to_dense(vals, unpacked, dim),
                             None, post)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.numpy().view(np.int32))
    assert torch.equal(got, stream_spmm_plain(plan, x, None, post))


# ---------------------------------------------------------------------------
# the kernels' warp walk, emulated (csrc/stream.cu::stream_walk_kernel)
# ---------------------------------------------------------------------------

def emulate_walk(plan, x: np.ndarray, pre, post,
                 eps: int | None = None) -> np.ndarray:
    """y of the stream kernels' walk in float64, step for step: a warp per
    span of `warp_chunks` chunks, the row bounds read from a window of 32
    indptr entries, a segment summed from 0 where a row or a chunk ends and
    folded into the row's sum over the span (the row's first segment, then
    each later chunk's added); a row written whole times post where it ends,
    unscaled where it goes on past the span, and a segment of a row that
    began before the span written to its chunk's carry slot; then the carry
    pass over the chunks past each carry row's first span. `eps` walks as
    the bf16-record kernel does (csrc/stream.cu::stream_cbsr16_kernel):
    stages of `eps` edges from the span's start, a stage in which no
    segment ends summed with no test between its edges, the others edge by
    edge with the segment ends."""
    ip = plan.indptr.numpy().astype(np.int64)
    idx = plan.indices.numpy()
    row0 = plan.chunk_row0.numpy()
    n_rows, n_edges, c = plan.num_rows, plan.num_edges, plan.chunk
    n_chunks, wc = plan.num_chunks, plan.warp_chunks
    y = np.full((n_rows, x.shape[1]), np.nan)
    carry = np.zeros((n_chunks, x.shape[1]))
    for c0 in range(0, n_chunks, wc):
        lo = c0 * c
        hi = min(min(c0 + wc, n_chunks) * c, n_edges)
        win = {"base": int(row0[c0])}

        def load(base):
            win["base"] = base
            win["w"] = ip[np.minimum(base + np.arange(32), n_rows)]

        def bound(i):
            if i - win["base"] >= 32:
                load(i)
            return int(win["w"][i - win["base"]])

        load(win["base"])
        r = int(row0[c0])
        rs, re = bound(r), bound(r + 1)
        pr = 1.0 if post is None else post[r]
        q, qlo, qhi = c0, lo, min(lo + c, n_edges)
        seg_end = min(re, qhi)
        acc = np.zeros(x.shape[1])
        head = None

        def consume(e):
            nonlocal acc
            u = idx[e]
            acc = acc + (1.0 if pre is None else pre[u]) * x[u]

        def segment_end(e):
            nonlocal acc, head, r, rs, re, pr, q, qlo, qhi, seg_end
            before = rs < lo
            head = acc if before or rs >= qlo else head + acc
            acc = np.zeros(x.shape[1])
            if before:
                carry[q] = head
            elif re <= qhi:
                y[r] = head * pr
            elif qhi == hi:
                y[r] = head
            if e + 1 < hi:
                if e + 1 == re:
                    rs = re
                    while True:
                        r += 1
                        re = bound(r + 1)
                        if re != rs:
                            break
                    pr = 1.0 if post is None else post[r]
                if e + 1 == qhi:
                    q, qlo = q + 1, qhi
                    qhi = min(qlo + c, n_edges)
                seg_end = min(re, qhi)

        step = eps or 1
        for e0 in range(lo, hi, step):
            if eps is not None and seg_end > e0 + eps and e0 + eps <= hi:
                for e in range(e0, e0 + eps):
                    consume(e)
                continue
            for e in range(e0, min(e0 + step, hi)):
                consume(e)
                if e + 1 == seg_end:
                    segment_end(e)
    for r in plan.carry_rows.numpy():
        a, b = ip[r], ip[r + 1]
        if a == b:
            y[r] = 0.0
            continue
        s = y[r].copy()
        for q in range((a // c // wc + 1) * wc, (b - 1) // c + 1):
            s = s + carry[q]
        y[r] = s * (1.0 if post is None else post[r])
    return y


@pytest.mark.parametrize("warp_chunks", [1, 2, 5, 8])
@pytest.mark.parametrize("chunk", [1, 3, 7, 128])
def test_walk_follows_the_plan(chunk, warp_chunks, eps=None):
    """The emulated walk writes every row, and equals the plain version in
    float64, on a graph with runs of empty rows (more than a window of 32),
    a hub row and rows across many chunks and spans."""
    rng = np.random.default_rng(chunk * 10 + warp_chunks)
    degrees = rng.integers(0, 9, 300)
    degrees[::7] = 0
    degrees[100:150] = 0
    degrees[5] = 700
    degrees[-1] = 0
    dst = np.repeat(np.arange(300), degrees)
    g = from_edges(rng.integers(0, 300, dst.size), dst, 300,
                   symmetric=False)
    plan = build_stream_plan(g.indptr, g.indices, chunk=chunk,
                             warp_chunks=warp_chunks)
    x = rng.standard_normal((300, 8))
    pre = rng.random(300) + 0.5
    post = rng.random(300) + 0.5
    for a, b in ((None, None), (pre, post)):
        got = emulate_walk(plan, x, a, b, eps)
        want = stream_spmm_plain(
            plan, torch.tensor(x), None if a is None else torch.tensor(a),
            None if b is None else torch.tensor(b)).numpy()
        assert not np.isnan(got).any()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("eps", [1, 2, 4])
@pytest.mark.parametrize("warp_chunks", [1, 2, 5, 8])
@pytest.mark.parametrize("chunk", [1, 3, 7, 128])
def test_staged_walk_follows_the_plan(chunk, warp_chunks, eps):
    """The walk in stages of eps edges (stream_cbsr16_kernel at 4, 2 or 1
    edges a stage: records of 1, 2, 4 or 8 128-B lines), with its fast
    path for a stage in which no segment ends, on the graph of
    `test_walk_follows_the_plan`: every row written, equal to the plain
    version in float64."""
    test_walk_follows_the_plan(chunk, warp_chunks, eps)
