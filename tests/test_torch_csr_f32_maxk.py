"""The f32 forms of the MaxK pair on a windowed plan: `csr_cbsr_spmm` on f32
records (kernel `csr_cbsr_spmm`: y = post ⊙ A (pre ⊙ densify(records)) at
the dense f32 form's schedule) for the forward, `csr_sspmm` on f32
messages (kernel `csr_sspmm`: MaxK's backward on Aᵀ at each row's k kept
channels, pre applied per edge) for the backward, and the f32 side of the
planner's rules (`cbsr_forward`, `sampled_backward`).

CPU: both plain versions bit for bit the blocked dense plain sum
(`csr_blocked_plain` with pre and post) on the densified rows / at the
kept channels; both kernels' walks emulated in numpy f32 with each term an
FMA by the edge's pre factor, bit-equal to the dense kernel's walk; the
plain versions against JAX `spgemm_forward` and `sspmm_backward` with
`stream_dtype=float32` (Pallas kernels in interpret mode);
`planned_aggregate` in f32 with k and MaxK's ids on a windowed plan
against JAX `planned_aggregate`, forward and gradient; the Trainer with
each flag on and off, losses bit-equal; a stream plan in f32 takes
`stream_sspmm` on f32 messages. GPU (marker `gpu`, skipped without a card, no JAX): both
kernels bit for bit the dense `csr_spmm` at nb None/1/3 with and without
pre (csr_cbsr_spmm also at nb 5 in 3 record passes), their launch counts,
`record_passes`, and the wrappers' raises. CPU, besides: the record-pass
walk (`graphs/tiles.py::RecordWalk`) in numpy bit-equal to the per-block
walk at every grouping, and the grouping rule at the recipes' shapes.

    python -m pytest tests/test_torch_csr_f32_maxk.py
    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_csr_f32_maxk.py
"""
import numpy as np
import pytest
import torch

from spgemm_gnn_tpu_torch.graphs import synthetic as tsyn
from spgemm_gnn_tpu_torch.graphs import tiles
from spgemm_gnn_tpu_torch.graphs.csr import from_edges
from spgemm_gnn_tpu_torch.graphs.datasets import SYNTH_SPECS
from spgemm_gnn_tpu_torch.graphs.tiles import (FIRST, LAST, PIECE, CSRPlan,
                                               auto_src_blocks,
                                               build_record_walk,
                                               record_group)
from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.kernels import planned as tplanned
from spgemm_gnn_tpu_torch.kernels.maxk import maxk_fwd
from spgemm_gnn_tpu_torch.kernels.spmm import (csr_cbsr_spmm, csr_spmm,
                                               csr_sspmm)
from spgemm_gnn_tpu_torch.ops import maxk as tmaxk
from spgemm_gnn_tpu_torch.ops.norms import node_factors
from spgemm_gnn_tpu_torch.ops.spmm import (csr_blocked_plain, csr_cbsr_plain,
                                           csr_sspmm_plain)

F32 = torch.float32
N, SEGMENT = 300, 64


@pytest.fixture
def one_torch_thread():
    """One torch thread for the Trainer runs this file compares bit for
    bit (as tests/test_torch_stream.py::one_torch_thread)."""
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


def hub_graph(n: int = N, seed: int = 11, hub_edges: int = 700):
    """Directed: random degrees 0-11, rows without edges (every 50th and
    the last 20) on both A and Aᵀ's sides, and node 3 with `hub_edges`
    in-edges and as many out-edges, whose runs are cut into pieces in every
    source block."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 12, n)
    deg[::50] = 0
    deg[-20:] = 0
    deg[3] = hub_edges
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n, dst.size)
    src[rng.choice(np.flatnonzero(dst != 3), hub_edges, replace=False)] = 3
    return from_edges(src, dst, n, symmetric=False)


def records_of(rng, n: int, dim: int, k: int, device="cpu", ints=False):
    """k-sparse f32 rows and their f32 records: k distinct random channels
    a row holding normals (or, with `ints`, integers in [-4, 4], whose f32
    sums are exact in any order), some slots 0 (short rows), row 1 empty.
    Returns (dense f32 [n, dim], records int32 [n, k + ceil(k / 4)])."""
    if ints:
        vals = rng.integers(-4, 5, (n, k)).astype(np.float32)
    else:
        vals = rng.standard_normal((n, k)).astype(np.float32)
        vals[rng.random((n, k)) < 0.1] = 0.0
    vals[1] = 0.0
    ch = np.argsort(rng.random((n, dim)), axis=1)[:, :k].astype(np.int32)
    v = torch.tensor(vals, device=device)
    c = torch.tensor(ch, device=device)
    return (tmaxk.cbsr_to_dense(v, c, dim),
            tmaxk.cbsr_records(v, c, dim).contiguous())


def factor(rng, n: int, kind: str, device="cpu"):
    """A node factor: None, or GCN's deg^-1/2 of random degrees."""
    if kind == "none":
        return None
    deg = rng.integers(1, 40, n).astype(np.float32)
    return torch.tensor(deg ** -0.5, device=device)


def kept(y: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
    """y at each row's channels ch, 0 elsewhere."""
    keep = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    keep.scatter_(1, ch.long(), True)
    return torch.where(keep, y, torch.zeros((), dtype=y.dtype,
                                            device=y.device))


def bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().view(torch.int32).numpy()


def near(got, ref, frac: float = 1e-5) -> None:
    """Within `frac` of ref's largest magnitude: the same f32 values summed
    in another order."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max()) if got.size else 0.0
    assert err <= frac * max(float(np.abs(ref).max()), 1e-30), err


def _spy(monkeypatch, *names: str) -> list:
    calls = []
    for name in names:
        fn = getattr(tplanned, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(tplanned, name, spy)
    return calls


# ---------------------------------------------------------------------------
# CPU: the plain versions and the wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pre_kind", ["none", "gcn"])
@pytest.mark.parametrize("dim,k", [(64, 8), (256, 32), (128, 40)])
@pytest.mark.parametrize("nb", [1, 3])
def test_f32_plain_forms_are_the_dense_plain(nb, dim, k, pre_kind):
    """On a schedule of nb source blocks (segments of 64, the hub split
    into pieces, rows without edges), with and without a pre factor and
    with a post factor: csr_cbsr_plain on f32 records is
    csr_blocked_plain(densified, pre, post) bit for bit, and the wrapper on
    CPU tensors csr_spmm on those rows; csr_sspmm on f32 messages is
    csr_spmm(plan, m, pre, post) at each row's kept channels, +0 at the
    others, bit for bit, and its plain version the same."""
    g = hub_graph()
    rng = np.random.default_rng(nb * 100 + k)
    dense, rec = records_of(rng, N, dim, k)
    pre = factor(rng, N, pre_kind)
    post = torch.tensor(rng.random(N).astype(np.float32) + 0.5)
    plan = CSRPlan(g.indptr, g.indices, nb, SEGMENT)
    s = plan.schedule(N, dim, 4)
    assert s.nb == nb and s.num_split_runs >= nb
    got = csr_cbsr_plain(s.block_indptr, s.indices, rec, k, dim, post,
                         pre=pre, value_dtype=F32)
    np.testing.assert_array_equal(bits(got), bits(csr_blocked_plain(
        s.block_indptr, s.indices, dense, pre, post)))
    y = csr_cbsr_spmm(plan, rec, k, dim, post, pre=pre, value_dtype=F32)
    np.testing.assert_array_equal(bits(y), bits(csr_spmm(plan, dense, pre,
                                                         post)))
    assert (y[g.indptr.diff() == 0] == 0).all()

    t_plan = CSRPlan(g.t_indptr, g.t_indices, nb, SEGMENT)
    m = torch.tensor(rng.standard_normal((N, dim)).astype(np.float32))
    _, _, ch = maxk_fwd(torch.tensor(rng.standard_normal((N, dim)).astype(
        np.float32)), k, with_ids=True)
    dx = csr_sspmm(t_plan, m, ch, post, pre=pre)
    assert dx.shape == (N, dim) and dx.dtype == F32
    np.testing.assert_array_equal(bits(dx), bits(kept(
        csr_spmm(t_plan, m, pre, post), ch)))
    ts = t_plan.schedule(N, dim, 4)
    np.testing.assert_array_equal(bits(dx), bits(csr_sspmm_plain(
        ts.block_indptr, ts.indices, m, ch, post, pre=pre)))


def test_f32_wrappers_check_their_inputs():
    """f32 records: dim % 4, dim <= 256, 1 <= k < dim, the f32 record
    width, no bf16 output; bf16 records take no pre. f32 messages: dim %
    4, no bf16 output; bf16 messages take no pre."""
    g = hub_graph()
    plan = CSRPlan(g.indptr, g.indices)
    _, rec = records_of(np.random.default_rng(0), N, 64, 8)
    for k, dim, match in ((64, 64, "1 <= k < dim"), (8, 260, "<= 256"),
                          (8, 66, "dim % 4"), (0, 64, "1 <= k")):
        with pytest.raises(ValueError, match=match):
            csr_cbsr_spmm(plan, rec, k, dim, value_dtype=F32)
    with pytest.raises(ValueError, match="shape"):
        csr_cbsr_spmm(plan, rec[:, :9].contiguous(), 8, 64, value_dtype=F32)
    with pytest.raises(ValueError, match="bf16 output needs bf16"):
        csr_cbsr_spmm(plan, rec, 8, 64, None, torch.bfloat16,
                      value_dtype=F32)
    with pytest.raises(ValueError, match="f32 or bf16 record values"):
        csr_cbsr_spmm(plan, rec, 8, 64, value_dtype=torch.float16)
    rec16 = torch.zeros((N, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="pre factor"):
        csr_cbsr_spmm(plan, rec16, 8, 64, pre=torch.ones(N))
    ch = torch.zeros((N, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="dim % 4"):
        csr_sspmm(plan, torch.zeros((N, 66)), ch)
    with pytest.raises(ValueError, match="pre factor"):
        csr_sspmm(plan, torch.zeros((N, 64), dtype=torch.bfloat16), ch,
                  pre=torch.ones(N))


# ---------------------------------------------------------------------------
# CPU: the kernels' walks, emulated (csrc/spmm.cu)
# ---------------------------------------------------------------------------

def fma(s, v, p):
    """f32 s · v + p with one rounding: the product is exact in float64
    (24 + 24 bits) and the sum rounds there before f32, the same
    arithmetic for every walk compared here (an exact zero term leaves p
    as it is)."""
    return (np.float64(s) * np.asarray(v, np.float64)
            + np.asarray(p, np.float64)).astype(np.float32)


def walk(s, pre, post, dim: int, n: int, cols, edge_add) -> np.ndarray:
    """csr_spmm's segment walk in f32, step for step, at the columns
    cols[r] of each row r: per pass a warp per segment; a batch of 32 edges
    summed from +0 (`edge_add(part, e, r)` adds edge e), then added to the
    segment's sum; a whole segment's sums added to the row's (FIRST: set),
    a piece's to its scratch slot; each fix-up adds its slots in order and
    finishes its row the same way; on LAST the row is written: 0, and at
    the columns the sums times post. Unwritten rows stay NaN."""
    f32 = np.float32
    seg, fix = s.seg.numpy(), s.fix.numpy()
    ps, pf = s.pass_seg.numpy(), s.pass_fix.numpy()
    acc = {}
    y = np.full((n, dim), np.nan, f32)

    def finish(r, flags, v):
        v = v if flags & FIRST else acc[r] + v
        if not flags & LAST:
            acc[r] = v
            return
        y[r] = 0
        y[r, cols[r]] = v * (f32(1) if post is None else post[r])

    for b in range(s.nb):
        scratch = {}
        for r, lo, hi, out in seg[ps[b]:ps[b + 1]]:
            v = np.zeros(len(cols[r]), f32)
            for base in range(lo, hi, 32):
                part = np.zeros(len(cols[r]), f32)
                for e in range(base, min(base + 32, hi)):
                    part = edge_add(part, e, r)
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


@pytest.mark.parametrize("pre_kind", ["none", "gcn"])
@pytest.mark.parametrize("nb", [1, 3])
def test_f32_walks_are_the_dense_walk_bit_for_bit(nb, pre_kind):
    """Forward: the record walk (each edge's nonzero f32 slots added into
    the batch's partial row by an FMA with the edge's pre factor, in edge
    order) against csr_spmm's (every channel of every densified row,
    zeros included): the same bits. Backward: the sampled walk (compact
    sums at each row's kept channels across the passes, each term an FMA
    by pre) against the dense walk at every channel: the same bits at the
    kept channels, 0 elsewhere. Both within 1e-5 of max |y| of the plain
    version in float64."""
    g = hub_graph()
    dim, k = 32, 8
    rng = np.random.default_rng(nb + len(pre_kind))
    dense, rec = records_of(rng, N, dim, k)
    pre = factor(rng, N, pre_kind)
    post = rng.random(N).astype(np.float32) + 0.5
    pre_np = np.ones(N, np.float32) if pre is None else pre.numpy()
    every = [np.arange(dim)] * N

    s = CSRPlan(g.indptr, g.indices, nb, SEGMENT).schedule(N, dim, 4)
    assert s.num_split_runs > 0
    ix = s.indices.numpy()
    rows = dense.numpy()
    vals, ch = tmaxk.split_records(rec, k, dim, F32)
    vals, ch = vals.numpy(), ch.numpy()

    def dense_add(part, e, r):
        return fma(pre_np[ix[e]], rows[ix[e]], part)

    def record_add(part, e, r):
        u = ix[e]
        for v, c in zip(vals[u], ch[u]):
            if v != 0:
                part[c] = fma(pre_np[u], v, part[c])
        return part

    got = walk(s, pre, post, dim, N, every, record_add)
    want = walk(s, pre, post, dim, N, every, dense_add)
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ref = csr_blocked_plain(s.block_indptr, s.indices, dense.double(),
                            None if pre is None else pre.double(),
                            torch.tensor(post).double()).numpy()
    near(got, ref)

    ts = CSRPlan(g.t_indptr, g.t_indices, nb, SEGMENT).schedule(N, dim, 4)
    assert ts.num_split_runs > 0
    tix = ts.indices.numpy()
    m = rng.standard_normal((N, dim)).astype(np.float32)
    _, _, ids = maxk_fwd(torch.tensor(rng.standard_normal((N, dim)).astype(
        np.float32)), k, with_ids=True)
    cols = ids.long().numpy()

    def sampled_add(part, e, r):
        return fma(pre_np[tix[e]], m[tix[e], cols[r]], part)

    def dense_t_add(part, e, r):
        return fma(pre_np[tix[e]], m[tix[e]], part)

    got = walk(ts, pre, post, dim, N, cols, sampled_add)
    dense_t = walk(ts, pre, post, dim, N, every, dense_t_add)
    assert not np.isnan(got).any()
    want = kept(torch.tensor(dense_t), ids).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    ref = csr_blocked_plain(ts.block_indptr, ts.indices,
                            torch.tensor(m).double(),
                            None if pre is None else pre.double(),
                            torch.tensor(post).double())
    near(got, kept(ref, ids).numpy())


def record_pass_walk(w, post, dim: int, n: int, edge_add) -> np.ndarray:
    """csr_cbsr_kernel's record walk (graphs/tiles.py::RecordWalk) in f32,
    step for step: per record pass, a warp per piece, then a warp per row;
    each whole run summed in batches of 32 edges from +0 (`edge_add(part,
    e)` adds edge e), each batch's sum added to the run's; each split run
    its slots in order; each run's sum added to the entry's, which starts
    at +0 (FIRST) or at y; a piece's sum to its slot, a row's to y, times
    post on LAST. Unwritten rows stay NaN."""
    f32 = np.float32
    ent, runs, off = w.entries.numpy(), w.runs.numpy(), w.offsets.numpy()
    y = np.full((n, dim), np.nan, f32)
    scratch = {}
    for out, lo, hi, flags in ent[off[0]:off[-1]]:
        total = np.zeros(dim, f32) if flags & FIRST else y[out].copy()
        for a, z in runs[lo:hi]:
            if a >= 0:
                v = np.zeros(dim, f32)
                for base in range(a, z, 32):
                    part = np.zeros(dim, f32)
                    for e in range(base, min(base + 32, z)):
                        part = edge_add(part, e)
                    v = v + part
            else:
                v = scratch[-1 - a].copy()
                for q in range(-a, z):
                    v = v + scratch[q]
            total = total + v
        if flags & PIECE:
            scratch[out] = total
        else:
            y[out] = total * (f32(1) if post is None or not flags & LAST
                              else post[out])
    return y


@pytest.mark.parametrize("rec", ["f32", "f32-gcn", "bf16"])
@pytest.mark.parametrize("nb", [1, 3, 5])
def test_record_passes_are_the_block_walk_bit_for_bit(nb, rec):
    """The record-pass walk at every grouping of the schedule's nb blocks
    (1 block a pass to all of them) against the per-block walk of
    csr_spmm's segments and fix-ups, on the same records: the same bits,
    for f32 records with no pre and with GCN's, and bf16 records; the hub's
    runs split into pieces of 64 in every block. A pass's slots are those
    of its blocks' passes one after another, and it launches its pieces
    (when it has any), then its rows."""
    g = hub_graph()
    dim, k = 32, 8
    rng = np.random.default_rng(nb * 7 + len(rec))
    dense, records = records_of(rng, N, dim, k)
    value = F32
    if rec == "bf16":
        value = torch.bfloat16
        vals, ch = tmaxk.split_records(records, k, dim, F32)
        records = tmaxk.cbsr_records(vals.to(value), ch, dim)
    pre = factor(rng, N, "gcn" if rec == "f32-gcn" else "none")
    post = rng.random(N).astype(np.float32) + 0.5
    pre_np = np.ones(N, np.float32) if pre is None else pre.numpy()
    s = CSRPlan(g.indptr, g.indices, nb, SEGMENT).schedule(N, dim, 4)
    assert s.num_split_runs > 0
    ix = s.indices.numpy()
    vals, ch = tmaxk.split_records(records, k, dim, value)
    vals, ch = vals.float().numpy(), ch.numpy()

    def record_add(part, e, r=None):
        u = ix[e]
        for v, c in zip(vals[u], ch[u]):
            if v != 0:
                part[c] = fma(pre_np[u], v, part[c])
        return part

    want = walk(s, pre, post, dim, N, [np.arange(dim)] * N, record_add)
    assert not np.isnan(want).any()
    for group in range(1, nb + 1):
        w = build_record_walk(s, group)
        assert w.passes == -(-nb // group)
        launches = (w.offsets[1:] > w.offsets[:-1]).view(-1, 2)
        assert launches[:, 1].all()
        assert w.launched == w.passes
        got = record_pass_walk(w, post, dim, N, record_add)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("name,elem,record_bytes,passes", [
    ("reddit", 4, 160, 2), ("reddit", 2, 128, 2),
    ("ogbn-proteins", 4, 160, 1), ("ogbn-proteins", 2, 128, 1),
    ("flickr", 4, 160, 1)])
def test_record_group_rule(name, elem, record_bytes, passes):
    """The grouping at the recipes' shapes (dim 256, k 32: 160-B f32
    records on f32 rows' schedule, 128-B bf16 ones on bf16 rows'): Reddit
    6 of 10 blocks a pass (2 passes) in f32 and 4 of 5 (2) in bf16;
    proteins and the flickr stand-in one pass; and a schedule's walk
    keeps to that rule, once built."""
    spec = SYNTH_SPECS[name]
    nb = auto_src_blocks(spec["n"], spec["e"], 256, spec["n"], elem)
    block_rows = -(-spec["n"] // nb)
    group = min(record_group(block_rows, record_bytes), nb)
    assert -(-nb // group) == passes
    if name == "reddit":
        assert (nb, group) == ((10, 6) if elem == 4 else (5, 4))
    g = hub_graph()
    s = CSRPlan(g.indptr, g.indices, 3, SEGMENT).schedule(N, 32, 4)
    w = s.record_walk(record_bytes)
    assert w is s.record_walk(record_bytes)
    assert w.group == min(record_group(s.block_rows, record_bytes), 3)


# ---------------------------------------------------------------------------
# CPU: against the JAX package
# ---------------------------------------------------------------------------

def _graphs():
    from spgemm_gnn_tpu.graphs import synthetic as jsyn
    return (jsyn.random_graph(200, 1500, seed=5, symmetric=False),
            tsyn.random_graph(200, 1500, seed=5, symmetric=False))


JPLAN = dict(kind="windowed", tile_slots=128, src_block=128, dst_block=128,
             window=8)


def _j(t: torch.Tensor | None):
    import jax.numpy as jnp
    return None if t is None else jnp.asarray(t.numpy())


@pytest.mark.parametrize("norm", ["mean", "gcn"])
def test_f32_pair_matches_jax_cbsr_pair(norm, monkeypatch):
    """The port's `spgemm_forward` on f32 values over a windowed plan (at
    the default rule csr_cbsr_spmm on f32 records, no densify) against JAX
    `spgemm_forward(stream_dtype=float32)` (densify, then the windowed
    kernel, interpret); csr_sspmm on the f32 cotangent with pre dst_f and
    post src_f at the channels, against JAX `sspmm_backward(stream_dtype=
    float32)`: both within 1e-5 of max |y|, and the backward 0 at the
    other channels."""
    import jax.numpy as jnp
    from spgemm_gnn_tpu.kernels import planned as jplanned

    jg, tg = _graphs()
    n, dim, k = tg.num_nodes, 64, 8
    rng = np.random.default_rng(len(norm))
    vals = torch.tensor(rng.standard_normal((n, k)).astype(np.float32))
    ch = torch.tensor(np.sort(np.argsort(rng.random((n, dim)), axis=1)[:, :k],
                              axis=1).astype(np.int32))
    g_ct = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32))
    src_f, dst_f = node_factors(tg, norm)
    jpg = jplanned.plan_graph(jg, **JPLAN)
    jplans = (jpg.fwd_plan, jpg.bwd_plan)
    y_j = np.asarray(jplanned.spgemm_forward(
        dim, jnp.asarray(vals.numpy()), jnp.asarray(ch.numpy()), _j(src_f),
        _j(dst_f), jplans, stream_dtype=jnp.float32))
    dv_j = np.asarray(jplanned.sspmm_backward(
        jnp.asarray(g_ct.numpy()), jnp.asarray(ch.numpy()), _j(src_f),
        _j(dst_f), jplans, stream_dtype=jnp.float32))

    tpg = tplanned.plan_graph(tg, kind="windowed", dim=dim)
    calls = _spy(monkeypatch, "csr_cbsr_spmm", "cbsr_densify", "csr_spmm")
    y = tplanned.spgemm_forward(dim, vals, ch, src_f, dst_f,
                                (tpg.fwd_plan, tpg.bwd_plan))
    assert calls == ["csr_cbsr_spmm"]
    near(y.numpy(), y_j)
    dx = csr_sspmm(tpg.bwd_plan, g_ct, ch.to(torch.uint8), src_f, pre=dst_f)
    near(torch.gather(dx, 1, ch.long()).numpy(), dv_j)
    np.testing.assert_array_equal(bits(dx), bits(kept(dx, ch)))


@pytest.mark.parametrize("norm", ["mean", "gcn"])
@pytest.mark.parametrize("kind", ["windowed", "stream"])
def test_f32_planned_aggregate_matches_jax(kind, norm, monkeypatch):
    """planned_aggregate in f32 with k and MaxK's ids at the default
    rules against JAX `planned_aggregate` (the dense kernel, interpret):
    y within 1e-5 of max, dx within 1e-5 at the kept channels. On a
    windowed plan the forward takes csr_cbsr_spmm and the backward
    csr_sspmm (dx 0 at the other channels, which MaxK's backward zeroes);
    on a stream plan the forward takes stream_cbsr_spmm and the backward
    stream_sspmm on the f32 cotangent (dx 0 at the other channels too),
    and `wants_channel_ids` says so on both. Each forward equals its
    flag-off forward bit for bit (windowed) or by value (stream)."""
    import importlib

    import jax
    import jax.numpy as jnp
    from spgemm_gnn_tpu_torch.kernels import api as tapi
    jplanned = importlib.import_module("spgemm_gnn_tpu.kernels.planned")

    jg, tg = _graphs()
    n, dim, k = tg.num_nodes, 32, 8
    rng = np.random.default_rng(len(kind) + len(norm))
    h = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32))
    x, _, ids = maxk_fwd(h, k, with_ids=True)
    ct = torch.tensor(rng.standard_normal((n, dim)).astype(np.float32))
    jpg = jplanned.plan_graph(jg, **JPLAN)
    y_j, vjp = jax.vjp(lambda v: jplanned.planned_aggregate(jpg, v, norm,
                                                            k=k),
                       jnp.asarray(x.numpy()))
    dx_j = np.asarray(vjp(jnp.asarray(ct.numpy()))[0], np.float32)

    tpg = tplanned.plan_graph(tg, kind=kind, dim=dim, chunk=16)
    xt = x.clone().requires_grad_(True)
    assert tplanned.wants_channel_ids(tpg, k, xt)
    calls = _spy(monkeypatch, "csr_cbsr_spmm", "csr_sspmm", "csr_spmm",
                 "stream_cbsr_spmm", "stream_sspmm", "stream_spmm")
    y = tapi.aggregate(tpg, xt, norm=norm, k=k, ids=ids)
    y.backward(ct)
    if kind == "windowed":
        assert calls == ["csr_cbsr_spmm", "csr_sspmm"]
    else:
        assert calls == ["stream_cbsr_spmm", "stream_sspmm"]
    np.testing.assert_array_equal(bits(xt.grad), bits(kept(xt.grad, ids)))
    near(y.detach().numpy(), np.asarray(y_j))
    near(kept(xt.grad, ids).numpy(),
         kept(torch.tensor(dx_j), ids).numpy())
    monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", False)
    off = tapi.aggregate(tpg, x, norm=norm, k=k)
    if kind == "windowed":
        np.testing.assert_array_equal(bits(y), bits(off))
    else:
        near(y.detach().numpy(), off.numpy(), 1e-6)


# ---------------------------------------------------------------------------
# CPU: the Trainer with each flag on and off
# ---------------------------------------------------------------------------

def test_f32_trainer_with_each_flag_gives_the_same_losses(monkeypatch,
                                                          one_torch_thread):
    """The Trainer on the flickr stand-in at scale 0.004 (a windowed
    plan), f32, MaxK k 8, dropout 0.5, 2 epochs: at the default rules each
    MaxK forward takes csr_cbsr_spmm (a train and an eval forward of each
    of 2 layers an epoch) and each MaxK backward csr_sspmm; with
    STREAM_CBSR_FORWARD off the forwards take csr_spmm, with
    SAMPLED_BACKWARD off the backwards do. The same schedule, so the three
    runs' losses are bit-equal."""
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    cfg = TrainConfig(dataset="flickr", model="sage", epochs=2,
                      hidden_dim=32, hidden_layers=2, maxk=8, dropout=0.5,
                      w_lr=0.01, nonlinear="maxk", norm=True, synthetic=True,
                      synthetic_scale=0.004, eval_every=1, log_every=0,
                      seed=3, device="cpu")
    calls = _spy(monkeypatch, "csr_cbsr_spmm", "csr_sspmm")
    want = {None: {"csr_cbsr_spmm": 8, "csr_sspmm": 4},
            "STREAM_CBSR_FORWARD": {"csr_sspmm": 4},
            "SAMPLED_BACKWARD": {"csr_cbsr_spmm": 8}}
    losses = {}
    for off in want:
        for flag in ("STREAM_CBSR_FORWARD", "SAMPLED_BACKWARD"):
            monkeypatch.setattr(tplanned, flag, False if flag == off else None)
        calls.clear()
        tr = Trainer(cfg)
        assert tr.g.kind == "windowed"
        losses[off] = [r.loss for r in tr.run()["history"]]
        assert {name: calls.count(name) for name in set(calls)} == want[off]
    assert all(np.isfinite(losses[None]))
    assert losses[None] == losses["STREAM_CBSR_FORWARD"]
    assert losses[None] == losses["SAMPLED_BACKWARD"]


# ---------------------------------------------------------------------------
# GPU: the kernels (skip without a card)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def two_block_passes(monkeypatch, nb: int, rows: int,
                     record_bytes: int) -> None:
    """Shrink L2_BLOCK_BYTES so that a schedule of nb forced blocks over
    `rows` sources groups 2 blocks a record pass: 3 passes at nb 5."""
    monkeypatch.setattr(tiles, "L2_BLOCK_BYTES",
                        2 * record_bytes * -(-rows // nb))


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [None, 1, 3, 5])
@pytest.mark.parametrize("k", [8, 32, 64, 255])
def test_csr_cbsr_spmm_f32_is_the_dense_form_on_gpu(cuda, k, nb,
                                                    monkeypatch):
    """dim 256 on A and Aᵀ of a directed graph with rows without edges and
    a hub row of 3000 edges (pieces of 512 in a block): csr_cbsr_spmm on
    f32 records bit for bit csr_spmm on the densified rows at the same
    schedule, with no pre and with GCN's, repeatable, one launch a call;
    within 1e-5 of max |y| of the plain version in float64; on integer
    values, whose sums are exact in any order, bit for bit the plain
    version. k 8 and 255 copy 4 bytes a lane (255's stages need more than
    48 KB of shared memory a block), 32 and 64 16. At nb 5 the budget is
    shrunk to 2 blocks a record pass: 3 record passes, more than one and
    fewer than the blocks; else the test's shapes take one."""
    dim = 256
    g = hub_graph(700, seed=k, hub_edges=3000).to(cuda)
    rng = np.random.default_rng(k)
    post = torch.tensor(rng.random(700).astype(np.float32) + 0.5,
                        device=cuda)
    record_bytes = 4 * tmaxk.record_words(k, dim, F32)
    if nb == 5:
        two_block_passes(monkeypatch, nb, 700, record_bytes)
    for indptr, indices in ((g.indptr, g.indices), (g.t_indptr, g.t_indices)):
        plan = CSRPlan(indptr, indices, nb)
        s = plan.schedule(700, dim, 4)
        assert s.record_walk(record_bytes).passes == (3 if nb == 5 else 1)
        for pre_kind in ("none", "gcn"):
            pre = factor(rng, 700, pre_kind, cuda)
            for ints in (False, True):
                dense, rec = records_of(rng, 700, dim, k, cuda, ints)
                _build.launches.clear()
                y = csr_cbsr_spmm(plan, rec, k, dim, post, pre=pre,
                                  value_dtype=F32)
                assert dict(_build.launches) == {"csr_cbsr_spmm": 1}
                again = csr_cbsr_spmm(plan, rec, k, dim, post, pre=pre,
                                      value_dtype=F32)
                np.testing.assert_array_equal(bits(y), bits(again))
                np.testing.assert_array_equal(
                    bits(y), bits(csr_spmm(plan, dense, pre, post)))
                plain = csr_cbsr_plain(s.block_indptr, s.indices, rec, k,
                                       dim, post, pre=pre, value_dtype=F32)
                if ints and pre is None:
                    np.testing.assert_array_equal(bits(y), bits(plain))
                else:
                    ref = csr_blocked_plain(
                        s.block_indptr, s.indices, dense.double(),
                        None if pre is None else pre.double(),
                        post.double())
                    near(y.cpu(), ref.cpu())
                assert (y[indptr.diff() == 0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("nb", [None, 1, 3])
@pytest.mark.parametrize("k", [8, 32, 255])
def test_csr_sspmm_f32_is_the_dense_form_on_gpu(cuda, k, nb):
    """dim 256 on Aᵀ with rows without edges and a hub row of 3000 edges
    (through the fix-up): csr_sspmm on f32 messages bit for bit csr_spmm
    at the kept channels and +0 elsewhere, with no pre and with GCN's,
    repeatable, one launch a call; within 1e-5 of max |y| of the plain
    version; on integer messages with no pre bit for bit the plain
    version."""
    dim = 256
    g = hub_graph(700, seed=k, hub_edges=3000).to(cuda)
    rng = np.random.default_rng(k)
    post = torch.tensor(rng.random(700).astype(np.float32) + 0.5,
                        device=cuda)
    plan = CSRPlan(g.t_indptr, g.t_indices, nb)
    s = plan.schedule(700, dim, 4)
    assert s.num_split_runs > 0
    _, _, ch = maxk_fwd(torch.randn((700, dim), device=cuda), k,
                        with_ids=True)
    for pre_kind in ("none", "gcn"):
        pre = factor(rng, 700, pre_kind, cuda)
        for ints in (False, True):
            m = (torch.randint(-4, 5, (700, dim), device=cuda).float()
                 if ints else torch.randn((700, dim), device=cuda))
            _build.launches.clear()
            y = csr_sspmm(plan, m, ch, post, pre=pre)
            assert dict(_build.launches) == {"csr_sspmm": 1}
            again = csr_sspmm(plan, m, ch, post, pre=pre)
            np.testing.assert_array_equal(bits(y), bits(again))
            np.testing.assert_array_equal(bits(y), bits(kept(
                csr_spmm(plan, m, pre, post), ch)))
            plain = csr_sspmm_plain(s.block_indptr, s.indices, m, ch, post,
                                    pre=pre)
            if ints and pre is None:
                np.testing.assert_array_equal(bits(y), bits(plain))
            else:
                near(y.cpu(), plain.cpu())
            assert (y[g.t_indptr.diff() == 0] == 0).all()


@pytest.mark.gpu
def test_record_passes_are_counted_on_gpu(cuda, monkeypatch):
    """`record_passes` counts each record pass csr_cbsr_spmm launches while
    spans record, and nothing outside them: on f32 and bf16 records, one
    pass at the test's budget, three with 2 blocks of 5 a pass; the launch
    count stays one a call."""
    from spgemm_gnn_tpu_torch.utils import spans
    dim, k = 256, 32
    g = hub_graph(700, seed=5, hub_edges=3000).to(cuda)
    rng = np.random.default_rng(5)
    _, rec = records_of(rng, 700, dim, k, cuda)
    vals, ch = tmaxk.split_records(rec, k, dim, F32)
    rec16 = tmaxk.cbsr_records(vals.to(torch.bfloat16), ch, dim)
    for records, value in ((rec, F32), (rec16, torch.bfloat16)):
        for shrink, passes in ((False, 1), (True, 3)):
            with monkeypatch.context() as m:
                if shrink:
                    two_block_passes(m, 5, 700, 4 * records.shape[1])
                plan = CSRPlan(g.indptr, g.indices, 5)
                spans.reset()
                _build.launches.clear()
                csr_cbsr_spmm(plan, records, k, dim, value_dtype=value)
                assert spans.counters["record_passes"] == 0
                with spans.recording():
                    csr_cbsr_spmm(plan, records, k, dim, value_dtype=value)
                    csr_cbsr_spmm(plan, records, k, dim, value_dtype=value)
                assert spans.counters["record_passes"] == 2 * passes
                name = ("csr_cbsr_spmm" if value == F32
                        else "csr_cbsr_spmm_bf16")
                assert dict(_build.launches) == {name: 3}
    spans.reset()


@pytest.mark.gpu
def test_f32_maxk_pair_launches_on_gpu(cuda, monkeypatch):
    """A k-sparse f32 aggregation with MaxK's ids on a windowed plan,
    forward and backward, at the default rules launches cbsr_compact and
    csr_cbsr_spmm forward and csr_sspmm backward, and gives y and dx of
    both flags off (csr_spmm both ways) bit for bit at the kept
    channels."""
    from spgemm_gnn_tpu_torch.kernels import api as tapi
    g = tsyn.powerlaw_graph(600, 6000, seed=9).to(cuda)
    pg = tplanned.plan_graph(g, kind="windowed", dim=256)
    x, _, ids = maxk_fwd(torch.randn((600, 256), device=cuda), 32,
                         with_ids=True)
    ct = torch.randn((600, 256), device=cuda)
    out = {}
    for flag in (None, False):
        monkeypatch.setattr(tplanned, "STREAM_CBSR_FORWARD", flag)
        monkeypatch.setattr(tplanned, "SAMPLED_BACKWARD", flag)
        xt = x.clone().requires_grad_(True)
        _build.launches.clear()
        y = tapi.aggregate(pg, xt, "gcn", k=32, impl="cuda", ids=ids)
        y.backward(ct)
        out[flag] = (y.detach(), kept(xt.grad, ids), dict(_build.launches))
    assert out[None][2] == {"cbsr_compact": 1, "csr_cbsr_spmm": 1,
                            "csr_sspmm": 1}
    assert out[False][2] == {"csr_spmm": 2}
    for a, b in zip(out[None][:2], out[False][:2]):
        np.testing.assert_array_equal(bits(a), bits(b))


@pytest.mark.gpu
def test_f32_wrappers_raise_on_gpu(cuda, monkeypatch):
    """Bad inputs raise, and a kernel that refuses its launch raises: the
    plain version never runs for a CUDA tensor, and nothing is counted."""
    g = hub_graph(200).to(cuda)
    plan = CSRPlan(g.indptr, g.indices)
    t_plan = CSRPlan(g.t_indptr, g.t_indices)
    _, rec = records_of(np.random.default_rng(1), 200, 64, 8, cuda)
    m = torch.randn((200, 64), device=cuda)
    _, _, ch = maxk_fwd(torch.randn((200, 64), device=cuda), 8,
                        with_ids=True)
    with pytest.raises(ValueError, match="dtype"):
        csr_cbsr_spmm(plan, rec.float(), 8, 64, value_dtype=F32)
    with pytest.raises(ValueError, match="is on cpu"):
        csr_cbsr_spmm(plan, rec, 8, 64, pre=torch.ones(200),
                      value_dtype=F32)
    with pytest.raises(ValueError, match="contiguous"):
        csr_sspmm(t_plan, m.t().contiguous().t(), ch)
    with pytest.raises(ValueError, match="is on cpu"):
        csr_sspmm(t_plan, m, ch, pre=torch.ones(200))
    real = _build.library

    class Refusing:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, fn):
            if fn in ("csr_cbsr_spmm", "csr_sspmm"):
                return lambda *args: 1      # cudaErrorInvalidValue
            return getattr(self.inner, fn)

    monkeypatch.setattr(_build, "library", lambda w: Refusing(real(w)))
    _build.launches.clear()
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        csr_cbsr_spmm(plan, rec, 8, 64, value_dtype=F32)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        csr_sspmm(t_plan, m, ch)
    assert not _build.launches
