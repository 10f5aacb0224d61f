"""Time the `csr_spmm` kernel over schedules on a recipe's graph, on the GPU:
source blocks and segment sizes (the measurements behind
`graphs/tiles.py::MIN_EDGES_PER_BLOCK_ROW` and `SEGMENT`).

    python -m spgemm_gnn_tpu_torch.utils.csr_sweep [--dataset reddit] \
        [--blocks auto,1,10] [--segments 512,1024] [--dim 256] [--iters 5] \
        [--stream f32|bf16x2] [--probes] [--sampled_only]

On the synthetic stand-in at full size (seed 97), for A (the input MaxK at
k 32 then dropout 0.5, under the mean factors, as on the training path) and
Aᵀ (a dense cotangent): each schedule's sizes and build time, the kernel's
time over `--iters` launches (CUDA events), its error against the plain
version in float64 (as a share of max |y|), and `torch.sparse.mm` on the
same product. "auto" is the rule (`graphs/tiles.py::auto_src_blocks`);
`--segments` defaults to `SEGMENT`, the path's. `--stream bf16x2` runs the
16-bit form (csr_spmm_bf16 on the rows of round_rows, the pre factor folded
into them, as the planner does; "auto" then sizes blocks for 2-byte
channels), held to the plain version on the same bf16 rows.

`--probes` (A only, with `--stream bf16x2`) also times a record-gather
probe of this script at each schedule: the bf16 CBSR records of the same
input (`ops/maxk.py::cbsr_records` of bf16(x) at k 32: 128 B a node)
gathered over the schedule's segments as `csr_cbsr_spmm_bf16`
gathers them, and nothing scattered, so that the records' share of the
product's time is on record; and beside it the CBSR forms themselves
(`csr_cbsr_spmm`, f32 and bf16 out) on those records at that schedule,
each first checked bit for bit against csr_spmm's bf16 form on the rows.

`--sampled_only` times the forms of MaxK's backward on Aᵀ instead, on bf16
messages (the 16-bit stream's bf16(dst_f ⊙ g), f32 out, and the 16-bit
model's dst_f ⊙ g in bf16, bf16 out; mean factors) at k 32 with the ids of
`maxk_fwd(..., with_ids=True)` on bf16 rows, the schedule of bf16 rows
(about 90 s with the Reddit build): (i) the dense form (`csr_spmm_bf16` /
`_out`) then `maxk_bwd` / `maxk_bwd_bf16`; (ii) `csr_sspmm`, the k-channel
gather on B2's schedule; (iii) two passes: pass 1 (stream_sspmm's
`sspmm_slots_bf16` on a StreamPlan of A) writes each edge's 2k-byte slot at
its position in the Aᵀ schedule's indices, pass 2 (`csr_sspmm_at(...,
slots=)`) reads them in order over the schedule; (iv) pass 1 writes the
slots in A's edge order and pass 2 reads slot where[position]. Each pass
is also timed alone, and pass 1 with no slot stored; (ii)-(iv) are each
first checked bitwise against the dense form at the kept channels, and
maxk_fwd is timed with and without ids.
Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import time

import torch

PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// Record-gather probe over csr_spmm's schedule: one warp per segment (row,
// lo, hi, out) of a pass, its source ids loaded 32 at a time, coalesced and
// one batch ahead, and each edge's 128-byte record copied by cp.async, 16
// bytes a lane (four records a warp copy), into a ring of S stages in the
// warp's shared memory, with an L2 evict_last policy: as csr_cbsr_spmm_bf16
// copies them (csrc/spmm.cu). Nothing is scattered: each lane XORs the word
// of its slot of every edge and stores it at the segment's end.
namespace {
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

constexpr int S = 8, EPS = 4, RW = 32, SW = RW * EPS;

__global__ void __launch_bounds__(256)
record_probe(const int4* __restrict__ seg, int64_t n_seg,
             const int* __restrict__ indices, const unsigned* __restrict__ rec,
             unsigned* __restrict__ out) {
  __shared__ __align__(16) unsigned ring_all[8][S * SW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * 8 + warp;
  if (i >= n_seg) return;
  const int4 s = seg[i];
  const int lo = s.y, hi = s.z;
  unsigned* ring = ring_all[warp];
  uint64_t keep;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
  int cu = lo + lane < hi ? __ldcs(indices + lo + lane) : 0;
  int nu = lo + 32 + lane < hi ? __ldcs(indices + lo + 32 + lane) : 0;
  auto fetch = [&](int st, int ids, int i0) {
    const int ri = lane / 8;  // the lane's record of the stage
    const int u = __shfl_sync(kFull, ids, (i0 + ri) & 31);
    if (lo + EPS * st + ri < hi)
      asm volatile(
          "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
          :
          : "r"(smem_addr(ring + (st % S) * SW + 4 * lane)),
            "l"(rec + (int64_t)u * RW + 4 * (lane % 8)), "l"(keep)
          : "memory");
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
#pragma unroll
  for (int st = 0; st < S; ++st) fetch(st, cu, EPS * st);
  unsigned fold = 0u;
  int st = 0;
  for (int base = lo; base < hi; base += 32) {
    for (int i0 = 0; i0 < 32 && base + i0 < hi; i0 += EPS, ++st) {
      asm volatile("cp.async.wait_group %0;" ::"n"(S - 1) : "memory");
      __syncwarp();
      const unsigned* sr = ring + (st % S) * SW;
      const int n = min(EPS, hi - base - i0);
      for (int e = 0; e < n; ++e) fold ^= sr[e * RW + lane];
      __syncwarp();
      fetch(st + S, nu, i0);  // S EPS = 32: a batch ahead
    }
    cu = nu;
    nu = base + 64 + lane < hi ? __ldcs(indices + base + 64 + lane) : 0;
  }
  out[i * 32 + lane] = fold;
}
}  // namespace

// seg int32 [n_seg, 4] (one pass's segments), indices int32 [E], rec int32
// [n_src, 32] (k <= 32), out int32 [n_seg, 32].
extern "C" int gather_records_csr(const void* seg, int64_t n_seg,
                                  const void* indices, const void* rec,
                                  void* out, void* stream) {
  if (n_seg == 0) return 0;
  record_probe<<<(unsigned)((n_seg + 7) / 8), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(seg), n_seg, static_cast<const int*>(indices),
      static_cast<const unsigned*>(rec), static_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}
"""


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def probe(sched, rec: torch.Tensor, iters: int) -> float:
    """ms of the record-gather probe (PROBE_SRC) over the schedule's passes,
    in block order, on the records `rec` (int32 [S, 32])."""
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.utils.maxk_sweep import build
    fn = build({"csr_record_probe": PROBE_SRC})["csr_record_probe"] \
        .gather_records_csr
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty((sched.num_segments, 32), dtype=torch.int32,
                      device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ps = sched.pass_seg.tolist()

    def run():
        for b in range(sched.nb):
            if ps[b + 1] == ps[b]:
                continue
            _build.check(fn(sched.seg[ps[b]].data_ptr(), ps[b + 1] - ps[b],
                            sched.indices.data_ptr(), rec.data_ptr(),
                            out[ps[b]].data_ptr(), stream),
                         "gather_records_csr")
    return time_ms(run, iters)


def sweep(dataset: str, blocks: list, segments: list[int], dim: int,
          iters: int, seed: int, stream: str,
          with_probes: bool = False) -> None:
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
    from spgemm_gnn_tpu_torch.kernels.cbsr import cbsr_compact
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_fwd
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.kernels.spmm import csr_cbsr_spmm, csr_spmm
    from spgemm_gnn_tpu_torch.ops.maxk import cbsr_records
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    from spgemm_gnn_tpu_torch.ops.spmm import csr_spmm_plain

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    ds = load_dataset(dataset, allow_synthetic=True, data_path="/nonexistent",
                      synthetic_scale=1.0, seed=seed)
    g = ds.graph.to("cuda")
    n, e = g.num_nodes, g.num_edges
    print(f"{dataset}: N={n} E={e} dim={dim} stream {stream}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    k = 32
    y, _ = maxk_fwd(torch.randn((n, dim), generator=gen, device="cuda"), k)
    keep = torch.rand((n, dim), generator=gen, device="cuda") >= 0.5
    xs = torch.where(keep, y / 0.5, torch.zeros_like(y))
    gy = torch.randn((n, dim), generator=gen, device="cuda")
    _, post = node_factors(g, "mean")
    rec = None
    if with_probes:
        if stream != "bf16x2":
            raise ValueError("--probes gathers bf16 records: give --stream "
                             "bf16x2")
        vals, ch = cbsr_compact(xs, k)
        rec = cbsr_records(round_rows(vals), ch, dim)
        del vals, ch
    for what, indptr, indices, rows, x, pre, pst in (
            ("A", g.indptr, g.indices, g.edge_dst, xs, None, post),
            ("A^T", g.t_indptr, g.t_indices, g.t_edge_dst, gy, post, None)):
        if stream == "bf16x2":
            x, pre = round_rows(x, pre), None
        ref = csr_spmm_plain(indptr, indices, x.double(), pre, pst)
        scale = float(ref.abs().max())
        w = torch.ones(e, device="cuda")
        if pre is not None:
            w = w * pre[indices.long()]
        if pst is not None:
            w = w * pst[rows.long()]
        a = torch.sparse_csr_tensor(indptr, indices, w.to(x.dtype),
                                    size=(n, n))
        print(f"{what}: torch.sparse.mm {time_ms(lambda: torch.sparse.mm(a, x), iters):.3f} ms",
              flush=True)
        del a, w
        for nb in blocks:
            for seg in segments:
                plan = CSRPlan(indptr, indices,
                               None if nb == "auto" else int(nb), seg)
                t0 = time.perf_counter()
                s = plan.schedule(n, dim, x.element_size())
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                got = csr_spmm(plan, x, pre, pst)
                err = float((got - ref).abs().max()) / scale
                del got
                ms = time_ms(lambda: csr_spmm(plan, x, pre, pst), iters)
                print(f"{what} blocks {nb}->{s.nb} segment {seg}: "
                      f"{ms:.3f} ms, err {err:.3e} of max; segments "
                      f"{s.num_segments}, split runs {s.num_split_runs}, "
                      f"slots {s.n_slots}, extra "
                      f"{s.extra_bytes(indices) / 2**20:.1f} MiB, build "
                      f"{build_s:.2f} s", flush=True)
                if rec is not None and what == "A":
                    p_ms = probe(s, rec, iters)
                    rb = 4 * rec.shape[1]
                    print(f"{what} blocks {s.nb} segment {seg}: record "
                          f"probe ({rb}-B records, no scatter) {p_ms:.3f} "
                          f"ms, {e / p_ms / 1e6:.3f} G edges/s (no-reuse "
                          f"gather {e * rb / PEAK_BYTES_S * 1e3:.3f} ms)",
                          flush=True)
                    for od in (None, torch.bfloat16):
                        def run(od=od):
                            return csr_cbsr_spmm(plan, rec, k, dim, pst, od)
                        if not torch.equal(run().view(torch.int16), csr_spmm(
                                plan, x, None, pst, out_dtype=od)
                                .view(torch.int16)):
                            raise AssertionError(
                                f"csr_cbsr_spmm at nb {s.nb} ({od}): bits "
                                f"differ from csr_spmm's bf16 form")
                        print(f"{what} blocks {s.nb} segment {seg}: "
                              f"csr_cbsr_spmm_bf16"
                              f"{'_out' if od is not None else ''} "
                              f"{time_ms(run, iters):.3f} ms (bitwise equal "
                              f"to the dense form)", flush=True)
                del plan, s
                torch.cuda.empty_cache()
        del ref


def schedule_positions(g, sched) -> torch.Tensor:
    """int32 [E]: for each edge of g's in-CSR (A), in its order, the
    position of its transposed edge in the indices of `sched`, a schedule
    of the transpose CSR (Aᵀ re-bucketed by source block, stably)."""
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import transpose_positions
    tp = transpose_positions(g.indptr, g.indices, g.t_indptr,
                             g.t_indices).long()
    if sched.nb == 1:
        return tp.int()
    order = torch.sort(g.t_indices.long() // sched.block_rows,
                       stable=True).indices
    at = torch.empty_like(order)
    at[order] = torch.arange(order.numel(), device=order.device)
    return at[tp].int()


def sampled(dataset: str, dim: int, iters: int, seed: int) -> None:
    """`--sampled_only`: the forms of MaxK's backward on Aᵀ (module
    docstring), each checked and timed in this one process."""
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_bwd, maxk_fwd
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.kernels.spmm import (csr_spmm, csr_sspmm,
                                                   csr_sspmm_at)
    from spgemm_gnn_tpu_torch.kernels.stream import new_slots
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    from spgemm_gnn_tpu_torch.ops.spmm import _scale

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    ds = load_dataset(dataset, allow_synthetic=True, data_path="/nonexistent",
                      synthetic_scale=1.0, seed=seed)
    g = ds.graph.to("cuda")
    del ds
    n, e = g.num_nodes, g.num_edges
    bf16, k = torch.bfloat16, 32
    print(f"{dataset}: N={n} E={e} dim={dim} k={k}, MaxK's backward on A^T",
          flush=True)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn((n, dim), generator=gen, device="cuda").to(bf16)
    gy = torch.randn((n, dim), generator=gen, device="cuda")
    _, meta, ch = maxk_fwd(h, k, with_ids=True)
    for rows in (h, h.float()):
        with_ids = time_ms(lambda: maxk_fwd(rows, k, True), 20)
        without = time_ms(lambda: maxk_fwd(rows, k), 20)
        print(f"maxk_fwd{'_bf16' if rows.dtype == bf16 else ''}: "
              f"{with_ids:.3f} ms with ids, {without:.3f} without", flush=True)
    keep = torch.zeros((n, dim), dtype=torch.bool, device="cuda")
    keep.scatter_(1, ch.long(), True)
    src_f, dst_f = node_factors(g, "mean")
    plan = CSRPlan(g.t_indptr, g.t_indices)
    sched = plan.schedule(n, dim, 2)
    print(f"A^T schedule: {sched.nb} source blocks, {sched.num_segments} "
          f"segments, {sched.num_split_runs} split runs", flush=True)
    fwd = build_stream_plan(g.indptr, g.indices)
    t0 = time.perf_counter()
    pos = schedule_positions(g, sched)
    where = torch.empty_like(pos)
    where[pos.long()] = torch.arange(e, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    print(f"positions: {time.perf_counter() - t0:.2f} s "
          f"({2 * e * 4 / 2**30:.2f} GiB with their inverse)", flush=True)
    slots = new_slots(e, k, torch.device("cuda"))
    in_order = torch.arange(e, dtype=torch.int32, device="cuda")
    lib = _build.library("stream")
    stream = torch.cuda.current_stream().cuda_stream

    def pass1(m, perm, mode=0):
        _build.check(lib.sspmm_slots_bf16(
            fwd.indptr.data_ptr(), fwd.indices.data_ptr(),
            fwd.chunk_row0.data_ptr(), perm.data_ptr(), m.data_ptr(),
            ch.data_ptr(), slots.data_ptr(), fwd.num_rows, fwd.num_chunks,
            e, fwd.chunk, fwd.warp_chunks, dim, k, mode, stream),
            "sspmm_slots_bf16")

    out_bytes = {None: 4, bf16: 2}
    for od in (None, bf16):
        m = (_scale(gy.to(bf16), dst_f).contiguous() if od is not None
             else round_rows(gy, dst_f))
        tag = "_out" if od is not None else ""
        mk = h if od is not None else h.float()
        dense = csr_spmm(plan, m, None, src_f, out_dtype=od)
        want = torch.where(keep, dense, torch.zeros((), dtype=dense.dtype,
                                                    device="cuda"))
        ints = torch.int16 if od is not None else torch.int32

        def same(got, what):
            if not torch.equal(got.view(ints), want.view(ints)):
                raise AssertionError(f"{what}{tag}: bits differ from the "
                                     f"dense form at the kept channels")

        same(csr_sspmm(plan, m, ch, src_f, od), "(ii) csr_sspmm")
        pass1(m, pos)
        same(csr_sspmm_at(plan, m, ch, src_f, out_dtype=od, slots=slots),
             "(iii) slots in schedule order")
        pass1(m, in_order, 2)
        same(csr_sspmm_at(plan, m, ch, src_f, out_dtype=od, slots=slots,
                          where=where), "(iv) slots in A's order")
        t = dict(
            dense=time_ms(lambda: csr_spmm(plan, m, None, src_f,
                                           out_dtype=od), iters),
            maxk_bwd=time_ms(lambda: maxk_bwd(mk, meta, dense), iters),
            gather=time_ms(lambda: csr_sspmm(plan, m, ch, src_f, od), iters),
            p1_sched=time_ms(lambda: pass1(m, pos), iters),
            p2_sched=time_ms(lambda: csr_sspmm_at(
                plan, m, ch, src_f, out_dtype=od, slots=slots), iters),
            p1_in_order=time_ms(lambda: pass1(m, in_order, 2), iters),
            p2_at=time_ms(lambda: csr_sspmm_at(
                plan, m, ch, src_f, out_dtype=od, slots=slots, where=where),
                iters),
            p1_no_store=time_ms(lambda: pass1(m, pos, 1), iters))
        n_bytes = (n * dim * 2 + n * k + e * 4 + (n + 1) * 4
                   + n * dim * out_bytes[od])
        print(f"sampled{tag}: bitwise the dense form at the kept channels "
              f"((ii), (iii), (iv)); bound {n_bytes / PEAK_BYTES_S * 1e3:.3f}"
              f" ms by bytes, {2 * e * k / 67e12 * 1e3:.3f} by operations; "
              f"no-reuse gather {2 * k} B an edge "
              f"{e * 2 * k / PEAK_BYTES_S * 1e3:.3f} ms, {2 * dim} B "
              f"{e * 2 * dim / PEAK_BYTES_S * 1e3:.3f}", flush=True)
        print(f"sampled{tag}: (i) dense {t['dense']:.3f} + maxk_bwd "
              f"{t['maxk_bwd']:.3f} = {t['dense'] + t['maxk_bwd']:.3f} ms; "
              f"(ii) gather {t['gather']:.3f}; (iii) pass 1 "
              f"{t['p1_sched']:.3f} + pass 2 {t['p2_sched']:.3f} = "
              f"{t['p1_sched'] + t['p2_sched']:.3f}; (iv) pass 1 in order "
              f"{t['p1_in_order']:.3f} + pass 2 at where "
              f"{t['p2_at']:.3f} = {t['p1_in_order'] + t['p2_at']:.3f}; "
              f"pass 1 with no slot stored {t['p1_no_store']:.3f}",
              flush=True)
        del m, mk, dense, want
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    from spgemm_gnn_tpu_torch.graphs.tiles import SEGMENT
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="reddit")
    ap.add_argument("--blocks", default="auto,1")
    ap.add_argument("--segments", default=str(SEGMENT))
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=97)
    ap.add_argument("--stream", default="f32", choices=["f32", "bf16x2"])
    ap.add_argument("--probes", action="store_true",
                    help="time the record-gather probe on A at each schedule")
    ap.add_argument("--sampled_only", action="store_true",
                    help="time the forms of MaxK's backward on A^T instead")
    args = ap.parse_args(argv)
    if args.sampled_only:
        sampled(args.dataset, args.dim, args.iters, args.seed)
        return
    sweep(args.dataset, args.blocks.split(","),
          [int(s) for s in args.segments.split(",")], args.dim, args.iters,
          args.seed, args.stream, args.probes)


if __name__ == "__main__":
    main()
