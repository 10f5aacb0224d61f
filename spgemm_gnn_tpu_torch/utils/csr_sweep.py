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

`--probes` (A only) also times a record-gather probe of this script at
each schedule: the CBSR records of the same input (at k 32) gathered over
the schedule's segments as `csr_cbsr_spmm`'s kernels gather them (cp.async
into a ring of stages in each warp's shared memory, with an L2 evict_last
policy), and nothing scattered, so that the records' share of the
product's time is on record; and beside it the CBSR forms themselves
(`csr_cbsr_spmm`) on those records at that schedule, each first checked
bit for bit against csr_spmm on the rows. Under `--stream bf16x2` the
records are `ops/maxk.py::cbsr_records` of bf16(x), 128 B a node, and the
forms f32 and bf16 out; under the f32 stream two layouts of the f32
records at the f32 schedule: `cbsr_records`' 160 B (k values, then the
uint8 ids; 8 and 16 stages in flight) and 256 B of 8-byte slots (a value
and its id), and the f32 form.

`--sampled_only` times the forms of MaxK's backward on Aᵀ instead, on bf16
messages (the 16-bit stream's bf16(dst_f ⊙ g), f32 out, and the 16-bit
model's dst_f ⊙ g in bf16, bf16 out; mean factors) at k 32 with the ids of
`maxk_fwd(..., with_ids=True)` on bf16 rows, the schedule of bf16 rows
(about 70 s with the Reddit build): (i) the dense form (`csr_spmm_bf16` /
`_out`) then `maxk_bwd` / `maxk_bwd_bf16`; (ii) `csr_sspmm`, the k-channel
gather on B2's schedule, first checked bitwise against the dense form at
the kept channels; and maxk_fwd with and without ids.
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
// one batch ahead, and each edge's record of RW words copied by cp.async,
// 16 bytes a lane (32 / EPS lanes a record, EPS records a stage), into a
// ring of S stages in the warp's shared memory, with an L2 evict_last
// policy: as csr_cbsr_kernel copies them (csrc/spmm.cu). Nothing is
// scattered: each lane XORs word `lane` of every edge's record and stores
// it at the segment's end.
namespace {
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int RW, int S>
__global__ void __launch_bounds__(256)
record_probe(const int4* __restrict__ seg, int64_t n_seg,
             const int* __restrict__ indices, const unsigned* __restrict__ rec,
             unsigned* __restrict__ out) {
  constexpr int RC = RW / 4;  // 16-byte copies a record
  constexpr int LPR = RC <= 8 ? 8 : RC <= 16 ? 16 : 32;  // lanes a record
  constexpr int EPS = 32 / LPR, SW = RW * EPS;
  static_assert(S * EPS <= 32, "a batch ahead at most");
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
    const int ri = lane / LPR;  // the lane's record of the stage
    const int u = __shfl_sync(kFull, ids, (i0 + ri) & 31);
    if (lo + EPS * st + ri < hi)
      for (int q = lane % LPR; q < RC; q += LPR)
        asm volatile(
            "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
            :
            : "r"(smem_addr(ring + (st % S) * SW + ri * RW + 4 * q)),
              "l"(rec + (int64_t)u * RW + 4 * q), "l"(keep)
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
      const int ahead = i0 + EPS * S;
      fetch(st + S, ahead < 32 ? cu : nu, ahead & 31);
    }
    cu = nu;
    nu = base + 64 + lane < hi ? __ldcs(indices + base + 64 + lane) : 0;
  }
  out[i * 32 + lane] = fold;
}
}  // namespace

// seg int32 [n_seg, 4] (one pass's segments), indices int32 [E], rec int32
// [n_src, rw] with (rw, stages) one of (32, 8), (40, 8), (40, 16), (64, 8),
// out int32 [n_seg, 32].
extern "C" int gather_records_csr(const void* seg, int64_t n_seg,
                                  const void* indices, const void* rec,
                                  void* out, int rw, int stages,
                                  void* stream) {
  if (n_seg == 0) return 0;
  const unsigned blocks = (unsigned)((n_seg + 7) / 8);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* sp = static_cast<const int4*>(seg);
  const int* ip = static_cast<const int*>(indices);
  const unsigned* rp = static_cast<const unsigned*>(rec);
  unsigned* op = static_cast<unsigned*>(out);
  if (rw == 32 && stages == 8)
    record_probe<32, 8><<<blocks, 256, 0, st>>>(sp, n_seg, ip, rp, op);
  else if (rw == 40 && stages == 8)
    record_probe<40, 8><<<blocks, 256, 0, st>>>(sp, n_seg, ip, rp, op);
  else if (rw == 40 && stages == 16)
    record_probe<40, 16><<<blocks, 256, 0, st>>>(sp, n_seg, ip, rp, op);
  else if (rw == 64 && stages == 8)
    record_probe<64, 8><<<blocks, 256, 0, st>>>(sp, n_seg, ip, rp, op);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
"""

# the probe's (layout, stages) under each stream at k 32: the bf16 records'
# 128 B; cbsr_records' 160-B f32 records and 8-byte slots of 256 B
PROBES = {"bf16x2": (("128-B bf16 records", 8),),
          "f32": (("160-B cbsr_records", 8), ("160-B cbsr_records", 16),
                  ("256-B 8-byte slots", 8))}


def slot_records(vals: torch.Tensor, ch: torch.Tensor) -> torch.Tensor:
    """The 8-byte-slot layout of f32 records: int32 [N, 2k], slot j the
    bits of value j then its channel."""
    return torch.stack([vals.float().contiguous().view(torch.int32),
                        ch.int()], dim=2).reshape(vals.shape[0], -1)


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


def probe(sched, rec: torch.Tensor, stages: int, iters: int) -> float:
    """ms of the record-gather probe (PROBE_SRC) over the schedule's passes,
    in block order, on the records `rec` (int32 [S, 32], [S, 40] or
    [S, 64]) with `stages` stages in flight."""
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.utils.maxk_sweep import build
    fn = build({"csr_record_probe": PROBE_SRC})["csr_record_probe"] \
        .gather_records_csr
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
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
                            out[ps[b]].data_ptr(), rec.shape[1], stages,
                            stream),
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
    layouts = {}
    if with_probes:
        vals, ch = cbsr_compact(xs, k)
        if stream == "bf16x2":
            layouts["128-B bf16 records"] = cbsr_records(round_rows(vals), ch,
                                                         dim)
        else:
            layouts["160-B cbsr_records"] = cbsr_records(vals, ch, dim)
            layouts["256-B 8-byte slots"] = slot_records(vals, ch)
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
                if layouts and what == "A":
                    for name, stages in PROBES[stream]:
                        rec = layouts[name]
                        p_ms = probe(s, rec, stages, iters)
                        rb = 4 * rec.shape[1]
                        print(f"{what} blocks {s.nb} segment {seg}: record "
                              f"probe ({name}, {stages} stages, no "
                              f"scatter) {p_ms:.3f} ms, "
                              f"{e / p_ms / 1e6:.3f} G edges/s (no-reuse "
                              f"gather {e * rb / PEAK_BYTES_S * 1e3:.3f} "
                              f"ms)", flush=True)
                    f32 = stream == "f32"
                    rec = layouts["160-B cbsr_records" if f32
                                  else "128-B bf16 records"]
                    for od in ((None,) if f32 else (None, torch.bfloat16)):
                        def run(od=od):
                            return csr_cbsr_spmm(
                                plan, rec, k, dim, pst, od, value_dtype=(
                                    torch.float32 if f32 else
                                    torch.bfloat16))
                        ints = torch.int16 if od is not None else torch.int32
                        if not torch.equal(run().view(ints), csr_spmm(
                                plan, x, None, pst, out_dtype=od)
                                .view(ints)):
                            raise AssertionError(
                                f"csr_cbsr_spmm at nb {s.nb} ({od}): bits "
                                f"differ from csr_spmm's form on the rows")
                        print(f"{what} blocks {s.nb} segment {seg}: "
                              f"csr_cbsr_spmm{'' if f32 else '_bf16'}"
                              f"{'_out' if od is not None else ''} "
                              f"{time_ms(run, iters):.3f} ms (bitwise equal "
                              f"to the dense form)", flush=True)
                del plan, s
                torch.cuda.empty_cache()
        del ref


def sampled(dataset: str, dim: int, iters: int, seed: int) -> None:
    """`--sampled_only`: the forms of MaxK's backward on Aᵀ (module
    docstring), each checked and timed in this one process."""
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_bwd, maxk_fwd
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm, csr_sspmm
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
        if not torch.equal(csr_sspmm(plan, m, ch, src_f, od).view(ints),
                           want.view(ints)):
            raise AssertionError(f"(ii) csr_sspmm{tag}: bits differ from "
                                 f"the dense form at the kept channels")
        t = dict(
            dense=time_ms(lambda: csr_spmm(plan, m, None, src_f,
                                           out_dtype=od), iters),
            maxk_bwd=time_ms(lambda: maxk_bwd(mk, meta, dense), iters),
            gather=time_ms(lambda: csr_sspmm(plan, m, ch, src_f, od), iters))
        n_bytes = (n * dim * 2 + n * k + e * 4 + (n + 1) * 4
                   + n * dim * out_bytes[od])
        print(f"sampled{tag}: (ii) bitwise the dense form at the kept "
              f"channels; bound {n_bytes / PEAK_BYTES_S * 1e3:.3f} ms by "
              f"bytes, {2 * e * k / 67e12 * 1e3:.3f} by operations; no-reuse "
              f"gather {2 * k} B an edge "
              f"{e * 2 * k / PEAK_BYTES_S * 1e3:.3f} ms, {2 * dim} B "
              f"{e * 2 * dim / PEAK_BYTES_S * 1e3:.3f}", flush=True)
        print(f"sampled{tag}: (i) dense {t['dense']:.3f} + maxk_bwd "
              f"{t['maxk_bwd']:.3f} = {t['dense'] + t['maxk_bwd']:.3f} ms; "
              f"(ii) gather {t['gather']:.3f}", flush=True)
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
