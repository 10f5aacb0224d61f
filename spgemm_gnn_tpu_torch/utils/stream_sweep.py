"""Time the stream kernels over hot-set budgets and launch shapes on a
recipe's graph, on the GPU (the measurements behind
`graphs/stream_tiles.py::HOT_BUDGET` and `kernels/stream.py`'s DEPTHS,
BATCHES).

    python -m spgemm_gnn_tpu_torch.utils.stream_sweep \
        [--dataset ogbn-products] [--budgets 0,10,20,30,40] \
        [--depths 4,8,16] [--batches B,...] [--iters 5] \
        [--stream f32|bf16x2] [--cbsr_only] [--out f32|bf16] \
        [--probes] [--sampled_only] [--sass DIR]

On the synthetic stand-in at full size (seed 97): `stream_spmm` on A (the
input MaxK at k 32 then dropout 0.5, under the mean factors, as on the
training path) and on Aᵀ (a dense cotangent, the mean factor as pre) at each
budget (MiB of L2), fetch depth and chunks per warp; `stream_cbsr_spmm` on A
(the records of the same input) at each budget, batch of edges loaded ahead
and chunks per warp, and its scatter-free variant (values summed in
registers, no shared-memory scatter: a wrong y by design, timed to measure
what the scatter costs) at each batch. Every other configuration must give
the bits of the kernel's defaults. One line per configuration: the time
over `--iters` launches (CUDA events) and the hot set's rows and edge share.
`--stream bf16x2` runs the 16-bit forms (stream_spmm_bf16 on the rows of
round_rows, the pre factor folded into them; stream_cbsr_spmm_bf16 on
records of bf16 values), as the planner does; the hot set is then built at
the 16-bit row and record sizes. Prints the card's name and power limit
first.

The diagnosis of the bf16-record walk (`--stream bf16x2`): `--out bf16` runs
the bf16-output form (stream_cbsr_spmm_bf16_out) instead; `--cbsr_only`
skips stream_spmm. Beside each batch of the real form, its two timing
variants (`kernels/stream.py::stream_cbsr_spmm_at` `variant`, never on the
path, a wrong y by design): "no_load" (the records of the first stages
only: the walk and the scatter) and "no_scatter" (records loaded, nothing
scattered: the walk and the gather), each with its registers, spills and
resident warps an SM. `--probes` times gather probes of this script: the
same edges' records read with nothing else, 32 edges in flight a warp, as a
lane's 4 B a word of an edge's record or as 16 B a lane (6 or 8 lanes a
record), at the record's stride and, where that is not whole 128-B lines,
padded to them. `--sass DIR` writes the bf16-record kernels' SASS
(`cuobjdump -sass`) and the stream library's `-res-usage` into DIR and
prints each kernel's SASS instruction count, loops (backward branches,
with the instructions from their target to them) and, at k <= 32, the
instructions of one steady stage of four edges (`sass_loops` `last_edge`).

`--probes` also times the forms of MaxK's backward on Aᵀ (`sampled_probes`,
bf16 messages bf16(post ⊙ g) under the mean factors, the kept channels of
MaxK at k on random bf16 rows): (i) the dense form, stream_spmm_bf16 (and
_out), then maxk_bwd_bf16 on its output; (ii) the k-channel gather form,
one lane a kept channel on B3's walk (`stream_ksample_at`); (iii) the
two-pass form, `stream_sspmm` (and _out), each pass timed alone, and pass
1's timing variants (no slot stored, slots in edge order, no id loaded).
(ii) and (iii) must give the dense form's bits at the kept channels and
zeros elsewhere. `--sampled_only` runs these and nothing else.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import re
import shutil
import subprocess
from pathlib import Path

import torch

PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// Gather probes: the warp of global id w reads the records of edges
// [1024 w, 1024 w + 1024) (source ids from idx), stride words apart, the
// first rw words of each, 32 edges in flight; SHAPE 0: lane l < rw loads
// word l (4 B) of each edge's record, 32 warp loads a batch; SHAPE 1: LPR
// lanes a record (6 at a 96-B stride, 8 at 128 B) load it as 16-byte
// words, 32 / LPR records a warp load. Each lane folds what it read into
// one word, stored.
template <int SHAPE, int LPR>
__global__ void __launch_bounds__(256)
gather_probe(const int* __restrict__ idx, const unsigned* __restrict__ rec,
             int64_t n_edges, int stride, int rw, unsigned* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t wg = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int64_t lo = wg * 1024;
  if (lo >= n_edges) return;
  const int64_t hi = lo + 1024 < n_edges ? lo + 1024 : n_edges;
  unsigned acc = 0u;
  for (int64_t base = lo; base < hi; base += 32) {
    const int u = base + lane < hi ? __ldcs(idx + base + lane) : -1;
    if (SHAPE == 0) {
      unsigned v[32];
#pragma unroll
      for (int d = 0; d < 32; ++d) {
        const int ud = __shfl_sync(0xffffffffu, u, d);
        v[d] = (ud >= 0 && lane < rw)
                   ? __ldg(rec + (int64_t)ud * stride + lane) : 0u;
      }
#pragma unroll
      for (int d = 0; d < 32; ++d) acc ^= v[d];
    } else {
      constexpr int PER = 32 / LPR, T = (32 + PER - 1) / PER;
      const int sub = lane / LPR, word = lane - LPR * sub;
      uint4 v[T];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int e = PER * t + sub;
        const int ud = __shfl_sync(0xffffffffu, u, e & 31);
        const bool ok = sub < PER && e < 32 && ud >= 0 && 4 * word < rw;
        v[t] = ok ? __ldg(reinterpret_cast<const uint4*>(
                              rec + (int64_t)ud * stride) + word)
                  : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int t = 0; t < T; ++t) acc ^= v[t].x ^ v[t].y ^ v[t].z ^ v[t].w;
    }
  }
  out[wg * 32 + lane] = acc;
}

extern "C" int gather_records(const void* idx, const void* rec, int64_t n,
                              int stride, int rw, int shape, void* out,
                              void* stream) {
  const int64_t warps = (n + 1023) / 1024;
  const unsigned blocks = (unsigned)((warps + 7) / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const unsigned* rp = static_cast<const unsigned*>(rec);
  unsigned* op = static_cast<unsigned*>(out);
  if (shape == 0)
    gather_probe<0, 1><<<blocks, 256, 0, s>>>(ip, rp, n, stride, rw, op);
  else if (shape == 1 && stride == 24)
    gather_probe<1, 6><<<blocks, 256, 0, s>>>(ip, rp, n, stride, rw, op);
  else if (shape == 1 && stride == 32)
    gather_probe<1, 8><<<blocks, 256, 0, s>>>(ip, rp, n, stride, rw, op);
  else
    return (int)cudaErrorInvalidValue;
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


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def probes(g, rec: torch.Tensor, iters: int) -> None:
    """Time the gather probes (PROBE_SRC) on the edges of g's CSR and the
    records `rec`, at their stride and, where that is not whole 128-byte
    lines, padded to them."""
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.utils.maxk_sweep import build
    lib = build({"gather_probe": PROBE_SRC})["gather_probe"]
    fn = lib.gather_records
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int64] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    e, rw = g.num_edges, rec.shape[1]
    out = torch.empty(((e + 1023) // 1024) * 32, dtype=torch.int32,
                      device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    tables = [rec]
    if rw % 32:
        tables.append(torch.nn.functional.pad(rec, (0, 32 - rw % 32)))
    for table in tables:
        stride = table.shape[1]
        for shape in (0, 1):
            def run(table=table, stride=stride, shape=shape):
                _build.check(fn(g.indices.data_ptr(), table.data_ptr(), e,
                                stride, rw, shape, out.data_ptr(), stream),
                             "gather_records")
            ms = time_ms(run, iters)
            print(f"gather probe: {4 * rw}-B records at a {4 * stride}-B "
                  f"stride, {'4 B a lane' if shape == 0 else '16 B a lane'}:"
                  f" {ms:.3f} ms, {e / ms / 1e6:.3f} G edges/s "
                  f"(no-reuse gather {e * 4 * rw / PEAK_BYTES_S * 1e3:.3f} "
                  f"ms)", flush=True)
    del tables, out


def _successors(ins: list[tuple[int, str]]) -> list[list[int]]:
    """The control-flow successors of each SASS instruction (indices into
    `ins`): a branch under a predicate, or BRA.DIV, falls through or goes to
    its target; a bare BRA goes to its target; a bare EXIT ends."""
    at = {a: i for i, (a, _) in enumerate(ins)}
    out = []
    for i, (_, t) in enumerate(ins):
        guarded = re.match(r"@!?U?P\w+\s+", t)
        op = t[guarded.end():] if guarded else t
        nxt = [i + 1] if i + 1 < len(ins) else []
        if re.match(r"BRA\b", op):
            target = at.get(int(re.findall(r"0x[0-9a-f]+", op)[-1], 16))
            falls = guarded or re.match(r"BRA(\.DIV|\s+!?U?P\d)", op)
            out.append((nxt if falls else []) +
                       ([target] if target is not None else []))
        elif re.match(r"(EXIT|RET)\b", op):
            out.append(nxt if guarded else [])
        else:
            out.append(nxt)
    return out


def _hops(succ: list[list[int]], start: int) -> dict[int, int]:
    """Instructions from `start` to each instruction it reaches."""
    dist, todo = {start: 0}, [start]
    for u in todo:
        for v in succ[u]:
            if v not in dist:
                dist[v] = dist[u] + 1
                todo.append(v)
    return dist


def sass_loops(lib_path: Path, pattern: str, out_dir: Path | None = None,
               last_edge: int | None = None) -> dict[str, dict]:
    """For each kernel of the library whose mangled name holds `pattern`:
    its SASS instruction count and its loops (each backward branch: the
    instructions from its target to it). With `last_edge`, the byte offset
    in a stage of stream_cbsr16_kernel's ring of the stage's last record
    (128 KV (EPS - 1)), also `stage`: the instructions of one steady stage,
    the shortest cycle of the control flow through that record's shared
    load (`LDS R, [R+last_edge]`: every edge of the stage taken) and a
    cp.async copy (LDGSTS: the next stage fetched). Writes those kernels'
    SASS and the library's resource usage into out_dir if given."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True).stdout
    blocks = [b for b in sass.split("Function : ")[1:]
              if pattern in b.split("\n", 1)[0]]
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{lib_path.stem}.sass").write_text(
            "".join("Function : " + b for b in blocks))
        (out_dir / f"{lib_path.stem}.res").write_text(subprocess.run(
            [tool, "-res-usage", str(lib_path)], check=True,
            capture_output=True, text=True).stdout)
    found = {}
    for block in blocks:
        name = block.split("\n", 1)[0].strip()
        ins = [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        ins = [(a, t) for a, t in ins if not t.startswith("NOP")]
        loops = []
        for a, t in ins:
            hexes = re.findall(r"0x[0-9a-f]+", t)
            if (re.match(r"(@!?U?P\w+\s+)?BRA\b", t) and hexes
                    and int(hexes[-1], 16) <= a):
                lo = int(hexes[-1], 16)
                loops.append(dict(start=lo, end=a, instructions=sum(
                    lo <= b <= a for b, _ in ins)))
        found[name] = dict(instructions=len(ins), loops=loops)
        if last_edge is not None:
            succ = _successors(ins)
            load = re.compile(rf"LDS R\d+, \[R\d+\+{last_edge:#x}\]")
            cycles = []
            for x in (i for i, (_, t) in enumerate(ins) if load.match(t)):
                from_x = _hops(succ, x)
                for y, (_, t) in enumerate(ins):
                    if "LDGSTS" in t and y in from_x:
                        back = _hops(succ, y).get(x)
                        if back is not None:
                            cycles.append(from_x[y] + back)
            found[name]["stage"] = min(cycles) if cycles else None
    return found


def cbsr_forms(plan, rec, k: int, dim: int, post, vd, od, budgets, batches,
               iters: int, line) -> None:
    """stream_cbsr_spmm on the records at each budget and batch (the bits of
    the defaults), then its timing variants and, on bf16 records, each
    walk's registers and resident warps."""
    from spgemm_gnn_tpu_torch.kernels.stream import (stream_cbsr16_attrs,
                                                     stream_cbsr_spmm,
                                                     stream_cbsr_spmm_at)
    bf16 = vd == torch.bfloat16
    row_bytes = 4 * rec.shape[1]
    name = ("stream_cbsr_spmm_bf16_out" if od is not None else
            "stream_cbsr_spmm_bf16" if bf16 else "stream_cbsr_spmm")
    want = stream_cbsr_spmm(plan, rec, k, dim, None, post, vd, od)
    for mib, batch in itertools.product(budgets, batches):
        def run():
            return stream_cbsr_spmm_at(plan, rec, k, dim, None, post,
                                       hot_budget=mib << 20, batch=batch,
                                       value_dtype=vd, out_dtype=od)
        if not _same_bits(run(), want):
            raise AssertionError(f"{name} budget {mib} batch {batch}: bits "
                                 f"differ")
        line(f"{name} A budget {mib} MiB batch {batch}",
             time_ms(run, iters),
             plan.hot_set(row_bytes, mib << 20))
    variants = ("no_load", "no_scatter") if bf16 else ("scatter_free",)
    for batch, variant in itertools.product(batches, variants):
        def run_variant():
            return stream_cbsr_spmm_at(plan, rec, k, dim, None, post,
                                       batch=batch, variant=variant,
                                       value_dtype=vd, out_dtype=od)
        line(f"{name} A variant {variant} (wrong y) batch {batch}",
             time_ms(run_variant, iters), plan.hot_set(row_bytes))
    if not bf16:
        return
    for batch, variant in itertools.product(batches, (None, *variants)):
        a = stream_cbsr16_attrs(k, dim, batch, variant, od is not None)
        print(f"{name} batch {batch} variant {variant}: {a['regs']} "
              f"registers, {a['local_bytes']} local bytes a thread, "
              f"{a['warps_per_sm']} resident warps an SM", flush=True)


def sampled_probes(g, dim: int, k: int, seed: int, iters: int) -> None:
    """Time (i) the dense backward form and MaxK's backward after it, (ii)
    the k-channel gather form and (iii) the two-pass form, each pass alone,
    on Aᵀ of g (module docstring); (ii) and (iii) checked bitwise against
    (i) masked to the kept channels first."""
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_bwd, maxk_fwd
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.kernels.stream import (_slices,
                                                     stream_ksample_at,
                                                     stream_spmm,
                                                     stream_sspmm_at)
    from spgemm_gnn_tpu_torch.ops.norms import node_factors

    bf16 = torch.bfloat16
    n, e = g.num_nodes, g.num_edges
    fwd = build_stream_plan(g.indptr, g.indices)
    plan = build_stream_plan(g.t_indptr, g.t_indices)
    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    h = torch.randn((n, dim), generator=gen, device="cuda").to(bf16)
    _, meta, ch = maxk_fwd(h, k, with_ids=True)
    _, post = node_factors(g, "mean")
    gy = torch.randn((n, dim), generator=gen, device="cuda")
    m = round_rows(gy, post)
    del gy
    keep = torch.zeros((n, dim), dtype=torch.bool, device="cuda")
    keep.scatter_(1, ch.long(), True)

    def masked(y):
        return torch.where(keep, y, torch.zeros((), dtype=y.dtype,
                                                device=y.device))

    def same(a, b) -> bool:
        return bool(torch.equal(a.view(torch.int16 if a.dtype == bf16
                                       else torch.int32),
                                b.view(torch.int16 if b.dtype == bf16
                                       else torch.int32)))

    edge_bytes = 2 * dim
    print(f"sampled backward probes (A^T, dim {dim}, k {k}, bf16 messages; "
          f"no-reuse gather of {edge_bytes}-B rows "
          f"{e * edge_bytes / PEAK_BYTES_S * 1e3:.3f} ms, of {2 * k}-B slots "
          f"{e * 2 * k / PEAK_BYTES_S * 1e3:.3f} ms)", flush=True)
    for od in (None, bf16):
        out = "bf16 out" if od is not None else "f32 out"
        dense = stream_spmm(plan, m, None, None, out_dtype=od)
        want = masked(dense)
        ms_dense = time_ms(lambda: stream_spmm(plan, m, None, None,
                                               out_dtype=od), iters)
        # MaxK's backward on the dense form's dx: f32 rows for the bf16x2
        # stream, bf16 rows for the 16-bit model
        g_mk, x_mk = dense, (h if od is not None else h.float())
        ms_bwd = time_ms(lambda: maxk_bwd(x_mk, meta, g_mk), iters)
        print(f"(i) dense stream_spmm_bf16 ({out}): {ms_dense:.3f} ms; "
              f"maxk_bwd{'_bf16' if od is not None else ''} after it "
              f"{ms_bwd:.3f} ms; together {ms_dense + ms_bwd:.3f} ms",
              flush=True)
        del dense, g_mk, x_mk
        if _slices(k) == 1:
            got = stream_ksample_at(plan, m, ch, g.t_edge_dst, None,
                                    out_dtype=od)
            if not same(got, want):
                raise AssertionError(f"gather form ({out}): bits differ "
                                     f"from the dense form's at the kept "
                                     f"channels")
            ms = time_ms(lambda: stream_ksample_at(
                plan, m, ch, g.t_edge_dst, None, out_dtype=od), iters)
            print(f"(ii) k-channel gather form ({out}): {ms:.3f} ms "
                  f"({e / ms / 1e6:.3f} G edges/s); bitwise the dense "
                  f"form's at the kept channels", flush=True)
        slots = stream_sspmm_at(plan, fwd, m, ch, passes=(1,))
        ms1 = time_ms(lambda: stream_sspmm_at(
            plan, fwd, m, ch, passes=(1,), slots=slots), iters)
        got = stream_sspmm_at(plan, fwd, m, ch, None, out_dtype=od)
        if not same(got, want):
            raise AssertionError(f"two-pass form ({out}): bits differ from "
                                 f"the dense form's at the kept channels")
        ms2 = time_ms(lambda: stream_sspmm_at(
            plan, fwd, m, ch, None, out_dtype=od, passes=(2,),
            slots=slots), iters)
        ms = time_ms(lambda: stream_sspmm_at(
            plan, fwd, m, ch, None, out_dtype=od, slots=slots), iters)
        print(f"(iii) two-pass form ({out}): {ms:.3f} ms (pass 1 {ms1:.3f}, "
              f"pass 2 {ms2:.3f}); bitwise the dense form's at the kept "
              f"channels", flush=True)
        if od is None and k % 4 == 0 and 16 < k <= 32:
            for variant in ("no_store", "in_order", "no_ids"):
                ms = time_ms(lambda: stream_sspmm_at(
                    plan, fwd, m, ch, passes=(1,), slots=slots,
                    variant=variant), iters)
                print(f"(iii) pass 1 variant {variant} (wrong slots): "
                      f"{ms:.3f} ms", flush=True)
        del slots, want, got
        torch.cuda.empty_cache()


def sweep(dataset: str, budgets: list[int], depths: list[int],
          batches: list[int], dim: int, k: int, iters: int,
          seed: int, stream: str, cbsr_only: bool = False,
          outs: tuple[str, ...] = ("f32",),
          with_probes: bool = False, sampled_only: bool = False) -> None:
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.kernels.cbsr import cbsr_compact
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_fwd
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.kernels.stream import stream_spmm, stream_spmm_at
    from spgemm_gnn_tpu_torch.ops.maxk import cbsr_records
    from spgemm_gnn_tpu_torch.ops.norms import node_factors

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    ds = load_dataset(dataset, allow_synthetic=True, data_path="/nonexistent",
                      synthetic_scale=1.0, seed=seed)
    g = ds.graph.to("cuda")
    del ds
    n, e = g.num_nodes, g.num_edges
    print(f"{dataset}: N={n} E={e} dim={dim} k={k} stream {stream}",
          flush=True)
    if sampled_only:
        sampled_probes(g, dim, k, seed, iters)
        return
    bf16 = stream == "bf16x2"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    y, _ = maxk_fwd(torch.randn((n, dim), generator=gen, device="cuda"), k)
    keep = torch.rand((n, dim), generator=gen, device="cuda") >= 0.5
    xs = torch.where(keep, y / 0.5, torch.zeros_like(y))
    del y, keep
    gy = torch.randn((n, dim), generator=gen, device="cuda")
    _, post = node_factors(g, "mean")

    def line(what: str, ms: float, hot) -> None:
        print(f"{what}: {ms:.3f} ms; hot set {hot.rows} rows, "
              f"{hot.edge_share:.2%} of the edges", flush=True)

    for what, indptr, indices, x, pre, pst in () if cbsr_only else (
            ("A", g.indptr, g.indices, xs, None, post),
            ("A^T", g.t_indptr, g.t_indices, gy, post, None)):
        if bf16:
            x, pre = round_rows(x, pre), None
        plan = build_stream_plan(indptr, indices)
        want = stream_spmm(plan, x, pre, pst)
        for mib, depth in itertools.product(budgets, depths):
            def run():
                return stream_spmm_at(plan, x, pre, pst, hot_budget=mib << 20,
                                      depth=depth)
            if not _same_bits(run(), want):
                raise AssertionError(f"stream_spmm {what} budget {mib} depth "
                                     f"{depth}: bits differ")
            line(f"stream_spmm {what} budget {mib} MiB depth {depth}",
                 time_ms(run, iters),
                 plan.hot_set(x.element_size() * dim, mib << 20))
        del want, plan
        torch.cuda.empty_cache()

    plan = build_stream_plan(g.indptr, g.indices)
    vals, ch = cbsr_compact(xs, k)
    vd = torch.bfloat16 if bf16 else torch.float32
    rec = cbsr_records(round_rows(vals) if bf16 else vals, ch, dim)
    del vals, ch, gy, xs
    for od in (torch.bfloat16 if o == "bf16" else None for o in outs):
        cbsr_forms(plan, rec, k, dim, post, vd, od, budgets, batches, iters,
                   line)
    if with_probes:
        probes(g, rec, iters)
        del rec
        sampled_probes(g, dim, k, seed, iters)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="ogbn-products")
    ap.add_argument("--budgets", default="0,10,20,30,40",
                    help="hot-set budgets in MiB")
    ap.add_argument("--depths", default="4,8,16",
                    help="stream_spmm rows fetched ahead")
    ap.add_argument("--batches", default="",
                    help="stream_cbsr_spmm edges loaded ahead (default: "
                         "every one its kernel is built for at k)")
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=97)
    ap.add_argument("--stream", default="f32", choices=["f32", "bf16x2"])
    ap.add_argument("--cbsr_only", action="store_true",
                    help="skip stream_spmm")
    ap.add_argument("--out", default="f32",
                    help="stream_cbsr_spmm's outputs, f32 and/or bf16 "
                         "(bf16 records only)")
    ap.add_argument("--probes", action="store_true",
                    help="time the record gather probes and the forms of "
                         "MaxK's backward on A^T")
    ap.add_argument("--sampled_only", action="store_true",
                    help="time only the forms of MaxK's backward on A^T")
    ap.add_argument("--sass", default="",
                    help="write the stream library's SASS here and print "
                         "the bf16-record walks' loops")
    args = ap.parse_args(argv)
    if args.sass:
        from spgemm_gnn_tpu_torch.kernels import _build
        _build.build_all()
        for name, r in sass_loops(_build._target("stream"), "cbsr16_kernel",
                                  Path(args.sass), 3 * 128).items():
            loops = [(hex(lp["start"]), lp["instructions"])
                     for lp in r["loops"]]
            print(f"SASS {name}: {r['instructions']} instructions; loops "
                  f"{loops}; a stage of 4 edges {r['stage']}", flush=True)

    def ints(s: str) -> list[int]:
        return [int(v) for v in s.split(",")]

    from spgemm_gnn_tpu_torch.kernels.stream import (BATCHES, BATCHES16,
                                                     _slices)
    batches = ints(args.batches) if args.batches else list(
        (BATCHES16 if args.stream == "bf16x2" else BATCHES)[_slices(args.k)])
    sweep(args.dataset, ints(args.budgets), ints(args.depths),
          batches, args.dim, args.k, args.iters, args.seed,
          args.stream, args.cbsr_only, tuple(args.out.split(",")),
          args.probes, args.sampled_only)


if __name__ == "__main__":
    main()
