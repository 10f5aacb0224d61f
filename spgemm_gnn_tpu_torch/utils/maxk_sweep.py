"""Time MaxK's forward (`maxk_fwd`, `maxk_fwd_bf16`) and `cbsr_compact_bf16`
from one or more kernel source trees, in turns in one process on the GPU,
beside memory-only and select-only forms of the same kernels.

    python -m spgemm_gnn_tpu_torch.utils.maxk_sweep \
        [--sources label=DIR,...] [--shapes reddit,products] [--iters 20] \
        [--rounds 2] [--depths 1,2,3]

Each DIR holds a `maxk.cu` and a `cbsr.cu` (default: this package's
`csrc`; another tree's `spgemm_gnn_tpu_torch/csrc` compares a commit with
this one in one call). Built with nvcc (sm_90a) into `build/kernels/sweep/`,
per source: the kernels as they are; "meta only", maxk.cu with its y store
removed (the select and the meta store alone: what the row's instructions
cost with half of the bytes); and, from this script, memory probes of the
same bytes: a warp per row, 8 rows to a block (the launch shape of a warp
per row), and a persistent walk of one wave of resident blocks with the
next `depth` rows in flight, each copying row after row (y = x for MaxK;
the first 192 B of a 512-B row for the compaction's k = 32 output).
`--depths` also builds maxk.cu of the last source with other ring depths
(its kDepth).

Inputs, at dim 256, k 32: `utils/rows.py::seeded_rows` (random normal rows
with every 97th rounded to integers, every 1009th zeroed, every 89th from
the row families) from --seed, at the Reddit (N 232,965) and
ogbn-products (N 2,449,029) node counts, f32 and bf16; the compaction on
the bf16 MaxK of those rows after dropout 0.5 (the training path's
input). Every form is checked bitwise
against the plain versions (y and meta; values and channels) first. The
rounds run the sources in turns (a, b, b, a for two sources). One JSON line
per (kernel, shape, form, source): ms (mean of its rounds), each round's
ms, the bound (bytes over 3.35 TB/s). Prints the card's name and power
limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from pathlib import Path

import torch

from spgemm_gnn_tpu_torch.kernels import _build
from spgemm_gnn_tpu_torch.utils.rows import seeded_rows

PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3
NODES = {"reddit": 232_965, "products": 2_449_029}
DIM, K = 256, 32
SWEEP_DIR = _build.BUILD_DIR / "sweep"

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// Memory probes: rows of 32 * NW 16-byte words, each read once; the first
// `out_words` of each written once.

// word j of a row's output, or (never taken) a store that keeps the load
// of a word past out_words from being dropped
__device__ __forceinline__ void store(uint4* y, int j, int out_words,
                                      uint4 v) {
  if (j < out_words) y[j] = v;
  else if ((v.x & v.y & v.z & v.w) == 0xffffffffu) y[0] = v;
}
template <int NW>
__global__ void copy_warp(const uint4* __restrict__ x, uint4* __restrict__ y,
                          int64_t n, int out_words) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= n) return;
  uint4 v[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) v[j] = x[row * 32 * NW + lane * NW + j];
#pragma unroll
  for (int j = 0; j < NW; ++j) store(y + row * out_words, lane * NW + j,
                                     out_words, v[j]);
}

template <int NW, int DEPTH>
__global__ void __launch_bounds__(256, 4)
copy_walk(const uint4* __restrict__ x, uint4* __restrict__ y, int64_t n,
          int out_words) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * 8;
  int64_t row = (int64_t)blockIdx.x * 8 + (threadIdx.x >> 5);
  uint4 ring[DEPTH][NW];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (row + d * stride < n)
#pragma unroll
      for (int j = 0; j < NW; ++j)
        ring[d][j] = x[(row + d * stride) * 32 * NW + lane * NW + j];
  for (; row < n; row += DEPTH * stride) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int64_t r = row + d * stride;
      if (r >= n) break;
      uint4 v[NW];
#pragma unroll
      for (int j = 0; j < NW; ++j) v[j] = ring[d][j];
      const int64_t ahead = r + DEPTH * stride;
      if (ahead < n)
#pragma unroll
        for (int j = 0; j < NW; ++j)
          ring[d][j] = x[ahead * 32 * NW + lane * NW + j];
#pragma unroll
      for (int j = 0; j < NW; ++j) store(y + r * out_words, lane * NW + j,
                                         out_words, v[j]);
    }
  }
}

template <class Kernel>
unsigned wave(Kernel kernel, int64_t n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, 0);
  const int64_t need = (n + 7) / 8, w = (int64_t)per_sm * sms;
  return (unsigned)(need < w ? need : w);
}

template <int NW, int DEPTH>
void walk(const uint4* x, uint4* y, int64_t n, int out, cudaStream_t s) {
  auto kernel = copy_walk<NW, DEPTH>;
  kernel<<<wave(kernel, n), 256, 0, s>>>(x, y, n, out);
}

// nw: 16-byte words of a row a lane reads (1 or 2); depth 0: a warp per
// row; 1 to 3: the walk with that many rows in flight
extern "C" int copy_rows(const void* x, void* y, int64_t n, int nw,
                         int out_words, int depth, void* stream) {
  const uint4* xp = static_cast<const uint4*>(x);
  uint4* yp = static_cast<uint4*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((n + 7) / 8);
  if (nw == 1 && depth == 0)
    copy_warp<1><<<blocks, 256, 0, s>>>(xp, yp, n, out_words);
  else if (nw == 2 && depth == 0)
    copy_warp<2><<<blocks, 256, 0, s>>>(xp, yp, n, out_words);
  else if (nw == 1 && depth == 1) walk<1, 1>(xp, yp, n, out_words, s);
  else if (nw == 1 && depth == 2) walk<1, 2>(xp, yp, n, out_words, s);
  else if (nw == 1 && depth == 3) walk<1, 3>(xp, yp, n, out_words, s);
  else if (nw == 2 && depth == 1) walk<2, 1>(xp, yp, n, out_words, s);
  else if (nw == 2 && depth == 2) walk<2, 2>(xp, yp, n, out_words, s);
  else if (nw == 2 && depth == 3) walk<2, 3>(xp, yp, n, out_words, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
"""

# the y store of maxk.cu's forward (removed for "meta only")
Y_STORE = re.compile(r"store_range<PER, FULL>\(y \+ [^;]*\);")


def meta_only(src: str) -> str:
    out, n = Y_STORE.subn("(void)out;", src)
    if n != 1:
        raise ValueError(f"maxk.cu: expected one y store, found {n}")
    return out


def with_depth(src: str, depth: int) -> str:
    """maxk.cu with its walk's ring of `depth` rows (kDepth)."""
    out, n = re.subn(r"constexpr int kDepth = \d+;",
                     f"constexpr int kDepth = {depth};", src)
    if n != 1:
        raise ValueError(f"maxk.cu: expected one kDepth, found {n}")
    return out


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """name -> CUDA source text; compiled in parallel, loaded."""
    nvcc = _build._nvcc()
    SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in sources.items():
        h = hashlib.sha256(text.encode()).hexdigest()[:12]
        cu = SWEEP_DIR / f"{name}_{h}.cu"
        so = cu.with_suffix(".so")
        cu.write_text(text)
        if not so.exists():
            jobs[name] = (subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                so)
        else:
            jobs[name] = (None, so)
    libs, errors = {}, []
    for name, (proc, so) in jobs.items():
        if proc is not None:
            out, _ = proc.communicate()
            if proc.returncode:
                errors.append(f"--- {name}\n{out}")
                continue
        libs[name] = ctypes.CDLL(str(so))
    if errors:
        raise RuntimeError("sweep build failed:\n" + "\n".join(errors))
    return libs


def entry(lib: ctypes.CDLL, name: str):
    """A C entry point of maxk.cu or cbsr.cu with the package's argtypes."""
    stem = "maxk" if name.startswith("maxk") else "cbsr"
    f = getattr(lib, name)
    f.argtypes = _build.SIGNATURES[stem][name]
    f.restype = ctypes.c_int
    return f


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sources", default="",
                    help="label=DIR,... (default: this package's csrc)")
    ap.add_argument("--shapes", default="reddit,products")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--depths", default="",
                    help="other ring depths for the last source's maxk.cu")
    ap.add_argument("--seed", type=int, default=97)
    args = ap.parse_args()
    from spgemm_gnn_tpu_torch.ops.maxk import cbsr_compact_plain, maxk_forward

    if not torch.cuda.is_available():
        raise SystemExit("maxk_sweep measures the card: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    dirs = dict(s.split("=", 1) for s in args.sources.split(",") if s) or {
        "this": str(_build.CSRC)}
    texts = {}
    for label, d in dirs.items():
        maxk_src = Path(d, "maxk.cu").read_text()
        texts[f"{label}.maxk"] = maxk_src
        texts[f"{label}.maxk_meta_only"] = meta_only(maxk_src)
        texts[f"{label}.cbsr"] = Path(d, "cbsr.cu").read_text()
    last = list(dirs)[-1]
    for depth in (int(a) for a in args.depths.split(",") if a):
        src = texts[f"{last}.maxk"]
        texts[f"{last}.maxk_depth{depth}"] = with_depth(src, depth)
    texts["probe"] = PROBE_SRC
    libs = build(texts)
    probe = libs.pop("probe")
    probe.copy_rows.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    probe.copy_rows.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    for shape in args.shapes.split(","):
        n = NODES[shape]
        x32 = seeded_rows(n, DIM, K, torch.Generator(
            device="cuda").manual_seed(args.seed))
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            esz = x.element_size()
            fwd = "maxk_fwd_bf16" if dt == torch.bfloat16 else "maxk_fwd"
            y, meta = torch.empty_like(x), torch.empty((n, 2),
                                                       dtype=torch.int32,
                                                       device="cuda")
            y_p, meta_p = maxk_forward(x, K)
            iv = torch.int16 if esz == 2 else torch.int32
            forms = {}
            for name, lib in libs.items():
                label, kind = name.split(".")
                if not kind.startswith("maxk"):
                    continue
                f = entry(lib, fwd)

                def run(f=f):
                    return _build.check(f(x.data_ptr(), y.data_ptr(),
                                          meta.data_ptr(), n, DIM, K,
                                          stream), fwd)
                run()
                torch.cuda.synchronize()
                if not torch.equal(meta, meta_p):
                    raise AssertionError(f"{name} {fwd}: meta differs")
                if kind != "maxk_meta_only" and not torch.equal(
                        y.view(iv), y_p.view(iv)):
                    raise AssertionError(f"{name} {fwd}: y differs")
                forms[(kind, label)] = run
            nw = DIM * esz // 16 // 32
            for depth in (0, 1, 2):
                def copy(depth=depth):
                    return _build.check(probe.copy_rows(
                        x.data_ptr(), y.data_ptr(), n, nw, 32 * nw, depth,
                        stream), "copy_rows")
                forms[(f"copy_{'warp' if depth == 0 else f'walk{depth}'}",
                       "probe")] = copy
            n_bytes = 2 * n * DIM * esz + n * 8
            report(fwd, shape, forms, args, n_bytes)
            del y, meta, y_p, meta_p

            if dt != torch.bfloat16 or shape != "products":
                continue
            # cbsr_compact_bf16 on the training path's input
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            keep = torch.rand((n, DIM), generator=gen, device="cuda") >= 0.5
            xs = torch.where(keep, maxk_forward(x32, K)[0] / 0.5,
                             0.0).to(torch.bfloat16)
            del keep
            v_p, c_p = cbsr_compact_plain(xs, K)
            v = torch.empty_like(v_p)
            c = torch.empty_like(c_p)
            forms = {}
            for name, lib in libs.items():
                label, kind = name.split(".")
                if kind != "cbsr":
                    continue
                f = entry(lib, "cbsr_compact_bf16")

                def run(f=f):
                    return _build.check(f(xs.data_ptr(), v.data_ptr(),
                                          c.data_ptr(), n, DIM, K, stream),
                                        "cbsr_compact_bf16")
                run()
                torch.cuda.synchronize()
                if not (torch.equal(v.view(torch.int16),
                                    v_p.view(torch.int16))
                        and torch.equal(c, c_p)):
                    raise AssertionError(f"{name} cbsr_compact_bf16 differs")
                forms[("compact", label)] = run
            out = torch.empty((n, 12 * 16 // 2), dtype=torch.bfloat16,
                              device="cuda")
            for depth in (0, 1, 2):
                def copy(depth=depth):
                    return _build.check(probe.copy_rows(
                        xs.data_ptr(), out.data_ptr(), n, 1, 12, depth,
                        stream), "copy_rows")
                forms[(f"copy_{'warp' if depth == 0 else f'walk{depth}'}",
                       "probe")] = copy
            report("cbsr_compact_bf16", shape, forms, args,
                   n * DIM * 2 + n * K * 6)
            del xs, v, c, v_p, c_p, out
        del x32
        torch.cuda.empty_cache()


def report(kernel: str, shape: str, forms: dict, args, n_bytes: int) -> None:
    """Time every form in turns (a, b, ..., b, a per pair of rounds) and
    print one JSON line each."""
    order = list(forms)
    times = {key: [] for key in order}
    for r in range(args.rounds):
        for key in (order if r % 2 == 0 else order[::-1]):
            times[key].append(time_ms(forms[key], args.iters))
    bound = n_bytes / PEAK_BYTES_S * 1e3
    for (form, label), ts in times.items():
        print(json.dumps({"kernel": kernel, "shape": shape, "form": form,
                          "source": label, "ms": sum(ts) / len(ts),
                          "rounds_ms": ts, "bound_ms": bound,
                          "bound_by": "bytes"}), flush=True)


if __name__ == "__main__":
    main()
