"""Reading a `torch.profiler` trace of the traced window.

The trace is the profiler's Chrome trace (CUPTI on the card). Device
operations are its kernels, copies and sets; host operations are the
events of the CPU side (aten ops, CUDA runtime calls, annotations). Times
are in microseconds on one clock.

The window is the span of the annotation `WINDOW` that the harness puts
around the traced calls; each ends in a synchronise, so the device's work
lies inside it. Busy time is the union of the device operations' intervals
inside the window, never their sum: operations that overlap count once.

The port's own kernels are the `__global__` functions of its `csrc/*.cu`,
read from the sources; every other device operation (cuBLAS, PyTorch's
element-wise kernels, copies, sets) belongs to the model layer. The
aggregation's kernels are the port's kernels named `csr_*`, `stream_*` and
`sspmm_*` (both passes of the sampled backward), and `round_out*`, which
rounds the output of the bf16-output aggregations.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import re
from pathlib import Path

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
AGG_PREFIXES = ("csr_", "stream_", "sspmm_", "round_out")


@dataclasses.dataclass
class Op:
    name: str
    start: float      # us
    end: float        # us


@dataclasses.dataclass
class Trace:
    window: Op
    device: list[Op]
    host: list[Op]

    @property
    def window_s(self) -> float:
        return (self.window.end - self.window.start) / 1e6


def load(path: str | Path) -> Trace:
    """The window, device and host operations of a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    device, host, window = [], [], None
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        op = Op(ev.get("name", ""), float(ev["ts"]),
                float(ev["ts"]) + float(ev["dur"]))
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(op)
        elif cat in HOST_CATS:
            if op.name == WINDOW and cat == "user_annotation":
                window = op
            else:
                host.append(op)
    if window is None:
        raise ValueError(f"no {WINDOW!r} annotation in the trace")
    inside = [Op(o.name, max(o.start, window.start), min(o.end, window.end))
              for o in device if o.end > window.start and o.start < window.end]
    return Trace(window, inside, host)


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The intervals merged where they overlap or touch, in order."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(trace: Trace) -> float:
    """Seconds of the window in which some operation ran on the device."""
    return sum(b - a for a, b in union([(o.start, o.end)
                                        for o in trace.device])) / 1e6


def gaps(trace: Trace) -> list[tuple[float, float]]:
    """The idle intervals of the device inside the window."""
    busy = union([(o.start, o.end) for o in trace.device])
    out, at = [], trace.window.start
    for a, b in busy:
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if trace.window.end > at:
        out.append((at, trace.window.end))
    return out


def host_doing(trace: Trace, times: list[float]) -> list[str]:
    """The innermost host operation (the one that started last) running at
    each of the sorted `times`, or "host: no traced op" between them."""
    ops = sorted(trace.host, key=lambda o: o.start)
    active: list[tuple[float, int]] = []
    out, i = [], 0
    for t in times:
        while i < len(ops) and ops[i].start <= t:
            heapq.heappush(active, (-ops[i].start, i))
            i += 1
        while active and ops[active[0][1]].end <= t:
            heapq.heappop(active)
        out.append(ops[active[0][1]].name if active
                   else "host: no traced op")
    return out


def base_name(kernel: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template arguments and parameters."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    return name.split()[-1].split("::")[-1] if name else kernel


def own_kernels(csrc: Path) -> set[str]:
    """The names of the `__global__` functions in the port's sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu")):
        text = re.sub(r"__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)", "",
                      path.read_text())
        for m in re.finditer(r"__global__\s+([^(]*?)\(", text, re.S):
            names.add(m.group(1).split()[-1])
    return names


def is_aggregation(name: str) -> bool:
    return base_name(name).startswith(AGG_PREFIXES)


def top_device_ops(trace: Trace, n: int = 10) -> list[list]:
    """[[kernel, seconds]] of the n device operations that took the most
    time in the window, summed by name."""
    total: dict[str, float] = {}
    for o in trace.device:
        total[o.name] = total.get(o.name, 0.0) + (o.end - o.start) / 1e6
    return [[k[:160], v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def top_idle_gaps(trace: Trace, n: int = 10) -> list[list]:
    """[[what the host was doing, seconds]]: the device's idle time in the
    window summed by the host operation running at each gap's start, the
    n largest."""
    total: dict[str, float] = {}
    idle = gaps(trace)
    for (a, b), label in zip(idle, host_doing(trace, [a for a, _ in idle])):
        total[label] = total.get(label, 0.0) + (b - a) / 1e6
    return [[k[:160], v] for k, v in
            sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def aggregation_s(trace: Trace, own: set[str]) -> float | None:
    """Seconds of the port's aggregation kernels in the window, or None
    where none ran."""
    ops = [o for o in trace.device
           if base_name(o.name) in own and is_aggregation(o.name)]
    if not ops:
        return None
    return sum(o.end - o.start for o in ops) / 1e6
