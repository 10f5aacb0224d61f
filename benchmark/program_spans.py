"""The program's own spans and counters (`spgemm_gnn_tpu_torch/utils/
spans.py`) as the run left them in memory: the step's phases and the
`host_syncs` counter recorded while the profiler traced its call, the
set-up spans always. A program without that module gives None, as does a
span or counter that did not occur."""
from __future__ import annotations


def _spans():
    try:
        from spgemm_gnn_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def device_ms_per_epoch(ctx, *names: str) -> float | None:
    """The spans of `names`: their summed device ms (between each span's
    stream events) over the traced call's epochs."""
    spans = _spans()
    if spans is None or ctx.trace is None or not ctx.traced_epochs:
        return None
    got = [ms for ms in (spans.device_ms(n) for n in names) if ms is not None]
    return sum(got) / ctx.traced_epochs if got else None


def count_per_epoch(ctx, name: str) -> float | None:
    """The counter `name` over the traced call's epochs."""
    spans = _spans()
    if spans is None or ctx.trace is None or not ctx.traced_epochs:
        return None
    return spans.counters[name] / ctx.traced_epochs


def self_s(name: str) -> float | None:
    """The summed self seconds on the host of the set-up spans of `name`:
    their time less that of the set-up spans inside them."""
    spans = _spans()
    if spans is None:
        return None
    setup = [s for s in spans.record() if s.name.startswith("setup.")]
    return spans.host_s(name, own=True, spans=setup)
