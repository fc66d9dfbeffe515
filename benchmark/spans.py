"""The port's own spans and counters in a traced run, for the per-layer
readers that read them.

The port (`deep_spectral_tpu_torch.utils.profiling`) opens named ranges
(`span`) and counts work (`count`) where the work happens. While the
profiler records, each span is a `record_function` range, so its host
interval is among `run.timeline.host` on the device trace's clock, and a
record holding the counts made inside it and its device milliseconds
between CUDA events (`profiling.records()`). A port without them gives
nothing to read: every function here then returns 0, None or an empty
list, and never raises.
"""
from __future__ import annotations

from benchmark.trace import union_seconds


def records() -> list[dict]:
    """The port's span records of the traced window ([] where it has none)."""
    try:
        from deep_spectral_tpu_torch.utils import profiling
        return profiling.records()
    except (ImportError, AttributeError):
        return []


def total(counter: str) -> int:
    """The counter's sum over the traced window's spans."""
    return sum(r["counts"].get(counter, 0) for r in records())


def opened(name: str) -> int:
    """How many spans named `name` the traced window opened."""
    return sum(r["name"] == name for r in records())


def device_ms(name: str) -> float | None:
    """Summed device milliseconds of the spans named `name` (None where
    none was timed on the card)."""
    ms = [r["device_ms"] for r in records() if r["name"] == name and r["device_ms"] is not None]
    return sum(ms) if ms else None


def host_ranges(run, name: str) -> list[tuple[float, float]]:
    """The host intervals (seconds, the trace's clock) of the ranges named
    `name`, clipped to the window."""
    lo, hi = run.timeline.window
    return [(max(s, lo), min(e, hi)) for n, s, e in run.timeline.host
            if n == name and min(e, hi) > max(s, lo)]


def window_share(run, name: str) -> float | None:
    """% of the traced window the host spent inside ranges named `name`
    (their union, so nested ranges count once); None where there is none."""
    ranges = host_ranges(run, name)
    w = run.timeline.window_s
    if not ranges or w <= 0:
        return None
    return union_seconds(ranges, *run.timeline.window) / w * 100
