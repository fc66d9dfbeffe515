"""Tracing, spans, counters and per-stage timing of the port: the JAX
package's `utils/profiling.py` on `torch.profiler`.

  * `span(name)`: a named range of the port's work. While `torch.profiler`
    records, it opens a `record_function` range (on the trace's clock, so
    the device's idle gaps are named after the span open when they start),
    records a CUDA event pair on the current stream around it, and keeps a
    record of it: name, enclosing span, the counts made inside it, device
    milliseconds. With the profiler off it does nothing but one flag check.
  * `count(name, n)`: adds to a process-wide counter (always on, plain host
    ints, `totals()`); while tracing, also to the innermost open span's
    record.
  * `records()` / `clear()`: the records of the spans traced so far.
  * `trace(logdir)`: a `torch.profiler` trace of the enclosed work (host and,
    with a card, CUDA activity), written into `logdir` as a Chrome trace
    (`trace.json`, which TensorBoard's and Perfetto's viewers open) and the
    span records with the counters' totals (`spans.json`).
  * `StageTimer`: per-stage wall time and item counts, printed as one
    summary table by `pipeline.run_all`. A stage's clock stops after the
    card has finished the stage's work (`torch.cuda.synchronize`), so its
    wall time includes its device time.

The spans and counters the port opens and counts:

  * stages (`pipeline/extract.py`): `stage.upload` (pin and copy to the
    card), `stage.fetch` (pinned buffers and the copies back), `stage.wait`
    (the host waiting for a fetch), `stage.callback` (the host's work on a
    fetched batch);
  * ViT (`models/vit.py`): `vit.extract` (`extract_patch_keys`), with its
    counters `vit.tokens` (the batch's B x T tokens run, prefix and any
    padding that runs included, from shapes: B x Tc where the blocks run
    compacted), `vit.compacted` (the batches whose blocks ran on each
    image's own tokens, DINOv2 or DINOv3 given grids),
    `vit.tokens_valid` (each image's CLS, registers and valid patches, from
    the grids the caller gives, counted only where it gives them),
    `vit.graph_replays` (the calls that a CUDA graph's replay served) and
    `vit.graph_captures` (the calls that captured one);
    `vit.swiglu` (a block's SwiGLU FFN: w12 or w1 and w2, the gate and w3);
    `vit.rope` (a DINOv3 block's RoPE on q and k), with its counter
    `vit.rope_rows` (the q and k patch rows it rotated);
  * eigensolve (`ops/eigen.py`, `ops/lobpcg.py`): `eigs.decompose`,
    `eigs.affinity`, `eigs.cheb` and `eigs.lobpcg` (one iterative solve),
    `eigs.outer` (one Chebyshev outer iteration), `eigs.guard` (the residual
    check, the continuation and the dense re-solve), `eigs.continue` (a
    round of outers the guard resumed a Chebyshev solve for), `eigs.sync`
    (each point where the solver waits for the device); counters
    `eigs.images` (valid lanes the guard checked), `eigs.continued` (lanes
    a Chebyshev solve's guard resumed at least once, counted with every
    such guard), `eigs.resolved` (lanes it re-solved densely), `eigs.syncs`,
    `cheb.lanes_filtered` (lanes each outer's filter ran on),
    `cheb.lanes_active` (lanes still above the residual tolerance there,
    the solve's `outers` summed: counted at the guard's read, or, without a
    guard, at a read made only while tracing),
    `eigs.rr_graph_captures` and `eigs.rr_graph_replays` (the Rayleigh-Ritz
    steps captured into a CUDA graph and replayed from one);
  * train step (`tasks/semantic_segmentation.py`): `train.forward`,
    `train.backward`, `train.optimizer`.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch


class _OpenSpans(threading.local):
    def __init__(self):
        self.stack: list = []   # indices in _records of this thread's open spans


_OFF = contextlib.nullcontext()
_records: list = []          # the spans opened while the profiler recorded
_records_lock = threading.Lock()
_totals: Counter = Counter()  # counter name -> process total
_open = _OpenSpans()


def recording() -> bool:
    """Whether `torch.profiler` is recording (spans are traced)."""
    return torch.autograd._profiler_enabled()


def span(name: str):
    """A named range of the port's work (see the module docstring); a no-op
    unless `torch.profiler` is recording, and while the current stream
    captures a CUDA graph (a replay runs no host code: its work is the
    span the replay is issued in)."""
    if not recording() or (torch.cuda.is_initialized()
                           and torch.cuda.is_current_stream_capturing()):
        return _OFF
    return _traced_span(name)


@contextlib.contextmanager
def _traced_span(name: str):
    stack = _open.stack
    with torch.profiler.record_function(name):
        rec = {"name": name, "parent": stack[-1] if stack else None, "counts": {},
               "events": None}
        with _records_lock:
            _records.append(rec)
            stack.append(len(_records) - 1)
        timed = torch.cuda.is_initialized()
        if timed:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        try:
            yield
        finally:
            stack.pop()
            if timed:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                rec["events"] = (start, end)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (and, while tracing, to the innermost
    open span's record)."""
    _totals[name] += n
    stack = _open.stack
    if stack:
        counts = _records[stack[-1]]["counts"]
        counts[name] = counts.get(name, 0) + n


def totals() -> dict:
    """The process's counter totals."""
    return dict(_totals)


def records() -> list[dict]:
    """The traced spans, in the order they opened: {'name', 'parent' (the
    index of the enclosing span or None), 'counts', 'device_ms' (between the
    span's CUDA events; None off the card)}. Synchronizes the card once."""
    with _records_lock:
        recs = list(_records)
    if any(r["events"] is not None for r in recs):
        torch.cuda.synchronize()
    return [{"name": r["name"], "parent": r["parent"], "counts": dict(r["counts"]),
             "device_ms": None if r["events"] is None else r["events"][0].elapsed_time(
                 r["events"][1])} for r in recs]


def clear() -> None:
    """Forget the traced spans (call with no span open)."""
    with _records_lock:
        _records.clear()


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the enclosed work into `logdir`/trace.json, with the spans
    it opened and the counters' totals in `logdir`/spans.json (no-op when
    logdir is None)."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    (out / "spans.json").write_text(json.dumps({"spans": records(), "totals": totals()}))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclass
class StageStats:
    items: int = 0
    seconds: float = 0.0

    @property
    def throughput(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0


@dataclass
class StageTimer:
    """Accumulates per-stage wall time and item counts.

    Usage:
        timer = StageTimer()
        with timer.stage("extract_features", n_items=batch):
            ...
        print(timer.summary())
    """
    stats: dict = field(default_factory=dict)
    counts_at_start: dict = field(default_factory=totals, repr=False)

    @contextlib.contextmanager
    def stage(self, name: str, n_items: int = 0):
        s = self.stats.setdefault(name, StageStats())
        _sync()
        t0 = time.perf_counter()
        with span(name):
            yield
        _sync()
        s.seconds += time.perf_counter() - t0
        s.items += n_items

    def summary(self) -> str:
        """The table, and the eigensolver's dense re-solves over the images
        its guard checked since the timer was made."""
        n_chips = max(torch.cuda.device_count(), 1)
        lines = [f"{'stage':<36} {'items':>8} {'sec':>9} {'items/s':>10} "
                 f"{'items/s/chip':>13}"]
        for name, s in self.stats.items():
            lines.append(f"{name:<36} {s.items:>8} {s.seconds:>9.3f} "
                         f"{s.throughput:>10.2f} {s.throughput / n_chips:>13.2f}")
        now = totals()
        images, resolved = (now.get(k, 0) - self.counts_at_start.get(k, 0)
                            for k in ("eigs.images", "eigs.resolved"))
        if images:
            lines.append(f"eigs: {resolved} of {images} image(s) re-solved with dense eigh "
                         f"(iterative solve under-converged)")
        return "\n".join(lines)
