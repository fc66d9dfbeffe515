"""Tracing and per-stage timing of the port: the JAX package's
`utils/profiling.py` on `torch.profiler`.

  * `trace(logdir)`: a `torch.profiler` trace of the enclosed work (host and,
    with a card, CUDA activity), written into `logdir` as a Chrome trace
    (`trace.json`), which TensorBoard's and Perfetto's viewers open.
  * `annotate(name)`: `torch.profiler.record_function`, so a pipeline phase
    shows up as a named range in the trace.
  * `StageTimer`: per-stage wall time and item counts, printed as one
    summary table by `pipeline.run_all`. A stage's clock stops after the
    card has finished the stage's work (`torch.cuda.synchronize`), so its
    wall time includes its device time.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """Profile the enclosed work into `logdir`/trace.json (no-op when logdir
    is None)."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def annotate(name: str):
    """Named range in the profiler trace for a host-side phase."""
    return torch.profiler.record_function(name)


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

    @contextlib.contextmanager
    def stage(self, name: str, n_items: int = 0):
        s = self.stats.setdefault(name, StageStats())
        _sync()
        t0 = time.perf_counter()
        with annotate(name):
            yield
        _sync()
        s.seconds += time.perf_counter() - t0
        s.items += n_items

    def summary(self) -> str:
        n_chips = max(torch.cuda.device_count(), 1)
        lines = [f"{'stage':<36} {'items':>8} {'sec':>9} {'items/s':>10} "
                 f"{'items/s/chip':>13}"]
        for name, s in self.stats.items():
            lines.append(f"{name:<36} {s.items:>8} {s.seconds:>9.3f} "
                         f"{s.throughput:>10.2f} {s.throughput / n_chips:>13.2f}")
        return "\n".join(lines)
