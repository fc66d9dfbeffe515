"""The device timeline of a traced run, read from `torch.profiler`.

`Timeline.record(fn)` runs `fn` under the profiler (host and CUDA
activities) inside one `record_function` range, the traced window. Device
operations (kernels, copies, memsets) become intervals on the profiler's
clock; the window is that range's interval. Busy time is the union of the
device intervals inside the window, so overlapping kernels count once.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch

WINDOW = "benchmark.window"


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi] between the union of the intervals."""
    out, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


@dataclass
class Timeline:
    """Device operations [(name, start_s, end_s)], host operations
    [(name, start_s, end_s)] and the window (start_s, end_s)."""
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)

    @classmethod
    def record(cls, fn) -> "Timeline":
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                fn()
        return cls.from_events(prof.events())

    @classmethod
    def from_events(cls, events) -> "Timeline":
        from torch.autograd import DeviceType
        tl = cls()
        for ev in events:
            span = (ev.name, ev.time_range.start * 1e-6, ev.time_range.end * 1e-6)
            if ev.device_type == DeviceType.CUDA:
                # the window's range is also drawn on the device's timeline
                if ev.name != WINDOW and not getattr(ev, "is_user_annotation", False):
                    tl.device.append(span)
            elif ev.name == WINDOW:
                tl.window = span[1:]
            else:
                tl.host.append(span)
        return tl

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device], *self.window)

    def matching_s(self, patterns) -> float:
        """Summed device seconds of the operations whose name matches any
        regular expression in `patterns`, inside the window."""
        rx = re.compile("|".join(f"(?:{p})" for p in patterns))
        lo, hi = self.window
        return sum(max(0.0, min(e, hi) - max(s, lo))
                   for name, s, e in self.device if rx.search(name))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each named by the innermost host operation open at its start
        ("python" where none is: the host was in the harness or the port's
        Python)."""
        lo, hi = self.window
        by_name: dict = {}
        for name, s, e in self.device:
            by_name[name] = by_name.get(name, 0.0) + max(0.0, min(e, hi) - max(s, lo))
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps([(s, e) for _, s, e in self.device], lo, hi),
                      key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in idle:
            open_ops = [(he - hs, n) for n, hs, he in self.host if hs <= s < he]
            named.append([min(open_ops)[1] if open_ops else "python", e - s])
        return {"device_ops": [[n, t] for n, t in ops], "idle_gaps": named}
