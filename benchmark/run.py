"""Run one cell of `BENCHMARK.json` on the card this process starts on.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights and inputs from the seed, the first steps a cell's check
needs, a warm-up of every shape it uses) runs first, then the window:
`--trace 0` measures the cell's end-to-end metrics with the profiler off;
`--trace 1` runs a traced window under `torch.profiler` and reads the
cell's per-layer metrics (`metrics/<name>.py`). After the window the peak
memory is read, the port's state is freed and the reference decides
`correct`. The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error.

Exits 3 with no result without enough CUDA devices, and 4 if JAX or the
JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

if __package__ in (None, ""):          # run as a file: the checkout's root on the path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness  # noqa: E402

START = harness.process_start()


class TracedRun:
    """What a per-layer metric reader sees of a traced window."""

    def __init__(self, cell, timeline, trace, counts):
        self.cell, self.timeline, self.counts = cell, timeline, counts
        self.work = {k: tuple(v) for k, v in trace.work.items()}
        self.spans_ms = trace.spans_ms()


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def per_layer(cell, run: TracedRun) -> dict:
    out = {}
    for m in cell.per_layer:
        value = harness.metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    harness.fix_cache_dirs()
    cell = harness.find_cell(args.workload)
    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # one host thread for torch's own CPU work: its idle pool threads would
    # otherwise compete with the host-bound loop for the shared host's cores
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    runner = harness.driver(cell).Runner(cell, args.seed, dev)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    breakdown = None
    if args.trace:
        timeline, trace, counts = runner.traced(args.seconds)
        run = TracedRun(cell, timeline, trace, counts)
        metrics = per_layer(cell, run)
        device.update(busy_s=timeline.busy_s(), window_s=timeline.window_s)
        breakdown = timeline.breakdown()
    else:
        out = runner.window(args.seconds)
        counts = out
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if m["name"] in out["metrics"]}
        metrics["setup_s"] = {"value": runner.window_start - START, "unit": "s"}
    device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    runner.release()
    correct, checks = runner.check()
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: loaded {found}: the port must not load JAX or the JAX package",
              file=sys.stderr)
        return 4
    result = {"correct": bool(correct), "attempted": int(counts["attempted"]),
              "failed": int(counts["failed"]), "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print("\n".join(f"check {n}: {c['value']:.6g} (limit {c['limit']:.6g})"
                    for n, c in checks.items()), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
