"""Training/eval observability: smoothed metrics with cross-process sync,
timing loggers, seeding, accuracy helpers and the metric log.

The port of `deep_spectral_tpu.utils.logging` (the reference's shared
`util.py`, object-segmentation/util.py and semantic-segmentation/util.py):
  * SmoothedValue + MetricLogger with distributed synchronization
    (reference: util.py:91-234): the global (count, total) is an all-reduce
    over the `torch.distributed` group (`parallel.distributed`);
  * master-only printing (util.py:310-322), rank-offset seeding
    (util.py:333-345), top-k accuracy (util.py:70-88);
  * `MetricWriter`, the append-only JSONL metric log in the role wandb plays
    in the reference (train.py:33-35).
"""
from __future__ import annotations

import builtins
import datetime
import json
import time
from collections import defaultdict, deque
from pathlib import Path
from typing import Iterable, Optional

import numpy as np
import torch

from ..parallel import distributed


class SmoothedValue:
    """Track a series of values with window-smoothed and global statistics
    (reference: util.py:91-150)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        """Global (count, total) across the processes of the group, summed in
        float64 (the reference's dist.all_reduce, util.py:109-121). A no-op
        for one process."""
        if distributed.process_count() == 1:
            return
        count, total = distributed.all_sum_host([self.count, self.total])
        self.count = int(count)
        self.total = float(total)

    @property
    def median(self):
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self):
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


class MetricLogger:
    """Iteration logger with per-metric smoothing and iter/data timing
    (reference: util.py:153-234)."""

    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def synchronize_between_processes(self):
        for meter in self.meters.values():
            meter.synchronize_between_processes()

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: Optional[str] = None):
        header = header or ""
        i, start = 0, time.time()
        iter_time, data_time = SmoothedValue(fmt="{avg:.4f}"), SmoothedValue(fmt="{avg:.4f}")
        end = time.time()
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if print_freq and i % print_freq == 0:
                eta = ""
                if total is not None:
                    eta_s = iter_time.global_avg * (total - i)
                    eta = f" eta: {datetime.timedelta(seconds=int(eta_s))}"
                print(f"{header} [{i}{'/' + str(total) if total else ''}]{eta} "
                      f"{self} time: {iter_time} data: {data_time}")
            i += 1
            end = time.time()
        elapsed = time.time() - start
        print(f"{header} Total time: {datetime.timedelta(seconds=int(elapsed))} "
              f"({elapsed / max(i, 1):.4f} s / it)")


def setup_distributed_print(is_master: bool):
    """Silence print on non-master processes (reference: util.py:310-322);
    print(..., force=True) still prints."""
    orig_print = builtins.print

    def maybe_print(*args, force: bool = False, **kwargs):
        if is_master or force:
            orig_print(*args, **kwargs)

    builtins.print = maybe_print


def set_seed(seed: int, process_offset: bool = True) -> np.random.Generator:
    """Seed python, numpy and torch with seed + this process's rank (without
    process_offset, seed alone) (reference: util.py:333-345). Returns a
    numpy Generator of the same seed."""
    import random
    s = seed + (distributed.process_index() if process_offset else 0)
    random.seed(s)
    np.random.seed(s % (2 ** 32))
    torch.manual_seed(s)
    return np.random.default_rng(s)


class MetricWriter:
    """Append one JSON object per `log` call: {"step": ..., metric: value}."""

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def log(self, step: int, **metrics):
        rec = {"step": int(step)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        self._fh.close()


def topk_accuracy(logits, targets, topk=(1,)) -> list[float]:
    """Top-k accuracy in percent (reference: util.py:70-88): logits (..., C),
    targets (...); ties rank by class index, as JAX's stable argsort."""
    logits = torch.as_tensor(logits)
    targets = torch.as_tensor(targets)
    maxk = max(topk)
    pred = torch.argsort(-logits, dim=-1, stable=True)[..., :maxk]
    correct = pred == targets[..., None]
    return [float(correct[..., :k].any(dim=-1).float().mean() * 100.0) for k in topk]
