"""Driver `train`: back-to-back `train_step` calls, as `train()` makes them.

Set-up builds the train state as `train()` does (`build_model`,
`create_train_state`) and loads the benchmark's weights into it, makes a
seeded pool of batches on the device (the data loader bypassed: images
normalized as `train_augment` leaves them, blocky pseudolabels), and drives
that same state through its first three steps on three different batches,
keeping what the check compares: each step's loss, the first gradient as
the optimizer got it (AdamW's first moment after one step over 1 - b1) and
each trained leaf's change after the three. Then it warms up and hands the
state to the window.

End-to-end: `train_step_ms`, the window (from a synchronized start to the
end of the last step it dispatched) over the steps in it. Correctness: the
reference (f64) follows the same three steps from the same weights,
batches and dropout draws.
"""
from __future__ import annotations

import math
import statistics
import time

import numpy as np
import torch

from benchmark import weights, work
from benchmark.drivers.extract import sync
from benchmark.reference import deeplab as ref_deeplab
from benchmark.reference.lowp import tf32_enabled
from benchmark.reference.vit import Numerics, normalize_uint8

FIRST_STEPS = 3


def make_batches(gen, n: int, B: int, crop: int, classes: int, cell: int, dev) -> list:
    """n (images (B, crop, crop, 3) f32 normalized, labels (B, crop, crop)
    int64) pairs: uniform uint8 images; labels constant on cell x cell
    squares."""
    out = []
    for _ in range(n):
        u8 = torch.randint(0, 256, (B, crop, crop, 3), generator=gen, dtype=torch.uint8, device=dev)
        g = crop // cell
        lab = torch.randint(0, classes, (B, g, g), generator=gen, device=dev)
        lab = lab.repeat_interleave(cell, 1).repeat_interleave(cell, 2)
        out.append((normalize_uint8(u8), lab))
    return out


class Runner:
    def __init__(self, cell, seed: int, dev):
        from deep_spectral_tpu_torch.tasks.semantic_segmentation import (
            TrainConfig, build_model, create_train_state, train_step)
        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr, self.seed, self.dev, self.limits = cfg, tr, seed, dev, cell.limits
        self.train_step = train_step
        self.tcfg = TrainConfig(
            backbone=cfg["name"], num_classes=tr["num_classes"], lr=tr["lr"],
            weight_decay=tr["weight_decay"], max_train_steps=tr["max_train_steps"],
            unfrozen_backbone_layers=tr["unfrozen_backbone_layers"], crop_size=tr["crop"],
            batch_size=tr["batch_size"], precision=tr["precision"], seed=seed)
        shapes = {**weights.vit_shapes(cfg), **weights.head_shapes(cfg, tr["num_classes"])}
        self.weights = weights.seeded_weights(shapes, seed, dev)
        vit_sd = {n: v for n, v in self.weights.items() if not n.startswith("head.")}
        self.state = create_train_state(self.tcfg, build_model(self.tcfg), vit_sd, dev)
        self.state.model.head.load_state_dict(
            {n[len("head."):]: v for n, v in self.weights.items() if n.startswith("head.")})
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.batches = make_batches(torch.Generator(device=dev).manual_seed(seed + 1),
                                    tr["pool_batches"], tr["batch_size"], tr["crop"],
                                    tr["num_classes"], tr["label_cell"], dev)
        self.j = 0
        self._first_steps()
        for _ in range(tr["warm_steps"]):
            self._step()
        sync(dev)

    def _step(self):
        images, labels = self.batches[self.j % len(self.batches)]
        self.j += 1
        return self.train_step(self.state, images, labels, self.gen)

    def _first_steps(self) -> None:
        opt = self.state.opt
        start = {n: p.detach().clone() for n, p in opt.params.items()}
        losses = []
        for s in range(FIRST_STEPS):
            losses.append(self._step()["loss"])
            if s == 0:
                grad1 = {n: torch.linalg.vector_norm(opt.state[f"mu.{n}"].double()) / (1 - opt.b1)
                         for n in opt.params}
        change = {n: torch.linalg.vector_norm((p.detach() - start[n]).double())
                  for n, p in opt.params.items()}
        self.port = {"losses": [float(x) for x in losses],
                     "grad1": {_ref_name(n): float(v) for n, v in grad1.items()},
                     "change": {_ref_name(n): float(v) for n, v in change.items()}}

    def window(self, seconds: float) -> dict:
        sync(self.dev)
        t0 = time.perf_counter()
        self.window_start = time.time()
        end, losses = t0 + seconds, []
        while time.perf_counter() < end:
            losses.append(self._step()["loss"])
        sync(self.dev)
        dt = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"metrics": {"train_step_ms": dt / len(losses) * 1e3},
                "attempted": len(losses), "failed": failed}

    def traced(self, seconds: float):
        from benchmark.stages import Trace
        from benchmark.trace import Timeline
        sync(self.dev)
        tr, losses = Trace(), []

        def body():
            end = time.perf_counter() + seconds
            for _ in range(self.tr["trace_steps"]):
                if time.perf_counter() >= end:
                    break
                losses.append(self._step()["loss"])
            sync(self.dev)

        self.window_start = time.time()
        timeline = Timeline.record(body)
        c, t = self.cfg, self.tr
        n = len(losses)
        T = 1 + (t["crop"] // c["patch_size"]) ** 2
        hd = c["embed_dim"] // c["num_heads"]
        keys = [T] * t["batch_size"]
        f_fwd, b_fwd = work.attention_fwd(keys, T, c["num_heads"], hd, 4, lse=True)
        f_bwd, b_bwd = work.attention_bwd(keys, T, c["num_heads"], hd, 4)
        k = t["unfrozen_backbone_layers"]
        tr.add("attention", n * (c["depth"] * f_fwd + k * f_bwd),
               n * (c["depth"] * b_fwd + k * b_bwd))
        tr.add("model", n * work.train_step(t["batch_size"], t["crop"], c, t["num_classes"], k))
        failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
        return timeline, tr, {"steps": n, "attempted": n, "failed": failed}

    def release(self) -> None:
        del self.state
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, dtype=torch.float64, tf32: bool = False, keep=slice(None)) -> dict:
        """The reference's first steps (f64; with `tf32`, the control: f32
        with TF32 products); `keep` takes rows of each batch (a fault)."""
        t = self.tr
        gen = torch.Generator(device=self.dev).manual_seed(self.seed)
        opt = dict(lr=t["lr"], weight_decay=t["weight_decay"], max_steps=t["max_train_steps"])
        with tf32_enabled(tf32):
            return ref_deeplab.first_steps(self.weights, self.cfg, self.batches[:FIRST_STEPS], gen,
                                           Numerics(dtype), opt,
                                           t["unfrozen_backbone_layers"], keep)

    def numbers(self, ref: dict | None = None) -> dict:
        return compare(self.port, ref or self.reference())

    def check(self) -> tuple[bool, dict]:
        from benchmark import checks
        return checks.verdict(self.numbers(), self.limits)


def _ref_name(port_name: str) -> str:
    return port_name.removeprefix("backbone.")


def compare(port: dict, ref: dict) -> dict:
    """`loss_gap`: the largest |loss - ref| / |ref| over the steps;
    `grad1_gap` and `change_gap`: the largest gap of a leaf's norm to the
    reference's, over the larger of that leaf's norm and the median leaf's,
    the change counted on the leaves whose reference gradient is at least a
    thousandth of the median leaf's (the others move by round-off alone)."""
    steps = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
             for a, b in zip(port["losses"], ref["losses"], strict=True)]
    out = {"loss_gap": max(steps), "loss_gap.first": steps[0]}
    g_med = statistics.median(ref["grad1"].values())
    c_med = statistics.median(ref["change"].values())

    def gap(a, b, med):
        return abs(a - b) / max(b, med) if math.isfinite(a) else math.inf

    out["grad1_gap"] = max(gap(port["grad1"][n], g, g_med) for n, g in ref["grad1"].items())
    moved = [n for n, g in ref["grad1"].items() if g >= 1e-3 * g_med]
    out["change_gap"] = max(gap(port["change"][n], ref["change"][n], c_med) for n in moved)
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}

