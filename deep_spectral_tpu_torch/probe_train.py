"""Probes of chip_smoke.py's phase-7 train step on one GPU.

    python -m deep_spectral_tpu_torch.probe_train [sensitivity] [profile] [steps]
        [determinism]

(no argument: sensitivity, then profile). Run from the repository root: it
reuses chip_smoke.py's synthetic batch (`blob_batch`) and its routing of
kernels 3-5 through their twins.

`profile`: the b144 bf16 flash step's wall time (CUDA events, no profiler),
then torch.profiler over 3 steps with the kernels grouped by name and the
device's idle share against the unprofiled step, for one unfrozen block
(chip_smoke phase 7b) and for the whole backbone unfrozen (phase 7c); and
the wall time of the fp32 flash and fp32 einsum steps.

`fp32`: the fp32 recipe's step (the precision `semantic_train` defaults
to; one unfrozen block: kernel 3's f32 build in all 12 blocks, kernels 4-5's
in the trained one) through the flash kernels and through einsum attention,
each one's ms/step and peak memory, then torch.profiler over the flash step
as in `profile`. Runs unchanged in an older checkout.

`steps`: the wall time of the two bf16 flash steps alone (one unfrozen
block, the whole backbone), with no profiler. The file runs unchanged in
an older checkout of the port, so two commits' steps can be compared in
one call.

`sensitivity`: how far the step's gradients move when the frozen blocks'
attention changes by bf16 rounding alone. The frozen blocks run through the
packed kernel (K1), its twin (P1), kernel 3's bf16 build (K3) or kernel 3's
twin (P3); it prints how many attention outputs each pair differs in, and
the worst trained-tensor gradient differences relative to max |reference|,
against a second run of the kernels (the step's own run-to-run spread).

`determinism`: where two runs of the same b144 bf16 step (one unfrozen
block, two fresh states of one seed) part, in the default mode and under
`torch.use_deterministic_algorithms`: which of the trained block's
attention-backward inputs (q, k, v, o, lse, do) and output (the fused
dq/dk/dv) and which trained gradients differ; then kernels 4-5 run 20 times
on one captured input, and how many distinct outputs they give.
"""
from __future__ import annotations

import contextlib
import re
from collections import defaultdict

import numpy as np
import torch

STEPS_TIMED, STEPS_PROFILED = 10, 3
BF16_STEPS = (("bf16", "flash", 1), ("bf16", "flash", -1))


def _state(dev, precision: str, impl: str, unfrozen: int = 1):
    import chip_smoke as C
    from .models.deeplab import DeepLabViT
    from .models.vit import get_model_config
    from .tasks import semantic_segmentation as SS
    cfg = SS.TrainConfig(backbone="dino_vits16", num_classes=C.CLASSES, lr=5e-3,
                         batch_size=C.TRAIN_B, unfrozen_backbone_layers=unfrozen,
                         precision=precision, seed=0)
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    model = DeepLabViT(get_model_config("dino_vits16"), C.CLASSES, compute_dtype=dtype,
                       attention_impl=impl)
    return SS.create_train_state(cfg, model, device=dev)


def _batch(dev):
    import chip_smoke as C
    x, y = C.blob_batch(C.TRAIN_B, np.random.default_rng(7))
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _timed_state(dev, x, y, precision: str, impl: str, unfrozen: int):
    """A fresh train state after 2 warm-up steps and STEPS_TIMED timed ones
    (CUDA events, printed); returns (state, generator, ms per step)."""
    from .tasks.semantic_segmentation import train_step
    state = _state(dev, precision, impl, unfrozen)
    gen = torch.Generator(device=dev).manual_seed(12)
    for _ in range(2):
        train_step(state, x, y, gen)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STEPS_TIMED):
        train_step(state, x, y, gen)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / STEPS_TIMED
    blocks = "whole backbone" if unfrozen < 0 else f"{unfrozen} block"
    print(f"== {precision} {impl}, {blocks} unfrozen: {step_ms:.3f} ms/step = "
          f"{x.shape[0] / step_ms * 1e3:.2f} img/s (CUDA events, mean of {STEPS_TIMED})",
          flush=True)
    return state, gen, step_ms


def steps(dev) -> None:
    x, y = _batch(dev)
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    for config in BF16_STEPS:
        _timed_state(dev, x, y, *config)


def _profiled(state, x, y, gen, step_ms) -> None:
    """torch.profiler over STEPS_PROFILED steps: kernel time by group and the
    top kernels, and the idle share against the unprofiled step."""
    from torch.autograd import DeviceType
    from .tasks.semantic_segmentation import train_step
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS_PROFILED):
            train_step(state, x, y, gen)
        torch.cuda.synchronize()
    kern = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            kern[ev.name][0] += ev.device_time_total / 1e3 / STEPS_PROFILED
            kern[ev.name][1] += 1
    total = sum(t for t, _ in kern.values())
    print(f"summed kernel time {total:.3f} ms/step; idle share against the unprofiled "
          f"step {1 - total / step_ms:.3f}")
    groups = [("kernels 3-5",
               r"flash_fwd_lse|flash_fwd_f32|flash_bwd_d|"
               r"flash_fwd_packed_kernel(<true>|ILb1E)"),
              ("packed flash kernel", r"flash_fwd_packed"),
              ("conv (cuDNN)", r"conv|fprop|dgrad|wgrad|cudnn|implicit|winograd|fft"),
              ("gemm (cuBLAS)", r"gemm|Gemm|cutlass|Kernel2|splitK|nvjet"),
              ("softmax", r"softmax"), ("reduce", r"reduce|Reduce"),
              ("index/gather/scatter", r"index|gather|scatter"),
              ("elementwise/copy", r"elementwise|vectorized|unrolled|copy|Copy|fill")]
    by_group = defaultdict(float)
    for name, (t, _) in kern.items():
        group = next((g for g, pat in groups if re.search(pat, name)), "other")
        by_group[group] += t
    for group, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {group:24s} {t:8.3f} ms/step {t / total:6.1%}")
    print("top kernels (ms/step, launches/step):")
    for name, (t, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:25]:
        print(f"  {t:8.3f} {n // STEPS_PROFILED:4d}  {name[:110]}")


def profile(dev) -> None:
    x, y = _batch(dev)
    for precision, impl, unfrozen in BF16_STEPS + (("fp32", "flash", 1), ("fp32", "einsum", 1)):
        state, gen, step_ms = _timed_state(dev, x, y, precision, impl, unfrozen)
        if (precision, impl) == ("bf16", "flash"):
            _profiled(state, x, y, gen, step_ms)


def fp32(dev) -> None:
    x, y = _batch(dev)
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    for impl in ("flash", "einsum"):
        torch.cuda.reset_peak_memory_stats(dev)
        state, gen, step_ms = _timed_state(dev, x, y, "fp32", impl, 1)
        print(f"   peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB "
              "(from the state's creation)", flush=True)
        if impl == "flash":
            _profiled(state, x, y, gen, step_ms)
        del state, gen
        torch.cuda.empty_cache()


def sensitivity(dev) -> None:
    import chip_smoke as C
    from .models import flash_attention as fa
    from .models import vit
    from .tasks.semantic_segmentation import train_step
    frozen = {"K1": fa.flash_attention_packed, "P1": fa.flash_attention_packed_plain,
              "K3": lambda q, k, v, m: fa.flash_attention_lse(q, k, v, m)[0],
              "P3": lambda q, k, v, m: fa.flash_attention_lse_plain(q, k, v, m)[0]}
    g = torch.Generator().manual_seed(1)
    q, k, v = torch.randn((C.TRAIN_B, 197, 3, 6, 64), generator=g).to(
        dev, torch.bfloat16).unbind(2)
    outs = {name: f(q, k, v, None).float() for name, f in frozen.items()}
    for a, b in (("K1", "P1"), ("K1", "K3"), ("K1", "P3"), ("K3", "P3"), ("P1", "P3")):
        d = (outs[a] - outs[b]).abs()
        print(f"attention b{C.TRAIN_B} T=197 bf16, {a} vs {b}: max |diff| "
              f"{d.max().item():.3e}, share of outputs that differ "
              f"{(d > 0).float().mean().item():.4f}", flush=True)

    x, y = _batch(dev)
    state = _state(dev, "bf16", "flash")
    weights = {n: t.clone() for n, t in state.model.state_dict().items()}
    opt0 = state.opt.state_dict()
    grads = {}
    for route in ("K1", "K1 again", "K1, kernels 3-5 twinned", "P1", "K3", "P3"):
        state.model.load_state_dict(weights)
        state.opt.load_state_dict(opt0)
        saved = vit.flash_attention_packed
        vit.flash_attention_packed = frozen[route.split()[0].rstrip(",")]
        try:
            with C.twins_on_the_card() if "twinned" in route else contextlib.nullcontext():
                train_step(state, x, y, torch.Generator(device=dev).manual_seed(11))
        finally:
            vit.flash_attention_packed = saved
        grads[route] = {n: p.grad.detach().float().clone() for n, p in state.opt.params.items()}
    for route in list(grads)[1:] + ["P3 vs K3"]:
        a, b = route.split(" vs ") if " vs " in route else (route, "K1")
        rel = {n: (grads[a][n] - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
               for n, r in grads[b].items()}
        top = sorted(rel, key=rel.get)[-3:]
        print(f"train step b{C.TRAIN_B}, frozen blocks {a} vs {b}: worst gradient differences "
              "relative to max |reference|: " + ", ".join(f"{n} {rel[n]:.3e}" for n in top),
              flush=True)


def determinism(dev) -> None:
    from .models import flash_attention as fa
    from .tasks.semantic_segmentation import train_step
    x, y = _batch(dev)
    real = fa.flash_backward
    for deterministic in (False, True):
        runs = []
        for _ in range(2):
            rec = {}

            def capture(q, k, v, kv_mask, o, lse, do, rec=rec):
                out = real(q, k, v, kv_mask, o, lse, do)
                rec.update({"q": q.clone(), "k": k.clone(), "v": v.clone(), "o": o.clone(),
                            "lse": lse.clone(), "do": do.clone(), "dqkv": out.clone()})
                return out
            state = _state(dev, "bf16", "flash")
            fa.flash_backward = capture
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            try:
                train_step(state, x, y, torch.Generator(device=dev).manual_seed(11))
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
                fa.flash_backward = real
            rec.update({f"grad {n}": p.grad.detach().clone()
                        for n, p in state.opt.params.items()})
            runs.append(rec)
            del state
        differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
        print(f"deterministic algorithms {deterministic}: of {len(runs[0])} tensors, these "
              f"differ between two runs of the step: {differ}", flush=True)
    r = runs[0]
    outs = {real(r["q"], r["k"], r["v"], None, r["o"], r["lse"], r["do"]).float().cpu()
            .numpy().tobytes() for _ in range(20)}
    print(f"kernels 4-5 on one captured input, 20 runs: {len(outs)} distinct output(s)",
          flush=True)


if __name__ == "__main__":
    import sys
    probes = {"sensitivity": sensitivity, "profile": profile, "steps": steps,
              "determinism": determinism, "fp32": fp32}
    for name in sys.argv[1:] or ["sensitivity", "profile"]:
        probes[name](torch.device("cuda", 0))
