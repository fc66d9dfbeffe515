"""Probes of chip_smoke.py's phase-4 main-path step on one GPU.

    python -m deep_spectral_tpu_torch.probe_main

Run from the repository root: it reuses chip_smoke.py's main-path step
(`main_path_step`: seeded random-weight dino_vits16, 480x480, b24, bf16,
then the Chebyshev eigensolve on structured features).

`profile`: the step's wall time (CUDA events, no profiler), then
torch.profiler over 3 steps with the kernels grouped by name and the
device's idle share against the unprofiled step.

`kernel_calls`: for the two main-path kernels at the main path's shapes, the
host's time to enqueue one call (wall clock over 20 calls, no sync) beside
the device time of one call (torch.profiler, kernels by name), so a kernel
time taken with CUDA events over back-to-back calls can be told from the
wrapper's host cost.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict

import torch

STEPS_TIMED, STEPS_PROFILED = 5, 3
GROUPS = [("packed flash kernel", r"flash_fwd_packed"),
          ("Chebyshev filter kernel", r"cheb_"),
          ("gemm (cuBLAS)", r"gemm|Gemm|cutlass|Kernel2|splitK|nvjet|xmma"),
          ("solver (cuSOLVER)", r"syevd|syevj|potrf|geqrf|orgqr|ormqr|trsm|cusolver|lapack"),
          ("resize (bicubic)", r"upsample|bicubic"),
          ("layernorm", r"layer_norm|LayerNorm"),
          ("softmax", r"softmax"), ("reduce", r"reduce|Reduce"),
          ("elementwise/copy", r"elementwise|vectorized|unrolled|copy|Copy|fill|Memset")]


def _kernel_times(prof, calls: int) -> dict:
    from torch.autograd import DeviceType
    kern = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            kern[ev.name][0] += ev.device_time_total / 1e3 / calls
            kern[ev.name][1] += 1
    return kern


def profile(dev) -> None:
    import chip_smoke as C
    step, base, *_ = C.main_path_step(dev)
    step(base)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(STEPS_TIMED):
        step(base)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / STEPS_TIMED
    print(f"== main path b{C.B}: {step_ms:.3f} ms/step = {C.B / step_ms * 1e3:.2f} img/s "
          f"(CUDA events, mean of {STEPS_TIMED})", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS_PROFILED):
            step(base)
        torch.cuda.synchronize()
    kern = _kernel_times(prof, STEPS_PROFILED)
    total = sum(t for t, _ in kern.values())
    print(f"summed kernel time {total:.3f} ms/step; idle share against the unprofiled "
          f"step {1 - total / step_ms:.3f}")
    by_group = defaultdict(lambda: [0.0, 0])
    for name, (t, n) in kern.items():
        group = next((g for g, pat in GROUPS if re.search(pat, name)), "other")
        by_group[group][0] += t
        by_group[group][1] += n
    for group, (t, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f"  {group:24s} {t:8.3f} ms/step {t / total:6.1%}  "
              f"{n / STEPS_PROFILED:6.1f} launches/step")
    print("top kernels (ms/step, launches/step):")
    for name, (t, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {t:8.3f} {n / STEPS_PROFILED:6.1f}  {name[:110]}")


def kernel_calls(dev) -> None:
    import chip_smoke as C
    from .models.flash_attention import flash_attention_packed
    from .ops.cheb_filter import chebyshev_filter
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((C.B, 901, 3, 6, 64), generator=g).to(dev, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    mask = torch.ones((C.B, 901), dtype=torch.bool, device=dev)
    S = C.whitened_operators(C.B, 900, dev, g)
    X = torch.randn((C.B, 900, 8), generator=g).to(dev)
    lam = (torch.rand(C.B, generator=g) * 0.9 + 0.05).to(dev)
    c, e = (lam + 2.0) / 2.0, (2.0 - lam) / 2.0
    calls = [(f"flash_attention_packed b{C.B} T=901", lambda: flash_attention_packed(q, k, v, mask))]
    calls += [(f"chebyshev_filter b{C.B} N=900 degree {d}",
               lambda d=d: chebyshev_filter(S, X, c, e, d)) for d in (3, 10)]
    for name, fn in calls:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        host_ms = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        kern = _kernel_times(prof, 10)
        print(f"{name}: host enqueue {host_ms:.4f} ms/call, device "
              f"{sum(t for t, _ in kern.values()):.4f} ms/call: " + "; ".join(
                  f"{n[:48]} x{c // 10} {t:.4f} ms" for n, (t, c) in
                  sorted(kern.items(), key=lambda kv: -kv[1][0])), flush=True)


if __name__ == "__main__":
    kernel_calls(torch.device("cuda", 0))
    profile(torch.device("cuda", 0))
