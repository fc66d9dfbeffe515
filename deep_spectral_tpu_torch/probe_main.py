"""Probes of chip_smoke.py's phase-4 main-path step on one GPU.

    python -m deep_spectral_tpu_torch.probe_main

Run from the repository root: it reuses chip_smoke.py's main-path step
(`main_path_step`: seeded random-weight dino_vits16, 480x480, b24, bf16,
then the Chebyshev eigensolve on structured features).

`profile`: the step's wall time (CUDA events, no profiler), then
torch.profiler over 3 steps with the kernels grouped by name and the
device's idle share against the unprofiled step.

`kernel_calls`: for the two main-path kernels at the main path's shapes,
and for the filter's library yardstick there (the JAX package's XLA chain,
`ops.eigen.chebyshev_filter_chain`, on the bf16 and on the f32 operator),
the host's time to enqueue one call (wall clock over 20 calls, no sync)
beside the device time of one call (torch.profiler, kernels by name), so a
time taken with CUDA events over back-to-back calls can be told from the
host's cost.

`steps` (`python -m deep_spectral_tpu_torch.probe_main steps`): only the
step's ms/step (CUDA events) over 7 windows of 5 steps after 3 warm-up
steps. It runs unchanged when copied into an older checkout that has
`chip_smoke.main_path_step`, so two commits are compared in one call
(parent, change, change, parent).

`eigs` (`... probe_main eigs`): stage 2 (`extract_eigs` with its defaults,
K=20 and b8) on the step's b24 features written as stage-1 feature files:
the stage's wall time (host clock around the synchronized call, files
loaded and written) over 5 runs after a warm-up run, as it is and, where
the stage keeps a batch in flight, with none in flight and with blocking
copies to and from pageable memory; then torch.profiler's host ops of one
run. It also runs unchanged in an older checkout that has
`chip_smoke.main_path_step`.

`lobpcg` (`... probe_main lobpcg`): one 'auto' K=5 solve that reaches LOBPCG
(b4, N=4096, chip_smoke's structured features at dino_vits8's 512x512
grid): its time (CUDA events, median of 5 single calls after a warm-up),
then torch.profiler over one call with the kernels grouped by name and the
device's idle share against the unprofiled call.
"""
from __future__ import annotations

import os
import re
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

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


def _print_groups(kern: dict, total: float, calls: int) -> None:
    by_group = defaultdict(lambda: [0.0, 0])
    for name, (t, n) in kern.items():
        group = next((g for g, pat in GROUPS if re.search(pat, name)), "other")
        by_group[group][0] += t
        by_group[group][1] += n
    for group, (t, n) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f"  {group:24s} {t:8.3f} ms/call {t / total:6.1%}  "
              f"{n / calls:6.1f} launches/call")
    print("top kernels (ms/call, launches/call):")
    for name, (t, n) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"  {t:8.3f} {n / calls:6.1f}  {name[:110]}")


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
    _print_groups(kern, total, STEPS_PROFILED)


def kernel_calls(dev) -> None:
    import chip_smoke as C
    from .models.flash_attention import flash_attention_packed
    from .ops.cheb_filter import chebyshev_filter
    from .ops.eigen import chebyshev_filter_chain
    from .utils.precision import exact_f32
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
    calls += [(f"XLA chain, bf16 operator, b{C.B} N=900 degree {d}",
               lambda d=d: chebyshev_filter_chain(S, X, c, e, d)) for d in (3, 10)]
    S32 = S.float()

    def chain_f32(d):
        with exact_f32():
            return chebyshev_filter_chain(S32, X, c, e, d)

    calls += [(f"XLA chain, f32 operator, b{C.B} N=900 degree {d}",
               lambda d=d: chain_f32(d)) for d in (3, 10)]
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


def steps(dev, windows: int = 7, per_window: int = 5) -> None:
    import chip_smoke as C
    step, base, *_ = C.main_path_step(dev)
    for _ in range(3):
        step(base)
    torch.cuda.synchronize()
    ms = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_window):
            step(base)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end) / per_window)
    print(f"== main path b{C.B} ms/step, {windows} windows of {per_window} steps: "
          + " ".join(f"{t:.3f}" for t in ms) + f"; median {sorted(ms)[windows // 2]:.3f}",
          flush=True)


class _PageableFetch:
    """`extract._Fetch` with blocking copies to pageable memory."""

    def __init__(self, *tensors):
        self._host = [t.cpu() for t in tensors]

    def result(self):
        return [h.numpy() for h in self._host]


def _stage2_variants(extract):
    """(name, setup) of the stage-2 variants this checkout has: as it is,
    and where it keeps a batch in flight, with none in flight and with
    blocking copies from and to pageable memory."""
    def patch(env=None, **attrs):
        def setup():
            saved = {k: getattr(extract, k) for k in attrs}
            old_env = os.environ.get("DSS_TPU_INFLIGHT")
            for k, v in attrs.items():
                setattr(extract, k, v)
            if env is not None:
                os.environ["DSS_TPU_INFLIGHT"] = env

            def undo():
                for k, v in saved.items():
                    setattr(extract, k, v)
                os.environ.pop("DSS_TPU_INFLIGHT", None)
                if old_env is not None:
                    os.environ["DSS_TPU_INFLIGHT"] = old_env
            return undo
        return setup
    out = [("as it is", patch())]
    if hasattr(extract, "_Fetch"):
        out += [("DSS_TPU_INFLIGHT=0", patch(env="0")),
                ("pageable blocking copies", patch(
                    _Fetch=_PageableFetch,
                    _to_device=lambda a, dev: torch.from_numpy(a).to(dev)))]
    return out


def eigs(dev, runs: int = 5) -> None:
    import numpy as np
    import chip_smoke as C
    from .pipeline import extract
    from .utils.serialization import save_pth
    _, _, cfg, _, out = C.main_path_step(dev)
    feats = out[1].to(torch.float16).cpu().numpy()  # (B, N, D), as stage 1 stores k
    side = C.IMG // cfg.patch_size * cfg.patch_size
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for i in range(len(feats)):
            save_pth({"k": feats[i:i + 1], "indices": np.asarray([i]), "file": f"p{i}.jpg",
                      "id": f"p{i}", "model_name": "dino_vits16", "patch_size": cfg.patch_size,
                      "shape": (1, 3, side, side)}, tmp / "features" / f"p{i}.pth")
        n = 0

        def run():
            nonlocal n
            n += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            extract.extract_eigs(str(tmp), str(tmp / "features"), str(tmp / f"eigs{n}"),
                                 device="cuda")
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        for name, setup in _stage2_variants(extract):
            undo = setup()
            try:
                ms = [run() for _ in range(runs + 1)]
            finally:
                undo()
            print(f"== extract_eigs (K=20, b8) on {len(feats)} feature files of the main path, "
                  f"{name}: ms per run after a warm-up run ({ms[0]:.1f}): "
                  + " ".join(f"{t:.1f}" for t in ms[1:])
                  + f"; median {sorted(ms[1:])[runs // 2]:.1f}", flush=True)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            run()
    print("one run as it is, host ops by self time:")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15,
                                    max_name_column_width=60), flush=True)


def lobpcg(dev, batch: int = 4, grid: int = 64) -> None:
    import numpy as np
    import chip_smoke as C
    from .ops import eigen
    feats = torch.from_numpy(
        C.structured_features(batch, grid, 384, np.random.default_rng(9))).to(dev)
    mask = torch.ones((batch, grid * grid), dtype=torch.bool, device=dev)
    if eigen._resolve_solver(grid * grid, C.K + 3, True, "auto") != "lobpcg":
        raise AssertionError("'auto' does not reach LOBPCG")
    t = C.cuda_ms(lambda: eigen.spectral_decompose_batched(feats, mask, K=C.K),
                  iters=1, windows=5, warmup=1)
    print(f"== 'auto' K={C.K} solve through LOBPCG, b{batch} N={grid * grid}: {t} "
          f"(CUDA events, single calls)", flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        eigen.spectral_decompose_batched(feats, mask, K=C.K)
        torch.cuda.synchronize()
    kern = _kernel_times(prof, 1)
    total = sum(t for t, _ in kern.values())
    print(f"summed kernel time {total:.3f} ms/call; idle share against the unprofiled "
          f"call {1 - total / t.ms:.3f}")
    _print_groups(kern, total, 1)


if __name__ == "__main__":
    dev = torch.device("cuda", 0)
    modes = {"steps": steps, "eigs": eigs, "lobpcg": lobpcg}
    if sys.argv[1:2] and sys.argv[1] in modes:
        modes[sys.argv[1]](dev)
    else:
        kernel_calls(dev)
        profile(dev)
