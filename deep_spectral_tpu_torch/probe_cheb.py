"""Probes of the Chebyshev filter kernel (kernel 2) on one GPU.

    python -m deep_spectral_tpu_torch.probe_cheb [check clusters times stream sizes
                                                  ablate crossover]

Run from the repository root (it reuses chip_smoke.py's timing helpers and
operators). With no mode it runs check, clusters, times and stream. Times:
CUDA events, median [min-max] of 5 windows of 20 calls.

`check`: the kernel (`chebyshev_filter`, the build its plan picks) and the
mma.sync build (`chebyshev_filter_mma`) against the twin on a grid of shapes
(N around the slab and the 64-key blocks, m not a multiple of 8, B=1, degree
1, a NaN column, N on both sides of the resident limit), and the streaming
build forced onto small shapes (several key windows, several column groups,
few CTAs).

`clusters`: how many thread-block clusters of 8 to 16 CTAs the card holds at
once at the resident build's shared memory (cudaOccupancyMaxActiveClusters),
and the waves at b24.

`times`: the kernel, the mma.sync build, the twin and the XLA chain as one
CUDA graph at chip_smoke phase 3's shapes, each beside its bound.

`stream`: at b4 N=3600 degree 3 (phase 9's first filter), the streaming
build on 132, 114 and 66 CTAs, and at b4 N=1288-2048 degree 10 on 132 to
66 (device time, last: torch.profiler slows its process); both builds at b4 degree 3 with the window handed as CUDA
tensors, Python floats and CPU tensors (a blocking copy a call); the
mma.sync build at b1 to b4 (57 to 228 CTAs: one wave of 132 SMs at b1 and
b2, two at b3 and b4), ms per image.

`sizes`: the resident build at b24 N=900, b4 N=1024 and 640 with every
cluster size whose slab fits, with the clusters at once and the waves.

`ablate`: the resident build compiled with parts of its step left out
(-DDSS_CHEB_ABLATE; wrong results, times only), and a build that records
clock64() at the step's phase boundaries (cycles a phase).

`crossover`: the streaming build beside the mma.sync build from the first N
the plan streams up to N=3600, at b4 and b24, degree 10 and 3, by CUDA events
and by device time (torch.profiler), each with the streaming build's clock64
timeline (a build of its own, -DDSS_CHEB_ABLATE=4:
cycles a step staging T, waiting for ring stages, to the grid barrier, in
it).
"""
from __future__ import annotations

import sys

import numpy as np
import torch


def _inputs(b, N, m, g, dev):
    import chip_smoke as C
    S = C.whitened_operators(b, N, dev, g)
    X = torch.randn((b, N, m), generator=g).to(dev)
    lam = (torch.rand(b, generator=g) * 0.9 + 0.05).to(dev)
    return S, X, (lam + 2.0) / 2.0, (2.0 - lam) / 2.0


def _ce(c, e):
    return torch.stack([c, e], dim=1).contiguous()


def check(dev) -> None:
    import chip_smoke as C
    from .ops import cheb_filter as cf
    g = torch.Generator().manual_seed(5)
    worst = 0.0
    for b, N, m, degree in [(2, 17, 13, 10), (2, 37, 5, 3), (2, 130, 13, 1), (2, 333, 13, 3),
                            (2, 900, 8, 10), (1, 900, 8, 10), (2, 900, 23, 1),
                            (2, 1000, 13, 10), (24, 900, 8, 10), (24, 900, 23, 10),
                            (4, 640, 8, 10), (4, 1024, 8, 10), (24, 1216, 8, 3),
                            (4, 1224, 8, 10), (2, 2500, 8, 10), (4, 3600, 8, 3)]:
        S, X, c, e = _inputs(b, N, m, g, dev)
        X[b - 1, N // 2, m - 1] = float("nan")
        plan = cf.cheb_filter_plan(b, N, m)
        before = cf.chebyshev_filter.launches
        got = cf.chebyshev_filter(S, X, c, e, degree)
        mma = cf.chebyshev_filter_mma(S, X, c, e, degree)
        torch.cuda.synchronize()
        ref = cf.chebyshev_filter_plain(S, X, c, e, degree)
        nan = torch.isnan(ref)
        same_nan = bool(torch.equal(torch.isnan(got), nan) and torch.equal(torch.isnan(mma), nan))
        err = (got - ref).nan_to_num().abs().max().item()
        err_mma = (mma - ref).nan_to_num().abs().max().item()
        between = (got - mma).nan_to_num().abs().max().item()
        worst = max(worst, err)
        print(f"check b{b} N={N} m={m} degree={degree}: {plan.build} (cluster {plan.cluster}, "
              f"rows {plan.rows}, ctas {plan.ctas}, smem {plan.smem}): max |kernel - twin| {err:.3e}, mma.sync build {err_mma:.3e}, "
              f"|kernel - mma.sync| {between:.3e}; NaNs where the twin's: {same_nan}, launches +"
              f"{cf.chebyshev_filter.launches - before}", flush=True)
        # recorded, not gated, where the mma.sync build is as far off the twin
        # (a bf16 rounding of T_j flipped on these inputs): the gates are
        # chip_smoke phase 3 and tests/test_torch_cuda.py
        if not same_nan or (err > C.CHEB_TOL and err_mma <= C.CHEB_TOL):
            raise AssertionError(f"b{b} N={N} m={m} degree={degree}: {err}, {err_mma}")
    # the streaming build forced onto shapes its plan would not pick
    for b, N, m, degree, window, ctas in [(4, 900, 8, 10, 1024, 132), (3, 700, 23, 3, 256, 50),
                                          (2, 3600, 13, 3, 1024, 132), (5, 130, 5, 1, 128, 7)]:
        S, X, c, e = _inputs(b, N, m, g, dev)
        plan = cf.ChebPlan("streaming", 1, 64, cf.stream_smem(window), ctas, window)
        got = cf.launch_plan(cf.kernel_operator(S), X, _ce(c, e), degree, plan)
        torch.cuda.synchronize()
        err = (got - cf.chebyshev_filter_plain(S, X, c, e, degree)).abs().max().item()
        worst = max(worst, err)
        print(f"check streaming forced b{b} N={N} m={m} degree={degree} window {window} "
              f"ctas {ctas}: max |kernel - twin| {err:.3e}", flush=True)
        if not err <= C.CHEB_TOL:
            raise AssertionError(f"forced streaming b{b} N={N}: {err}")
    print(f"check: worst {worst:.3e} (tol {C.CHEB_TOL})", flush=True)


def info(plan, b, N, m) -> list:
    import chip_smoke as C
    if plan.build == "resident":
        return C.launch_shape("dss_cheb_filter_sm90_info", 0, b, N, m, plan.cluster, plan.rows,
                              n=6)
    return C.launch_shape("dss_cheb_filter_sm90_info", 1, b, N, m, plan.ctas, plan.key_window,
                          n=6)


def clusters(dev) -> None:
    import chip_smoke as C
    from .ops import cheb_filter as cf
    sms, at_once = cf.card_clusters_at_once(dev)
    print(f"clusters: the card ({sms} SMs) holds {dict(enumerate(at_once))} clusters of each "
          f"size at once at one CTA an SM; the H100 record: "
          f"{dict(enumerate(cf.H100_CLUSTERS_AT_ONCE))}", flush=True)
    for cluster, Ns in ((8, (640, 768)), (9, (900, 1024)), (10, (900, 1024)), (11, (900,)),
                        (12, (900, 1024)), (13, (900,)), (14, (900, 1024)), (15, (900,)),
                        (16, (640, 900, 1024, 1216))):
        for N in Ns:
            rows = -(-(-(-N // cluster)) // 8) * 8
            if rows > 256 or cf.resident_smem(N, 8, rows, cluster) > cf.SMEM_MAX:
                print(f"clusters: {cluster} CTAs, N={N}: the slab does not fit", flush=True)
                continue
            _, _, threads, smem, at_once, waves = C.launch_shape(
                "dss_cheb_filter_sm90_info", 0, 24, N, 8, cluster, rows, n=6)
            print(f"clusters: {cluster} CTAs of {threads} threads, N={N} m=8 ({rows} rows a "
                  f"CTA, {smem} B shared): {at_once} clusters at once, {waves} waves at b24",
                  flush=True)


def sizes(dev) -> None:
    """The resident build at b24 N=900 m=8 degree 10 and b4 N=1024 with each
    cluster size whose slab fits (rows a multiple of 8)."""
    import chip_smoke as C
    from .ops import cheb_filter as cf
    g = torch.Generator().manual_seed(6)
    for b, N, degree in ((24, 900, 10), (24, 900, 3), (4, 1024, 10), (4, 640, 10)):
        S, X, c, e = _inputs(b, N, 8, g, dev)
        Sk, ce = cf.kernel_operator(S), _ce(c, e)
        ref = cf.chebyshev_filter_plain(S, X, c, e, degree)
        for cluster in range(4, 17):
            rows = -(-(-(-N // cluster)) // 8) * 8
            smem = cf.resident_smem(N, 8, rows, cluster)
            if rows > 256 or smem > cf.SMEM_MAX or (cluster - 1) * rows >= N:
                continue
            plan = cf.ChebPlan("resident", cluster, rows, smem, b * cluster, 0)
            out = cf.launch_plan(Sk, X, ce, degree, plan)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            t = C.cuda_ms(lambda: cf.launch_plan(Sk, X, ce, degree, plan))
            *_, at_once, waves = info(plan, b, N, 8)
            print(f"sizes b{b} N={N} m=8 degree={degree}: cluster {cluster}, {rows} rows a "
                  f"CTA, {smem} B shared, {at_once} clusters at once, {waves} waves: {t}; "
                  f"max |kernel - twin| {err:.3e}", flush=True)


SHAPES = [(24, 900, 10, 8), (24, 900, 3, 8), (2, 3600, 10, 8), (4, 3600, 3, 8),
          (24, 900, 10, 23), (4, 1024, 10, 8), (4, 640, 10, 8), (1, 900, 10, 8),
          (4, 1224, 10, 8)]


def times(dev) -> None:
    import chip_smoke as C
    from .ops import cheb_filter as cf
    from .ops.eigen import chebyshev_filter_chain
    g = torch.Generator().manual_seed(2)
    for b, N, degree, m in SHAPES:
        S, X, c, e = _inputs(b, N, m, g, dev)
        Sk = cf.kernel_operator(S)
        plan = cf.cheb_filter_plan(b, N, m)
        graph, _ = C.graphed(lambda: chebyshev_filter_chain(S, X, c, e, degree))
        t = [C.cuda_ms(lambda: cf.chebyshev_filter(Sk, X, c, e, degree)),
             C.cuda_ms(lambda: cf.chebyshev_filter_mma(S, X, c, e, degree)),
             C.cuda_ms(lambda: cf.chebyshev_filter_plain(S, X, c, e, degree)),
             C.cuda_ms(graph.replay)]
        del graph
        bd = C.bound(S.numel() * 2 + 2 * X.numel() * 4, degree * 2 * b * N * N * m, C.PEAK_BF16)
        *_, smem, at_once, waves = info(plan, b, N, m)
        print(f"times b{b} N={N} m={m} degree={degree}: {plan.build} (cluster {plan.cluster}, "
              f"{plan.ctas} CTAs, {smem} B shared, {at_once} at once, {waves} waves): kernel "
              f"{t[0]}, mma.sync build {t[1]}, twin {t[2]}, XLA chain graph {t[3]} "
              f"({C.TIMING}); bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}), kernel "
              f"{bd['bound_ms'] / t[0].ms:.1%} of it, mma.sync {bd['bound_ms'] / t[1].ms:.1%}",
              flush=True)


def stream(dev) -> None:
    import chip_smoke as C
    from .ops import cheb_filter as cf
    g = torch.Generator().manual_seed(3)
    S, X, c, e = _inputs(4, 3600, 8, g, dev)
    ce = _ce(c, e)
    base = cf.cheb_filter_plan(4, 3600, 8)
    for ctas in (132, 114, 66):
        plan = base._replace(ctas=ctas)
        t = C.cuda_ms(lambda: cf.launch_plan(S, X, ce, 3, plan))
        print(f"stream b4 N=3600 degree 3: streaming build on {ctas} CTAs: {t} ({C.TIMING})",
              flush=True)
    # the window (2, 1) of phase 3's degree-3 shape handed over three ways:
    # CUDA tensors, Python floats (filled on the device), and CPU tensors
    # (a blocking host-to-device copy a call, as the wrappers made of
    # Python floats before this PR)
    for how, cc, ee in (("CUDA tensors", torch.full((4,), 2.0, device=dev),
                         torch.full((4,), 1.0, device=dev)),
                        ("Python floats", 2.0, 1.0),
                        ("CPU tensors", torch.tensor(2.0), torch.tensor(1.0))):
        t = [C.cuda_ms(lambda: fn(S, X, cc, ee, 3))
             for fn in (cf.chebyshev_filter, cf.chebyshev_filter_mma)]
        print(f"stream b4 N=3600 degree 3, window (2, 1) as {how}: kernel {t[0]}, mma.sync "
              f"build {t[1]}", flush=True)
    for b in (1, 2, 3, 4):
        t = C.cuda_ms(lambda: cf.chebyshev_filter_mma(S[:b], X[:b], c[:b], e[:b], 3))
        gx = C.launch_shape("dss_cheb_filter_mma_shape", b, 3600, 8)[0]
        print(f"stream b{b} N=3600 degree 3: mma.sync build, {gx * b} CTAs a step "
              f"({gx * b / 132:.2f} waves of 132): {t}, {t.ms / b:.4f} ms an image", flush=True)
    # fewer CTAs where the operators sit in L2: fewer stage the whole image's
    # T a step, each multiplies more rows (device time, torch.profiler)
    for N in (1288, 1600, 2048):
        Sn, Xn, cn, en = _inputs(4, N, 8, g, dev)
        Skn, cen = cf.kernel_operator(Sn), _ce(cn, en)
        plan = cf.cheb_filter_plan(4, N, 8)
        for ctas in (132, 100, 81, 66):
            p = plan._replace(ctas=ctas)
            d = device_ms(lambda: cf.launch_plan(Skn, Xn, cen, 10, p))
            print(f"stream b4 N={N} degree 10: streaming build on {ctas} CTAs: device "
                  f"{d:.4f} ms (torch.profiler, mean of 10 calls)", flush=True)


ABLATIONS = {"whole step": 0, "no products": 1, "no exchange with the peers": 2,
             "neither": 3}
TIMELINE_PHASES = ("products (with the waits for the peers' rows)",
                   "epilogue (T_{j+1}, local maxima)", "maxima sent, peers' awaited",
                   "scale and round own rows", "own rows sent to the peers", "to the next step")


def ablate(dev) -> None:
    """The resident build compiled with parts of its step left out
    (-DDSS_CHEB_ABLATE; wrong results, times only), one library each."""
    import ctypes
    import subprocess
    import chip_smoke as C
    from . import _build
    from .ops import cheb_filter as cf
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, bits in ABLATIONS.items():
        out = _build.BUILD_DIR / f"libcheb_filter_sm90_ablate{bits}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-DDSS_CHEB_ABLATE={bits}", "-shared",
               "-o", str(out), str(_build.CSRC / "cheb_filter_sm90.cu")]
        procs[label] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    tl_out = _build.BUILD_DIR / "libcheb_filter_sm90_timeline.so"
    tl_cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DDSS_CHEB_ABLATE=4", "-shared",
              "-o", str(tl_out), str(_build.CSRC / "cheb_filter_sm90.cu")]
    tl_proc = subprocess.Popen(tl_cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True)
    for _, proc in procs.values():
        proc.communicate()
    tl_proc.communicate()
    _build.load()
    log, func = _build.last_build.get("log", ""), ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1] if "'" in line else ""
        elif "cheb_resident" in func or "cheb_stream" in func:
            if "registers" in line or "stack" in line:
                print(f"ptxas {func[:60]}: {line.strip()}", flush=True)
    g = torch.Generator().manual_seed(4)
    shapes = [(24, 900, 10), (1, 900, 10), (1, 900, 1), (4, 640, 10)]
    inputs = []
    for b, N, degree in shapes:
        S, X, c, e = _inputs(b, N, 8, g, dev)
        inputs.append((cf.kernel_operator(S), X, _ce(c, e), cf.cheb_filter_plan(b, N, 8)))
    # one library at a time, each timed right after it is loaded
    for label, (out, proc) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {label} ({proc.returncode})")
        lib = ctypes.CDLL(str(out))
        fn = lib.dss_cheb_filter_resident
        fn.argtypes = _build._SIGNATURES["dss_cheb_filter_resident"]
        fn.restype = ctypes.c_int
        for (b, N, degree), (Sk, X, ce, plan) in zip(shapes, inputs):
            t = C.cuda_ms(lambda: cf.launch_plan(Sk, X, ce, degree, plan, lib))
            print(f"ablate {label}: b{b} N={N} m=8 degree={degree} (cluster {plan.cluster}, "
                  f"rows {plan.rows}): {t}", flush=True)
    # the timeline build: clock64() cycles of each phase, CTA 0 of the first
    # cluster, median over the steps of one chain, after warm-up launches
    lib = ctypes.CDLL(str(tl_out))
    lib.dss_cheb_filter_resident.argtypes = _build._SIGNATURES["dss_cheb_filter_resident"]
    lib.dss_cheb_filter_resident.restype = ctypes.c_int
    host = (ctypes.c_longlong * (2 + 32 * 6))()
    for (b, N, degree), (Sk, X, ce, plan) in zip(shapes, inputs):
        for _ in range(3):
            cf.launch_plan(Sk, X, ce, degree, plan, lib)
        torch.cuda.synchronize()
        lib.dss_cheb_timeline(host)
        tl = np.array(host[:2 + degree * 6], dtype=np.int64)
        steps = tl[2:].reshape(degree, 6)
        starts = np.concatenate([[tl[1]], steps[:-1, 5]])
        spans = np.diff(np.concatenate([starts[:, None], steps], axis=1), axis=1)
        med = np.median(spans[1:] if degree > 1 else spans, axis=0)
        print(f"timeline b{b} N={N} m=8 degree={degree}: start to slab landed "
              f"{tl[1] - tl[0]} cycles; per step (median of steps 2..{degree}, cycles): " +
              "; ".join(f"{n} {v:.0f}" for n, v in zip(TIMELINE_PHASES, med)), flush=True)


STREAM_PHASES = ("staging T's first chunks", "waiting for ring stages", "products loops",
                 "epilogues", "grid barrier", "producer waiting for free stages")


def stream_timeline(host, degree) -> np.ndarray:
    """Cycles a step of the streaming build's CTA 0 (steps 2 .. degree - 1),
    in STREAM_PHASES order, from its timeline slots: a step's staging,
    ring-wait and epilogue cycles, clock64() with its products done and
    past the grid barrier, and its producer's waits for free stages (the
    products loops: the rest of the time to the barrier)."""
    tl = np.array(host[:2 + degree * 6], dtype=np.int64)
    steps = tl[2:].reshape(degree, 6)
    return np.array([[steps[j, 0], steps[j, 1],
                      steps[j, 2] - steps[j - 1, 3] - steps[j, 0] - steps[j, 4], steps[j, 4],
                      steps[j, 3] - steps[j, 2], steps[j, 5]] for j in range(1, degree - 1)])


def device_ms(fn, calls: int = 10) -> float:
    """Device time of the filter's kernels in one call of `fn` (torch.profiler,
    mean of `calls` calls): the kernels alone, without the host's enqueue
    that CUDA events over back-to-back calls include where it is longer."""
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(ev.device_time_total for ev in prof.events()
               if ev.device_type == DeviceType.CUDA and "cheb_" in ev.name) / 1e3 / calls


def crossover(dev) -> None:
    """The kernel beside the mma.sync build at three resident shapes and,
    streaming, from the first N streamed at b4 to N=3600, at b4 and b24,
    degree 10 and 3: CUDA events over back-to-back calls, the timeline
    at degree 10 from a build of its own, then (torch.profiler slows the
    launches of its process, so last) the device time of each."""
    import ctypes
    import subprocess
    import chip_smoke as C
    from . import _build
    from .ops import cheb_filter as cf
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tl_out = _build.BUILD_DIR / "libcheb_filter_sm90_stream_timeline.so"
    proc = subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-DDSS_CHEB_ABLATE=4",
                             "-shared", "-o", str(tl_out),
                             str(_build.CSRC / "cheb_filter_sm90.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.load()
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the timeline build:\n{log[-3000:]}")
    lib = ctypes.CDLL(str(tl_out))
    lib.dss_cheb_filter_stream.argtypes = _build._SIGNATURES["dss_cheb_filter_stream"]
    lib.dss_cheb_filter_stream.restype = ctypes.c_int
    host = (ctypes.c_longlong * (2 + 32 * 6))()
    shapes = [(24, 900), (4, 1024), (1, 900)] + [
        (b, N) for b in (4, 24) for N in (cf.first_streamed_n(b, 8), 1600, 2048, 2500, 3600)]

    def inputs(i, b, N):
        S, X, c, e = _inputs(b, N, 8, torch.Generator().manual_seed(9 + i), dev)
        return S, cf.kernel_operator(S), X, c, e

    for i, (b, N) in enumerate(shapes):
        S, Sk, X, c, e = inputs(i, b, N)
        plan = cf.cheb_filter_plan(b, N, 8, *cf.card_clusters_at_once(dev))
        for degree in (10, 3):
            got = cf.chebyshev_filter(Sk, X, c, e, degree)
            mma = cf.chebyshev_filter_mma(S, X, c, e, degree)
            torch.cuda.synchronize()
            ref = cf.chebyshev_filter_plain(S, X, c, e, degree)
            err = (got - ref).abs().max().item()
            err_mma = (mma - ref).abs().max().item()
            t = [C.cuda_ms(lambda: cf.chebyshev_filter(Sk, X, c, e, degree)),
                 C.cuda_ms(lambda: cf.chebyshev_filter_mma(S, X, c, e, degree))]
            bd = C.bound(S.numel() * 2 + 2 * X.numel() * 4, degree * 2 * b * N * N * 8,
                         C.PEAK_BF16)
            # the twin again with rows and keys in reverse order (the same
            # chain, P S P^T for the reversal P; only its sums' order differs):
            # how far a changed order alone moves the result on these inputs
            ref_rev = cf.chebyshev_filter_plain(S.flip(1, 2), X.flip(1), c, e, degree).flip(1)
            order = (ref_rev - ref).abs().max().item()
            print(f"crossover b{b} N={N} m=8 degree={degree}: {plan.build} ({plan.ctas} "
                  f"CTAs), kernel {t[0]}, mma.sync build {t[1]} ({C.TIMING}): kernel / "
                  f"mma.sync {t[0].ms / t[1].ms:.3f}; bound {bd['bound_ms']:.4f} ms; max "
                  f"|kernel - twin| {err:.3e}, |mma.sync - twin| {err_mma:.3e}, |twin in "
                  f"reverse order - twin| {order:.3e}", flush=True)
            del ref_rev
        if plan.build == "streaming":
            for _ in range(3):
                cf.launch_plan(Sk, X, _ce(c, e), 10, plan, lib)
            torch.cuda.synchronize()
            lib.dss_cheb_timeline(host)
            med = np.median(stream_timeline(host, 10), axis=0)
            print(f"crossover timeline b{b} N={N} degree=10 (CTA 0, median of steps 2..9, "
                  f"cycles): " + "; ".join(f"{n} {v:.0f}" for n, v in zip(STREAM_PHASES, med)),
                  flush=True)
        del S, Sk, X
    for i, (b, N) in enumerate(shapes):
        S, Sk, X, c, e = inputs(i, b, N)
        for degree in (10, 3):
            d = [device_ms(lambda: cf.chebyshev_filter(Sk, X, c, e, degree)),
                 device_ms(lambda: cf.chebyshev_filter_mma(S, X, c, e, degree))]
            print(f"crossover device b{b} N={N} m=8 degree={degree}: kernel {d[0]:.4f} ms, "
                  f"mma.sync build {d[1]:.4f} ms (its step and rescale kernels; torch.profiler, "
                  f"mean of 10 calls): kernel / mma.sync {d[0] / d[1]:.3f}", flush=True)
        del S, Sk, X


def flip(dev) -> None:
    """Where the kernel is further from the twin than the mma.sync build:
    b24 N=2500 m=8 degree 10 on `crossover`'s inputs. The error after each
    degree, the worst element's distance from a bf16 rounding boundary one
    step before, and the error at degree 10 on other CTA counts (a row's
    sums keep their order on any count: an error that moves with the count
    is the partition's, one that stays is the order's), and with every step
    traversed forward (-DDSS_CHEB_ABLATE=8, a build of its own)."""
    import ctypes
    import subprocess
    from . import _build
    from .ops import cheb_filter as cf
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fwd_out = _build.BUILD_DIR / "libcheb_filter_sm90_forward.so"
    proc = subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, "-DDSS_CHEB_ABLATE=8",
                             "-shared", "-o", str(fwd_out),
                             str(_build.CSRC / "cheb_filter_sm90.cu")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.load()
    S, X, c, e = _inputs(24, 2500, 8, torch.Generator().manual_seed(9 + 11), dev)
    Sk, ce = cf.kernel_operator(S), _ce(c, e)
    plan = cf.cheb_filter_plan(24, 2500, 8, *cf.card_clusters_at_once(dev))
    for degree in range(1, 11):
        ref = cf.chebyshev_filter_plain(S, X, c, e, degree)
        got = cf.chebyshev_filter(Sk, X, c, e, degree)
        mma = cf.chebyshev_filter_mma(S, X, c, e, degree)
        d = (got - ref).abs()
        worst = np.unravel_index(int(d.argmax()), tuple(d.shape))
        print(f"flip b24 N=2500 degree {degree}: max |kernel - twin| {d.max().item():.3e} at "
              f"{tuple(int(x) for x in worst)}, |mma.sync - twin| "
              f"{(mma - ref).abs().max().item():.3e}", flush=True)
    ref = cf.chebyshev_filter_plain(S, X, c, e, 10)
    for ctas in (132, 131, 100, 66):
        got = cf.launch_plan(Sk, X, ce, 10, plan._replace(ctas=ctas))
        print(f"flip b24 N=2500 degree 10 on {ctas} CTAs: max |kernel - twin| "
              f"{(got - ref).abs().max().item():.3e}", flush=True)
    # the worst column alone (image 23, column 5 on these inputs), and every
    # build against a twin whose products sum in f64 (its other operations
    # the twin's f32 ones): which side of the bf16 roundings each build took
    def twin64(S, X, c, e, degree):
        B = X.shape[0]
        cc = torch.as_tensor(c, dtype=torch.float32, device=dev).reshape(-1).expand(B)[:, None, None]
        inv_e = 1.0 / torch.as_tensor(e, dtype=torch.float32, device=dev).reshape(-1).expand(B)[
            :, None, None]
        Sd = S.double()

        def a_shift(t):
            st = (Sd @ t.to(torch.bfloat16).double()).float()
            return ((1.0 - cc) * t - st) * inv_e
        one = torch.ones((), device=dev)
        t0 = X.float()
        t1 = a_shift(t0)
        for _ in range(degree - 1):
            t2 = 2.0 * a_shift(t1) - t0
            sc = 1.0 / torch.maximum(t2.abs().amax(dim=1, keepdim=True), one)
            t0, t1 = t1 * sc, t2 * sc
        return t1
    ref64 = twin64(S, X, c, e, 10)
    for name, out in (("kernel", cf.chebyshev_filter(Sk, X, c, e, 10)),
                      ("mma.sync build", cf.chebyshev_filter_mma(S, X, c, e, 10)),
                      ("twin", ref)):
        d = (out - ref64).abs()
        print(f"flip b24 N=2500 degree 10, {name} against the f64-sum twin: max {d.max().item():.3e}, "
              f"image 23 column 5 {d[23, :, 5].max().item():.3e}", flush=True)
    # the column's sensitivity: the twin with one element of T_j moved by
    # one bf16 ulp before its rounding (the size of one flipped rounding)
    def perturbed(S, X, c, e, degree, step, row, col):
        cc, inv_e = c[:, None, None], 1.0 / e[:, None, None]
        Sf = S.float()

        def a_shift(t):
            return ((1.0 - cc) * t - Sf @ t.to(torch.bfloat16).float()) * inv_e
        one = torch.ones((), device=dev)
        t0 = X.float()
        t1 = a_shift(t0)
        for j in range(2, degree + 1):
            t2 = 2.0 * a_shift(t1) - t0
            sc = 1.0 / torch.maximum(t2.abs().amax(dim=1, keepdim=True), one)
            t0, t1 = t1 * sc, t2 * sc
            if j == step:
                v = t1[23, row, col].to(torch.bfloat16).view(torch.int16)
                t1[23, row, col] = (v + 1).view(torch.bfloat16).float()
        return t1
    for step in (5, 6):
        for row in (100, 1435, 2000):
            moved = (perturbed(S, X, c, e, 10, step, row, 5) - ref)[23, :, 5].abs().max().item()
            print(f"flip twin with T_{step}[image 23, row {row}, column 5] one bf16 ulp up: "
                  f"column 5 at degree 10 moves {moved:.3e}", flush=True)
    one = [x[23:24] for x in (S, X, c, e)]
    got1 = cf.chebyshev_filter(cf.kernel_operator(one[0]), one[1], one[2], one[3], 10)
    ref1 = cf.chebyshev_filter_plain(*one, 10)
    print(f"flip image 23 alone (b1 N=2500 degree 10, {cf.cheb_filter_plan(1, 2500, 8).build}): "
          f"max |kernel - twin| {(got1 - ref1).abs().max().item():.3e}, column 5 "
          f"{(got1 - ref1)[0, :, 5].abs().max().item():.3e}", flush=True)
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the forward build:\n{log[-3000:]}")
    lib = ctypes.CDLL(str(fwd_out))
    lib.dss_cheb_filter_stream.argtypes = _build._SIGNATURES["dss_cheb_filter_stream"]
    lib.dss_cheb_filter_stream.restype = ctypes.c_int
    for degree in (3, 10):
        got = cf.launch_plan(Sk, X, ce, degree, plan, lib)
        err = (got - cf.chebyshev_filter_plain(S, X, c, e, degree)).abs().max().item()
        print(f"flip b24 N=2500 degree {degree}, every step forward: max |kernel - twin| "
              f"{err:.3e}", flush=True)


if __name__ == "__main__":
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    modes = {"check": check, "clusters": clusters, "times": times, "stream": stream,
             "ablate": ablate, "sizes": sizes, "crossover": crossover, "flip": flip}
    chosen = [a for a in sys.argv[1:] if a in modes] or ["check", "clusters", "times", "stream"]
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    np.random.seed(0)
    for name in chosen:
        modes[name](dev)
