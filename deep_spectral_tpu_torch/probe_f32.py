"""The f32 builds of the trainable flash kernels (kernels 3-5) on one GPU.

    python -m deep_spectral_tpu_torch.probe_f32 [times] [backend] [control]

(no argument: all three). Run from the repository root: it reuses
chip_smoke.py's phase-6 inputs (`train_kernel_inputs`), its timing
(`cuda_ms`) and its bounds (`attention_work`, f32 work over PEAK_F32).

`times`: at the shapes users run the f32 builds (F32_SHAPES: the fp32
recipe's b144 T=197, localization's b1 T=901 and 601, the SP hop at b1
T=8465, b4 T=901 ragged with an all-masked row, b2 T=3601 ragged), each
kernel's time through its wrapper (the port's route), the CUDA-core FMA
build's (`csrc/flash_attn_train.cu`) called directly, the twin's, f32
SDPA's forward (inputs that need a gradient) and backward (dq, dk and dv
together), and each kernel's bound. It runs unchanged in an older checkout,
where the FMA build is the wrapper's route (entry points without the `_fma`
suffix). Also written to `chiprun_out/probe_f32.json`.

`backend`: the CUDA kernels that torch.profiler reports for one f32 SDPA
forward and backward at b144 T=197: which SDPA backend the yardstick is.

`control`: each split-TF32 kernel's max |kernel - twin| beside the
single-pass-TF32 control's (the same source built with -DDSS_F32_SINGLE_TF32:
every lo part 0, so the lo products add nothing) at chip_smoke phase 6's f32
inputs and b144 T=197; the control's error must be the larger by far.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import torch

# (batch, T, ragged mask with an all-masked batch row, backward too)
F32_SHAPES = [(144, 197, False, True), (1, 901, False, False), (1, 601, False, False),
              (1, 8465, False, False), (4, 901, True, True), (2, 3601, True, True)]
# the split-TF32 entry points and their single-pass-TF32 control builds
CONTROLS = {"dss_flash_fwd_lse_f32": ("flash_fwd_f32.cu", "DSS_F32_SINGLE_TF32"),
            "dss_flash_bwd_dkv_f32": ("flash_bwd_dkv_f32.cu", "DSS_F32_SINGLE_TF32"),
            "dss_flash_bwd_dq_f32": ("flash_bwd_dq_f32.cu", "DSS_F32_SINGLE_TF32")}


def _fma(lib, name: str):
    """The CUDA-core FMA build's entry point: `<name>_fma`, or `<name>` in a
    checkout whose wrappers still route f32 to it."""
    return getattr(lib, f"{name}_fma", None) or getattr(lib, name)


def fma_calls(q, k, v, mask, do, lse, di):
    """Closures that launch the three FMA builds on these operands."""
    from . import _build
    from .models.flash_attention import _strides
    lib = _build.load()
    B, T, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    stream = torch.cuda.current_stream().cuda_stream
    m = None if mask is None else mask.data_ptr()
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse_o = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(o) for _ in range(3))
    fwd, dkv, dqf = (_fma(lib, f"dss_flash_{n}_f32") for n in ("fwd_lse", "bwd_dkv", "bwd_dq"))

    def run_fwd():
        _build.check(fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), m, o.data_ptr(),
                         lse_o.data_ptr(), B, T, H, _strides(q, k, v, o), scale, stream),
                     "fma fwd")
        return o, lse_o

    def run_dkv():
        _build.check(dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), m, do.data_ptr(),
                         lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, H,
                         _strides(q, k, v, do, dk, dv), scale, stream), "fma dkv")
        return dk, dv

    def run_dq():
        _build.check(dqf(q.data_ptr(), k.data_ptr(), v.data_ptr(), m, do.data_ptr(),
                         lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B, T, H,
                         _strides(q, k, v, do, dq), scale, stream), "fma dq")
        return dq

    return run_fwd, run_dkv, run_dq


def _inputs(b, T, ragged, g, dev):
    import chip_smoke as C
    q, k, v, do, mask = C.train_kernel_inputs(b, T, torch.float32, ragged, g, dev)
    return q, k, v, do, (mask if ragged else None)


def times(dev) -> list:
    import chip_smoke as C
    import torch.nn.functional as F
    from .models import flash_attention as fa
    g = torch.Generator().manual_seed(11)
    rows = []
    for b, T, ragged, bwd in F32_SHAPES:
        q, k, v, do, mask = _inputs(b, T, ragged, g, dev)
        o, lse = fa.flash_attention_lse(q, k, v, mask)
        di = fa._row_dot(o, do)
        fwd_fma, dkv_fma, dq_fma = fma_calls(q, k, v, mask, do, lse, di)
        fwd_fma()
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_lse_plain(q, k, v, mask)
        err = {"o": (o - o_ref).abs().max().item(), "lse": (lse - lse_ref).abs().max().item()}
        t = {"fwd": C.cuda_ms(lambda: fa.flash_attention_lse(q, k, v, mask)),
             "fwd_fma": C.cuda_ms(fwd_fma),
             "fwd_plain": C.cuda_ms(lambda: fa.flash_attention_lse_plain(q, k, v, mask),
                                    iters=2 if T > 4000 else 20)}
        qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_(bwd) for x in (q, k, v))
        t["sdpa_fwd"] = C.cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        bounds = {"fwd": C.attention_work(q, mask, products=2, io_tensors=4, stats=1)}
        if bwd:
            refs = fa.flash_backward_plain(q, k, v, mask, o, lse, do)
            dk, dv = fa.flash_bwd_dkv(q, k, v, mask, do, lse, di)
            dq = fa.flash_bwd_dq(q, k, v, mask, do, lse, di)
            torch.cuda.synchronize()
            for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
                err[name] = (got - ref).abs().max().item()
            t.update({
                "dkv": C.cuda_ms(lambda: fa.flash_bwd_dkv(q, k, v, mask, do, lse, di)),
                "dkv_fma": C.cuda_ms(dkv_fma),
                "dq": C.cuda_ms(lambda: fa.flash_bwd_dq(q, k, v, mask, do, lse, di)),
                "dq_fma": C.cuda_ms(dq_fma),
                "bwd_plain": C.cuda_ms(lambda: fa._backward_plain(q, k, v, mask, lse, do, di))})
            o_lib = F.scaled_dot_product_attention(qh, kh, vh)
            doh = do.transpose(1, 2)
            t["sdpa_bwd"] = C.cuda_ms(lambda: torch.autograd.grad(o_lib, (qh, kh, vh), doh,
                                                                  retain_graph=True))
            bounds["dkv"] = C.attention_work(q, mask, products=4, io_tensors=6, stats=2)
            bounds["dq"] = C.attention_work(q, mask, products=3, io_tensors=5, stats=2)
        row = {"b": b, "T": T, "ragged": ragged, "max_abs_err": err,
               **{n: x.ms for n, x in t.items()},
               "bounds": {n: x["bound_ms"] for n, x in bounds.items()},
               "bound_by": {n: x["bound_by"] for n, x in bounds.items()}}
        print(f"b{b} T={T} f32 ragged={ragged}: max |kernel - twin| "
              + ", ".join(f"{n} {e:.3e}" for n, e in err.items()) + f" (tol {C.F32_TOL}); "
              + ", ".join(f"{n} {x}" for n, x in t.items()) + f" ({C.TIMING}); bounds "
              + ", ".join(f"{n} {x['bound_ms']:.4f} ms ({x['bound_by']}, "
                          f"{x['bound_ms'] / t[n].ms:.1%} of the wrapper, "
                          f"{x['bound_ms'] / t[n + '_fma'].ms:.1%} of the FMA build)"
                          for n, x in bounds.items()), flush=True)
        rows.append(row)
        del q, k, v, do, o, lse, di, o_ref, lse_ref, qh, kh, vh
        torch.cuda.empty_cache()
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "probe_f32.json").write_text(json.dumps(rows, indent=1))
    return rows


def backend(dev) -> None:
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    g = torch.Generator().manual_seed(11)
    q, k, v, do, _ = _inputs(144, 197, False, g, dev)
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    for _ in range(2):
        o = F.scaled_dot_product_attention(qh, kh, vh)
        torch.autograd.grad(o, (qh, kh, vh), do.transpose(1, 2))
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        o = F.scaled_dot_product_attention(qh, kh, vh)
        torch.autograd.grad(o, (qh, kh, vh), do.transpose(1, 2))
        torch.cuda.synchronize()
    names = sorted({(ev.name, round(ev.device_time_total / 1e3, 4)) for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA}, key=lambda x: -x[1])
    print("f32 SDPA forward + backward at b144 T=197, CUDA kernels (name, ms):", flush=True)
    for name, ms in names:
        print(f"  {ms:8.4f}  {name[:150]}", flush=True)


def control(dev) -> None:
    import chip_smoke as C
    from . import _build
    from .models import flash_attention as fa
    from .probe_dkv import _WithControls, control_entry_points
    lib, ctl = _build.load(), control_entry_points(CONTROLS)
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    g = torch.Generator().manual_seed(6)          # phase 6's generator and order
    for b, T, dtype, ragged in C.TRAIN_KERNEL_SHAPES:
        q, k, v, do, mask = C.train_kernel_inputs(b, T, getattr(torch, dtype), ragged, g, dev)
        if dtype != "float32":
            continue
        o_ref, lse_ref = fa.flash_attention_lse_plain(q, k, v, mask)
        refs = fa.flash_backward_plain(q, k, v, mask, o_ref, lse_ref, do)
        di = fa._row_dot(o_ref, do)
        for build in ("split TF32 (the port)", "single-pass TF32 (control)"):
            _build._lib = lib if build.startswith("split") else _WithControls(lib, ctl)
            try:
                o, lse = fa.flash_attention_lse(q, k, v, mask)
                dk, dv = fa.flash_bwd_dkv(q, k, v, mask, do, lse_ref, di)
                dq = fa.flash_bwd_dq(q, k, v, mask, do, lse_ref, di)
            finally:
                _build._lib = lib
            torch.cuda.synchronize()
            errs = {"o": (o - o_ref).abs().max().item(),
                    "lse": (lse - lse_ref).abs().max().item(),
                    "dk": (dk - refs[1]).abs().max().item(),
                    "dv": (dv - refs[2]).abs().max().item(),
                    "dq": (dq - refs[0]).abs().max().item()}
            print(f"b{b} T={T} f32 ragged={ragged}, {build}: max |kernel - twin| "
                  + ", ".join(f"{n} {e:.3e}" for n, e in errs.items())
                  + f" (F32_TOL {C.F32_TOL})", flush=True)


if __name__ == "__main__":
    import sys
    probes = {"times": times, "backend": backend, "control": control}
    for name in sys.argv[1:] or list(probes):
        probes[name](torch.device("cuda", 0))
