"""Kernels 4 and 5 (bf16 dK/dV and dQ): their hi/lo precision on one GPU,
against single-rounding control builds.

    python -m deep_spectral_tpu_torch.probe_dkv

Run from the repository root: it reuses chip_smoke.py's phase-6 inputs
(`train_kernel_inputs`, the same seed, so the same tensors) and its reading
(`hi_lo_reading`: the share of dk and dv entries on valid keys, and of dq
entries in batch rows with a valid key, that are not bit-equal to the
twin's, and the RMS difference over max |twin|).

It builds `csrc/flash_bwd_dkv.cu` a second time with
-DDSS_DKV_SINGLE_ROUNDING (p^T and ds^T rounded to bf16 once) and
`csrc/flash_bwd_dq.cu` with -DDSS_DQ_SINGLE_ROUNDING (ds rounded to bf16
once), the lo products left out, each into a library of its own, and prints
the reading of the port's builds and of the controls at phase 6's bf16
shapes. chip_smoke.py gates the port's builds on the shares, each with a
limit between the two readings.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import torch

# entry point: (source, the control's define)
CONTROLS = {"dss_flash_bwd_dkv_bf16": ("flash_bwd_dkv.cu", "DSS_DKV_SINGLE_ROUNDING"),
            "dss_flash_bwd_dq_bf16": ("flash_bwd_dq.cu", "DSS_DQ_SINGLE_ROUNDING")}


def control_entry_points(controls: dict = CONTROLS) -> dict:
    """Control builds' entry points, by name: each entry point's source
    built alone with its define (`controls`: name -> (source, define); by
    default the single-rounding controls); the nvcc runs go together."""
    from . import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, define) in controls.items():
        out = _build.BUILD_DIR / f"lib{Path(source).stem}_{define.lower()}.so"
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, f"-D{define}", "-shared",
               "-o", str(out), str(_build.CSRC / source)]
        procs[name] = (out, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (out, cmd, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        fn = getattr(ctypes.CDLL(str(out)), name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


class _WithControls:
    """The port's kernel library with some entry points replaced (by name)."""

    def __init__(self, lib, controls: dict):
        self._lib = lib
        self.__dict__.update(controls)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def main(dev) -> None:
    import chip_smoke as C
    from . import _build
    from .models.flash_attention import (
        _row_dot, flash_attention_lse, flash_backward_plain, flash_bwd_dkv, flash_bwd_dq)
    lib, controls = _build.load(), control_entry_points()
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    g = torch.Generator().manual_seed(6)          # phase 6's generator and order
    for (b, T, dtype, ragged) in C.TRAIN_KERNEL_SHAPES:
        q, k, v, do, mask = C.train_kernel_inputs(b, T, getattr(torch, dtype), ragged, g, dev)
        if dtype != "bfloat16":
            continue
        o, lse = flash_attention_lse(q, k, v, mask)
        di = _row_dot(o, do)
        refs = dict(zip(("dq", "dk", "dv"), flash_backward_plain(q, k, v, mask, o, lse, do)))
        rows = C.hi_lo_rows(mask)
        for build in ("hi/lo (the port)", "single rounding (control)"):
            _build._lib = lib if build.startswith("hi/lo") else _WithControls(lib, controls)
            try:
                got = dict(zip(("dk", "dv"), flash_bwd_dkv(q, k, v, mask, do, lse, di)))
                got["dq"] = flash_bwd_dq(q, k, v, mask, do, lse, di)
            finally:
                _build._lib = lib
            torch.cuda.synchronize()
            line = []
            for name, x in got.items():
                share, rms = C.hi_lo_reading(x, refs[name], rows[name])
                worst = C._max_err(x, refs[name], mask.any(dim=1)) / \
                    refs[name].float().abs().max().item()
                line.append(f"{name} share not bit-equal {share:.4f}, RMS diff / max |twin| "
                            f"{rms:.3e}, max |diff| / max |twin| {worst:.3e}")
            print(f"b{b} T={T} bf16 ragged={ragged}, {build}: " + "; ".join(line), flush=True)


if __name__ == "__main__":
    main(torch.device("cuda", 0))
