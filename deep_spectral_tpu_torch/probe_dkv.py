"""Kernel 4's (bf16 dK/dV) hi/lo precision on one GPU, against a
single-rounding control build.

    python -m deep_spectral_tpu_torch.probe_dkv

Run from the repository root: it reuses chip_smoke.py's phase-6 inputs
(`train_kernel_inputs`, the same seed, so the same tensors) and its reading
(`dkv_rounding`: the share of dk and dv entries on valid keys that are not
bit-equal to the twin's, and the RMS difference over max |twin|).

It builds `csrc/flash_bwd_dkv.cu` a second time with
-DDSS_DKV_SINGLE_ROUNDING (p^T and ds^T rounded to bf16 once, the lo
products left out) into a library of its own, and prints the reading of the
port's build and of the control at phase 6's bf16 shapes. chip_smoke.py
gates the port's build on the share, with a limit between the two readings.
"""
from __future__ import annotations

import ctypes
import subprocess

import torch


def control_entry_point():
    """`dss_flash_bwd_dkv_bf16` of the single-rounding control build."""
    from . import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "libdss_dkv_single_rounding.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-DDSS_DKV_SINGLE_ROUNDING", "-shared",
           "-o", str(out), str(_build.CSRC / "flash_bwd_dkv.cu")]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).dss_flash_bwd_dkv_bf16
    fn.argtypes = _build._SIGNATURES["dss_flash_bwd_dkv_bf16"]
    fn.restype = ctypes.c_int
    return fn


class _WithControl:
    """The port's kernel library with the control's dKV entry point."""

    def __init__(self, lib, dkv):
        self._lib, self.dss_flash_bwd_dkv_bf16 = lib, dkv

    def __getattr__(self, name):
        return getattr(self._lib, name)


def main(dev) -> None:
    import chip_smoke as C
    from . import _build
    from .models.flash_attention import (
        _row_dot, flash_attention_lse, flash_backward_plain, flash_bwd_dkv)
    lib, control = _build.load(), control_entry_point()
    print(f"card: {torch.cuda.get_device_name(0)}", flush=True)
    g = torch.Generator().manual_seed(6)          # phase 6's generator and order
    for (b, T, dtype, ragged) in C.TRAIN_KERNEL_SHAPES:
        q, k, v, do, mask = C.train_kernel_inputs(b, T, getattr(torch, dtype), ragged, g, dev)
        if dtype != "bfloat16":
            continue
        o, lse = flash_attention_lse(q, k, v, mask)
        di = _row_dot(o, do)
        refs = flash_backward_plain(q, k, v, mask, o, lse, do)[1:]
        for build in ("hi/lo (the port)", "single rounding (control)"):
            _build._lib = lib if build.startswith("hi/lo") else _WithControl(lib, control)
            try:
                got = flash_bwd_dkv(q, k, v, mask, do, lse, di)
            finally:
                _build._lib = lib
            torch.cuda.synchronize()
            line = []
            for name, x, ref in zip(("dk", "dv"), got, refs):
                share, rms = C.dkv_rounding(x, ref, mask)
                worst = C._max_err(x, ref, mask.any(dim=1)) / ref.float().abs().max().item()
                line.append(f"{name} share not bit-equal {share:.4f}, RMS diff / max |twin| "
                            f"{rms:.3e}, max |diff| / max |twin| {worst:.3e}")
            print(f"b{b} T={T} bf16 ragged={ragged}, {build}: " + "; ".join(line), flush=True)


if __name__ == "__main__":
    main(torch.device("cuda", 0))
