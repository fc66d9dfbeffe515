"""Build and load the port's CUDA kernels.

Every `*.cu` file under `deep_spectral_tpu_torch/csrc/` is compiled by nvcc, at
first use, one nvcc process per source, all started together
(`-gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC -c`), and the
objects are linked into one shared library with a plain C interface, which is
loaded with ctypes. The library goes into `deep_spectral_tpu_torch/_build/`
(listed in `.gitignore`) under a name that carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is not. The build
writes to a temporary file and renames it into place, so two processes that
build at once both end with a whole library.

The library links against the CUDA runtime only: the wgmma kernels' TMA
tensor maps (bf16 in `csrc/hopper.cuh`, f32 in `csrc/tf32.cuh`) are encoded
with `cuTensorMapEncodeTiled` (libcuda), which `csrc/hopper.cuh` looks up
through the runtime's entry-point query, so no `-lcuda` is needed. Headers (`csrc/*.cuh`) enter the hash with the sources.

Nothing here runs at import time: the package imports on hosts without nvcc
or a GPU, and only a wrapper that is handed a CUDA tensor calls `load()`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_LLP = ctypes.POINTER(ctypes.c_longlong)
_IP = ctypes.POINTER(ctypes.c_int)
# Argument types of every C entry point (pointers and the stream are c_void_p:
# without argtypes ctypes would pass Python ints as 32-bit ints).
_SIGNATURES = {
    # q, k, v, kv_mask, out, lse (null: no lse); B, T, H, hd; 9 strides; scale; stream
    "dss_flash_fwd_packed": [_P] * 6 + [_I] * 4 + [_LL] * 9 + [_F, _P],
    # q, k, v, out, rel_h, rel_w; B, T, H, S, NY; 9 q/k/v strides, 6 table
    # strides; scale; stream
    "dss_flash_fwd_relpos": [_P] * 6 + [_I] * 5 + [_LL] * 15 + [_F, _P],
    # S, ld, bs, X, ce, out, T staging in global memory; B, N, m, degree,
    # cluster, rows, smem; stream
    "dss_cheb_filter_resident": [_P, _LL, _LL] + [_P] * 4 + [_I] * 7 + [_P],
    # S, ld, bs, X, ce, out, work, flags; B, N, m, degree, ctas,
    # key_window, smem; stream
    "dss_cheb_filter_stream": [_P, _LL, _LL] + [_P] * 5 + [_I] * 7 + [_P],
    # cluster, shared bytes a CTA; out: clusters the card holds at once
    "dss_cheb_clusters_at_once": [_I, _I, _IP],
    # N, m, rows, cluster, key_window; out: the resident and streaming
    # layouts' shared bytes a CTA
    "dss_cheb_layout_bytes": [_I] * 5 + [_IP],
    # the mma.sync build: S, X, ce, out, work, colmax; B, N, m, degree; stream
    "dss_cheb_filter_mma": [_P] * 6 + [_I] * 4 + [_P],
    # q, k, v, kv_mask, o, lse; B, T, H; strides; scale; stream
    "dss_flash_fwd_lse_f32": [_P] * 6 + [_I] * 3 + [_LLP, _F, _P],
    # q, k, v, kv_mask, do, lse, di, dk, dv; B, T, H; strides; scale; stream
    "dss_flash_bwd_dkv_f32": [_P] * 9 + [_I] * 3 + [_LLP, _F, _P],
    "dss_flash_bwd_dkv_bf16": [_P] * 9 + [_I] * 3 + [_LLP, _F, _P],
    # q, k, v, kv_mask, do, lse, di, dq; B, T, H; strides; scale; stream
    "dss_flash_bwd_dq_f32": [_P] * 8 + [_I] * 3 + [_LLP, _F, _P],
    "dss_flash_bwd_dq_bf16": [_P] * 8 + [_I] * 3 + [_LLP, _F, _P],
    # M, w, V, bad; B, m; stream
    "dss_small_eigh": [_P] * 4 + [_I] * 2 + [_P],
    # qkv, f32 (0: bf16), grids, periods; B, T, prefix, H; stream
    "dss_rope_rotate": [_P, _I, _P, _P] + [_I] * 4 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
last_build: dict = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the port's CUDA kernels are built from source")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):      # sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdss_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed library unless it already exists:
    one nvcc per source, all running at once, then one link. A compile
    records its nvcc log in `last_build`."""
    out = library_path()
    if out.is_file() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [Path(work) / f"{src.stem}.o" for src in _sources()]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                             for src, obj in zip(_sources(), objs))]
        logs = []
        for cmd, proc in procs:
            text = proc.communicate()[0]
            logs.append(text)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{text}")
        tmp = Path(work) / out.name
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    last_build.update(path=str(out), log="\n".join(logs).strip())
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first call, with argtypes set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.dss_error_string.argtypes = [_I]
        lib.dss_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        text = load().dss_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")
