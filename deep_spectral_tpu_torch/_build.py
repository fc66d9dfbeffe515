"""Build and load the port's CUDA kernels.

Every `*.cu` file under `deep_spectral_tpu_torch/csrc/` is compiled by nvcc, at
first use, into one shared library with a plain C interface
(`-gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`), which
is loaded with ctypes. The library goes into `deep_spectral_tpu_torch/_build/`
(listed in `.gitignore`) under a name that carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is not. The build
writes to a temporary file and renames it into place, so two processes that
build at once both end with a whole library.

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
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# Argument types of every C entry point (pointers and the stream are c_void_p:
# without argtypes ctypes would pass Python ints as 32-bit ints).
_SIGNATURES = {
    "dss_flash_fwd_packed": [_P, _P, _P, _P, _P, _I, _I, _I,
                             _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                             _F, _P],
    "dss_cheb_filter": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "dss_cheb_filter_row_bytes": [],
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
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdss_kernels_{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile csrc/*.cu into the hashed library unless it already exists.
    A compile records its nvcc log and wall time in `last_build`."""
    out = library_path()
    if out.is_file() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, _sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    last_build.update(path=str(out), seconds=seconds,
                      log=(proc.stdout + proc.stderr).strip())
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
