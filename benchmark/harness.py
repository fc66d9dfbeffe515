"""Finding a cell's files by name, and what every run needs around them.

A cell is one entry of `workloads` in the root `BENCHMARK.json`. Its
configuration is the file its `configs` entry names, its traffic mix is
`traffic/<traffic>.json` (whose `driver` key names `drivers/<driver>.py`),
its limits are `limits/<workload>.json`, and each per-layer metric is read
by `metrics/<metric>.py`. Adding a cell, a configuration, a mix or a
metric therefore adds files and entries and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "deep_spectral_tpu")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def spec_path(root: Optional[Path] = None) -> Path:
    return (root or HERE.parent) / "BENCHMARK.json"


def load_spec(root: Optional[Path] = None) -> dict:
    return json.loads(spec_path(root).read_text())


def _applies(metric: dict, cell: str, e2e_cells: dict) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    moves = metric.get("moves")
    return moves is None or cell in e2e_cells.get(moves, ())


def find_cell(name: str, root: Optional[Path] = None) -> Cell:
    """The cell `name` of `BENCHMARK.json` under `root` (the checkout) with
    its configuration, traffic, limits and the metrics it reports."""
    root = root or HERE.parent
    spec = load_spec(root)
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in {spec_path(root)}")
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    bench = root / "benchmark"
    all_names = [w["name"] for w in spec["workloads"]]
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", all_names)]
    e2e_cells = {m["name"]: m.get("workloads", all_names) for m in spec["end_to_end"]}
    per_layer = [m for m in spec["per_layer"] if _applies(m, name, e2e_cells)]
    return Cell(name=name, workload=wl,
                config=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((bench / "traffic" / f"{wl['traffic']}.json").read_text()),
                limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer)


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file `path` as module `name` (metric files carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell, root: Optional[Path] = None) -> ModuleType:
    kind = cell.traffic["driver"]
    return load_module((root or HERE.parent) / "benchmark" / "drivers" / f"{kind}.py",
                       f"benchmark_driver_{kind}")


def metric_reader(metric: str, root: Optional[Path] = None) -> ModuleType:
    return load_module((root or HERE.parent) / "benchmark" / "metrics" / f"{metric}.py",
                       f"benchmark_metric_{metric.replace('.', '_')}")


def fix_cache_dirs(root: Optional[Path] = None) -> None:
    """Every compiler cache of the run at a fixed path inside the checkout,
    so only a cell's first run in a checkout builds (the port builds its
    kernels into `deep_spectral_tpu_torch/_build/` by itself); libraries
    that would load JAX are told not to."""
    cache = (root or HERE.parent) / "benchmark" / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def process_start() -> float:
    """The process's start on the `time.time()` clock (Linux /proc)."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19]) / ticks
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))

