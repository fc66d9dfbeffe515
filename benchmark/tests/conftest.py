"""Fixtures of the benchmark's tests: a copy of the benchmark in a temporary
checkout with small cells added by files alone: `tiny-*` (a tiny ViT, small
traffic) run on the CPU with the port's plain twins, `card-*` (dino_vits16
at small sizes) on the card."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"name": "test_vit_tiny", "patch_size": 8, "embed_dim": 32, "depth": 2, "num_heads": 2,
        "mlp_ratio": 4.0, "img_size": 32}


FULL = {"voc480": "vits16-extract-voc480", "coco_ragged": "vits16-eigs-coco-ragged",
        "selftrain_b144_fp32": "vits16-selftrain-b144-fp32"}
# small mixes: on the CPU with the tiny ViT, on the card with dino_vits16
# (the kernels take the published head width of 64)
CPU_MIXES = {"voc480": dict(image_hw=[184, 184], batch_size=4, eig_batch_size=2,
                            pool_batches=2, warm_batches=2),
             "coco_ragged": dict(longer_side=200, aspects=[[[4, 3], 4], [[1, 1], 2]],
                                 eig_batch_size=2),
             "selftrain_b144_fp32": dict(batch_size=4, crop=64, pool_batches=3, label_cell=16,
                                         warm_steps=1)}
CARD_MIXES = {"voc480": dict(image_hw=[384, 384], batch_size=8, pool_batches=2, warm_batches=2),
              "coco_ragged": dict(longer_side=384, aspects=[[[4, 3], 8], [[1, 1], 8]]),
              "selftrain_b144_fp32": dict(batch_size=8, pool_batches=3, warm_steps=1)}


def add_small_cells(root: Path, prefix: str, config: str, mixes: dict,
                    config_file: dict | None = None) -> list[str]:
    """Add small cells `<prefix>-<driver>` of `config` (written from
    `config_file` when given) to the checkout at `root` by new files and new
    entries only. A cell's limits are those of the full-size cell of its mix."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    if config_file is not None:
        (bench / "configs" / f"{config}.json").write_text(json.dumps(config_file))
        spec["configs"].append({"name": config, "source": "tests",
                                "file": f"benchmark/configs/{config}.json",
                                "reduced": [], "why": "a ViT small enough for the CPU"})
    names = []
    for mix, edit in mixes.items():
        traffic = json.loads((bench / "traffic" / f"{mix}.json").read_text()) | edit
        (bench / "traffic" / f"{prefix}_{mix}.json").write_text(json.dumps(traffic))
        name = f"{prefix}-{traffic['driver']}"
        spec["workloads"].append({"name": name, "config": config, "traffic": f"{prefix}_{mix}",
                                  "chips": 1, "why": "tests"})
        shutil.copy(bench / "limits" / f"{FULL[mix]}.json", bench / "limits" / f"{name}.json")
        names.append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return names


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    add_small_cells(root, "tiny", "tiny", CPU_MIXES, TINY)
    add_small_cells(root, "card", "dino_vits16", CARD_MIXES)
    return root


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
