"""The harness finds every piece of a cell by name, takes up a cell added by
files alone, counts work as by hand, reads idle time as a union, and loads
neither JAX nor the JAX package."""
from __future__ import annotations

import ast
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import features, harness, work
from benchmark.trace import Timeline, gaps, union_seconds

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_finds_each_cell_by_name(name):
    cell = harness.find_cell(name)
    assert cell.config["name"] == cell.workload["config"]
    assert hasattr(harness.driver(cell), "Runner")
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer, name
    for m in cell.per_layer:
        assert m["moves"] in reported, (name, m["name"])
        assert callable(harness.metric_reader(m["name"]).read)
    assert cell.limits["limits"], f"{name} has no limits"


def test_a_cell_added_by_files_alone_is_taken_up(tiny_root):
    for name in ("tiny-extract", "tiny-eigs", "tiny-train"):
        cell = harness.find_cell(name, tiny_root)
        assert cell.config["name"] == "test_vit_tiny"
        assert harness.driver(cell, tiny_root).Runner
    with pytest.raises(KeyError):
        harness.find_cell("tiny-extract")            # not in the repo's own file


def test_spec_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in SPEC["configs"]:
        assert (REPO / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert (REPO / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1


def test_attention_work_by_hand():
    # b2, T=3 rows, 2 valid tokens in the first item, 3 in the second; 1 head of 2
    f, b = work.attention_fwd([2, 3], T=3, heads=1, hd=2, itemsize=2, masked=True)
    assert f == 2 * 2 * 2 * 1 * (2 * 2 + 3 * 3)       # 2 products x 2 flops x hd x H x rows x keys
    assert b == 4 * 5 * 2 * 2 + 2 * 3                 # Q, K, V, O at the valid rows; mask
    f, b = work.attention_bwd([3], T=3, heads=1, hd=2, itemsize=4)
    assert f == 5 * 2 * 2 * 3 * 3
    assert b == 7 * 3 * 8 + 2 * 3 * 4


def test_model_work_by_hand():
    cfg = {"patch_size": 2, "embed_dim": 4, "depth": 2, "num_heads": 1, "mlp_ratio": 4.0}
    t, D = 5, 4
    block = 2 * t * D * 3 * D + 2 * t * D * D + 2 * 2 * t * D * 16 + 4 * t * t * D
    assert work.vit_block(t, D, 4.0) == block
    assert work.vit_keys(4, cfg) == 2 * 4 * 4 * 3 * 4 + block + 2 * t * D * D
    assert work.cheb_chain(10, 8, 3) == (2 * 100 * 8 * 3, 2 * 100 + 8 * 10 * 8)
    assert work.affinity(10, 4) == 800
    assert work.upsample_mm(2, 4, 3) == 2 * (2 * 4 * 2 + 4 * 2 * 4) * 3
    assert work.bound_s(989e12, 0, work.PEAK_BF16) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12, work.PEAK_BF16) == pytest.approx(1.0)


def test_train_work_counts_the_trained_part_three_times():
    cfg = {"patch_size": 16, "embed_dim": 384, "depth": 12, "num_heads": 6, "mlp_ratio": 4.0}
    one = work.train_step(1, 224, cfg, 21, 1)
    blk = work.vit_block(197, 384, 4.0)
    head = work.deeplab_head(196, 384, 21) + work.upsample_mm(14, 224, 21)
    assert one == pytest.approx(work.patch_embed(196, 16, 384) + 12 * blk + head
                                + 2 * (blk + head))
    assert work.train_step(144, 224, cfg, 21, 1) == pytest.approx(144 * one)


def test_idle_share_is_a_union():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (9.0, 12.0)]
    assert union_seconds(iv, 0.0, 10.0) == pytest.approx(3.0 + 1.0 + 1.0)
    assert gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    tl = Timeline(device=[("k", s, e) for s, e in iv], host=[("op", 5.5, 7.0)], window=(0.0, 10.0))
    assert 1 - tl.busy_s() / tl.window_s == pytest.approx(0.5)
    assert tl.matching_s(["k"]) == pytest.approx(2 + 2 + 1 + 0.2 + 1)
    bd = tl.breakdown()
    assert bd["idle_gaps"] == [["op", pytest.approx(3.0)], ["python", pytest.approx(2.0)]]


def test_structured_field_is_bench_py_field():
    """bench.py's `_structured_features` recipe, as written there."""
    grid, D = 16, 8
    rng = np.random.default_rng(3)
    expect = np.zeros((grid, grid, D), np.float32)
    yy, xx = np.mgrid[:grid, :grid] / grid
    for _ in range(6):
        fy, fx = rng.uniform(0.5, 3, 2)
        ph = rng.uniform(0, 2 * np.pi)
        expect += np.sin(2 * np.pi * (fy * yy + fx * xx) + ph)[..., None] * \
            rng.standard_normal(D).astype(np.float32)
    cy, cx = rng.integers(6, grid - 6), rng.integers(6, grid - 6)
    blob = ((np.mgrid[:grid, :grid][0] - cy) ** 2 + (np.mgrid[:grid, :grid][1] - cx) ** 2) \
        < grid * grid // 36
    expect[blob] += 3 * rng.standard_normal(D).astype(np.float32)
    draws = [features.field_draws(np.random.default_rng(3), grid, grid, D)]
    got = features.structured_field(draws, grid, grid, "cpu")[0].numpy()
    np.testing.assert_allclose(got, expect.reshape(-1, D), rtol=0, atol=1e-5)


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_port():
    for path in (REPO / "benchmark" / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "contextlib", "math", "torch", "typing"}, path


def test_no_module_of_any_cell_is_jax_or_the_jax_package():
    """Import everything a run of each cell imports (the harness, drivers,
    readers and the port's modules they reach) in a fresh process, then
    compare whole top-level names: the port's own name begins with the
    JAX package's."""
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from benchmark import harness, run, calibrate
for name in {CELLS!r}:
    cell = harness.find_cell(name)
    harness.driver(cell)
    for m in cell.per_layer:
        harness.metric_reader(m["name"])
import deep_spectral_tpu_torch.pipeline.extract, deep_spectral_tpu_torch.tasks.semantic_segmentation
import deep_spectral_tpu_torch.ops.eigen, deep_spectral_tpu_torch.models.vit
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "deep_spectral_tpu_torch_x", object())
    assert "deep_spectral_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()


def test_run_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is attached")
    from benchmark import run
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name", CELLS)
def test_limits_lie_between_their_readings(name):
    """Each limit lies above the program's largest reading and below the
    smallest reading of the control or a fault, unless the configuration
    states it (the solver's residual guard)."""
    lim = json.loads((REPO / "benchmark" / "limits" / f"{name}.json").read_text())
    assert lim["limits"]
    for number, value in lim["limits"].items():
        r = lim["readings"][number]
        assert math.isfinite(value) and r["lower"] < value, (name, number)
        assert "stated" in r or value < r["upper"], (name, number)
