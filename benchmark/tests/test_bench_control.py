"""The control comes out not correct, and the program correct, on the card.

The control is the reference put in the program's place one precision step
below the configuration's (fp8 below the ViT's bf16 and the features' fp16
and the filter's bf16 operator, TF32 below true f32). Each cell's limits
were set from its readings at full size (`limits/<workload>.json`,
`python -m benchmark.calibrate`); here small cells of dino_vits16 are held
to the same limits. Needs an NVIDIA GPU; run there with
`python -m pytest -q -m cuda benchmark/tests/test_bench_control.py`.
"""
from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, checks, harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["card-extract", "card-eigs", "card-train"])
def test_control_fails_and_program_passes(tiny_root, name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's kernels run only there)")
    cell = harness.find_cell(name, tiny_root)
    for seed in (2**31 + 11, 12, 13):
        rows = {r["kind"]: r["numbers"] for r in calibrate.readings(
            cell, seed, 1.0, torch.device("cuda", 0), control=True, faults=False,
            root=tiny_root)}
        ok, got = checks.verdict(rows["port"], cell.limits)
        assert ok, (seed, got)
        ok, got = checks.verdict(rows["control"], cell.limits)
        assert not ok, (seed, got)
