"""Readings that the limits of `limits/<workload>.json` are set from.

    python -m benchmark.calibrate --workload <name> --seeds 1,2,3 --seconds 3 [--control] [--faults]

For each seed, in one process: the cell's set-up and a short window at its
own load, then the numbers `check` compares for the program's answers
(`port`); with `--control`, the same numbers for the control, the reference
put in the program's place one precision step below the configuration's
(`control`); with `--faults`, for answers with a fault planted where they
are produced (`fault.<name>`). Each row carries the verdict (`correct`) that
the cell's limits give it, with the port's numbers standing for those the
row leaves alone. One JSON line per seed and kind goes to standard output
and to `--out`. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import checks, harness
from benchmark.reference import eigen as ref_eigen
from benchmark.reference.lowp import tf32_enabled


def _extract_control(r) -> dict:
    out = {"keys_rel_err": checks.keys_gap(r.reference_keys(fp8=True), r.reference_keys())}
    return out | _eig_control(r.stage2_features(), r.tr["K"])


def _eig_control(feats, K) -> dict:
    with tf32_enabled(False):
        answers = [ref_eigen.control_answer(f, K) for f in feats]
        return checks.eig_gaps(feats, answers, K)


def _eig_faults(feats, answers, K, lanes: int) -> dict:
    """One eigenvector altered by 1% of its norm; the second half of the
    lanes of every solve (`lanes` images a solve, answers in solve and lane
    order) never computed (zeros), as a solver that left half its batch out
    would return them."""
    gen = torch.Generator().manual_seed(0)
    ev, x = answers[0]
    x = x.clone()
    x[0] += 0.01 * torch.linalg.vector_norm(x[0]) * torch.randn(x.shape[1], generator=gen) \
        / x.shape[1] ** 0.5
    altered = [(ev, x)] + answers[1:]
    missing = [(torch.zeros_like(e), torch.zeros_like(v)) if i % lanes >= lanes // 2 else (e, v)
               for i, (e, v) in enumerate(answers)]
    with tf32_enabled(False):
        return {"answer_altered": checks.eig_gaps(feats, altered, K),
                "half_batch_missing": checks.eig_gaps(feats, missing, K)}


def readings(cell, seed: int, seconds: float, dev, control: bool, faults: bool,
             root=None) -> list[dict]:
    runner = harness.driver(cell, root).Runner(cell, seed, dev)
    runner.window(seconds)
    runner.release()
    kind = cell.traffic["driver"]
    rows = [{"kind": "port", "numbers": runner.numbers()}]
    if kind == "extract":
        if control:
            rows.append({"kind": "control", "numbers": _extract_control(runner)})
        if faults:
            f = _eig_faults(runner.stage2_features(), runner.port_answers(), runner.tr["K"],
                            runner.B2)
            port_k = runner.port_keys()
            port_k[0] = port_k[0] * 1.1
            f["keys_altered"] = {"keys_rel_err": checks.keys_gap(port_k, runner.reference_keys())}
            rows += [{"kind": f"fault.{k}", "numbers": v} for k, v in f.items()]
    elif kind == "eigs":
        feats, answers = runner.compared()
        if control:
            rows.append({"kind": "control", "numbers": _eig_control(feats, runner.tr["K"])})
        if faults:
            rows += [{"kind": f"fault.{k}", "numbers": v}
                     for k, v in _eig_faults(feats, answers, runner.tr["K"],
                                             runner.tr["eig_batch_size"]).items()]
    elif kind == "train":
        from benchmark.drivers.train import compare
        ref = runner.reference()
        if control:
            rows.append({"kind": "control",
                         "numbers": compare(runner.reference(torch.float32, tf32=True), ref)})
        if faults:
            half = runner.reference(keep=slice(0, runner.tr["batch_size"] // 2))
            rows.append({"kind": "fault.half_batch", "numbers": compare(half, ref)})
    port = rows[0]["numbers"]
    for row in rows:
        row["correct"] = checks.verdict(port | row["numbers"], cell.limits)[0]
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.fix_cache_dirs()
    cell = harness.find_cell(args.workload)
    dev = torch.device("cuda", 0)
    out = Path(args.out) if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for row in readings(cell, seed, args.seconds, dev, args.control, args.faults):
            row.update(workload=args.workload, seed=seed, seconds=round(time.perf_counter() - t0, 1))
            line = json.dumps(row)
            print(line, flush=True)
            if out:
                with out.open("a") as f:
                    f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
