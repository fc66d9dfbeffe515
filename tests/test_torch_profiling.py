"""The port's spans and counters (`deep_spectral_tpu_torch.utils.profiling`)
on the CPU: nothing is recorded and no range is opened with the profiler
off; under `torch.profiler` the spans nest as the solver, the stages and
the train step run, the counters count the guard's re-solves and the
Chebyshev lanes, the ranges land on the profiler's timeline inside the
benchmark's window, and `trace` writes them out."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.trace import Timeline
from deep_spectral_tpu_torch.ops import affinity as ta
from deep_spectral_tpu_torch.ops import eigen as te
from deep_spectral_tpu_torch.pipeline import extract as stages
from deep_spectral_tpu_torch.tasks import semantic_segmentation as TSS
from deep_spectral_tpu_torch.utils import profiling
from deep_spectral_tpu_torch.utils.profiling import StageTimer, span

sys.path.insert(0, str(Path(__file__).parent))
from test_solver_lobpcg import _smooth_features  # noqa: E402

K, HW = 5, (24, 24)


@pytest.fixture(autouse=True)
def _fresh_records():
    """One torch thread, and no record left from another test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear()
    yield
    profiling.clear()
    torch.set_num_threads(n)


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _feats(seeds=(7, 8)):
    feats = np.stack([_smooth_features(np.random.default_rng(s), *HW) for s in seeds])
    mask = np.ones((len(seeds), HW[0] * HW[1]), bool)
    mask[-1, -3 * HW[1]:] = False             # the last image padded
    return torch.from_numpy(feats), torch.from_numpy(mask)


def _train_state():
    cfg = TSS.TrainConfig(backbone="test_vit_tiny", num_classes=3, crop_size=32,
                          resize_size=40, batch_size=2, max_train_steps=10)
    state = TSS.create_train_state(cfg, TSS.build_model(cfg), device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 3, (2, 32, 32)))
    return state, x, y


def _names(recs, parent=None):
    return [r["name"] for r in recs if r["parent"] == parent]


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    f, m = _feats()
    before = profiling.totals()
    te.spectral_decompose_batched(f, m, K=K)
    state, x, y = _train_state()
    TSS.train_step(state, x, y, torch.Generator().manual_seed(0))
    assert profiling.records() == [] and opened == []
    # the counters are always on
    after = profiling.totals()
    assert after["eigs.images"] - before.get("eigs.images", 0) == 2
    assert after["eigs.syncs"] > before.get("eigs.syncs", 0)


def test_solver_spans_nest():
    f, m = _feats()
    te._resident_start_block.cache_clear()
    with _profile():
        te.spectral_decompose_batched(f, m, K=K)
        te.spectral_decompose_batched(f, m, K=K)
    recs = profiling.records()
    assert _names(recs) == ["eigs.decompose"] * 2
    # the default start block is copied to the device once per (N, m, device)
    second = [i for i, r in enumerate(recs) if r["parent"] is None][1]
    again = next(i for i, r in enumerate(recs) if r["name"] == "eigs.cheb" and i > second)
    assert set(_names(recs, again)) == {"eigs.outer"}
    recs = recs[:second]
    assert _names(recs, 0) == ["eigs.affinity", "eigs.cheb", "eigs.guard"]
    cheb, guard = (next(i for i, r in enumerate(recs) if r["name"] == n)
                   for n in ("eigs.cheb", "eigs.guard"))
    start, *outers = [i for i, r in enumerate(recs) if r["parent"] == cheb]
    assert recs[start]["name"] == "eigs.sync"                # the start block's upload
    assert outers and all(recs[i]["name"] == "eigs.outer" for i in outers)
    # every outer but a last one that finds nothing active: the exit test and rr's two eighs
    for i in outers:
        assert set(_names(recs, i)) == {"eigs.sync"}
        assert len(_names(recs, i)) in (1, 3)
    assert _names(recs, guard) == ["eigs.sync"]
    assert all(r["device_ms"] is None for r in recs)       # no card: no events
    syncs = sum(r["counts"].get("eigs.syncs", 0) for r in recs)
    assert syncs == sum(r["name"] == "eigs.sync" for r in recs)


def test_resolved_counts_the_guards_dense_resolves():
    """Degree-1 filters cannot converge: the guard re-solves both lanes
    (tests/test_torch_eigen.py's case), and counts them."""
    f, m = _feats()
    with _profile():
        ev1, _ = te.spectral_decompose_batched(f, m, K=K, cheb_degree=1)
        ev, _ = te.spectral_decompose_batched(f, m, K=K)
    ev_e, _ = te.spectral_decompose_batched(f, m, K=K, solver="eigh")
    np.testing.assert_array_equal(ev1.numpy(), ev_e.numpy())
    recs = profiling.records()
    guards = [r for r in recs if r["name"] == "eigs.guard"]
    assert [g["counts"].get("eigs.resolved", 0) for g in guards] == [2, 0]
    assert [g["counts"]["eigs.images"] for g in guards] == [2, 2]
    # both lanes are first resumed for the rounds left (a read after each),
    # then re-solved: the dense eigh is a sync of the guard too
    resolving = recs.index(guards[0])
    assert _names(recs, resolving) == (["eigs.sync"] + ["eigs.continue", "eigs.sync"]
                                       * (te.CHEB_ROUNDS - 1) + ["eigs.sync"])
    assert [g["counts"]["eigs.continued"] for g in guards] == [2, 0]


def test_guard_counts_valid_lanes_only():
    f, m = _feats((7, 8, 9))
    m[1] = False                               # a padding lane: no valid node
    with _profile():
        te.spectral_decompose_batched(f, m, K=K)
    guard = next(r for r in profiling.records() if r["name"] == "eigs.guard")
    assert guard["counts"]["eigs.images"] == 2


def test_lane_counters_match_the_outers():
    feats = np.stack([_smooth_features(np.random.default_rng(s), *HW) for s in (3, 7, 8, 11)])
    W = ta.feature_affinity(torch.from_numpy(feats), max_normalize=False)
    ws = 1.0 / W.amax(dim=(-2, -1))
    d = W.sum(-1) * ws[:, None]
    d = torch.where(d < 1e-12, 1.0, d)
    B = W.shape[0]
    *_, outers = te._chebyshev_laplacian(W, d, K, K + 3, 4, 10, None, True, w_scale=ws)
    with _profile():   # the same solve, guarded: the guard's read counts the active lanes
        te._laplacian_eigs_batched(W, K, w_scale=ws, solver="chebyshev", cheb_outer=4,
                                   cheb_degree=10)
    recs = profiling.records()
    active = sum(r["counts"].get("cheb.lanes_active", 0) for r in recs)
    filtered = sum(r["counts"].get("cheb.lanes_filtered", 0) for r in recs)
    assert active == int(outers.sum())
    assert filtered == B * int(outers.max())
    assert sum(r["name"] == "eigs.outer" for r in recs) >= int(outers.max())


@pytest.mark.parametrize("window_init", ["wide", "estimate"])
def test_fixed_schedule_matches_the_exit_test(monkeypatch, window_init):
    """The card's sync-free schedule, emulated on the CPU (every outer runs,
    no exit test is read, the lane count is read at the guard, no graph),
    against the loop that reads the exit test: bit-identical results and
    `outers`; `cheb.lanes_active` is outers.sum() under both schedules, and
    `cheb.lanes_filtered` B x cheb_outer under the fixed one. Degree 6 leaves
    the lanes converging at different outers, all before the fourth."""
    feats = np.stack([_smooth_features(np.random.default_rng(s), *HW) for s in (3, 7, 8, 11)])
    W = ta.feature_affinity(torch.from_numpy(feats), max_normalize=False)
    ws = 1.0 / W.amax(dim=(-2, -1))
    d = W.sum(-1) * ws[:, None]
    d = torch.where(d < 1e-12, 1.0, d)
    B, n_outer, degree = W.shape[0], 4, 6
    results, counts = [], []
    for fixed in (False, True):
        with monkeypatch.context() as mp:
            if fixed:
                mp.setattr(te, "_sync_free", lambda device, m: True)
                mp.setattr(te, "_RR_GRAPH_BYTES", 0)
            results.append(te._chebyshev_laplacian(W, d, K, K + 3, n_outer, degree, None,
                                                   True, w_scale=ws, window_init=window_init))
            profiling.clear()
            kw = dict(w_scale=ws, solver="chebyshev", cheb_outer=n_outer, cheb_degree=degree,
                      cheb_window_init=window_init)
            with _profile():
                te._laplacian_eigs_batched(W, K, **kw)                          # guarded
                te._laplacian_eigs_batched(W, K, return_residual=True, **kw)
            recs = profiling.records()
            counts.append([sum(r["counts"].get(n, 0) for r in recs)
                           for n in ("cheb.lanes_active", "cheb.lanes_filtered")])
    for exit_test, fixed in zip(*results):
        assert torch.equal(exit_test, fixed)
    outers = results[0][3]
    assert len(set(outers.tolist())) > 1 and int(outers.max()) < n_outer
    assert counts[0] == [2 * int(outers.sum()), 2 * B * int(outers.max())]
    assert counts[1] == [2 * int(outers.sum()), 2 * B * n_outer]


def test_fixed_schedule_matches_the_exit_test_with_continuation(monkeypatch):
    """The two schedules of `test_fixed_schedule_matches_the_exit_test`
    through the guard's continuation rounds, at the CLI's K=20 on five
    graphs whose lanes pass in the first, second, third and fourth round of
    4 outers and in none (the last ends under CHEB_RESIDUAL_TOL but above
    CHEB_CONTINUE_TOL, so dense eigh takes it at the cap): each round's
    results and `outers` bit-identical under both, and so the guarded
    solve's; the guard's counters exact under both (`eigs.continued` the
    four lanes resumed, `eigs.resolved` the last, `cheb.lanes_active` the
    outers summed, `cheb.lanes_filtered` B a round's outer, every one under
    the fixed schedule)."""
    feats = np.stack([_smooth_features(np.random.default_rng(s), *HW)
                      for s in (15, 3, 0, 17, 5)])
    W = ta.feature_affinity(torch.from_numpy(feats), max_normalize=False)
    ws = 1.0 / W.amax(dim=(-2, -1))
    d = W.sum(-1) * ws[:, None]
    d = torch.where(d < 1e-12, 1.0, d)
    B, k, n_outer = W.shape[0], 20, 4
    names = ("eigs.continued", "eigs.resolved", "eigs.images", "cheb.lanes_active",
             "cheb.lanes_filtered")
    rounds, results, counts = [], [], []
    for fixed in (False, True):
        with monkeypatch.context() as mp:
            if fixed:
                mp.setattr(te, "_sync_free", lambda device, m: True)
                mp.setattr(te, "_RR_GRAPH_BYTES", 0)
            solve = te._ChebyshevSolve(W, d, k, k + 3, 10, None, True, ws)
            outs = [solve.run(n_outer)]
            tol = torch.where(outs[0][2] > te.CHEB_RESIDUAL_TOL, te.CHEB_CONTINUE_TOL,
                              te.CHEB_RESIDUAL_TOL)
            for _ in range(te.CHEB_ROUNDS - 1):
                outs.append(solve.resume(outs[-1][2] > tol, tol, n_outer))
            solve.close()
            rounds.append(outs)
            profiling.clear()
            with _profile():
                results.append(te._laplacian_eigs_batched(
                    W, k, w_scale=ws, solver="chebyshev", cheb_outer=n_outer))
            recs = profiling.records()
            counts.append({n: sum(r["counts"].get(n, 0) for r in recs) for n in names})
    for exit_test, fixed in zip(*rounds):
        for a, b in zip(exit_test, fixed):
            assert torch.equal(a, b)
    for a, b in zip(*results):
        assert torch.equal(a, b)
    outers = [o[3] for o in rounds[0]]
    passed = [(o[2] <= tol).tolist() for o in rounds[0]]
    assert passed == [[True] * r + [False] * (B - r) for r in range(1, te.CHEB_ROUNDS + 1)]
    assert outers[-1][-1] == te.CHEB_ROUNDS * n_outer
    assert rounds[0][-1][2][-1] <= te.CHEB_RESIDUAL_TOL
    ev, vec, *_ = rounds[0][-1]
    assert torch.equal(results[0][0][:-1], ev[:-1])
    assert torch.equal(results[0][1][:-1], vec[:-1])
    assert not torch.equal(results[0][0][-1], ev[-1])               # the dense re-solve
    steps = [int(outers[0].max())] + [int((b - a).max()) for a, b in zip(outers, outers[1:])]
    expect = {"eigs.continued": B - 1, "eigs.resolved": 1, "eigs.images": B,
              "cheb.lanes_active": int(outers[-1].sum())}
    assert counts[0] == {**expect, "cheb.lanes_filtered": B * sum(steps)}
    assert counts[1] == {**expect, "cheb.lanes_filtered": B * n_outer * te.CHEB_ROUNDS}


def test_train_step_spans_once_each_per_step():
    state, x, y = _train_state()
    gen = torch.Generator().manual_seed(0)
    with _profile():
        for _ in range(2):
            TSS.train_step(state, x, y, gen)
    assert _names(profiling.records()) == ["train.forward", "train.backward",
                                           "train.optimizer"] * 2


def test_stage_callback_encloses_the_hosts_work():
    inflight = stages._InFlight()
    seen = []

    def on_result(a):
        with span("inner"):
            seen.append(a.sum())

    with _profile():
        for i in range(3):
            inflight.push(stages._Fetch(torch.full((2,), float(i))), on_result)
        inflight.drain()
    recs = profiling.records()
    assert _names(recs) == ["stage.callback"] * 3 and len(seen) == 3
    for r in recs:
        if r["name"] == "inner":
            assert recs[r["parent"]]["name"] == "stage.callback"


def test_ranges_land_on_the_benchmarks_timeline():
    f, m = _feats()
    tl = Timeline.record(lambda: te.spectral_decompose_batched(f, m, K=K))
    lo, hi = tl.window
    ours = [(n, s, e) for n, s, e in tl.host if n.startswith(("eigs.", "cheb."))]
    names = {n for n, _, _ in ours}
    assert {"eigs.decompose", "eigs.affinity", "eigs.cheb", "eigs.outer", "eigs.sync",
            "eigs.guard"} <= names
    assert all(lo <= s <= e <= hi for _, s, e in ours)
    # the ranges are not device operations
    assert not any(n.startswith("eigs.") for n, _, _ in tl.device)


def test_trace_writes_spans_json(tmp_path):
    f, m = _feats()
    with profiling.trace(str(tmp_path / "tr")):
        te.spectral_decompose_batched(f, m, K=K, cheb_degree=1)
    out = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert out["spans"][0]["name"] == "eigs.decompose"
    assert sum(r["counts"].get("eigs.resolved", 0) for r in out["spans"]) == 2
    assert out["totals"]["eigs.resolved"] >= 2
    assert json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]


def test_stage_timer_reports_the_runs_resolves():
    timer = StageTimer()
    f, m = _feats()
    with timer.stage("extract_eigs", n_items=4):
        te.spectral_decompose_batched(f, m, K=K, cheb_degree=1)
        te.spectral_decompose_batched(f, m, K=K)
    assert timer.summary().splitlines()[-1].startswith("eigs: 2 of 4 image(s) re-solved")
    assert "re-solved" not in StageTimer().summary()


def test_vit_extract_is_one_span():
    from deep_spectral_tpu_torch.models.vit import (VisionTransformer, extract_patch_keys,
                                                    get_model_config)
    model = VisionTransformer(get_model_config("test_vit_tiny"), torch.float32).eval()
    images = torch.randn(2, 32, 48, 3)
    with _profile():
        k = extract_patch_keys(model, images)
    assert k.shape == (2, 4 * 6, 32)
    assert _names(profiling.records()) == ["vit.extract"]


def test_swiglu_spans_and_token_counters():
    """`vit.swiglu` opens once a block that runs its FFN (the forward's every
    block, stage 1's all but the last), inside `vit.extract`; `vit.tokens`
    counts the B x T tokens run (given grids, the compacted B x Tc, Tc the
    largest image's 5 + 24), `vit.compacted` the batches run compacted and
    `vit.tokens_valid` each image's CLS, 4 registers and grid patches, only
    where grids are given; the benchmark's readers read them (no device time
    on the CPU)."""
    from benchmark import harness
    from deep_spectral_tpu_torch.models.vit import (VisionTransformer, extract_patch_keys,
                                                    get_model_config)
    cfg = get_model_config("test_dinov2_tiny")
    model = VisionTransformer(cfg, torch.float32).eval()
    images = torch.randn(2, 5 * 14, 6 * 14, 3)
    mask = torch.zeros(2, 5, 6, dtype=torch.bool)
    mask[0, :4, :6] = True
    mask[1, :5, :3] = True
    with _profile():
        extract_patch_keys(model, images, token_mask=mask.reshape(2, -1),
                           grids=np.array([[4, 6], [5, 3]]))
    recs = profiling.records()
    assert [r["name"] for r in recs] == ["vit.extract"] + ["vit.swiglu"] * (cfg.depth - 1)
    assert all(r["parent"] == 0 for r in recs[1:])
    assert recs[0]["counts"] == {"vit.tokens": 2 * 29, "vit.tokens_valid": (5 + 24) + (5 + 15),
                                 "vit.compacted": 1}
    assert harness.metric_reader("vit_pad_share.extract").read(None) == \
        pytest.approx(100 * (1 - 49 / 58))
    assert harness.metric_reader("swiglu_ms.extract").read(None) is None
    profiling.clear()
    with _profile(), torch.no_grad():
        model(images)
        extract_patch_keys(model, images)
    recs = profiling.records()
    assert [r["name"] for r in recs] == ["vit.swiglu"] * cfg.depth + ["vit.extract"] + \
        ["vit.swiglu"] * (cfg.depth - 1)
    assert recs[cfg.depth]["counts"] == {"vit.tokens": 2 * 35}
    assert harness.metric_reader("vit_pad_share.extract").read(None) is None
