"""The readers of the port's spans and counters (`benchmark/spans.py` and the
metrics whose `source` is `program_span` and that read it), on synthetic
traced runs: known host ranges, span records and counts. Each reads its
value, reads nothing (None) where the run recorded nothing, and never
raises on a port that has no spans."""
from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.trace import Timeline
from deep_spectral_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
READ_SPANS = ["eig_resolve_share.extract", "eigs_syncs.extract", "eigs_sync_share.extract",
              "cheb_useful_share.extract", "fetch_wait_share.extract", "upload_share.extract",
              "vit_host_ms.extract", "forward_ms.train", "backward_ms.train",
              "optimizer_ms.train"]


def rec(name, parent=None, device_ms=None, **counts):
    return {"name": name, "parent": parent, "counts": counts, "device_ms": device_ms}


# two b8 solves: one resolving 2 lanes, 4 + 3 outers; a 2 s window
RECORDS = [
    rec("eigs.decompose"), rec("eigs.cheb", 0),
    rec("eigs.outer", 1, **{"cheb.lanes_filtered": 8, "cheb.lanes_active": 8}),
    rec("eigs.sync", 2, **{"eigs.syncs": 3}),
    rec("eigs.outer", 1, **{"cheb.lanes_filtered": 8, "cheb.lanes_active": 2}),
    rec("eigs.sync", 4, **{"eigs.syncs": 3}),
    rec("eigs.guard", 0, **{"eigs.images": 8, "eigs.resolved": 2, "eigs.syncs": 2}),
    rec("eigs.decompose"), rec("eigs.lobpcg", 7, **{"eigs.syncs": 10}),
    rec("eigs.guard", 7, **{"eigs.images": 8, "eigs.syncs": 1}),
    rec("train.forward", device_ms=30.0), rec("train.backward", device_ms=45.0),
    rec("train.optimizer", device_ms=6.0),
    rec("train.forward", device_ms=32.0), rec("train.backward", device_ms=47.0),
    rec("train.optimizer", device_ms=6.5),
]
HOST = [("eigs.sync", 10.1, 10.2), ("eigs.sync", 10.5, 10.55), ("aten::mm", 10.5, 10.52),
        ("stage.wait", 9.5, 10.3),            # starts before the window: clipped
        ("stage.upload", 11.0, 11.1), ("stage.upload", 11.05, 11.2),   # overlap counts once
        ("vit.extract", 10.0, 10.004), ("vit.extract", 11.0, 11.006)]


def run_of(host=(), counts=None):
    tl = Timeline(device=[("k", 10.0, 12.0)], host=list(host), window=(10.0, 12.0))
    return SimpleNamespace(timeline=tl, counts=counts or {"images": 16, "steps": 2},
                           cell=None, work={}, spans_ms={})


def read(name, run):
    return harness.metric_reader(name).read(run)


@pytest.fixture
def records(monkeypatch):
    def use(recs):
        monkeypatch.setattr(profiling, "records", lambda: [dict(r) for r in recs])
    return use


def test_every_reader_is_in_the_spec_as_a_program_span():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in READ_SPANS:
        m = entries[name]
        assert m["source"] == "program_span" and m["workloads"], name
        assert m["moves"] == ("train_step_ms" if name.endswith(".train") else "images_per_s")


def test_readers_read_the_synthetic_run(records):
    records(RECORDS)
    run = run_of(HOST)
    assert read("eig_resolve_share.extract", run) == pytest.approx(2 / 16 * 100)
    assert read("eigs_syncs.extract", run) == pytest.approx((3 + 3 + 2 + 10 + 1) / 2)
    assert read("eigs_sync_share.extract", run) == pytest.approx(0.15 / 2 * 100)
    assert read("cheb_useful_share.extract", run) == pytest.approx(10 / 16 * 100)
    assert read("fetch_wait_share.extract", run) == pytest.approx(0.3 / 2 * 100)
    assert read("upload_share.extract", run) == pytest.approx(0.2 / 2 * 100)
    assert read("vit_host_ms.extract", run) == pytest.approx(5.0)
    assert read("forward_ms.train", run) == pytest.approx(31.0)
    assert read("backward_ms.train", run) == pytest.approx(46.0)
    assert read("optimizer_ms.train", run) == pytest.approx(6.25)


def test_no_resolve_reads_zero(records):
    records([rec("eigs.cheb"), rec("eigs.guard", **{"eigs.images": 8, "eigs.syncs": 1})])
    assert read("eig_resolve_share.extract", run_of()) == 0


@pytest.mark.parametrize("name", READ_SPANS)
def test_nothing_recorded_reads_none(records, name):
    records([])
    assert read(name, run_of([("aten::mm", 10.0, 10.1)])) is None


@pytest.mark.parametrize("name", READ_SPANS)
def test_a_port_without_spans_reads_none(monkeypatch, name):
    """The parent of the spans' change: no `records` in the port."""
    monkeypatch.delattr(profiling, "records")
    assert read(name, run_of([("aten::mm", 10.0, 10.1)])) is None


def test_device_times_need_the_card(records):
    records([rec("train.forward"), rec("train.backward"), rec("train.optimizer")])
    assert read("forward_ms.train", run_of()) is None
