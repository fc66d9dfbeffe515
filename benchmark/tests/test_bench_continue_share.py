"""The reader of `eig_continue_share.extract`: the share of the valid lanes
that the eigensolver's guard resumed for more Chebyshev outers before any
dense re-solve (the port's counter `eigs.continued` over `eigs.images`), on
synthetic span records. It reads its value, 0 where nothing was resumed, and
None, without raising, on a port that has no such counter or no spans."""
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
NAME = "eig_continue_share.extract"


def rec(name, parent=None, **counts):
    return {"name": name, "parent": parent, "counts": counts, "device_ms": None}


def run_of():
    tl = Timeline(device=[("k", 10.0, 12.0)], host=[("aten::mm", 10.0, 10.1)],
                  window=(10.0, 12.0))
    return SimpleNamespace(timeline=tl, counts={"images": 16}, cell=None, work={},
                           spans_ms={})


def read(run):
    return harness.metric_reader(NAME).read(run)


@pytest.fixture
def records(monkeypatch):
    def use(recs):
        monkeypatch.setattr(profiling, "records", lambda: [dict(r) for r in recs])
    return use


def test_the_spec_lists_it_where_the_resolve_share_is_read():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    m = entries[NAME]
    assert (m["unit"], m["better"], m["source"]) == ("%", "lower", "program_span")
    assert (m["layer"], m["moves"]) == ("Eigensolve", "images_per_s")
    assert m["workloads"] == entries["eig_resolve_share.extract"]["workloads"]


@pytest.mark.parametrize("counts, value", [
    ({"eigs.continued": 6}, 6 / 16 * 100),   # lanes resumed in the first solve
    ({"eigs.continued": 0}, 0.0),            # a port that resumed nothing
    ({}, None),                              # a port without the counter
])
def test_continue_share_reads_the_resumed_lanes(records, counts, value):
    records([rec("eigs.cheb", 0), rec("eigs.guard", 0, **{"eigs.images": 8, **counts}),
             rec("eigs.continue", 1), rec("eigs.guard", 2, **{"eigs.images": 8})])
    got = read(run_of())
    assert got == (None if value is None else pytest.approx(value))


def test_nothing_recorded_reads_none(records):
    records([])
    assert read(run_of()) is None


def test_a_port_without_spans_reads_none(monkeypatch):
    monkeypatch.delattr(profiling, "records")
    assert read(run_of()) is None
