"""The per-layer metrics that read the program's own spans
(pmbench/program.py): their values on synthetic records, None (and no
raise) where the program keeps none or has no such module, and each of
them in the result of a tiny traced run of every cell that lists it."""

import sys

import pytest

from pmbench import manifest, program, tracing
from pmbench.tests import small

NEW = {  # metric -> the cells BENCHMARK.json lists it for
    "place.sketch_s": ("illumina.single", "illumina.plate"),
    "place.upload_s": ("illumina.single", "illumina.plate"),
    "place.rescue_s": ("illumina.single", "illumina.plate"),
    "align.bam_wait_s": ("illumina.single",),
    "sw.survivor_pct": ("illumina.single",),
    "genotype.columns_s": ("illumina.single",),
    "genotype.snps_s": ("illumina.single",),
    "genotype.indels_s": ("illumina.single",),
    "meta.collapse_s": ("wastewater.meta",),
    "meta.events_s": ("wastewater.meta",),
    "meta.keys_s": ("wastewater.meta",),
    "meta.upload_s": ("wastewater.meta",),
    "meta.em_steps": ("wastewater.meta",),
    "batch.wait_s": ("illumina.plate",),
    "batch.worker_s": ("illumina.plate",),
}


def empty_trace(n_samples=2):
    return tracing.Trace(n_samples=n_samples, window_s=10.0,
                         spans=tracing.Spans(lambda: None), busy_s=0.0)


def rec(name, start_s, end_s, pid=1, **counts):
    return dict(name=name, start_ns=int(start_s * 1e9),
                end_ns=int(end_s * 1e9), id=(pid, 0), parent=None,
                thread=1, pid=pid, sample=0, counts=counts)


def test_manifest_lists_each_new_metric_for_its_cells():
    listed = {m["name"]: tuple(m["workloads"])
              for m in manifest.load()["per_layer"]}
    assert {m: listed.get(m) for m in NEW} == NEW


def test_readers_on_synthetic_records():
    t = empty_trace(n_samples=2)
    t.program_records = [
        rec("place.sketch", 0.0, 1.0), rec("place.sketch", 5.0, 8.0),
        rec("align.sw", 1.0, 1.5, deferred=40),
        rec("align.sw", 2.0, 2.5, device_scored=40, survivors=10),
        rec("meta.em", 3.0, 3.1, steps=30, rounds=1),
        rec("meta.em", 4.0, 4.1, steps=40, rounds=2),
        rec("batch.worker", 0.0, 2.0, pid=7),
        rec("batch.worker", 1.0, 4.0, pid=8)]
    read = {m: manifest.reader(m)(t) for m in NEW}
    assert read["place.sketch_s"] == pytest.approx(2.0)
    assert read["sw.survivor_pct"] == pytest.approx(25.0)
    assert read["meta.em_steps"] == pytest.approx(35.0)
    assert read["batch.worker_s"] == pytest.approx(2.5)  # both workers'
    assert {m for m, v in read.items() if v is not None} == {
        "place.sketch_s", "sw.survivor_pct", "meta.em_steps",
        "batch.worker_s"}


def test_readers_none_without_program_records(monkeypatch):
    from panmap_tpu_torch import trace

    trace.take()
    for m in NEW:
        assert manifest.reader(m)(empty_trace()) is None, m
    # a program from before its spans: no such module, no raise
    monkeypatch.setitem(sys.modules, "panmap_tpu_torch.trace", None)
    t = empty_trace()
    assert program.records(t) == []
    for m in NEW:
        assert manifest.reader(m)(t) is None, m


@pytest.mark.parametrize("name", ["illumina.single", "wastewater.meta",
                                  "illumina.plate"])
def test_a_tiny_traced_run_reports_the_new_metrics(tmp_path, name):
    out, res = small.run(small.tiny(name), tmp_path, trace=True)
    assert out["correct"], out["checks"]
    want = sorted(m for m, cells in NEW.items() if name in cells)
    got = out["metrics"]
    assert [m for m in want if m not in got] == []
    for m in want:
        assert got[m]["value"] >= 0, m
    if "sw.survivor_pct" in want:
        assert 0 < got["sw.survivor_pct"]["value"] <= 100
    # the window's records were taken once, by the first reader
    assert res["trace"].program_records
