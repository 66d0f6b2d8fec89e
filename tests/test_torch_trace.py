"""The port's spans (panmap_tpu_torch/trace.py): on exactly while a
torch.profiler session records in the process, off (one check, a shared
no-op, no profiler range, nothing kept) otherwise.

 - trace.py alone: the off path, parents across a with-nest, a helper
   thread under carry(), a task under resumed(), take() and adopt();
 - the CLI on CPU tensors, in a process of its own (the --batch pool forks,
   and this process has jax loaded): a single sample, a --meta sample and a
   two-sample --batch through two forked workers, each under torch.profiler.
   The span tree holds the stages' names and parents, the counts equal what
   the stages returned (reads, read sets, EM steps, the SW stage's
   pallas_stats, the index rows, the scorer's hashes, events and upload),
   the workers' spans arrive in the parent under their sample's span, and
   the profile holds a "panmap:" range for each span of the profiling
   thread;
 - --meta --profile DIR writes a trace that names the meta stages;
 - the same three calls with no profiler and the profiler's range types
   made to raise: nothing is kept and nothing raises.
"""

import json
import os
import subprocess
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from panmap_tpu_torch import trace
from panmap_tpu_torch.native import get_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- trace.py on its own --------------------------------------------------

def test_off_is_a_shared_no_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range opened with tracing off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    trace.take()
    a, b = trace.span("x", n=1), trace.span("y")
    assert a is b
    with a as sp:
        sp.count("k", 3)
        trace.count("k", 1)
    assert trace.here() is None
    fn = lambda: 1  # noqa: E731
    assert trace.carry(fn) is fn
    assert trace.take() == []


def test_spans_nest_and_count_under_a_profiler():
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("outer", rows=2) as sp:
            sp.count("rows", 3)
            with trace.span("inner"):
                trace.count("hits", 5)
            with trace.span("task", sample=4):
                ctx = trace.here()
            box = {}

            def work():
                with trace.span("helper"):
                    box["thread"] = threading.get_native_id()

            th = threading.Thread(target=trace.carry(work))
            th.start()
            th.join()
    recs = {r["name"]: r for r in trace.take()}
    assert trace.take() == []
    outer = recs["outer"]
    assert outer["parent"] is None and outer["sample"] == 0
    assert outer["counts"] == {"rows": 5}
    assert outer["pid"] == os.getpid()
    assert outer["start_ns"] <= recs["inner"]["start_ns"] \
        <= recs["inner"]["end_ns"] <= outer["end_ns"]
    assert recs["inner"]["parent"] == outer["id"]
    assert recs["inner"]["counts"] == {"hits": 5}
    assert recs["task"]["sample"] == 4 and ctx == (recs["task"]["id"], 4)
    # the helper thread's span: kept, under the span that started it, and
    # no range (the profiler records its own thread only)
    assert recs["helper"]["parent"] == outer["id"]
    assert recs["helper"]["thread"] == box["thread"] != outer["thread"]
    names = {e.name for e in prof.events() if e.name.startswith("panmap:")}
    assert names == {"panmap:outer", "panmap:inner", "panmap:task"}


def test_a_resumed_task_and_adopt():
    trace.take()
    with trace.resumed(((123, 7), 2)):
        with trace.span("batch.worker"):
            pass
    (rec,) = trace.take()
    assert rec["parent"] == (123, 7) and rec["sample"] == 2
    trace.adopt([rec])
    assert trace.take() == [rec]
    with trace.resumed(None):  # off stays off
        assert trace.span("x") is trace.span("y")


# ---- the CLI on CPU tensors, in a process of its own ----------------------

_CALLS = r"""
import json, os, re, sys
import torch
from torch.profiler import ProfilerActivity, profile

from panmap_tpu_torch import pipeline as tp, trace
from panmap_tpu_torch.__main__ import main
from panmap_tpu_torch.align import batch as abatch
from panmap_tpu_torch.align import longread
from panmap_tpu_torch.io.index_io import save_index
from panmap_tpu_torch.meta import driver as md
from panmap_tpu_torch.meta.index import save_meta_index
from panmap_tpu_torch.synthetic import (make_long_workload,
                                        make_meta_workload, make_workload)
from panmap_tpu_torch.utils import device

out, mode = sys.argv[1], sys.argv[2]
cpu = torch.device("cpu")
device.cuda_device = lambda index=0: cpu
panman = os.path.join(out, "x.panman")
open(panman, "wb").close()
os.utime(panman, (0, 0))  # older than the saved indexes: they are loaded
w = make_workload(os.path.join(out, "reads"), seed=2, n_nodes=40,
                  genome_len=30000, n_pairs=300)
idx_path = os.path.join(out, "x.ptidx.npz")
save_index(idx_path, w.idx)
lw = make_long_workload(os.path.join(out, "long_reads"), seed=2, n_reads=12,
                        n_nodes=40, genome_len=4000, len_lo=600, len_hi=900)
long_panman = os.path.join(out, "long.panman")
open(long_panman, "wb").close()
os.utime(long_panman, (0, 0))
long_idx = os.path.join(out, "long.ptidx.npz")
save_index(long_idx, lw.idx)
trees = {panman: w.tree, long_panman: lw.tree}
tp.load_panman = lambda path: trees[path]
mw = make_meta_workload(os.path.join(out, "meta_reads"), seed=2, n_nodes=200,
                        genome_len=5000, n_pairs=1300)
midx_path = os.path.join(out, "x.ptmidx.npz")
save_meta_index(midx_path, mw.midx)
manifest = os.path.join(out, "manifest.txt")
with open(manifest, "w") as fh:
    for name in ("batch_a", "batch_b"):
        fh.write(f"{w.reads1} {w.reads2} {os.path.join(out, name)}\n")

seen = {"pallas_stats": [], "sketch": [], "run_em": [], "make_scorers": [],
        "long": []}


class Aligner(abatch.TorchBatchAligner):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        seen["pallas_stats"].append(self.pallas_stats)


def keep(name, pick):
    fn = getattr(md, name)

    def run(*a, **k):
        res = fn(*a, **k)
        seen[name].append(pick(res))
        return res

    setattr(md, name, run)


abatch.TorchBatchAligner = Aligner
long_batch = longread.TorchLongReadAligner.align_batch


def long_align(self, seqs):
    res = long_batch(self, seqs)
    mapq = [a.mapq for a in res if a.mapped]
    seen["long"].append([len(mapq), sum(m < 20 for m in mapq)])
    return res


longread.TorchLongReadAligner.align_batch = long_align
keep("sketch", lambda res: len(res[0]))
keep("run_em", lambda res: res.n_iterations)


# the device scorer's read hashes, events and delta rows, and the bytes of
# the inputs its build uploads: the delta rows' seed id (int32) and deletion
# flag, the seed table's hash (int64) and orientation, the node offsets and
# subtree ends (int64), each read occurrence's hash and orientation, each
# read's count (int64)
def scorer_counts(res):
    fast = res[1]
    m = fast.midx
    n, occ = len(m.node_ids), sum(len(r.hashes) for r in fast.reads)
    upload = (5 * len(m.delta_seed) + 9 * len(m.seed_hash)
              + 8 * (2 * n + 1) + 9 * occ + 8 * len(fast.reads))
    return [fast.U, len(fast.ev_pos), len(m.delta_seed), upload]


keep("make_scorers", scorer_counts)

if mode == "off":
    def refuse(*a, **k):
        raise RuntimeError("a profiler range opened with tracing off")

    torch._C._profiler._RecordFunctionFast = refuse
    torch.profiler.record_function = refuse
    torch.autograd.profiler.record_function = refuse

calls = {
    "single": [panman, w.reads1, w.reads2, "-i", idx_path,
               "-o", os.path.join(out, "sample"), "-q"],
    "meta": [panman, mw.reads1, mw.reads2, "--meta", "-i", midx_path,
             "-o", os.path.join(out, "meta"), "-q"],
    "batch": [panman, "--batch", manifest, "-i", idx_path, "-t", "2", "-q"],
    "long": [long_panman, lw.reads1, "-i", long_idx,
             "-o", os.path.join(out, "long"), "-q"],
}
got = {"pid": os.getpid(), "index_rows": len(w.idx.seed_hashes)}
trace.take()
for name, argv in calls.items():
    if mode == "on":
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            rc = main(argv)
        # the long call's plain DP makes tens of thousands of events, which
        # take the profiler half a minute to hand over: its records only
        ranges = [] if name == "long" else sorted(
            {e.name for e in prof.events() if e.name.startswith("panmap:")})
    else:
        rc, ranges = main(argv), []
    got[name] = {"rc": rc, "records": trace.take(), "ranges": ranges}
if mode == "on":  # --profile DIR on --meta: the CLI's own profiler session
    pdir = os.path.join(out, "meta_profile")
    rc = main([panman, mw.reads1, mw.reads2, "--meta", "-i", midx_path,
               "-o", os.path.join(out, "meta_p"), "--profile", pdir, "-q"])
    (name,) = os.listdir(pdir)
    with open(os.path.join(pdir, name)) as fh:
        text = fh.read()
    got["meta_profile"] = {"rc": rc, "ranges": sorted(set(
        re.findall(r'"(panmap:[a-z_.]+)"', text)))}
    trace.take()
got["seen"] = seen


def n_reads(*paths):
    return sum(sum(1 for _ in open(p)) // 4 for p in paths)


got["fastq_reads"] = n_reads(w.reads1, w.reads2)
got["meta_reads"] = n_reads(mw.reads1, mw.reads2)
print(json.dumps(got))
"""


def _calls(tmp_path, mode):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _CALLS, str(tmp_path), mode],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for name in ("single", "meta", "batch", "long"):
        assert got[name]["rc"] == 0, name
        for r in got[name]["records"]:
            r["id"] = tuple(r["id"])
            r["parent"] = tuple(r["parent"]) if r["parent"] else None
    return got


def _by_name(records):
    out = {}
    for r in records:
        out.setdefault(r["name"], []).append(r)
    return out


def _one(by, name):
    (rec,) = by[name]
    return rec


def _ranges_of_profiling_thread(records, pid):
    """The "panmap:" names the profile should hold: every span of the
    process's profiling thread (helper threads and workers open none)."""
    main_thread = {r["thread"] for r in records
                   if r["name"] == "run" and r["pid"] == pid}
    return sorted({"panmap:" + r["name"] for r in records
                   if r["pid"] == pid and r["thread"] in main_thread})


needs_native = pytest.mark.skipif(get_lib() is None,
                                  reason="native library unavailable")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    return _calls(tmp_path_factory.mktemp("traced"), "on")


@needs_native
def test_single_sample_span_tree_and_counts(traced):
    recs = traced["single"]["records"]
    by = _by_name(recs)
    run = _one(by, "run")
    assert run["parent"] is None
    under_run = ("index.read", "tree.load", "place.sketch", "place.upload",
                 "place.select", "place.fetch", "place.rescue", "place.write",
                 "align", "genotype", "align.bam_wait", "consensus")
    for name in under_run:
        for r in by[name]:
            assert r["parent"] == run["id"], name
    for name in ("genotype.columns", "genotype.snps", "genotype.indels",
                 "genotype.vcf"):
        assert all(r["parent"] == _one(by, "genotype")["id"]
                   for r in by[name]), name
    assert all(r["parent"] == _one(by, "align")["id"] for r in by["align.sw"])
    assert {r["sample"] for r in recs} == {0}
    assert {r["pid"] for r in recs} == {traced["pid"]}
    assert _one(by, "tree.load")["thread"] != run["thread"]
    # the counts are the stages' own numbers
    sketch = _one(by, "place.sketch")["counts"]
    assert sketch["reads"] == traced["fastq_reads"] and sketch["seeds"] > 0
    assert _one(by, "place.upload")["counts"] == {
        "rows": traced["index_rows"]}
    rescue = _one(by, "place.rescue")["counts"]
    assert rescue["candidates"] >= 1 and rescue["witnesses"] >= 0
    (stats,) = traced["seen"]["pallas_stats"][:1]
    sw = {}
    for r in by["align.sw"]:
        for k, v in r["counts"].items():
            sw[k] = sw.get(k, 0) + v
    assert sw == stats and stats["device_scored"] > 0
    assert sum(r["counts"].get("columns", 0)
               for r in by["genotype.columns"]) > 0
    assert _one(by, "genotype.snps")["counts"]["columns_called"] >= 0
    indels = _one(by, "genotype.indels")["counts"]
    assert set(indels) == {"sites", "jobs", "threads"}
    # one native call over the candidates, on the library's default threads
    assert indels["threads"] == min(os.cpu_count() or 1, 16)
    assert indels["sites"] > 0 and indels["jobs"] > 0
    assert traced["single"]["ranges"] == _ranges_of_profiling_thread(
        recs, traced["pid"])
    assert "panmap:place.sketch" in traced["single"]["ranges"]


@needs_native
def test_meta_span_tree_and_counts(traced):
    recs = traced["meta"]["records"]
    by = _by_name(recs)
    run = _one(by, "run")
    for name in ("index.read", "meta.sketch", "meta.collapse", "meta.events",
                 "meta.keys", "meta.upload", "meta.rank", "meta.score",
                 "meta.em"):
        assert _one(by, name)["parent"] == run["id"], name
    # the --meta call's (the --profile call after it adds its own)
    read_sets = traced["seen"]["sketch"][0]
    steps = traced["seen"]["run_em"][0]
    hashes, events, rows, upload = traced["seen"]["make_scorers"][0]
    sketch = _one(by, "meta.sketch")["counts"]
    assert sketch == {"reads": traced["meta_reads"], "read_sets": read_sets}
    em = _one(by, "meta.em")["counts"]
    assert em["steps"] == steps > 0 and 1 <= em["rounds"] <= 5
    score = _one(by, "meta.score")["counts"]
    assert score["device"] == 1 and score["candidates"] > 0
    assert _one(by, "meta.events")["counts"] == {
        "read_hashes": hashes, "events": events, "steps": 2 * rows}
    assert rows > 0 and events > 0
    assert _one(by, "meta.upload")["counts"] == {"bytes": upload}
    assert traced["meta"]["ranges"] == _ranges_of_profiling_thread(
        recs, traced["pid"])
    assert "panmap:meta.events" in traced["meta"]["ranges"]


@needs_native
def test_batch_workers_spans_arrive_under_their_sample(traced):
    recs = traced["batch"]["records"]
    pid = traced["pid"]
    mine = _by_name([r for r in recs if r["pid"] == pid])
    theirs = [r for r in recs if r["pid"] != pid]
    run = _one(mine, "run")
    for name in ("index.read", "tree.load", "batch.fork", "place.upload",
                 "batch.join"):
        assert _one(mine, name)["parent"] == run["id"], name
    samples = {r["id"]: r for r in mine["batch.sample"]}
    assert sorted(r["sample"] for r in samples.values()) == [1, 1, 2, 2]
    assert all(r["parent"] == run["id"] for r in samples.values())
    for name in ("place.sketch", "place.select", "place.fetch",
                 "place.rescue", "place.write"):
        assert sorted(r["sample"] for r in mine[name]) == [1, 2], name
        assert all(r["parent"] in samples for r in mine[name]), name
    assert sorted(r["sample"] for r in mine["batch.wait"]) == [1, 2]
    workers = _by_name(theirs)
    assert len(workers["batch.worker"]) == 2
    assert len({r["pid"] for r in theirs}) >= 1
    for w in workers["batch.worker"]:
        parent = samples[w["parent"]]
        assert parent["sample"] == w["sample"]
        kids = [r for r in theirs if r["parent"] == w["id"]]
        assert {r["name"] for r in kids} == {"align", "genotype",
                                              "consensus"}
        assert {r["sample"] for r in kids} == {w["sample"]}
    assert "align.sw" not in workers  # no device in a worker
    # a worker's realignment takes one thread: the pool fills the cores
    assert len(workers["genotype.indels"]) == 2
    for r in workers["genotype.indels"]:
        assert r["counts"]["threads"] == 1
        assert {"sites", "jobs"} <= set(r["counts"])
    assert traced["batch"]["ranges"] == _ranges_of_profiling_thread(
        recs, pid)
    assert "panmap:batch.wait" in traced["batch"]["ranges"]


@needs_native
def test_long_read_span_tree_and_counts(traced):
    recs = traced["long"]["records"]
    by = _by_name(recs)
    align = _one(by, "align")
    assert align["parent"] == _one(by, "run")["id"]
    for name in ("align.front", "align.dp", "align.traceback",
                 "align.mapq"):
        assert by[name] and all(r["parent"] == align["id"]
                                for r in by[name]), name
    # the mapq stage follows the DP's launches, and counts what it made
    mapq = _one(by, "align.mapq")
    assert mapq["start_ns"] >= max(r["end_ns"] for r in by["align.dp"])
    (mapped, low), = traced["seen"]["long"]
    assert mapq["counts"] == {"mapped": mapped, "mapq_low": low}
    assert mapped >= 10
    indels = _one(by, "genotype.indels")["counts"]
    assert set(indels) == {"sites", "jobs", "threads"}
    assert indels["sites"] > 0 and indels["jobs"] > 0


@needs_native
def test_untraced_calls_keep_nothing_and_open_no_range(tmp_path):
    got = _calls(tmp_path, "off")
    for name in ("single", "meta", "batch", "long"):
        assert got[name]["records"] == [], name


@needs_native
def test_meta_profile_trace_names_the_meta_stages(traced):
    got = traced["meta_profile"]
    assert got["rc"] == 0
    assert {"panmap:run", "panmap:meta.sketch", "panmap:meta.events",
            "panmap:meta.em"} <= set(got["ranges"])
