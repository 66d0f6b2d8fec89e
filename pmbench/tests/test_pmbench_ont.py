"""The cell ont.single: its sample maker's truth, its per-layer metric
readers, and its correctness check at a tiny size on CPU tensors: a sound
run comes out correct; the control and each fault the cell can have,
planted in the program underneath the harness, come out not correct on
the number the fault names."""

import random

import numpy as np
import pytest
import torch

from pmbench import manifest, roofline, roofline_long, tracing
from pmbench.frozen import longreads as flong
from pmbench.modes import ont as ont_mode
from pmbench.reference import outputs as ref_out

from . import small

CELL = "ont.single"
READS = 150  # 800-1,000 bp on the tiny tree's 6 kb genomes: ~22x


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """B2's plain version runs thousands of small row ops, which intra-op
    threads only slow down, and stall when several test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny():
    cell = small.tiny(CELL)
    cell.traffic.update(reads=READS, read_len=[800, 1000])
    return cell


def checks(out):
    return {n: c["value"] for n, c in out["checks"].items()}


# ---- the sample maker ------------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_planted_rows_make_the_sample_genome(seed, tmp_path):
    """The large deletion, with every planted row it touches, written as
    one row: the rows applied to the source genome give the sample's."""
    rng = np.random.default_rng(seed)
    source = "".join("ACGT"[i] for i in rng.integers(0, 4, 6000))
    ls = flong._long_reads(rng, random.Random(seed), source,
                           str(tmp_path / "r.fastq"), 20, 800, 1000,
                           n_snp=60, n_ins=12, n_del=12)
    rows = ont_mode.planted_rows(source, ls)
    assert ref_out.apply_calls(source, [(None, *r) for r in rows]) == \
        ls.genome
    assert len(rows) <= len(ls.rows) + 1
    assert any(len(r) - len(a) >= ls.big_del[1] // 2 for _, r, a in rows)
    # each read's bases come from its start on the sample genome
    assert ls.junk.sum() == 1 and (ls.starts[ls.junk] == -1).all()
    assert (ls.starts[~ls.junk] + ls.lens[~ls.junk] <= len(ls.genome)).all()


# ---- the readers -----------------------------------------------------------

NEW = ("ont.front_s", "ont.dp_s", "ont.traceback_s", "ont.mapq_s",
       "ont.columns_s", "ont.indels_s", "ont.mapq_low_pct",
       "b2.roofline_pct")


def trace_of(records, launches=None, ops=()):
    t = tracing.Trace(n_samples=2, window_s=10.0,
                      spans=tracing.Spans(lambda: None), busy_s=0.0,
                      launches=launches or {}, device_ops=list(ops))
    t.program_records = records
    return t


def rec(name, start_s, end_s, **counts):
    return dict(name=name, start_ns=int(start_s * 1e9),
                end_ns=int(end_s * 1e9), id=(1, 0), parent=None, thread=1,
                pid=1, sample=0, counts=counts)


# the harness's spans and the card's trace, which the cell shares with others
SHARED = ("align.s", "genotype.s", "device.idle_pct", "device.kernel_ms")


def test_manifest_lists_the_cell_and_its_metrics():
    bench = manifest.load()
    cell = manifest.cell(bench, CELL)
    assert cell.chips == 1 and cell.traffic["mode"] == "ont"
    assert {m["name"] for m in cell.end_to_end} == {"sample_s", "setup_s"}
    assert sorted(m["name"] for m in cell.per_layer) == sorted(NEW + SHARED)
    for m in cell.per_layer:
        assert m["moves"] == "sample_s"
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]
        else:
            assert CELL in m["workloads"] and len(m["workloads"]) > 1


def test_readers_on_synthetic_records():
    t = trace_of([rec("align.front", 0.0, 3.0), rec("align.dp", 3.0, 3.5),
                  rec("align.traceback", 3.5, 4.5),
                  rec("align.mapq", 4.5, 4.6, mapped=990, mapq_low=3),
                  rec("align.mapq", 9.0, 9.2, mapped=10, mapq_low=2),
                  rec("genotype.columns", 5.0, 6.0),
                  rec("genotype.indels", 6.0, 16.0)])
    read = {m: manifest.reader(m)(t) for m in NEW}
    assert read["ont.front_s"] == pytest.approx(1.5)
    assert read["ont.mapq_s"] == pytest.approx(0.15)
    assert read["ont.indels_s"] == pytest.approx(5.0)
    assert read["ont.mapq_low_pct"] == pytest.approx(0.5)
    assert read["b2.roofline_pct"] is None  # no launch, no kernel event


def test_readers_none_without_records():
    t = trace_of([])
    for m in NEW:
        assert manifest.reader(m)(t) is None, m


def test_b2_roofline_share():
    lq = np.array([1000, 1400])
    w = np.array([1201, 1264])
    cells = 1000 * 1201 + 1400 * 1264
    want = cells * roofline_long.LONG_OPS_PER_CELL / roofline.INT32_OPS_PER_S
    assert roofline_long.long_bound_s(lq, w) == pytest.approx(want)
    launches = {"banded_long": [(lq, w), (lq[:1], w[:1])]}
    ops = [("void banded_long_kernel<8>(...)", 0.0, 0.004),
           ("void banded_long_kernel<8>(...)", 1.0, 1.004),
           ("Memcpy DtoH", 2.0, 3.0)]
    got = manifest.reader("b2.roofline_pct")(trace_of([], launches, ops))
    bound = (roofline_long.long_bound_s(lq, w)
             + roofline_long.long_bound_s(lq[:1], w[:1]))
    assert got == pytest.approx(100 * bound / 0.008)
    # a launch whose kernel event is missing reads nothing
    assert manifest.reader("b2.roofline_pct")(
        trace_of([], launches, ops[:1])) is None


# ---- the runs --------------------------------------------------------------

def test_sound_run_is_correct(tmp_path):
    out, res = small.run(tiny(), tmp_path)
    assert out["correct"], out["checks"]
    assert res["n"] >= 1 and res["failed"] == 0
    info = res["info"]
    assert info["reads_mapped"] >= 0.9 * READS
    assert info["long_dp_items_checked"] == info["secondary_scores_checked"]
    assert info["long_dp_items_checked"] >= 0.9 * READS
    assert checks(out)["mapq_low_share"] == 0.0


def test_a_tiny_traced_run_reports_the_harness_spans(tmp_path):
    """The mode's harness spans "align" and "genotype" read in a traced
    run; the card's trace, which device.idle_pct and device.kernel_ms read,
    has no device operation on the CPU, so those two read on the card
    only."""
    out, res = small.run(tiny(), tmp_path, trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert got["align.s"]["value"] > 0 and got["genotype.s"]["value"] > 0
    assert got["ont.front_s"]["value"] <= got["align.s"]["value"]
    assert res["trace"].device_ops == []
    assert "device.idle_pct" not in got and "device.kernel_ms" not in got


def test_control_is_not_correct(tmp_path):
    out, _ = small.run(tiny(), tmp_path, control=True)
    assert not out["correct"], out["checks"]
    assert checks(out)["place_score_rel_gap"] > 1e-9


def old_secondary(monkeypatch):
    """The secondary score the JAX package takes: the best f of an anchor
    off the best chain, which an anchor beside it nearly always reaches
    (here a chain over the best chain's anchors, so that it overlaps
    it)."""
    from panmap_tpu_torch.align import longread

    orig = longread.chain_dp

    def run(qv, rv, k, max_gap, *a, h=50):
        best, idx, chains = orig(qv, rv, k, max_gap, *a, h=h)
        order = np.lexsort((qv, rv))
        q, r = qv[order].astype(np.int64), rv[order].astype(np.int64)
        f = np.full(len(q), float(k))
        for j in range(1, len(q)):
            i0 = max(0, j - h)
            dq, dr = q[j] - q[i0:j], r[j] - r[i0:j]
            ok = (dq > 0) & (dr > 0) & (np.maximum(dq, dr) < max_gap)
            dd = np.abs(dr - dq)
            pen = np.where(dd > 0, 0.01 * k * dd
                           + 0.5 * np.log2(np.maximum(dd, 2)), 0.0)
            cand = np.where(ok, f[i0:j] + np.minimum(np.minimum(dq, dr), k)
                            - pen, -np.inf)
            f[j] = max(f[j], cand.max())
        off = ~np.isin(order, idx)  # in (r, q) order
        if off.any():
            chains = chains + [(float(f[off].max()), idx)]
        return best, idx, chains

    monkeypatch.setattr(longread, "chain_dp", run)


def flipped_byte(monkeypatch):
    """An answer altered where it is produced: one direction byte of B2's
    first item, in its first row and column."""
    from panmap_tpu_torch.align import long_dp

    orig = long_dp.long_dp_rows_reference

    def run(*a):
        dirs, stats = orig(*a)
        dirs[0, 0, 0] ^= 64
        return dirs, stats

    monkeypatch.setattr(long_dp, "long_dp_rows_reference", run)


def junk_mapped(monkeypatch):
    """The reads the aligner leaves unmapped (the junk reads among them)
    reported mapped, over their own length from the reference's start."""
    from panmap_tpu_torch.align.core import Alignment
    from panmap_tpu_torch.align.longread import TorchLongReadAligner

    orig = TorchLongReadAligner.align_batch

    def run(self, seqs):
        out = orig(self, seqs)
        return [a if a.mapped else Alignment(
            mapped=True, rs=0, re=len(s), qs=0, qe=len(s), mapq=60,
            score=2 * len(s), cigar=[(len(s), "M")])
            for a, s in zip(out, seqs)]

    monkeypatch.setattr(TorchLongReadAligner, "align_batch", run)


def shifted(monkeypatch):
    """One mapped read in a hundred moved 2 kb along the reference."""
    from panmap_tpu_torch.align.longread import LongReadAligner

    orig = LongReadAligner._finish
    seen = []

    def run(self, dp, meta):
        aln = orig(self, dp, meta)
        if aln.mapped:
            if len(seen) % 100 == 0:
                step = 2000 if aln.re + 2000 <= self.index.n else -2000
                aln.rs, aln.re = aln.rs + step, aln.re + step
            seen.append(aln)
        return aln

    monkeypatch.setattr(LongReadAligner, "_finish", run)


def snp_dropped(monkeypatch):
    """An answer altered where it is produced: the first SNP call left out
    of the VCF and the consensus."""
    from panmap_tpu_torch import pipeline

    orig = pipeline.apply_spectrum

    def run(*a):
        recs = list(orig(*a))
        snps = [i for i, r in enumerate(recs)
                if len(r.ref) == 1 and 0 < r.gt <= len(r.alts)
                and len(r.alts[r.gt - 1]) == 1]
        return [r for i, r in enumerate(recs) if i != snps[0]] if snps \
            else recs

    monkeypatch.setattr(pipeline, "apply_spectrum", run)


FAULTS = [
    (old_secondary, ("mapq_low_share", "secondary_score_differing")),
    (flipped_byte, ("long_dp_items_differing",)),
    (junk_mapped, ("junk_reads_mapped",)),
    (shifted, ("reads_off_origin",)),
    (snp_dropped, ("snps_missed",)),
]


@pytest.mark.parametrize("fault,numbers", FAULTS,
                         ids=[f.__name__ for f, _ in FAULTS])
def test_fault_is_not_correct(fault, numbers, tmp_path, monkeypatch):
    fault(monkeypatch)
    out, _ = small.run(tiny(), tmp_path)
    assert not out["correct"]
    for number in numbers:
        got, limit = (out["checks"][number]["value"],
                      out["checks"][number]["limit"])
        assert got is None or got > limit, (number, out["checks"])
