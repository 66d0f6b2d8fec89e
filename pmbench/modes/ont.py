"""Mode "ont": a Nanopore isolate a CLI call, single-end long reads whose
mean length selects map-ont.  Placement and the consensus are checked as
for the short-read isolates; besides, every read's alignment (junk reads
unmapped, each other read near where it came from, its mapq), and, for
the first pass over the inputs, B2's launches against
reference/long_dp.py and each read's secondary chain score against
reference/chains.py."""

from __future__ import annotations

import os
import random

import numpy as np

from pmbench.frozen import longreads as flong
from pmbench.isolates import Isolates
from pmbench.mode import Sample
from pmbench.reference import chains as ref_chains
from pmbench.reference import long_dp as ref_long_dp
from pmbench.reference import outputs as ref_out

MAPQ_LOW = 20  # below it a read counts as placed with little confidence


def planted_rows(source: str, ls: flong.LongSample) -> list:
    """The sample's mutations against ``source`` as (1-based position,
    ref, alt) rows, sorted: simulate_mutations' rows, with the large
    deletion and every row that touches it written as one row."""
    spans, at = [], 0  # each row's span on the mutated genome
    for pos1, ref, alt in ls.rows:
        a = pos1 - 1 + at
        spans.append((a, a + len(alt)))
        at += len(alt) - len(ref)
    p, d = ls.big_del
    lo, hi = p, p + d
    merged, grew = set(), True
    while grew:  # a merged row can widen the span onto another
        grew = False
        for n, (a, b) in enumerate(spans):
            if n not in merged and a <= hi and lo <= b:
                merged.add(n)
                lo, hi, grew = min(lo, a), max(hi, b), True

    def source_pos(x):  # position on ``source`` of mutated-genome base x
        return x - sum(len(alt) - len(ref) for (pos1, ref, alt), (a, b)
                       in zip(ls.rows, spans) if b <= x)

    oa, ob = source_pos(lo), source_pos(hi)
    alt = ls.small[lo:p] + ls.small[p + d:hi]
    rows = [r for n, r in enumerate(ls.rows) if n not in merged]
    rows.append((oa, source[oa - 1:ob], source[oa - 1] + alt))
    return sorted(rows)


class Ont(Isolates):

    def make_inputs(self):
        t = self.traffic
        rng = self.rng(1)
        self.inputs = []
        for j in range(t["inputs"]):
            leaf = self.leaves[int(rng.integers(len(self.leaves)))]
            source = self.model.get_string(leaf)
            path = os.path.join(self.work, f"in{j}.fastq")
            ls = flong._long_reads(
                rng, random.Random(int(rng.integers(1 << 62))), source, path,
                t["reads"], *t["read_len"], t["error"], t["junk_share"],
                t["snps"], t["insertions"], t["deletions"],
                tuple(t["indel_len"]), tuple(t["big_del"]))
            rows = planted_rows(source, ls)
            if ref_out.apply_calls(source, [(None, *r) for r in rows]) \
                    != ls.genome:
                raise AssertionError("the planted rows do not make the "
                                     "sample's genome")
            with open(path) as fh:
                seqs = fh.read().split("\n")[1::4]
            # reads padded to one length with code 4, which reads as N
            codes = np.full((len(seqs), max(map(len, seqs))), 4, np.uint8)
            for i, s in enumerate(seqs):
                codes[i, :len(s)] = np.searchsorted(
                    np.frombuffer(b"ACGT", np.uint8),
                    np.frombuffer(s.encode(), np.uint8))
            s = Sample(f"in{j}", path, "", (leaf,), ls.genome, rows, codes,
                       codes[:0])
            self.inputs.append((s, ls))

    def install(self, spans=None, launches=None):
        super().install(spans, launches)
        from panmap_tpu_torch.align import long_dp
        from panmap_tpu_torch.align.longread import (LongReadAligner,
                                                     TorchLongReadAligner)

        self.aligned = None
        self.hits = None

        def rows(fn):
            def run(q, ref, meta, pre, width):
                out = fn(q, ref, meta, pre, width)
                if launches is not None or self.deep is not None:
                    m = meta.cpu().numpy()  # the program waits here too
                    if launches is not None:
                        launches.setdefault("banded_long", []).append(
                            (m[:, 0].astype(np.int64),
                             m[:, 2].astype(np.int64)))
                    if self.deep is not None:
                        scores = (pre.match, pre.mismatch, pre.gap_open,
                                  pre.gap_ext, pre.gap_open2, pre.gap_ext2)
                        self.captured.append(
                            ("long_dp", (q, ref, meta, scores, width), out))
                return out
            return run

        def anchors(fn):
            def run(aligner, codes2):
                got = fn(aligner, codes2)
                if self.deep is not None:
                    self.hits = got
                return got
            return run

        def front(fn):
            def run(aligner, seq):
                self.hits = None
                got = fn(aligner, seq)
                if self.deep is not None and got is not None \
                        and self.hits is not None:
                    self.captured.append(("front", (
                        self.hits, len(seq), aligner.pre), got[3]))
                return got
            return run

        def aligned(fn):
            def run(aligner, seqs):
                out = fn(aligner, seqs)
                self.aligned = out
                return out
            return run

        self.patches.replace(long_dp, "long_dp_rows", rows)
        # a program whose front end has no _anchors step gives no anchors,
        # and its secondary scores are not compared
        if hasattr(LongReadAligner, "_anchors"):
            self.patches.replace(LongReadAligner, "_anchors", anchors)
        self.patches.replace(LongReadAligner, "_chain_front", front)
        self.patches.replace(TorchLongReadAligner, "align_batch", aligned)

    def run_one(self, i) -> tuple:
        j = i % len(self.inputs)
        s, ls = self.inputs[j]
        prefix = os.path.join(self.out, f"slot{j}")
        self.deep = j if 0 <= i < len(self.inputs) else None
        self.aligned = None
        try:
            rc = self.cli([self.panman, s.r1, "-o", prefix])
        finally:
            self.deep = None
        self.collect(s, prefix, rc)
        self.records[-1].update(truth=ls, alns=self.aligned)
        return 1, int(rc != 0)

    def check(self):
        from pmbench import isolates

        # Isolates.check reads a sample's reads through ACGT[codes]: for the
        # long reads' padding, code 4, it reads N, which starts no seed
        self.patches.replace(isolates, "ACGT", lambda _: np.frombuffer(
            b"ACGTN", np.uint8))
        try:
            out = super().check()
        finally:
            self.patches.undo()
        junk_mapped = off = low = mapped = 0
        for rec in self.records:
            ls, alns = rec["truth"], rec["alns"]
            if alns is None:
                continue
            genome = None
            if rec["consensus"] is not None:
                node = rec["consensus"][0].rsplit("ref=", 1)[-1]
                genome = self.model.get_string(node)
            same = genome == self.model.get_string(rec["sample"].leaves[0])
            tol = ls.big_del[1] + sum(abs(len(r) - len(a))
                                      for _, r, a in ls.rows)
            for a, junk, s0, n in zip(alns, ls.junk, ls.starts, ls.lens):
                if not a.mapped:
                    continue
                if junk:
                    junk_mapped += 1
                    continue
                mapped += 1
                low += a.mapq < MAPQ_LOW
                off += not (same and a.rs >= s0 - tol
                            and a.re <= s0 + n + tol)
        dp_bad = dp_items = sec_bad = sec_reads = 0
        for kind, args, got in self.captured:
            if kind == "long_dp":
                want = ref_long_dp.long_dp_rows(*args)
                bad = ((want[0] != got[0]).flatten(1).any(1)
                       | (want[1] != got[1]).flatten(1).any(1))
                dp_bad += int(bad.sum())
                dp_items += len(bad)
            elif kind == "front":
                (hits, lq, pre), meta = args, got
                want = ref_chains.secondary_score(
                    *hits, lq, pre.k, pre.max_gap, pre.min_cnt,
                    pre.min_chain_score)
                sec_bad += want is None or want[1] != meta[4]
                sec_reads += 1
        self.info.update(reads_mapped=mapped, long_dp_items_checked=dp_items,
                         secondary_scores_checked=sec_reads)
        lim = self.traffic["limits"]
        return out + [
            ("long_dp_items_differing", dp_bad if dp_items else None, 0),
            ("junk_reads_mapped", junk_mapped, 0),
            ("reads_off_origin", off, 0),
            ("mapq_low_share", low / mapped if mapped else None,
             lim["mapq_low_share"]),
            ("secondary_score_differing", sec_bad if sec_reads else None,
             0)]


MODE = Ont
