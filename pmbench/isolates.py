"""Shared by the "single" and "plate" modes: isolates placed, aligned,
genotyped and written as a consensus, checked against the tree and the
truth the generator planted."""

from __future__ import annotations

import os

import numpy as np

from .mode import ACGT, Mode, fasta
from .reference import outputs as ref_out
from .reference import placement as ref_place
from .reference import seeds as ref_seeds


class Isolates(Mode):

    def span_targets(self):
        from panmap_tpu_torch import pipeline

        return [(pipeline, "ensure_index", "index_load", True),
                (pipeline, "run_placement", "place", True),
                (pipeline, "run_alignment", "align", True),
                (pipeline, "run_genotyping", "genotype", True),
                (pipeline, "run_consensus", "consensus", True)]

    def install(self, spans=None, launches=None):
        from panmap_tpu_torch import pipeline
        from panmap_tpu_torch.align import sw
        from panmap_tpu_torch.genotype import caller

        self.placed = {}

        def finish(fn):
            def run(cfg, idx, res, n_reads):
                out = fn(cfg, idx, res, n_reads)
                names = idx.node_ids
                self.placed[cfg.output] = {
                    m: (None if res.best_index[m] is None
                        else names[res.best_index[m]], res.best_score[m],
                        [names[i] for i in res.tied_indices[m]])
                    for m in ref_place.METRICS}
                return out
            return run

        def sw_capture(fn):
            def run(q, r, qlens):
                out = fn(q, r, qlens)
                if launches is not None:
                    launches.setdefault("banded_sw", []).append(
                        tuple(q.shape) + (r.shape[1],))
                if self.deep is not None:
                    self.captured.append(("sw", (q, r, qlens), out))
                return out
            return run

        def tally_capture(fn):
            def run(*args):
                out = fn(*args)
                if self.deep is not None:
                    self.captured.append(("tally", args[:5], out))
                return out
            return run

        self.patches.replace(pipeline, "_finish_placement", finish)
        self.patches.replace(sw, "banded_sw_scores", sw_capture)
        self.patches.replace(caller, "tally_columns_device", tally_capture)
        for module, fn, label, sync in (self.span_targets() if spans
                                        else ()):
            self.patches.replace(module, fn, spans.wrapper(label, sync))

    def collect(self, sample, prefix, rc):
        cons, vcf = prefix + ".consensus.fa", prefix + ".vcf"
        ok = rc == 0 and os.path.exists(cons) and os.path.exists(vcf)
        self.records.append(dict(
            sample=sample, placed=self.placed.pop(prefix, None),
            consensus=fasta(cons) if ok else None,
            calls=ref_out.vcf_calls(vcf) if ok else None))

    def check(self):
        seedargs, flank = self.seedargs()
        k = seedargs[0]
        genomes, counts, fixed, tables = {}, {}, {}, {}

        def genome(n):
            if n not in genomes:
                genomes[n] = self.model.get_string(n)
            return genomes[n]

        def seeds(n):
            if n not in counts:
                counts[n] = ref_seeds.genome_seed_counts(genome(n), *seedargs,
                                                         flank)
            return counts[n]

        def is_fixed(n):
            if n not in fixed:
                fixed[n] = ref_place.mask_fixed(self.model, n, flank)
            return fixed[n]

        root = seeds(self.model.names[0])
        gap = below = 0.0
        off = skipped = missing = differing = 0
        snps = indels = planted = 0
        for rec in self.records:
            s = rec["sample"]
            src = s.leaves[0]
            n_indels = sum(len(r) != len(a) for _, r, a in s.rows)
            planted += n_indels
            if rec["placed"] is None or rec["consensus"] is None:
                off += 1
                missing = max(missing, ref_out.missing_tiles("", s.genome,
                                                             s.rows))
                snps += len(s.rows) - n_indels
                indels += n_indels
                continue
            if s.name not in tables:
                reads = ACGT[np.concatenate([s.c1, s.c2])]
                h, c = ref_seeds.read_seed_counts(reads, *seedargs)
                tables[s.name] = (ref_place.ReadTable(h, c, k),
                                  ref_place.ReadTable(h, c, k, np.float32))
            t64, t32 = tables[s.name]
            placed = rec["placed"]
            off += src not in placed["log_containment"][2]
            at_src = (ref_place.node_scores(t64, seeds(src), root)
                      if is_fixed(src) else None)
            for m in ref_place.METRICS:
                node, score, _ = placed[m]
                if node is None:
                    continue
                if not is_fixed(node):
                    skipped += 1
                    continue
                want = ref_place.node_scores(t64, seeds(node), root)[m]
                if self.control:  # the reference in float32 answers
                    score = ref_place.node_scores(t32, seeds(node), root)[m]
                gap = max(gap, abs(score - want) / abs(want))
                # no node scores above the best, the source leaf included
                if at_src is not None and at_src[m]:
                    below = max(below, (at_src[m] - score) / abs(at_src[m]))
            head, cons = rec["consensus"]
            node = head.rsplit("ref=", 1)[-1]
            calls = rec["calls"]
            missing = max(missing, ref_out.missing_tiles(cons, s.genome,
                                                         s.rows))
            differing += (cons != ref_out.apply_calls(genome(node), calls)
                          or any(c[0] != node for c in calls))
            if genome(node) == genome(src):
                a, b = ref_out.planted_missed(genome(src), s.rows, calls)
            else:  # called against another genome: nothing planted matches
                a, b = len(s.rows) - n_indels, n_indels
            snps, indels = snps + a, indels + b
        self.info = dict(samples_checked=len(self.records),
                         placement_metrics_not_checked=skipped,
                         indels_planted=planted, indels_missed=indels)
        lim = self.traffic["limits"]
        return [("place_score_rel_gap", gap, lim["place_score_rel_gap"]),
                ("place_below_source_rel", below,
                 lim["place_score_rel_gap"]),
                ("placed_off_source_leaf", off, 0),
                ("consensus_tiles_missing", missing, 0),
                ("consensus_calls_differing", differing, 0),
                ("snps_missed", snps, 0),
                ("indels_missed_share", indels / planted if planted else None,
                 lim["indels_missed_share"])]
