"""The correctness check fails what it should.  Each cell's run at a tiny
size on CPU tensors: a sound run comes out correct; the control (the plain
reference answering one precision below the configuration's) and each
fault the cell can have, planted in the program underneath the harness,
come out not correct.  Not applicable to these cells: the exchange
between chips (every cell takes one card), and, for the isolates, a step
that returns its state unchanged (no iterative state)."""

import numpy as np
import pytest
import torch

from pmbench.reference.placement import METRICS

from . import small


def checks(out):
    return {n: c["value"] for n, c in out["checks"].items()}


@pytest.mark.parametrize("name", ["illumina.single", "illumina.plate",
                                  "wastewater.meta"])
def test_sound_run_is_correct(name, tmp_path):
    out, res = small.run(small.tiny(name), tmp_path)
    assert out["correct"], out["checks"]
    assert res["n"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("name", ["illumina.single", "illumina.plate",
                                  "wastewater.meta"])
def test_control_is_not_correct(name, tmp_path):
    out, _ = small.run(small.tiny(name), tmp_path, control=True)
    assert not out["correct"], out["checks"]


def altered_placement(monkeypatch):
    """An answer altered where it is produced: the best scores placement
    reports, moved in their sixth digit."""
    from panmap_tpu_torch.place.query_torch import TorchPlacer

    orig = TorchPlacer._place_exact_finish

    def finish(self, *a):
        res = orig(self, *a)
        if res is not None:
            res.best_score = {m: v * (1 + 1e-6)
                              for m, v in res.best_score.items()}
        return res

    monkeypatch.setattr(TorchPlacer, "_place_exact_finish", finish)


def altered_sw(monkeypatch):
    """An answer altered where it is produced: one B1 score off by one."""
    from panmap_tpu_torch.align import sw

    orig = sw.banded_sw_scores_reference

    def run(q, r, qlens):
        out = orig(q, r, qlens).clone()
        out[0, 0] += 1
        return out

    monkeypatch.setattr(sw, "banded_sw_scores_reference", run)


def half_tally(monkeypatch):
    """Half of the batch left out: the tally over every other base."""
    from panmap_tpu_torch.genotype import caller

    orig = caller.tally_columns_device

    def run(col_id, g_q, g_s, g_b, ncol, device):
        return orig(col_id[::2], g_q[::2], g_s[::2], g_b[::2], ncol, device)

    monkeypatch.setattr(caller, "tally_columns_device", run)


def altered_consensus(monkeypatch):
    """An answer altered where it is produced: one consensus base."""
    from panmap_tpu_torch import pipeline

    orig = pipeline.build_consensus

    def run(ref, records, header):
        text = orig(ref, records, header)
        head, seq = text.split("\n", 1)
        i = len(head) + 1 + len(seq) // 2
        while text[i] not in "ACGT":
            i += 1
        return text[:i] + ("A" if text[i] != "A" else "C") + text[i + 1:]

    monkeypatch.setattr(pipeline, "build_consensus", run)


def second_best(monkeypatch):
    """An answer altered where it is produced: for every metric but
    log_containment (whose ties placed_off_source_leaf holds), the best
    node below the true best, reported with its own exact score."""
    from panmap_tpu_torch.place import query_torch
    from panmap_tpu_torch.place.query_torch import TorchPlacer

    orig = TorchPlacer._place_exact_finish

    def finish(self, sk, cand, col32, zero_metric):
        res = orig(self, sk, cand, col32, zero_metric)
        if res is None:
            return res
        union = np.arange(col32.shape[0])  # every node, at the tiny tree
        exact = query_torch.rescore_paths(self.idx, sk, union)
        for m, name in enumerate(METRICS[:4]):
            best = res.best_score[name]
            below = np.flatnonzero(exact[:, m] < best - 1e-9 * abs(best))
            if res.best_index[name] is None or not len(below):
                continue
            i = below[np.argmax(exact[below, m])]
            res.best_index[name] = int(union[i])
            res.best_score[name] = float(exact[i, m])
            res.tied_indices[name] = [int(union[i])]
        return res

    monkeypatch.setattr(TorchPlacer, "_place_exact_finish", finish)


def _called(monkeypatch, alter):
    """The genotyper's final calls, altered by ``alter`` before the VCF
    and the consensus are written from them."""
    from panmap_tpu_torch import pipeline

    orig = pipeline.apply_spectrum
    monkeypatch.setattr(pipeline, "apply_spectrum",
                        lambda *a: alter(orig(*a)))


def no_indel_calls(monkeypatch):
    """An answer altered where it is produced: every indel call dropped."""
    _called(monkeypatch, lambda recs: [
        r for r in recs if len(r.ref) == 1 and all(len(a) == 1
                                                   for a in r.alts)])


def clustered_snp_flipped(monkeypatch):
    """An answer altered where it is produced: the called base of the SNP
    nearest to another call (outside every other call's reference
    bases)."""
    import copy

    def alter(recs):
        recs = list(recs)

        def inside(r):
            return any(o is not r and o.pos <= r.pos < o.pos + len(o.ref)
                       for o in recs)

        snps = [i for i, r in enumerate(recs)
                if len(r.ref) == 1 and 0 < r.gt <= len(r.alts)
                and len(r.alts[r.gt - 1]) == 1 and not inside(r)]
        if not snps:
            return recs
        i = min(snps, key=lambda i: min(abs(o.pos - recs[i].pos) or 10**9
                                        for o in recs))
        r = recs[i] = copy.copy(recs[i])
        r.alts = list(r.alts)
        r.alts[r.gt - 1] = next(b for b in "ACGT"
                                if b not in (r.ref, r.alts[r.gt - 1]))
        return recs

    _called(monkeypatch, alter)


def consensus_without_indels(monkeypatch):
    """An answer altered where it is produced: the consensus written from
    the SNP calls alone."""
    from panmap_tpu_torch import pipeline

    orig = pipeline.build_consensus
    monkeypatch.setattr(pipeline, "build_consensus", lambda ref, recs, head:
                        orig(ref, [r for r in recs if len(r.ref) == 1 and all(
                            len(a) == 1 for a in r.alts)], head))


def half_plate(monkeypatch):
    """Half of the batch left out: a plate run on half of its manifest."""
    from panmap_tpu_torch import pipeline

    orig = pipeline.read_batch_file
    monkeypatch.setattr(pipeline, "read_batch_file",
                        lambda path: orig(path)[::2])


def em_unchanged(monkeypatch):
    """A step that returns its state unchanged: the EM hands back its
    uniform start."""
    from panmap_tpu_torch.meta import em

    def run(S, lens, w, **kw):
        M = S.shape[1]
        return (torch.full((M,), 1.0 / M, device=S.device),
                torch.ones(M, dtype=torch.bool, device=S.device), 0)

    monkeypatch.setattr(em, "squarem", run)


def em_half(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: the EM
    over every other read."""
    from panmap_tpu_torch.meta import em

    orig = em.squarem
    monkeypatch.setattr(em, "squarem", lambda S, lens, w, **kw: orig(
        S[::2], lens[::2], w[::2], **kw))


def altered_read_scores(monkeypatch):
    """An answer altered where it is produced: the device scorer's read
    scores, one more at every node."""
    from panmap_tpu_torch.meta.engine_torch import TorchMetaScorer

    orig = TorchMetaScorer.score_all

    def run(self, *a, **k):
        max_score, snap = orig(self, *a, **k)
        return max_score, snap + 1

    monkeypatch.setattr(TorchMetaScorer, "score_all", run)


def _meta_sources(monkeypatch):
    """A predicate on candidate names: whether the column stands for one of
    the mixture's source leaves after its last (the run's tree, genomes and
    meta index as it makes them)."""
    from panmap_tpu_torch.meta import driver

    from pmbench import mode as pm

    seen = {}
    orig_tree, orig_sample = pm.Mode.make_tree, pm.Mode.write_sample
    orig_scorers = driver.make_scorers

    def make_tree(self):
        orig_tree(self)
        seen["model"] = self.model

    def write_sample(self, rng, name, haps, props, genome=""):
        seen["haps"] = set(haps[1:])
        return orig_sample(self, rng, name, haps, props, genome)

    def make_scorers(cfg, midx, *a, **k):
        out = orig_scorers(cfg, midx, *a, **k)
        names = midx.node_ids
        seen["members"] = {names[k]: {names[x] for x in v} for k, v in
                           out[0].tree.identical_members.items()}
        return out

    monkeypatch.setattr(pm.Mode, "make_tree", make_tree)
    monkeypatch.setattr(pm.Mode, "write_sample", write_sample)
    monkeypatch.setattr(driver, "make_scorers", make_scorers)

    def is_source(name):
        model = seen["model"]
        return any(model.get_string(n) in seen["haps"] for n in
                   {name} | seen["members"].get(name, set())
                   if n in model.index)

    return is_source


def source_column_dropped(monkeypatch):
    """A lineage left out: the EM run without the columns that stand for
    the mixture's source leaves after its first."""
    from panmap_tpu_torch.meta import driver

    is_source = _meta_sources(monkeypatch)
    orig = driver.run_em

    def run(cfg, snap, read_lens, weights, cand_names, *a, **k):
        keep = [c for c, n in enumerate(cand_names) if not is_source(n)]
        snap = (snap[:, keep] if isinstance(snap, torch.Tensor)
                else snap[keep])
        return orig(cfg, snap, read_lens, weights,
                    [cand_names[c] for c in keep], *a, **k)

    monkeypatch.setattr(driver, "run_em", run)


def other_scores_altered(monkeypatch):
    """An answer altered where it is produced: the device scorer's read
    scores, one more at every candidate that is not a source leaf."""
    from panmap_tpu_torch.meta.engine_torch import TorchMetaScorer

    is_source = _meta_sources(monkeypatch)
    orig = TorchMetaScorer.score_all

    def run(self, candidate_nodes):
        max_score, snap = orig(self, candidate_nodes)
        names = self.midx.node_ids
        other = torch.tensor([not is_source(names[n])
                              for n in candidate_nodes], device=snap.device)
        return max_score, snap + other.to(snap.dtype)

    monkeypatch.setattr(TorchMetaScorer, "score_all", run)


FAULTS = [
    ("illumina.single", altered_placement, "place_score_rel_gap"),
    ("illumina.single", altered_sw, "sw_rows_differing"),
    ("illumina.single", half_tally, "tally_entries_differing"),
    ("illumina.single", altered_consensus, "consensus_tiles_missing"),
    ("illumina.single", second_best, "place_below_source_rel"),
    ("illumina.single", no_indel_calls, "indels_missed_share"),
    ("illumina.single", clustered_snp_flipped, "snps_missed"),
    ("illumina.single", consensus_without_indels,
     "consensus_calls_differing"),
    ("illumina.plate", altered_placement, "place_score_rel_gap"),
    ("illumina.plate", half_plate, "consensus_tiles_missing"),
    ("illumina.plate", second_best, "place_below_source_rel"),
    ("illumina.plate", no_indel_calls, "indels_missed_share"),
    ("wastewater.meta", em_unchanged, "em_step_residual"),
    ("wastewater.meta", em_half, "em_step_residual"),
    ("wastewater.meta", altered_read_scores, "read_scores_differing"),
    ("wastewater.meta", source_column_dropped, "source_lineages_missing"),
    ("wastewater.meta", other_scores_altered, "read_scores_differing"),
]


@pytest.mark.parametrize("name,fault,number", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f, _ in FAULTS])
def test_fault_is_not_correct(name, fault, number, tmp_path, monkeypatch):
    fault(monkeypatch)
    out, _ = small.run(small.tiny(name), tmp_path)
    assert not out["correct"]
    got, limit = out["checks"][number]["value"], out["checks"][number][
        "limit"]
    assert got is None or got > limit, out["checks"]
    assert np.isfinite(limit)
