"""Mode "meta": a --meta mixture a CLI call.  The read scores of the
source leaves and of a sample of the other candidates, the EM's fixed
point, the source lineages' presence and the top lineage are checked."""

from __future__ import annotations

import os

import numpy as np

from pmbench.mode import ACGT, Mode
from pmbench.reference import em as ref_em
from pmbench.reference import placement as ref_place
from pmbench.reference import seeds as ref_seeds


class Meta(Mode):

    @classmethod
    def tiny(cls, config, traffic):
        config, traffic = super().tiny(config, traffic)
        traffic["pairs"] = 6000  # a mixture of five leaves
        return config, traffic

    def make_inputs(self):
        rng = self.rng(1)
        props = tuple(self.traffic["proportions"])
        self.inputs = []
        for j in range(self.traffic["inputs"]):
            haps = tuple(self.leaves[int(i)] for i in rng.choice(
                len(self.leaves), len(props), replace=False))
            s = self.write_sample(rng, f"in{j}",
                                  [self.model.get_string(h) for h in haps],
                                  props)
            s.leaves = haps
            self.inputs.append(s)

    def span_targets(self):
        from panmap_tpu_torch.meta import driver

        return [(driver, "ensure_meta_index", "index_load", True),
                (driver, "sketch", "meta.sketch", True),
                (driver, "make_scorers", "meta.prep", True),
                (driver, "rank_candidates", "meta.score", True),
                (driver, "score", "meta.score", True),
                (driver, "run_em", "meta.em", True)]

    def install(self, spans=None, launches=None):
        from panmap_tpu_torch.meta import driver

        def keep(key, pick):
            def make(fn):
                def run(*a, **k):
                    out = fn(*a, **k)
                    if self.deep is not None:
                        self.cap[key] = pick(a, out)
                    return out
                return run
            return make

        def scores(fn):
            def run(cfg, scorer, fast, candidates):
                out = fn(cfg, scorer, fast, candidates)
                if self.deep is not None:
                    snap = out[1]
                    names = self.cap["node_ids"]
                    s = self.inputs[self.deep]
                    cols = [c for c, n in enumerate(candidates)
                            if names[n] in s.leaves]
                    others = [c for c in range(len(candidates))
                              if c not in cols]
                    n_other = min(self.traffic["checked_nodes"], len(others))
                    cols += sorted(self.rng(4, self.deep).choice(
                        others, n_other, replace=False).tolist())
                    sub = (snap[:, cols].cpu().numpy()
                           if not isinstance(snap, np.ndarray)
                           else snap[cols].T)
                    self.cap["cols"] = (
                        [names[candidates[c]] for c in cols], sub)
                return out
            return run

        def em(fn):
            def run(cfg, snap, read_lens, weights, cand_names, device,
                    mesh=None):
                if self.control:
                    res = self.reference_em(cfg, snap, read_lens, weights,
                                            cand_names)
                else:
                    res = fn(cfg, snap, read_lens, weights, cand_names,
                             device, mesh)
                if self.deep is not None:
                    at = {n: c for c, n in enumerate(cand_names)}
                    cols = [at[n] for n in res.node_names]
                    R = len(read_lens)
                    sub = (snap[:R, cols].cpu().numpy()
                           if not isinstance(snap, np.ndarray)
                           else snap[cols].T)
                    self.cap["em"] = (sub, read_lens, weights, res.props)
                return res
            return run

        self.cap = {}
        self.patches.replace(driver, "sketch",
                             keep("dup_index", lambda a, out: out[1]))
        self.patches.replace(driver, "make_scorers",
                             keep("node_ids", lambda a, out: a[1].node_ids))
        self.patches.replace(driver, "score", scores)
        self.patches.replace(driver, "run_em", em)
        for module, fn, label, sync in (self.span_targets() if spans
                                        else ()):
            self.patches.replace(module, fn, spans.wrapper(label, sync))

    def reference_em(self, cfg, snap, read_lens, weights, cand_names):
        """The control: reference.em in bfloat16 where the program's EM
        runs."""
        import torch

        from panmap_tpu_torch.meta.engine import EMResult

        S = (snap if not isinstance(snap, np.ndarray)
             else torch.from_numpy(np.ascontiguousarray(snap.T)))
        keep, groups, props = ref_em.em(
            S.to(torch.int32), read_lens, weights, torch.bfloat16,
            cfg.em_delta_threshold, cfg.em_maximum_iterations,
            cfg.em_maximum_rounds)
        return EMResult(
            node_names=[cand_names[c] for c in keep], props=props,
            identical_groups={cand_names[c]: [cand_names[g] for g in gs]
                              for c, gs in groups.items() if gs})

    def run_one(self, i):
        j = i % len(self.inputs)
        s = self.inputs[j]
        prefix = os.path.join(self.out, f"slot{j}")
        self.deep = j if 0 <= i < len(self.inputs) else None
        self.cap = {}
        try:
            rc = self.cli([self.panman, s.r1, s.r2, "-o", prefix])
        finally:
            if self.deep is not None:
                self.captured.append((j, self.cap))
            self.deep = None
        path = prefix + ".mgsr.abundance.out"
        lines = None
        if rc == 0 and os.path.exists(path):
            with open(path) as fh:
                lines = [ln.rstrip("\n").split("\t") for ln in fh]
        self.records.append(dict(sample=s, lines=lines))
        return 1, int(rc != 0)

    def check(self):
        seedargs, flank = self.seedargs()
        top_wrong = absent = 0
        for rec in self.records:
            lines, leaves = rec["lines"], rec["sample"].leaves
            named = {n for ln in lines or () for n in ln[0].split(",")}
            top_wrong += not lines or leaves[0] not in lines[0][0].split(",")
            absent += sum(h not in named for h in leaves)
        bad = checked = nodes = 0
        resid = 0.0
        for j, cap in self.captured:
            s = self.inputs[j]
            if "em" not in cap or "cols" not in cap:
                resid = None
                continue
            sub, lens, w, props = cap["em"]
            keep = np.asarray(w) > 0
            pr = np.asarray(props, np.float64)
            resid = None if resid is None else max(resid, ref_em.residual(
                sub[keep], np.asarray(lens)[keep], np.asarray(w)[keep],
                pr / pr.sum()))
            names, got = cap["cols"]
            dup = cap["dup_index"]
            rows = np.sort(self.rng(3, j).choice(
                len(dup), min(self.traffic["checked_reads"], len(dup)),
                replace=False))
            first = np.array([dup[r][0] for r in rows])
            # the program reads mate 1 and mate 2 interleaved
            reads = ACGT[np.where((first % 2 == 0)[:, None],
                                  s.c1[first // 2], s.c2[first // 2])]
            km, rv, owner = ref_seeds.read_seeds(reads, *seedargs)
            for at, h in enumerate(names):
                if not ref_place.mask_fixed(self.model, h, flank):
                    continue
                nh, nr = ref_seeds.genome_seeds(
                    self.model.get_string(h), *seedargs, flank)
                same = np.where(rv, np.isin(km, nh[nr]), np.isin(km, nh[~nr]))
                flip = np.where(rv, np.isin(km, nh[~nr]), np.isin(km, nh[nr]))
                fwd = np.bincount(owner, same, len(rows))
                rev = np.bincount(owner, flip, len(rows))
                want = np.maximum(fwd, rev).astype(np.int64)
                bad += int((want != got[rows, at].astype(np.int64)).sum())
                checked += len(rows)
                nodes += 1
        self.info = dict(samples_checked=len(self.records),
                         read_scores_checked=checked,
                         score_columns_checked=nodes)
        return [("read_scores_differing", bad if checked else None, 0),
                ("em_step_residual", resid,
                 self.traffic["limits"]["em_step_residual"]),
                ("source_lineages_missing", absent, 0),
                ("top_lineage_wrong", top_wrong, 0)]


MODE = Meta
