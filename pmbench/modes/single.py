"""Mode "single": one isolate a CLI call.  B1's launch and the pileup
tally of the first pass over the inputs are checked too."""

from __future__ import annotations

import os

import numpy as np

from pmbench.isolates import Isolates
from pmbench.reference import outputs as ref_out
from pmbench.reference import sw as ref_sw


class Single(Isolates):

    def make_inputs(self):
        rng = self.rng(1)
        self.inputs = [self.isolate(rng, f"in{j}")
                       for j in range(self.traffic["inputs"])]

    def run_one(self, i) -> tuple:
        j = i % len(self.inputs)
        s = self.inputs[j]
        prefix = os.path.join(self.out, f"slot{j}")
        self.deep = j if 0 <= i < len(self.inputs) else None
        try:
            rc = self.cli([self.panman, s.r1, s.r2, "-o", prefix])
        finally:
            self.deep = None
        self.collect(s, prefix, rc)
        return 1, int(rc != 0)

    def check(self):
        out = super().check()
        sw_bad = sw_rows = tally_bad = tallies = 0
        for kind, args, res in self.captured:
            if kind == "sw":
                want = ref_sw.banded_sw_scores(*args)
                sw_bad += int((want != res).any(1).sum())
                sw_rows += len(want)
            else:
                want = ref_out.tallies(*args)
                tally_bad += sum(int((np.asarray(a) != b).sum())
                                 for a, b in zip(res, want))
                tallies += 1
        self.info.update(sw_rows_checked=sw_rows, tallies_checked=tallies)
        # None where nothing was compared: the cell's kernels did not run
        return out + [("sw_rows_differing", sw_bad if sw_rows else None, 0),
                      ("tally_entries_differing",
                       tally_bad if tallies else None, 0)]


MODE = Single
