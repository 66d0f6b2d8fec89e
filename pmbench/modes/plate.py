"""Mode "plate": a --batch manifest of isolates, each of its own leaf, a
CLI call."""

from __future__ import annotations

import os

from pmbench.isolates import Isolates


class Plate(Isolates):

    @classmethod
    def tiny(cls, config, traffic):
        config, traffic = super().tiny(config, traffic)
        traffic["pairs"] = 4000  # 500 to each isolate of a plate of 8
        return config, traffic

    def span_targets(self):
        # the forked workers run alignment, genotyping and consensus: a
        # span there would reach for the card; placement's two halves and
        # the index load run in this process
        from panmap_tpu_torch import pipeline

        return [(pipeline, "ensure_index", "index_load", True),
                (pipeline, "read_sketch", "place.sketch", False),
                (pipeline, "_place_finish", "place.finish", True)]

    def n_pairs(self, name):
        k = int(name.rsplit("_", 1)[1])
        total, n = self.traffic["pairs"], self.traffic["plate"]
        return total // n + (k < total % n)

    def make_inputs(self):
        rng = self.rng(1)
        self.inputs = []
        for j in range(self.traffic["inputs"]):
            leaves = rng.choice(len(self.leaves), self.traffic["plate"],
                                replace=False)
            plate = [self.isolate(rng, f"in{j}_{k}", self.leaves[int(li)])
                     for k, li in enumerate(leaves)]
            manifest_path = os.path.join(self.work, f"plate{j}.txt")
            with open(manifest_path, "w") as fh:
                for k, s in enumerate(plate):
                    fh.write(f"{s.r1} {s.r2} "
                             f"{os.path.join(self.out, f'slot{j}_{k}')}\n")
            self.inputs.append((manifest_path, plate))

    def run_one(self, i):
        j = i % len(self.inputs)
        path, plate = self.inputs[j]
        rc = self.cli([self.panman, "--batch", path])
        failed = 0
        for k, s in enumerate(plate):
            prefix = os.path.join(self.out, f"slot{j}_{k}")
            ok = os.path.exists(prefix + ".consensus.fa") and (
                prefix in self.placed)
            failed += not ok
            self.collect(s, prefix, 0 if ok else 1)
        return len(plate), failed


MODE = Plate
