"""What every traffic mode shares: a sample, and the base of a mode.

A traffic mix names its mode ("mode" in pmbench/workloads/<traffic>.json);
the mode is pmbench/modes/<mode>.py, whose ``MODE`` is a subclass of
``Mode`` below, found by name (manifest.mode).  A mode makes the run's
inputs from the seed, runs one CLI call of them at a time, captures what
the checks need, and checks the window's answers against the plain
reference after it.
"""

from __future__ import annotations

import os
import random
from dataclasses import dataclass

import numpy as np

from . import tracing
from .frozen import panman as fpanman
from .frozen import samples as fsamples

ACGT = np.frombuffer(b"ACGT", np.uint8)


@dataclass
class Sample:
    """One sample's reads on disk and what the generator knows of them."""

    name: str
    r1: str
    r2: str
    leaves: tuple  # the leaves its reads come from
    genome: str  # an isolate's true genome ("" for a mixture)
    rows: list  # its planted mutations, (1-based position, ref, alt)
    c1: np.ndarray  # mate 1 and mate 2 read codes (0-3), [pairs, 150]
    c2: np.ndarray


class Mode:
    """The parts of a run that depend on the traffic's mode.

    A mode also has make_inputs(); run_one(i) -> (samples, failed);
    span_targets() -> [(module, function, label, sync)], the functions the
    traced run wraps in spans; install(spans, launches), the captures for
    the checks (with spans: the traced run's spans and kernel launch
    shapes); and check() -> [(name, value, limit)], the compared numbers,
    setting ``info`` to what it counted."""

    def __init__(self, cell, seed: int, work: str, device, control=False):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = seed % (1 << 63)
        self.work = work
        self.out = os.path.join(work, "out")
        self.device = device
        self.cuda = device.type == "cuda"
        self.control = control
        self.patches = tracing.Patches()
        self.deep = None  # the input index whose answers are captured
        self.records = []  # one per completed sample
        self.captured = []
        self.info = {}

    @classmethod
    def tiny(cls, config: dict, traffic: dict) -> tuple:
        """The cell cut for a run on a CPU in the tests: ``config`` and
        ``traffic`` (deep copies, changed in place) returned as
        (config, traffic).  Here make_panman_model's tree of 300 nodes of
        6 kb genomes in 8 blocks, 2,500 read pairs and 6 SNPs where the
        traffic plants SNPs; a mode overrides it to cut keys of its own."""
        config["tree"].update(n_nodes=300, genome_len=6000, n_blocks=8)
        traffic["pairs"] = 2500
        if "snps" in traffic:
            traffic["snps"] = 6
        return config, traffic

    def rng(self, *stream):
        return np.random.default_rng([self.seed, *stream])

    def sync(self):
        if self.cuda:
            import torch

            torch.cuda.synchronize()

    def make_tree(self):
        self.model = fpanman.make_panman_model(self.rng(0),
                                               **self.config["tree"])
        self.panman = os.path.join(self.work, "tree.panman")
        fpanman.write_panman(self.panman, self.model)
        self.leaves = self.model.leaves()

    def write_sample(self, rng, name, haps, props, genome="") -> Sample:
        c1, c2, q1, q2 = fsamples._simulate_pairs(
            rng, haps, props, self.n_pairs(name), fsamples.NOVASEQ_ERROR)
        p1 = os.path.join(self.work, name + "_R1.fastq")
        p2 = os.path.join(self.work, name + "_R2.fastq")
        fsamples._write_fastq_codes(p1, 1, c1, q1)
        fsamples._write_fastq_codes(p2, 2, c2, q2)
        return Sample(name, p1, p2, (), genome, [], c1, c2)

    def isolate(self, rng, name, leaf=None) -> Sample:
        """A leaf's genome (a random leaf's by default) with the traffic's
        SNPs and indels, read as pairs."""
        t = self.traffic
        if leaf is None:
            leaf = self.leaves[int(rng.integers(len(self.leaves)))]
        genome, rows = fsamples.simulate_mutations(
            self.model.get_string(leaf), t["snps"], t["insertions"],
            t["deletions"], tuple(t["indel_len"]),
            random.Random(int(rng.integers(1 << 62))))
        s = self.write_sample(rng, name, [genome], [1.0], genome)
        s.leaves, s.rows = (leaf,), rows
        return s

    def n_pairs(self, name) -> int:
        return self.traffic["pairs"]

    def cli(self, argv) -> int:
        from panmap_tpu_torch.__main__ import main

        return main([*argv, "--quiet", *self.config["cli"]]) or 0

    def seedargs(self):
        """The index's seed parameters (k, s, t, l, open) and flank mask."""
        p = self.config["index"]
        return (p["k"], p["s"], p["t"], p["l"], p["open"]), p["flank_mask_bp"]

    def warm(self):
        self.run_one(-1)
        self.records.clear()
        self.captured.clear()


def fasta(path):
    """(header without '>', sequence) of a one-record FASTA file."""
    with open(path) as fh:
        head = fh.readline()[1:].rstrip("\n")
        return head, "".join(ln.strip() for ln in fh)
