"""`python -m panmap_tpu_torch` against `python -m panmap_tpu` on a PanMAN
file written by panmap_tpu_torch.synthetic (300 nodes, a 6 kb genome in 8
blocks, an inverted block and a deleted one), in process, with no stand-in
for load_panman: each package decodes the file, builds and caches its own
index beside its own copy of it, places, aligns, genotypes and writes.
The port is asked for the CPU (utils.device.cuda_device), so its kernels
run their plain versions.

The ROADMAP's rules for "done": placement.tsv, ref.fa and consensus.fa
byte-equal, the VCF record-equal; and both place the sample on a node
whose genome is the source leaf's.  Modes here: the default short sample,
long reads (map-ont), --reference-node, --refine, --batch (two samples),
--meta --filter-and-assign.  tests/test_torch_panman.py holds --meta
abundance, --simulate and the --dump-* tools on its own file.
"""

import filecmp
import os
import shutil

import pytest
import torch

from panmap_tpu.__main__ import main as jax_main
from panmap_tpu_torch.__main__ import main as torch_main
from panmap_tpu_torch.synthetic import (make_panman_long_workload,
                                        make_panman_meta_workload,
                                        make_panman_workload)
from panmap_tpu_torch.utils import device

from test_torch_assign import FILES as ASSIGN_FILES
from test_torch_long import jax_front_with_port_secondary

MAINS = {"jax": jax_main, "torch": torch_main}


def vcf_records(path):
    with open(path) as fh:
        return [ln for ln in fh if not ln.startswith("##")]


def same_sample_outputs(a, b):
    """The "done" rules for one sample's outputs under prefixes a and b."""
    for ext in ("placement.tsv", "ref.fa", "consensus.fa"):
        assert filecmp.cmp(f"{a}.{ext}", f"{b}.{ext}", shallow=False), ext
    assert vcf_records(f"{a}.vcf") == vcf_records(f"{b}.vcf")


def placed_node(prefix):
    with open(prefix + ".ref.fa") as fh:
        return fh.readline()[1:].strip()


@pytest.fixture(scope="module")
def panman_dirs(tmp_path_factory):
    """The workload, and per package a directory holding a copy of the
    PanMAN file whose index that package built with --stop index."""
    root = tmp_path_factory.mktemp("cli_panman")
    w = make_panman_workload(str(root / "reads"), seed=3, n_nodes=300,
                             genome_len=6000, n_pairs=3000, n_blocks=8)
    dirs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(device, "cuda_device", lambda index=0: torch.device("cpu"))
        for name, main in MAINS.items():
            d = root / name
            d.mkdir()
            shutil.copy(w.panman, d / "tree.panman")
            assert main([str(d / "tree.panman"), "--stop", "index", "-t", "2",
                         "-q"]) == 0
            assert os.path.exists(d / "tree.panman.ptidx.npz")
            dirs[name] = d
    return w, dirs


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "cuda_device",
                        lambda index=0: torch.device("cpu"))
    monkeypatch.setenv("PANMAP_PALLAS_LONG", "0")  # the JAX host DP


def run_both(dirs, argv, out):
    """Both CLIs on their own copy of the file; returns the prefixes."""
    prefixes = {}
    for name, main in MAINS.items():
        prefix = str(dirs[name] / out)
        assert main([str(dirs[name] / "tree.panman"), *argv, "-o", prefix,
                     "-t", "2", "-q"]) == 0, name
        prefixes[name] = prefix
    return prefixes["jax"], prefixes["torch"]


def test_short_sample_places_on_the_source_leaf(panman_dirs, on_cpu):
    w, dirs = panman_dirs
    a, b = run_both(dirs, [w.reads1, w.reads2], "short")
    same_sample_outputs(a, b)
    for prefix in (a, b):
        got = placed_node(prefix)
        assert w.model.get_string(got) == w.model.get_string(w.leaf), got
    # the reference of the alignment is the placed node's decoded genome
    with open(b + ".ref.fa") as fh:
        ref = "".join(ln.strip() for ln in fh if not ln.startswith(">"))
    assert ref == w.model.get_string(placed_node(b))


def test_long_reads(panman_dirs, on_cpu, tmp_path, monkeypatch):
    # the JAX package's front end with the port's secondary chain score,
    # the one part of it the port changes (ROADMAP C)
    jax_front_with_port_secondary(monkeypatch)
    w, dirs = panman_dirs
    lw = make_panman_long_workload(w, str(tmp_path), seed=3, n_reads=60,
                                   len_lo=800, len_hi=1400)
    a, b = run_both(dirs, [lw.reads1, "--min-qual", "10"], "long")
    same_sample_outputs(a, b)
    got = placed_node(b)
    assert w.model.get_string(got) == w.model.get_string(lw.leaf), got


def test_reference_node(panman_dirs, on_cpu):
    w, dirs = panman_dirs
    node = w.model.names[int(w.model.parent[w.model.index[w.leaf]])]
    a, b = run_both(dirs, [w.reads1, w.reads2, "--reference-node", node],
                    "forced")
    for ext in ("ref.fa", "consensus.fa"):
        assert filecmp.cmp(f"{a}.{ext}", f"{b}.{ext}", shallow=False), ext
    assert vcf_records(f"{a}.vcf") == vcf_records(f"{b}.vcf")
    assert placed_node(b) == node


def test_refine(panman_dirs, on_cpu):
    w, dirs = panman_dirs
    a, b = run_both(dirs, [w.reads1, w.reads2, "--refine"], "refined")
    same_sample_outputs(a, b)
    with open(b + ".placement.tsv") as fh:
        assert "refined" in fh.read().lower()


def test_batch_of_two_samples(panman_dirs, on_cpu):
    w, dirs = panman_dirs
    prefixes = {}
    for name, main in MAINS.items():
        manifest = dirs[name] / "manifest.txt"
        with open(manifest, "w") as fh:
            for k in range(2):
                fh.write(f"{w.reads1} {w.reads2} {dirs[name] / f'batch{k}'}\n")
        assert main([str(dirs[name] / "tree.panman"), "--batch",
                     str(manifest), "-t", "2", "-q"]) == 0, name
        prefixes[name] = [str(dirs[name] / f"batch{k}") for k in range(2)]
    for a, b in zip(prefixes["jax"], prefixes["torch"]):
        same_sample_outputs(a, b)
        got = placed_node(b)
        assert w.model.get_string(got) == w.model.get_string(w.leaf), got


def test_meta_filter_and_assign(panman_dirs, on_cpu, tmp_path, monkeypatch):
    """Both packages build and cache the meta index from the file and
    write the same files byte for byte; the port takes the batched
    scorer's route (>= 2,000 unique read sets: its assignment pass)."""
    from panmap_tpu_torch.meta.engine_torch import TorchMetaScorer

    w, dirs = panman_dirs
    mw = make_panman_meta_workload(w, str(tmp_path), seed=3, n_pairs=3000)
    passes = []
    real = TorchMetaScorer.assignment_pass
    monkeypatch.setattr(TorchMetaScorer, "assignment_pass",
                        lambda self, *a, **k: passes.append(1)
                        or real(self, *a, **k))
    a, b = run_both(dirs, [mw.reads1, "--meta", "--filter-and-assign",
                           "--discard", "0.6", "--dust", "5",
                           "--breadth-ratio", "--jplace",
                           "--write-meta-read-scores-filtered"], "assign")
    for ext in ASSIGN_FILES:
        assert filecmp.cmp(f"{a}.{ext}", f"{b}.{ext}", shallow=False), ext
    assert passes
    with open(b + ".mgsr.assignedReads.out") as fh:
        assigned = fh.read()
    assert set(mw.haplotypes) & set(assigned.replace(",", "\t").split())
    for name in MAINS:
        assert os.path.exists(dirs[name] / "tree.panman.ptmidx.npz")
