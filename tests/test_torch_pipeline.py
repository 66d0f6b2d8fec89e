"""The port's single-sample slice end to end at a small size, against the
JAX package's own stage functions on the same synthetic workload
(panmap_tpu_torch.synthetic: a 40-node index, a 30 kb genome, 300 read
pairs; and the long-read path on 40 ONT-like reads).  All five outputs
(placement.tsv, ref.fa, BAM, VCF, consensus.fa) must be byte-equal.

The JAX side runs as its tests run on the CPU: TpuPlacer on the JAX CPU
backend with mesh = 1, the Pallas SW kernel in interpret mode, the host
pileup tally.  The port runs on torch CPU tensors, where the SW wrapper uses
its plain version.  A subprocess run shows the port never loads jax (this
process has it loaded by the conftest), CIGAR-overflow realignment, the
long-read path and --meta abundance included.
"""

import filecmp
import json
import os
import subprocess
import sys

import pytest
import torch

from panmap_tpu import pipeline as hp
from panmap_tpu.native import get_lib
from panmap_tpu_torch import pipeline as tp
from panmap_tpu_torch.__main__ import main as torch_main
from panmap_tpu_torch.synthetic import make_long_workload, make_workload

OUTPUTS = ("placement.tsv", "ref.fa", "bam", "vcf", "consensus.fa")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native library unavailable")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions' row loops run thousands of small ops, which
    intra-op threads only slow down when several test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(out, w, lines, **kw):
    return hp.PipelineConfig(panman="synthetic", reads1=w.reads1,
                             reads2=w.reads2, output=out, mesh=1,
                             device_pileup="off",
                             log=lambda msg, *a, **k: lines.append(msg), **kw)


def _small(tmp_path, seed):
    return make_workload(str(tmp_path / "reads"), seed=seed, n_nodes=40,
                         genome_len=30000, n_pairs=300)


@pytest.mark.parametrize("seed", [0, 1])
def test_slice_outputs_byte_equal_to_jax_package(tmp_path, monkeypatch, seed):
    w = _small(tmp_path, seed)
    # JAX package: device placement on the JAX CPU backend, Pallas SW in
    # interpret mode
    monkeypatch.setenv("PANMAP_PALLAS", "interpret")
    lines = []
    cfg = _cfg(str(tmp_path / "jax" / "sample"), w, lines)
    os.makedirs(os.path.dirname(cfg.output))
    res, best, _ = hp.run_placement(cfg, w.idx)
    ref, placed, join = hp.run_alignment(cfg, w.tree, best, defer_bam=True,
                                         prefetch=hp._start_align_prefetch(cfg))
    final = hp.run_genotyping(cfg, w.idx, ref, best, placed)
    join()
    hp.run_consensus(cfg, ref, best, final)
    monkeypatch.delenv("PANMAP_PALLAS")

    # the port
    tcfg = _cfg(str(tmp_path / "torch" / "sample"), w, lines)
    os.makedirs(os.path.dirname(tcfg.output))
    cpu = torch.device("cpu")
    tres, tbest, _ = tp.run_placement(tcfg, w.idx, cpu)
    assert tbest == best
    stats = {}
    tref, tplaced, tjoin = tp.run_alignment(
        tcfg, w.tree, tbest, cpu, defer_bam=True,
        prefetch=tp._start_align_prefetch(tcfg), stats=stats)
    tfinal = tp.run_genotyping(tcfg, w.idx, tref, tbest, tplaced)
    tjoin()
    tp.run_consensus(tcfg, tref, tbest, tfinal)

    assert stats["device_scored"] == stats["deferred"] > 0
    # every deferred window holds a seed, so the gate keeps them all
    # (test_torch_sw.py::test_gate_keeps_every_seeded_window)
    assert stats["survivors"] == stats["device_scored"]
    # both placements were decided on the device path (no host fallback)
    assert not [x for x in lines if "host engine" in x], lines
    assert len(final) > 0
    for ext in OUTPUTS:
        a, b = f"{cfg.output}.{ext}", f"{tcfg.output}.{ext}"
        assert filecmp.cmp(a, b, shallow=False), ext


_NO_JAX_RUN = r"""
import json, os, sys
import torch
from panmap_tpu_torch import pipeline as tp
from panmap_tpu_torch.synthetic import make_long_workload, make_workload

out = sys.argv[1]
w = make_workload(os.path.join(out, "reads"), seed=2, n_nodes=40,
                  genome_len=30000, n_pairs=300)
cfg = tp.PipelineConfig(panman="synthetic", reads1=w.reads1, reads2=w.reads2,
                        output=os.path.join(out, "sample"),
                        log=lambda *a, **k: None)
cpu = torch.device("cpu")
res, best, _ = tp.run_placement(cfg, w.idx, cpu)
ref, placed = tp.run_alignment(cfg, w.tree, best, cpu)
final = tp.run_genotyping(cfg, w.idx, ref, best, placed)
tp.run_consensus(cfg, ref, best, final)

# CIGARs past a 2-op native capacity: the numpy oracle redoes those reads
import functools
import panmap_tpu.native as native
from panmap_tpu.io import fastq
from panmap_tpu_torch.align.batch import TorchBatchAligner

native.align_sr_native = functools.partial(native.align_sr_native, cigar_cap=2)
_, seqs, _ = fastq.read_paired_for_alignment(w.reads1, w.reads2)
arrays = TorchBatchAligner(ref, cpu).align_batch_arrays(seqs)

# the long-read path
lw = make_long_workload(os.path.join(out, "long_reads"), seed=2, n_reads=6,
                        n_nodes=40, genome_len=4000)
lout = os.path.join(out, "long")
lcfg = tp.PipelineConfig(panman="synthetic", reads1=lw.reads1,
                         output=lout + "/sample", log=lambda *a, **k: None)
os.makedirs(lout)
stats = {}
res, best, _ = tp.run_placement(lcfg, lw.idx, cpu)
ref, placed = tp.run_alignment(lcfg, lw.tree, best, cpu, stats=stats)
final = tp.run_genotyping(lcfg, lw.idx, ref, best, placed)
tp.run_consensus(lcfg, ref, best, final)

# --meta abundance on the device route (>= 2,000 unique read sets)
from panmap_tpu_torch.meta import driver as md
from panmap_tpu_torch.synthetic import make_meta_workload

mw = make_meta_workload(os.path.join(out, "meta_reads"), seed=2, n_nodes=200,
                        genome_len=5000, n_pairs=1300)
mcfg = md.MetaConfig(panman="synthetic", reads1=mw.reads1, reads2=mw.reads2,
                     output=os.path.join(out, "meta"), log=lambda *a, **k: None)
mstats = {}
md.run_meta(mcfg, midx=mw.midx, device=cpu, stats=mstats)
print(json.dumps({"jax": "jax" in sys.modules,
                  "outputs": sorted(os.listdir(out)),
                  "long_outputs": sorted(os.listdir(lout)),
                  "long_device_dp": stats["device_dp"],
                  "oversized": len(arrays["extra_cigars"]),
                  "meta_route": mstats["route"]}))
"""


def test_port_never_imports_jax(tmp_path):
    # JAX_PLATFORMS as a CUDA host with jax installed sets it: panmap_tpu's
    # own package init would import jax under it
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cuda,cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_RUN, str(tmp_path)],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["jax"] is False
    assert got["oversized"] > 0
    assert got["long_device_dp"] > 0
    for ext in OUTPUTS:
        assert f"sample.{ext}" in got["outputs"], ext
        assert f"sample.{ext}" in got["long_outputs"], ext
    assert got["meta_route"] == "device"
    assert "meta.mgsr.abundance.out" in got["outputs"]


@pytest.mark.parametrize("argv", [
    ["--meta", "--filter-and-assign"], ["--batch", "manifest.txt"],
    ["--mesh", "2"], ["--device-pileup", "on"], ["--dist-nprocs", "2"],
    ["--meta", "--batch", "manifest.txt"]])
def test_cli_refuses_unported_options(tmp_path, argv):
    with pytest.raises(NotImplementedError):
        torch_main([str(tmp_path / "x.panman"), "r1.fq", *argv])


def test_cli_needs_a_cuda_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main([str(tmp_path / "x.panman"), "r1.fq"])


def test_long_read_slice_outputs_byte_equal_to_jax_package(tmp_path,
                                                          monkeypatch):
    """The long-read path (map-ont): a 40-node index, a 4 kb genome with a
    ~200 bp deletion, 40 Nanopore-like reads of 800-1,600 bp, one of them
    junk.  The JAX side aligns with its host DP (its bit-equality to the
    Pallas kernel is tests/test_align_long.py's job), the port with the
    kernel's plain version on CPU tensors.  A QUAL floor of 10 instead of
    30 lets ~12x depth call variants (long-read mapq is 1: ROADMAP C)."""
    w = make_long_workload(str(tmp_path / "reads"), seed=0, n_reads=40,
                           n_nodes=40, genome_len=4000, len_lo=800,
                           len_hi=1600)
    assert len(w.junk) == 1
    monkeypatch.setenv("PANMAP_PALLAS_LONG", "0")
    lines = []
    cfg = _cfg(str(tmp_path / "jax" / "sample"), w, lines, min_qual=10)
    os.makedirs(os.path.dirname(cfg.output))
    res, best, _ = hp.run_placement(cfg, w.idx)
    ref, placed, join = hp.run_alignment(cfg, w.tree, best, defer_bam=True,
                                         prefetch=hp._start_align_prefetch(cfg))
    final = hp.run_genotyping(cfg, w.idx, ref, best, placed)
    join()
    hp.run_consensus(cfg, ref, best, final)

    tcfg = _cfg(str(tmp_path / "torch" / "sample"), w, lines, min_qual=10)
    os.makedirs(os.path.dirname(tcfg.output))
    cpu = torch.device("cpu")
    tres, tbest, _ = tp.run_placement(tcfg, w.idx, cpu)
    assert tbest == best
    stats = {}
    tref, tplaced, tjoin = tp.run_alignment(
        tcfg, w.tree, tbest, cpu, defer_bam=True,
        prefetch=tp._start_align_prefetch(tcfg), stats=stats)
    tfinal = tp.run_genotyping(tcfg, w.idx, tref, tbest, tplaced)
    tjoin()
    tp.run_consensus(tcfg, tref, tbest, tfinal)

    assert [x for x in lines if "long-read preset map-ont" in x]
    assert stats["device_dp"] == stats["items"] > 0 and stats["host_dp"] == 0
    names = {p.qname for p in tplaced}
    assert len(names) == len(tplaced) > 30 and not names & set(w.junk)
    # reads across the deletion align through the long-gap tier
    assert any(n >= 150 and op == "D" for p in tplaced for n, op in p.cigar)
    assert len(tfinal) > 0
    for ext in OUTPUTS:
        a, b = f"{cfg.output}.{ext}", f"{tcfg.output}.{ext}"
        assert filecmp.cmp(a, b, shallow=False), ext
