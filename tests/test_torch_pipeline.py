"""The port's single-sample slice end to end at a small size, against the
JAX package's own stage functions on the same synthetic workload
(panmap_tpu_torch.synthetic: a 40-node index, a 30 kb genome, 300 read
pairs).  All five outputs (placement.tsv, ref.fa, BAM, VCF, consensus.fa)
must be byte-equal.

The JAX side runs as its tests run on the CPU: TpuPlacer on the JAX CPU
backend with mesh = 1, the Pallas SW kernel in interpret mode, the host
pileup tally.  The port runs on torch CPU tensors, where the SW wrapper uses
its plain version.  A subprocess run shows the port never loads jax (this
process has it loaded by the conftest), CIGAR-overflow realignment
included.
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
from panmap_tpu_torch.synthetic import make_workload

OUTPUTS = ("placement.tsv", "ref.fa", "bam", "vcf", "consensus.fa")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native library unavailable")


def _cfg(out, w, lines):
    return hp.PipelineConfig(panman="synthetic", reads1=w.reads1,
                             reads2=w.reads2, output=out, mesh=1,
                             device_pileup="off",
                             log=lambda msg, *a, **k: lines.append(msg))


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
from panmap_tpu_torch.synthetic import make_workload

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
print(json.dumps({"jax": "jax" in sys.modules,
                  "outputs": sorted(os.listdir(out)),
                  "oversized": len(arrays["extra_cigars"])}))
"""


def test_port_never_imports_jax(tmp_path):
    # JAX_PLATFORMS as a CUDA host with jax installed sets it: panmap_tpu's
    # own package init would import jax under it
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cuda,cpu")
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_RUN, str(tmp_path)],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["jax"] is False
    assert got["oversized"] > 0
    for ext in OUTPUTS:
        assert f"sample.{ext}" in got["outputs"], ext


@pytest.mark.parametrize("argv", [
    ["--meta"], ["--batch", "manifest.txt"], ["--mesh", "2"],
    ["--device-pileup", "on"], ["--dist-nprocs", "2"]])
def test_cli_refuses_unported_options(tmp_path, argv):
    with pytest.raises(NotImplementedError):
        torch_main([str(tmp_path / "x.panman"), "r1.fq", *argv])


def test_cli_needs_a_cuda_device(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main([str(tmp_path / "x.panman"), "r1.fq"])


def test_long_reads_refused(tmp_path):
    from panmap_tpu_torch.synthetic import GenomeTree

    fq = tmp_path / "long.fq"
    fq.write_text("@r\n" + "ACGT" * 150 + "\n+\n" + "I" * 600 + "\n")
    cfg = hp.PipelineConfig(panman="x", reads1=str(fq),
                            output=str(tmp_path / "o"),
                            log=lambda *a, **k: None)
    with pytest.raises(NotImplementedError, match="B2"):
        tp.run_alignment(cfg, GenomeTree("ACGT" * 500), "n0", "cpu")
