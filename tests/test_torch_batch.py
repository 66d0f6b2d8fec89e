"""The port's batch mode (--batch, --meta --batch) on the CPU against the
JAX package's, on a small synthetic workload whose reads are split into
three samples over one index (panmap_tpu_torch.synthetic.make_workload: a
40-node index, a 30 kb genome, 3 x 100 read pairs).

 - read_batch_file parses every manifest form as the JAX package's does;
 - run_batch's per-sample outputs are byte-equal to panmap_tpu's run_batch
   and to three single runs of run_pipeline, through the forked pool and in
   process;
 - one TorchPlacer (one index upload) serves the whole run;
 - a sample that fails leaves exit code 1 and the other samples' files;
 - the forked workers load no jax / panmap_tpu module and never call
   torch.cuda (shown in a process of its own: this one has both loaded),
   and an explicit --device-pileup on that cannot reach them is logged;
 - the --meta --batch loop gives each sample the abundances of its single
   run.
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
from panmap_tpu_torch.align import sw
from panmap_tpu_torch.io.index_io import save_index
from panmap_tpu_torch.synthetic import make_meta_workload, make_workload
from test_torch_standalone import jax_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("placement.tsv", "ref.fa", "bam", "vcf", "consensus.fa")
CPU = torch.device("cpu")

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native library unavailable")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split_fastq(src, dst_pattern, n_parts):
    """``src``'s records dealt into ``n_parts`` files of consecutive
    records; returns their paths."""
    with open(src) as fh:
        lines = fh.readlines()
    n_rec = len(lines) // 4
    per = -(-n_rec // n_parts)
    paths = []
    for k in range(n_parts):
        paths.append(dst_pattern.format(k))
        with open(paths[-1], "w") as fh:
            fh.writelines(lines[4 * k * per:4 * (k + 1) * per])
    return paths


@pytest.fixture(scope="module")
def batch(tmp_path_factory):
    """(workload, [(reads1, reads2)] of 3 samples, dummy panman, saved
    index path)."""
    d = tmp_path_factory.mktemp("batch")
    w = make_workload(str(d / "reads"), seed=4, n_nodes=40, genome_len=30000,
                      n_pairs=300)
    r1 = split_fastq(w.reads1, str(d / "s{}_R1.fastq"), 3)
    r2 = split_fastq(w.reads2, str(d / "s{}_R2.fastq"), 3)
    panman = d / "x.panman"
    panman.write_bytes(b"")
    os.utime(panman, (0, 0))
    idx_path = str(d / "x.ptidx.npz")
    save_index(idx_path, w.idx)
    return w, list(zip(r1, r2)), str(panman), idx_path


def _manifest(path, samples, out_dir, names=None):
    with open(path, "w") as fh:
        fh.write("# reads1 reads2 prefix\n\n")
        for k, (a, b) in enumerate(samples):
            name = names[k] if names else f"s{k}"
            fh.write(f"{a} {b} {os.path.join(out_dir, name)}\n")
    return str(path)


def _same_outputs(a, b):
    for ext in OUTPUTS:
        assert filecmp.cmp(f"{a}.{ext}", f"{b}.{ext}", shallow=False), (a, ext)


# ---- the manifest ---------------------------------------------------------

MANIFESTS = {
    "three_fields": "{d}/a_R1.fastq {d}/a_R2.fastq {d}/out/a\n",
    "two_fields_fastq": "{d}/a_R1.fastq {d}/a_R2.fastq\n",
    "two_fields_fq_gz": "{d}/b_1.fq.gz {d}/b_2.FQ.gz\n",
    "two_fields_prefix": "{d}/a_R1.fastq {d}/out/named\n",
    "one_field_derived_prefix": "{d}/a_R1.fastq\n{d}/b_1.fq.gz\n",
    "comments_and_blanks": "# header\n\n  {d}/a_R1.fastq   {d}/out/x  \n#\n",
    "relative_reads": "a_R1.fastq\n",
}


@pytest.mark.parametrize("case", sorted(MANIFESTS))
def test_read_batch_file_equals_jax_package(tmp_path, monkeypatch, case):
    for name in ("a_R1.fastq", "a_R2.fastq", "b_1.fq.gz", "b_2.FQ.gz"):
        (tmp_path / name).write_text("")
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "manifest.txt"
    path.write_text(MANIFESTS[case].format(d=tmp_path))
    got = tp.read_batch_file(str(path))
    assert got == hp.read_batch_file(str(path)) and len(got) >= 1
    d = str(tmp_path)
    if case == "one_field_derived_prefix":
        assert got == [(f"{d}/a_R1.fastq", "", f"{d}/a"),
                       (f"{d}/b_1.fq.gz", "", f"{d}/b")]
    if case == "two_fields_fq_gz":
        assert got == [(f"{d}/b_1.fq.gz", f"{d}/b_2.FQ.gz", f"{d}/b")]
    if case == "relative_reads":
        assert got == [("a_R1.fastq", "", "./a")]


@pytest.mark.parametrize("line", ["missing_R1.fastq",
                                  "a_R1.fastq missing_R2.fastq out"])
def test_read_batch_file_missing_reads(tmp_path, monkeypatch, line):
    (tmp_path / "a_R1.fastq").write_text("")
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "manifest.txt"
    path.write_text(line + "\n")
    for mod in (tp, hp):
        with pytest.raises(FileNotFoundError, match="batch line 1"):
            mod.read_batch_file(str(path))


def test_run_batch_reports_a_bad_manifest(tmp_path):
    lines = []
    cfg = tp.PipelineConfig(batch_file=str(tmp_path / "none.txt"),
                            log=lambda m, *a, **k: lines.append(m))
    assert tp.run_batch(cfg, device=CPU) == 1 and "[batch] error" in lines[0]
    (tmp_path / "empty.txt").write_text("# nothing\n")
    cfg.batch_file = str(tmp_path / "empty.txt")
    assert tp.run_batch(cfg, device=CPU) == 1 and "no samples" in lines[-1]


# ---- run_batch ------------------------------------------------------------

class _Counting:
    """Counts constructions of tp.TorchPlacer (each uploads the index)."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = tp.TorchPlacer
        counter = self

        class CountingPlacer(real):
            def __init__(self, *a, **k):
                counter.n += 1
                super().__init__(*a, **k)

        monkeypatch.setattr(tp, "TorchPlacer", CountingPlacer)


@pytest.fixture(scope="module")
def single_runs(batch, tmp_path_factory):
    """Each sample through the port's run_pipeline on its own."""
    w, samples, panman, idx_path = batch
    out = tmp_path_factory.mktemp("single")
    load = tp.load_panman
    tp.load_panman = lambda path: w.tree
    try:
        for k, (a, b) in enumerate(samples):
            cfg = tp.PipelineConfig(panman=panman, reads1=a, reads2=b,
                                    index_path=idx_path,
                                    output=str(out / f"s{k}"),
                                    log=lambda *a, **k: None)
            tp.run_pipeline(cfg, device=CPU)
    finally:
        tp.load_panman = load
    return str(out)


def test_run_batch_byte_equal_to_jax_package_and_single_runs(
        batch, single_runs, pooled, tmp_path, monkeypatch):
    """Three samples through the port's forked pool (``pooled``), through
    panmap_tpu's run_batch in process, through the port's run_batch in
    process (run_pipeline's dispatch on batch_file, the index loaded from
    its file), and one by one."""
    w, samples, panman, idx_path = batch
    jidx = jax_index(w.idx)
    monkeypatch.setattr(hp, "ensure_index", lambda cfg, tree=None: (jidx,
                                                                     w.tree))
    monkeypatch.setattr(hp, "load_panman", lambda path: w.tree)
    monkeypatch.setattr(tp, "load_panman", lambda path: w.tree)
    lines = []
    jcfg = hp.PipelineConfig(
        panman=panman, mesh=1, threads=1, device_pileup="off",
        batch_file=_manifest(tmp_path / "jax.txt", samples,
                             str(tmp_path / "jax")),
        log=lambda m, *a, **k: lines.append(m))
    assert hp.run_batch(jcfg) == 0

    placers = _Counting(monkeypatch)
    tcfg = tp.PipelineConfig(
        panman=panman, index_path=idx_path, threads=1,
        batch_file=_manifest(tmp_path / "torch.txt", samples,
                             str(tmp_path / "torch")),
        log=lambda m, *a, **k: lines.append(m))
    assert tp.run_pipeline(tcfg, device=CPU) == 0
    assert placers.n == 1
    assert len([x for x in lines if "3 succeeded, 0 failed" in x]) == 2

    assert pooled["rc"] == 0 and pooled["placers"] == 1
    assert [x for x in pooled["lines"]
            if "3 forked workers" in x and "host only" in x]
    for k in range(3):
        for other in (tmp_path / "jax", tmp_path / "torch", single_runs):
            _same_outputs(os.path.join(pooled["out"], f"s{k}"),
                          os.path.join(str(other), f"s{k}"))


@pytest.mark.parametrize("threads, n_samples", [(1, 3), (4, 1)])
def test_run_batch_in_process_runs_the_device_stages(
        batch, single_runs, tmp_path, monkeypatch, threads, n_samples):
    """One worker or one sample: no pool; the stages run in this process on
    the device, the SW scoring stage included, on one TorchPlacer."""
    w, samples, panman, _ = batch
    calls = []
    launch = sw.banded_sw_scores
    monkeypatch.setattr(sw, "banded_sw_scores",
                        lambda *a: calls.append(1) or launch(*a))
    placers = _Counting(monkeypatch)
    lines = []
    cfg = tp.PipelineConfig(
        panman=panman, threads=threads,
        batch_file=_manifest(tmp_path / "m.txt", samples[:n_samples],
                             str(tmp_path / "out")),
        log=lambda m, *a, **k: lines.append(m))
    assert tp.run_batch(cfg, device=CPU, idx=w.idx, tree=w.tree) == 0
    assert placers.n == 1 and len(calls) >= n_samples
    assert not [x for x in lines if "forked workers" in x]
    for k in range(n_samples):
        _same_outputs(str(tmp_path / "out" / f"s{k}"),
                      os.path.join(single_runs, f"s{k}"))


BLOCKED = ["s0", os.path.join("..", "blocker", "sub", "s1"), "s2"]


def test_a_failing_sample_fails_alone(batch, single_runs, tmp_path):
    """A prefix under a regular file cannot be made: that sample fails,
    the exit code is 1, the other samples' files are whole."""
    w, samples, panman, _ = batch
    (tmp_path / "blocker").write_text("a file, not a directory")
    lines = []
    cfg = tp.PipelineConfig(
        panman=panman, threads=1,
        batch_file=_manifest(tmp_path / "m.txt", samples,
                             str(tmp_path / "out"), BLOCKED),
        log=lambda m, *a, **k: lines.append(m))
    assert tp.run_batch(cfg, device=CPU, idx=w.idx, tree=w.tree) == 1
    assert len([x for x in lines if "FAILED" in x]) == 1
    assert [x for x in lines if "2 succeeded, 1 failed" in x]
    for k in (0, 2):
        _same_outputs(str(tmp_path / "out" / f"s{k}"),
                      os.path.join(single_runs, f"s{k}"))


def test_a_failing_sample_fails_alone_in_the_pool(single_runs, tmp_path):
    got = _run_pooled(tmp_path, BLOCKED)
    assert got["rc"] == 1 and len(got["workers"]) == 2
    assert len([x for x in got["lines"] if "FAILED" in x]) == 1
    assert [x for x in got["lines"] if "2 succeeded, 1 failed" in x]
    for k in (0, 2):
        _same_outputs(os.path.join(got["out"], f"s{k}"),
                      os.path.join(single_runs, f"s{k}"))


def test_run_batch_stop_place_needs_no_tree(batch, single_runs, tmp_path):
    w, samples, panman, _ = batch
    cfg = tp.PipelineConfig(
        panman=panman, stop="place", threads=3,  # no tree: no pool either
        batch_file=_manifest(tmp_path / "m.txt", samples,
                             str(tmp_path / "out")),
        log=lambda *a, **k: None)
    assert tp.run_batch(cfg, device=CPU, idx=w.idx) == 0
    for k in range(3):
        assert filecmp.cmp(str(tmp_path / "out" / f"s{k}.placement.tsv"),
                           os.path.join(single_runs, f"s{k}.placement.tsv"),
                           shallow=False)
        assert not os.path.exists(tmp_path / "out" / f"s{k}.bam")


# ---- the forked workers, in a process without jax -------------------------

_WORKERS = r"""
import json, os, sys
import torch
from panmap_tpu_torch import pipeline as tp
from panmap_tpu_torch.synthetic import make_workload

out, names, pileup = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
real = tp._batch_host_stages


def watched(args):
    # in the forked worker: any use of torch.cuda is recorded, then refused
    touched = []

    def refuse(*a, **k):
        touched.append(1)
        raise RuntimeError("a batch worker reached torch.cuda")

    torch.cuda.is_available = torch.cuda._lazy_init = refuse
    torch.cuda.init = torch.cuda.synchronize = refuse
    prefix = real(args)
    bad = sorted(k for k in sys.modules
                 if k in ("jax", "jaxlib", "panmap_tpu")
                 or k.startswith(("jax.", "jaxlib.", "panmap_tpu.")))
    with open(prefix + ".worker.json", "w") as fh:
        json.dump({"pid": os.getpid(), "bad": bad, "cuda_calls": len(touched),
                   "cuda_initialized": torch.cuda.is_initialized()}, fh)
    return prefix


class CountingPlacer(tp.TorchPlacer):
    n = 0

    def __init__(self, *a, **k):
        CountingPlacer.n += 1
        super().__init__(*a, **k)


tp._batch_host_stages = watched
tp.TorchPlacer = CountingPlacer
# the workload and the split of the ``batch`` fixture
w = make_workload(os.path.join(out, "reads"), seed=4, n_nodes=40,
                  genome_len=30000, n_pairs=300)
reads = []
for src in (w.reads1, w.reads2):
    with open(src) as fh:
        reads.append(fh.readlines())
manifest = os.path.join(out, "manifest.txt")
open(os.path.join(out, "blocker"), "w").close()
os.makedirs(os.path.join(out, "out"))
with open(manifest, "w") as mf:
    for k, name in enumerate(names):
        paths = []
        for mate, lines in enumerate(reads, 1):
            paths.append(os.path.join(out, f"s{k}_R{mate}.fastq"))
            with open(paths[-1], "w") as fh:
                fh.writelines(lines[400 * k:400 * (k + 1)])
        mf.write(f"{paths[0]} {paths[1]} {os.path.join(out, 'out', name)}\n")
log = []
cfg = tp.PipelineConfig(panman="synthetic", batch_file=manifest, threads=3,
                        device_pileup=pileup,
                        log=lambda m, *a, **k: log.append(m))
rc = tp.run_batch(cfg, device=torch.device("cpu"), idx=w.idx, tree=w.tree)
reports = []
for name in names:
    path = os.path.join(out, "out", name + ".worker.json")
    if os.path.exists(path):
        with open(path) as fh:
            reports.append(json.load(fh))
print(json.dumps({"rc": rc, "parent": os.getpid(), "workers": reports,
                  "lines": log, "placers": CountingPlacer.n,
                  "out": os.path.join(out, "out")}))
"""


def _run_pooled(path, names, device_pileup="auto"):
    """run_batch with a pool of 3 forked workers on the ``batch`` fixture's
    samples, in a process that has loaded neither jax nor panmap_tpu (a
    fork of this one would carry both, and their threads)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _WORKERS, str(path),
                           json.dumps(names), device_pileup],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def pooled(tmp_path_factory):
    return _run_pooled(tmp_path_factory.mktemp("pooled"), ["s0", "s1", "s2"])


def test_forked_workers_load_no_jax_and_never_touch_cuda(pooled):
    assert pooled["rc"] == 0 and len(pooled["workers"]) == 3
    for rep in pooled["workers"]:
        assert rep["pid"] != pooled["parent"]  # a forked worker ran it
        assert rep["bad"] == [] and rep["cuda_calls"] == 0
        assert not rep["cuda_initialized"]


def test_device_pileup_on_is_reported_for_the_pool(pooled, single_runs,
                                                   tmp_path):
    """--device-pileup on with a pool: the workers still tally on the host
    (and never reach torch.cuda), the log says so, the files are the same."""
    note = "--device-pileup on does not reach the forked workers"
    assert not [x for x in pooled["lines"] if note in x]
    got = _run_pooled(tmp_path, ["s0", "s1", "s2"], "on")
    assert got["rc"] == 0 and len(got["workers"]) == 3
    assert len([x for x in got["lines"] if note in x]) == 1
    for rep in got["workers"]:
        assert rep["cuda_calls"] == 0 and not rep["cuda_initialized"]
    for k in range(3):
        _same_outputs(os.path.join(got["out"], f"s{k}"),
                      os.path.join(single_runs, f"s{k}"))


# ---- --meta --batch -------------------------------------------------------

def test_cli_meta_batch_equals_single_runs(tmp_path, monkeypatch):
    from panmap_tpu_torch.meta.index import save_meta_index
    from panmap_tpu_torch.utils import device

    mw = make_meta_workload(str(tmp_path / "reads"), seed=2, n_nodes=200,
                            genome_len=5000, n_pairs=600)
    r1 = split_fastq(mw.reads1, str(tmp_path / "m{}_R1.fastq"), 2)
    r2 = split_fastq(mw.reads2, str(tmp_path / "m{}_R2.fastq"), 2)
    panman = tmp_path / "x.panman"
    panman.write_bytes(b"")
    os.utime(panman, (0, 0))
    idx = str(tmp_path / "x.ptmidx.npz")
    save_meta_index(idx, mw.midx)
    monkeypatch.setattr(device, "cuda_device", lambda index=0: CPU)
    manifest = _manifest(tmp_path / "m.txt", list(zip(r1, r2)),
                         str(tmp_path / "batch"))
    os.makedirs(tmp_path / "batch")
    args = [str(panman), "--meta", "-i", idx, "-q"]
    assert torch_main(args + ["--batch", manifest]) == 0
    for k in range(2):
        single = str(tmp_path / f"single{k}")
        assert torch_main(args[:1] + [r1[k], r2[k]] + args[1:]
                          + ["-o", single]) == 0
        assert filecmp.cmp(single + ".mgsr.abundance.out",
                           str(tmp_path / "batch" / f"s{k}")
                           + ".mgsr.abundance.out", shallow=False)
    bad = tmp_path / "bad.txt"
    bad.write_text("missing.fastq\n")
    assert torch_main(args + ["--batch", str(bad)]) == 1
