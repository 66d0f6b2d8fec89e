"""The port's single-sample slice end to end at a small size, against the
JAX package's own stage functions on the same synthetic workload
(panmap_tpu_torch.synthetic: a 40-node index, a 30 kb genome, 300 read
pairs; and the long-read path on 40 ONT-like reads).  All five outputs
(placement.tsv, ref.fa, BAM, VCF, consensus.fa) must be byte-equal.

The JAX side runs as its tests run on the CPU: TpuPlacer on the JAX CPU
backend with mesh = 1, the Pallas SW kernel in interpret mode, the host
pileup tally.  The port runs on torch CPU tensors, where the SW wrapper uses
its plain version.  Each side gets its own package's objects: the workload
is made by the port (synthetic.py) and its index crosses to the JAX package
as a plain dict (convert.py); the configs are each package's own class.
That the port runs without jax and without panmap_tpu is
tests/test_torch_standalone.py's subject.
"""

import filecmp
import os

import pytest
import torch

from panmap_tpu import pipeline as hp
from panmap_tpu.native import get_lib
from panmap_tpu_torch import pipeline as tp
from panmap_tpu_torch.__main__ import main as torch_main
from panmap_tpu_torch.synthetic import make_long_workload, make_workload
from test_torch_standalone import jax_index
from test_torch_long import jax_front_with_port_secondary

OUTPUTS = ("placement.tsv", "ref.fa", "bam", "vcf", "consensus.fa")

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


def _cfg(mod, out, w, lines, **kw):
    """``mod``'s own PipelineConfig (hp: the JAX package, tp: the port)."""
    return mod.PipelineConfig(panman="synthetic", reads1=w.reads1,
                              reads2=w.reads2, output=out, mesh=1,
                              device_pileup="off",
                              log=lambda msg, *a, **k: lines.append(msg),
                              **kw)


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
    cfg = _cfg(hp, str(tmp_path / "jax" / "sample"), w, lines)
    jidx = jax_index(w.idx)
    os.makedirs(os.path.dirname(cfg.output))
    res, best, _ = hp.run_placement(cfg, jidx)
    ref, placed, join = hp.run_alignment(cfg, w.tree, best, defer_bam=True,
                                         prefetch=hp._start_align_prefetch(cfg))
    final = hp.run_genotyping(cfg, jidx, ref, best, placed)
    join()
    hp.run_consensus(cfg, ref, best, final)
    monkeypatch.delenv("PANMAP_PALLAS")

    # the port
    tcfg = _cfg(tp, str(tmp_path / "torch" / "sample"), w, lines)
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


@pytest.mark.parametrize("argv", [
    ["--meta", "--filter-and-assign"], ["--batch", "manifest.txt"],
    ["--device-pileup", "on"], ["--meta", "--batch", "manifest.txt"],
    ["--mesh", "2"], ["--dist-nprocs", "2"], ["--meta", "--mesh", "2"],
    ["--profile", "trace_dir"]])
def test_cli_takes_the_ported_modes(tmp_path, monkeypatch, argv):
    """Every mode of the JAX package's CLI gets past argument handling:
    with no card and an empty PanMAN they fail for the card or the file
    (or, for a manifest that is not there, return 1), not with
    NotImplementedError.  (--dist-nprocs without the other two flags runs
    one process, as the JAX package's CLI does.)"""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)  # --profile writes its trace here
    panman = tmp_path / "x.panman"
    panman.write_bytes(b"")
    if "--batch" in argv:
        assert torch_main([str(panman), *argv, "-q"]) == 1
    else:
        with pytest.raises((RuntimeError, EOFError)) as exc:
            torch_main([str(panman), "r1.fq", *argv, "-q"])
        assert not isinstance(exc.value, NotImplementedError)


def test_profile_writes_a_trace_and_leaves_the_outputs(tmp_path,
                                                       monkeypatch):
    """run_pipeline with profile_dir on CPU tensors: a torch.profiler trace
    of the run's ops in the directory, and the five outputs byte-equal to
    the same run without it."""
    from panmap_tpu_torch.io.index_io import save_index

    w = _small(tmp_path, 0)
    panman = tmp_path / "x.panman"
    panman.write_bytes(b"")
    os.utime(panman, (0, 0))  # older than the saved index: it is loaded
    idx_path = str(tmp_path / "x.ptidx.npz")
    save_index(idx_path, w.idx)
    monkeypatch.setattr(tp, "load_panman", lambda path: w.tree)
    lines = []
    outs = []
    for name, prof in (("plain", ""), ("profiled", str(tmp_path / "trace"))):
        os.makedirs(tmp_path / name)
        cfg = tp.PipelineConfig(panman=str(panman), reads1=w.reads1,
                                reads2=w.reads2, index_path=idx_path,
                                output=str(tmp_path / name / "sample"),
                                profile_dir=prof,
                                log=lambda m, *a, **k: lines.append(m))
        tp.run_pipeline(cfg, device=torch.device("cpu"))
        outs.append(cfg.output)
    for ext in OUTPUTS:
        assert filecmp.cmp(f"{outs[0]}.{ext}", f"{outs[1]}.{ext}",
                           shallow=False), ext
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(tmp_path / "trace" / traces[0]) as fh:
        trace = fh.read()
    assert '"traceEvents"' in trace and "aten::" in trace
    # the port's own spans, on the profiler's clock
    assert '"panmap:place.sketch"' in trace and '"panmap:genotype"' in trace
    assert lines.count(f"[profile] trace written to {tmp_path / 'trace'}") \
        == 1


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
    kernel's plain version on CPU tensors.  The JAX side's front end takes
    the port's secondary chain score, the one part of it the port changes
    (ROADMAP C), so that the mapq and the genotyper's quality caps agree; a
    QUAL floor of 10 instead of 30 lets ~12x depth call variants."""
    w = make_long_workload(str(tmp_path / "reads"), seed=0, n_reads=40,
                           n_nodes=40, genome_len=4000, len_lo=800,
                           len_hi=1600)
    assert len(w.junk) == 1
    monkeypatch.setenv("PANMAP_PALLAS_LONG", "0")
    jax_front_with_port_secondary(monkeypatch)
    lines = []
    cfg = _cfg(hp, str(tmp_path / "jax" / "sample"), w, lines, min_qual=10)
    jidx = jax_index(w.idx)
    os.makedirs(os.path.dirname(cfg.output))
    res, best, _ = hp.run_placement(cfg, jidx)
    ref, placed, join = hp.run_alignment(cfg, w.tree, best, defer_bam=True,
                                         prefetch=hp._start_align_prefetch(cfg))
    final = hp.run_genotyping(cfg, jidx, ref, best, placed)
    join()
    hp.run_consensus(cfg, ref, best, final)

    tcfg = _cfg(tp, str(tmp_path / "torch" / "sample"), w, lines,
                min_qual=10)
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


def _saved(tmp_path, w):
    """The workload's index saved beside an older dummy panman, so
    run_pipeline loads it; returns (panman, index path)."""
    from panmap_tpu_torch.io.index_io import save_index

    panman = tmp_path / "x.panman"
    panman.write_bytes(b"")
    os.utime(panman, (0, 0))
    idx = str(tmp_path / "x.ptidx.npz")
    save_index(idx, w.idx)
    return str(panman), idx


@pytest.mark.parametrize("option", ["bwa", "refine", "host_place",
                                    "export_ref_idx"])
def test_host_options_run_in_the_port(tmp_path, monkeypatch, option):
    """The options whose work is all host code (--aligner bwa, --refine,
    --host-place, --export-ref-idx) run through the port's own copies of
    that code, from run_pipeline down, with the JAX package's results."""
    w = _small(tmp_path, 3)
    panman, idx_path = _saved(tmp_path, w)
    monkeypatch.setattr(tp, "load_panman", lambda path: w.tree)
    lines = []
    ref_idx = str(tmp_path / "exported.idx")
    opts = {"bwa": {"aligner": "bwa"}, "refine": {"refine": True},
            "host_place": {"device_place": False},
            "export_ref_idx": {"export_ref_idx": ref_idx,
                               "stop": "place"}}[option]
    out = tmp_path / "torch"
    out.mkdir()
    cfg = tp.PipelineConfig(panman=panman, reads1=w.reads1, reads2=w.reads2,
                            index_path=idx_path, output=str(out / "sample"),
                            log=lambda m, *a, **k: lines.append(m), **opts)
    tp.run_pipeline(cfg, device=torch.device("cpu"))
    placement = open(cfg.output + ".placement.tsv").read()
    jidx = jax_index(w.idx)
    if option == "bwa":
        jout = tmp_path / "jax"
        jout.mkdir()
        jcfg = hp.PipelineConfig(panman=panman, reads1=w.reads1,
                                 reads2=w.reads2, output=str(jout / "sample"),
                                 aligner="bwa", device_pileup="off",
                                 log=lambda *a, **k: None)
        best = placement.splitlines()[1].split("\t")[-1]
        ref, placed = hp.run_alignment(jcfg, w.tree, best)
        final = hp.run_genotyping(jcfg, jidx, ref, best, placed)
        hp.run_consensus(jcfg, ref, best, final)
        assert [x for x in lines if "aDNA backend" in x]
        for ext in ("ref.fa", "bam", "vcf", "consensus.fa"):
            assert filecmp.cmp(f"{jcfg.output}.{ext}", f"{cfg.output}.{ext}",
                               shallow=False), ext
    elif option == "refine":
        assert "refined" in placement.lower()
        for ext in OUTPUTS:
            assert os.path.getsize(f"{cfg.output}.{ext}") > 0, ext
    elif option == "host_place":
        # the f64 host engine's placement is what the device path gives
        dev_out = tmp_path / "dev"
        dev_out.mkdir()
        dcfg = tp.PipelineConfig(panman=panman, reads1=w.reads1,
                                 reads2=w.reads2, index_path=idx_path,
                                 output=str(dev_out / "sample"), stop="place",
                                 log=lambda *a, **k: None)
        tp.run_pipeline(dcfg, device=torch.device("cpu"))
        assert open(dcfg.output + ".placement.tsv").read() == placement
    else:
        from panmap_tpu.io.refidx import read_ref_index

        got = read_ref_index(ref_idx)  # the JAX package reads the port's file
        assert got.node_ids == jidx.node_ids
        for name in ("seed_hashes", "parent_counts", "child_counts",
                     "node_offsets", "parent_index"):
            assert (getattr(got, name) == getattr(jidx, name)).all(), name


# ---- the pileup tally on the device ---------------------------------------

def _bincounts(col_id, g_q, g_s, g_b, ncol):
    """The host tallies of _pileup_finish (the oracle)."""
    import numpy as np

    v = g_b < 4
    f, r = v & (g_s == 0), v & (g_s == 1)
    return (np.bincount(col_id * 5 + np.minimum(g_b, 4),
                        minlength=ncol * 5).reshape(ncol, 5),
            np.bincount(col_id[v] * 4 + g_b[v],
                        weights=g_q[v].astype(np.float64),
                        minlength=ncol * 4).reshape(ncol, 4),
            np.bincount(col_id[f] * 4 + g_b[f],
                        minlength=ncol * 4).reshape(ncol, 4),
            np.bincount(col_id[r] * 4 + g_b[r],
                        minlength=ncol * 4).reshape(ncol, 4))


@pytest.mark.parametrize("n, ncol", [(1, 1), (37, 5), (5000, 300),
                                     (70000, 1100)])
def test_tally_columns_device_equals_bincounts_and_jax_package(n, ncol):
    """tally_columns_device on CPU tensors against the numpy bincounts and
    the JAX package's jitted tally, on random grouped entries (bases 0-4,
    qualities 4-63, both strands; some columns empty)."""
    import numpy as np

    from panmap_tpu.genotype.caller import tally_columns_device as jax_tally
    from panmap_tpu_torch.genotype.caller import tally_columns_device

    rng = np.random.default_rng(n)
    col_id = np.sort(rng.integers(0, ncol, n)).astype(np.int64)
    g_q = rng.integers(4, 64, n).astype(np.int64)
    g_s = rng.integers(0, 2, n).astype(np.int8)
    g_b = rng.integers(0, 5, n).astype(np.int8)
    got = tally_columns_device(col_id, g_q, g_s, g_b, ncol,
                               torch.device("cpu"))
    want = _bincounts(col_id, g_q, g_s, g_b, ncol)
    jax_got = jax_tally(col_id, g_q, g_s, g_b, ncol)
    for a, b, c in zip(got, want, jax_got):
        assert a.dtype == b.dtype == c.dtype and a.shape == b.shape
        assert np.array_equal(a, b) and np.array_equal(a, c)


@pytest.mark.parametrize("mode, env, want", [
    ("on", "", ("cpu", "cuda")), ("off", "", (None, None)),
    ("auto", "", (None, "cuda")), ("off", "1", ("cpu", "cuda")),
    ("on", "0", (None, None))])
def test_resolve_device_pileup(monkeypatch, mode, env, want):
    """on / off are explicit, auto tallies on a CUDA device only, the
    environment variable overrides all three (the JAX package's rule with
    "a locally attached accelerator" read as "a CUDA device")."""
    from panmap_tpu_torch.genotype.caller import resolve_device_pileup

    monkeypatch.setenv("PANMAP_TPU_DEVICE_PILEUP", env)
    for device, expected in zip((torch.device("cpu"),
                                 torch.device("cuda", 0)), want):
        got = resolve_device_pileup(mode, device)
        assert (got.type if got is not None else None) == expected


def test_device_pileup_on_byte_equal_to_jax_package(tmp_path, monkeypatch):
    """--device-pileup on: both packages tally on their device (here each
    one's CPU backend); the five outputs stay byte-equal, and equal to the
    port's run with the host tally."""
    from panmap_tpu.genotype import caller as hcaller
    from panmap_tpu_torch.genotype import caller as tcaller

    w = _small(tmp_path, 0)
    calls = {"jax": 0, "torch": 0}
    for name, mod in (("jax", hcaller), ("torch", tcaller)):
        def counting(*a, _real=mod.tally_columns_device, _name=name):
            calls[_name] += 1
            return _real(*a)

        monkeypatch.setattr(mod, "tally_columns_device", counting)
    lines = []
    cfg = _cfg(hp, str(tmp_path / "jax" / "sample"), w, lines)
    cfg.device_pileup = "on"
    jidx = jax_index(w.idx)
    os.makedirs(os.path.dirname(cfg.output))
    res, best, _ = hp.run_placement(cfg, jidx)
    ref, placed = hp.run_alignment(cfg, w.tree, best)
    final = hp.run_genotyping(cfg, jidx, ref, best, placed)
    hp.run_consensus(cfg, ref, best, final)

    cpu = torch.device("cpu")
    outs = {}
    for mode in ("on", "off"):
        tcfg = _cfg(tp, str(tmp_path / f"torch_{mode}" / "sample"), w, lines)
        tcfg.device_pileup = mode
        os.makedirs(os.path.dirname(tcfg.output))
        _, tbest, _ = tp.run_placement(tcfg, w.idx, cpu)
        tref, tplaced = tp.run_alignment(tcfg, w.tree, tbest, cpu)
        tfinal = tp.run_genotyping(tcfg, w.idx, tref, tbest, tplaced, cpu)
        tp.run_consensus(tcfg, tref, tbest, tfinal)
        outs[mode] = tcfg.output
    assert calls == {"jax": 1, "torch": 1} and len(final) > 0
    for ext in OUTPUTS:
        for other in (cfg.output, outs["off"]):
            assert filecmp.cmp(f"{outs['on']}.{ext}", f"{other}.{ext}",
                               shallow=False), ext
