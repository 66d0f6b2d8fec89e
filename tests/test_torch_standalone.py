"""panmap_tpu_torch stands on its own: it imports torch, numpy and the
standard library, never jax and nothing of panmap_tpu.

 (i)   A subprocess imports every module of the port, runs its CLI on a
       small synthetic single-sample workload, a two-line --batch manifest,
       a small --meta workload and a --meta --filter-and-assign sample on
       the CPU device, drives the long-read path and the CIGAR-overflow
       oracle, runs the CLI from a written PanMAN file (the decoder, both
       index builders, a sample, --simulate, --dump-node), and ends with
       no `jax*` / `panmap_tpu*` key in sys.modules
       (this process has both loaded, so only a subprocess can show it).
 (ii)  An ast walk over every .py of the port and chip_smoke.py finds no
       import of jax or panmap_tpu at any depth.
 (iii) The host layers the port carried over from the JAX package are the
       JAX package's code: every top-level function, and every method of a
       top-level class, that exists under the same name in both files has
       the same source, except a listed set, each with its reason.
 (iv)  State crosses between the packages as plain dicts (convert.py), and
       an index file saved by either package loads in the other.
 (v)   The port's native host library (its own build of its own copy of
       panmap_native.cpp) is bit-equal to the JAX package's on the entry
       points the main paths call.

The helpers ``jax_index`` / ``jax_meta_index`` / ``jax_read_sketch`` build
the JAX package's containers from the port's; the other test_torch_* files
import them to hand one synthetic workload to both packages.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from panmap_tpu.index.builder import IndexArrays as JaxIndexArrays
from panmap_tpu.index.builder import IndexParams as JaxIndexParams
from panmap_tpu.meta.index import MetaIndexArrays as JaxMetaIndexArrays
from panmap_tpu.place.engine import ReadSketch as JaxReadSketch
from panmap_tpu_torch import convert
from panmap_tpu_torch.index.builder import IndexArrays, IndexParams
from panmap_tpu_torch.meta.index import MetaIndexArrays
from panmap_tpu_torch.place.engine import ReadSketch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "panmap_tpu_torch")
JAXPKG = os.path.join(REPO, "panmap_tpu")
OUTPUTS = ("placement.tsv", "ref.fa", "bam", "vcf", "consensus.fa")


# ---- state across packages (used by the other test_torch_* files) --------

def jax_index(idx: IndexArrays) -> JaxIndexArrays:
    """The port's IndexArrays as the JAX package's (through a plain dict)."""
    assert isinstance(idx, IndexArrays)
    d = convert.as_dict(idx)
    d["params"] = JaxIndexParams(**d["params"])
    return JaxIndexArrays(**d)


def jax_meta_index(midx: MetaIndexArrays) -> JaxMetaIndexArrays:
    assert isinstance(midx, MetaIndexArrays)
    d = convert.as_dict(midx)
    d["params"] = JaxIndexParams(**d["params"])
    return JaxMetaIndexArrays(**d)


def jax_read_sketch(sk: ReadSketch) -> JaxReadSketch:
    assert isinstance(sk, ReadSketch)
    return JaxReadSketch(**convert.as_dict(sk))


def _same_fields(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for key in a:
        x, y = a[key], b[key]
        if isinstance(x, dict):
            _same_fields(x, y)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), key
        else:
            assert x == y, key


# ---- (i) no jax, no panmap_tpu, in a process of its own ------------------

_RUN = r"""
import functools, importlib, json, os, pkgutil, sys
import torch
import panmap_tpu_torch

mods = [m.name for m in pkgutil.walk_packages(panmap_tpu_torch.__path__,
                                              "panmap_tpu_torch.")]
for name in mods:
    importlib.import_module(name)

from panmap_tpu_torch import native, pipeline as tp
from panmap_tpu_torch.__main__ import main
from panmap_tpu_torch.io import fastq
from panmap_tpu_torch.io.index_io import save_index
from panmap_tpu_torch.meta.index import save_meta_index
from panmap_tpu_torch.synthetic import (make_assign_workload,
                                        make_long_workload,
                                        make_meta_workload,
                                        make_panman_workload, make_workload)
from panmap_tpu_torch.utils import device

out = sys.argv[1]
cpu = torch.device("cpu")
device.cuda_device = lambda index=0: cpu  # the caller asks for the CPU
panman = os.path.join(out, "x.panman")
open(panman, "wb").close()
os.utime(panman, (0, 0))  # older than the saved indexes: the CLI loads them

# the CLI, single sample (the tree of a synthetic workload is its genome:
# there is no PanMAN file to decode)
w = make_workload(os.path.join(out, "reads"), seed=2, n_nodes=40,
                  genome_len=30000, n_pairs=300)
idx_path = os.path.join(out, "x.ptidx.npz")
save_index(idx_path, w.idx)
load_panman = tp.load_panman
tp.load_panman = lambda path: w.tree
rc = main([panman, w.reads1, w.reads2, "-i", idx_path,
           "-o", os.path.join(out, "sample"), "-q"])
assert rc == 0, rc

# the CLI in batch mode: a manifest of two samples, through the forked pool
manifest = os.path.join(out, "manifest.txt")
with open(manifest, "w") as fh:
    for name in ("batch_a", "batch_b"):
        fh.write(f"{w.reads1} {w.reads2} {os.path.join(out, name)}\n")
rc = main([panman, "--batch", manifest, "-i", idx_path, "-t", "2", "-q"])
assert rc == 0, rc

# CIGARs past a 2-op native capacity: the numpy oracle redoes those reads
from panmap_tpu_torch.align.batch import TorchBatchAligner

ref = w.tree.get_string(None)
full = native.align_sr_native
native.align_sr_native = functools.partial(full, cigar_cap=2)
_, seqs, _ = fastq.read_paired_for_alignment(w.reads1, w.reads2)
arrays = TorchBatchAligner(ref, cpu).align_batch_arrays(seqs)
native.align_sr_native = full

# the CLI on long reads, then the stage itself for its counters
lw = make_long_workload(os.path.join(out, "long_reads"), seed=2, n_reads=6,
                        n_nodes=40, genome_len=4000)
lout = os.path.join(out, "long")
os.makedirs(lout)
lidx = os.path.join(out, "l.ptidx.npz")
save_index(lidx, lw.idx)
tp.load_panman = lambda path: lw.tree
rc = main([panman, lw.reads1, "-i", lidx, "-o", lout + "/sample", "-q"])
assert rc == 0, rc
stats = {}
lcfg = tp.PipelineConfig(panman=panman, reads1=lw.reads1,
                         output=lout + "/again", log=lambda *a, **k: None)
res, best, _ = tp.run_placement(lcfg, lw.idx, cpu)
tp.run_alignment(lcfg, lw.tree, best, cpu, stats=stats)

# the CLI with --meta on the device route (>= 2,000 unique read sets)
from panmap_tpu_torch.meta import driver as md

mw = make_meta_workload(os.path.join(out, "meta_reads"), seed=2, n_nodes=200,
                        genome_len=5000, n_pairs=1300)
midx_path = os.path.join(out, "x.ptmidx.npz")
save_meta_index(midx_path, mw.midx)
rc = main([panman, mw.reads1, mw.reads2, "--meta", "-i", midx_path,
           "-o", os.path.join(out, "meta"), "-q"])
assert rc == 0, rc
from panmap_tpu_torch import trace
from torch.profiler import ProfilerActivity, profile

trace.take()
with profile(activities=[ProfilerActivity.CPU]):
    md.run_meta(md.MetaConfig(panman=panman, reads1=mw.reads1,
                              reads2=mw.reads2,
                              output=os.path.join(out, "meta2"),
                              log=lambda *a, **k: None),
                midx=mw.midx, device=cpu)
scored = [r for r in trace.take() if r["name"] == "meta.score"]

# the CLI with --meta --filter-and-assign, demo 3's options, on the batched
# scorer's route (>= 2,000 unique read sets)
aw = make_assign_workload(os.path.join(out, "assign_reads"), seed=2,
                          n_clades=6, clade_nodes=10, genome_len=2000,
                          n_reads=3000, n_taxa=4, sister_genera=1,
                          target_share=0.5)
aidx_path = os.path.join(out, "a.ptmidx.npz")
save_meta_index(aidx_path, aw.midx)
rc = main([panman, aw.reads1, "--meta", "--filter-and-assign", "-k", "15",
           "-s", "8", "-l", "1", "--discard", "0.6", "--dust", "5",
           "--taxonomic-metadata", aw.taxonomy, "--taxonomic-rank",
           "species", "--breadth-ratio", "-i", aidx_path,
           "-o", os.path.join(out, "assign"), "-q"])
assert rc == 0, rc
# the CLI from a written PanMAN file, no stand-in: the decoder, the index
# and meta index builders, the single sample, --simulate and --dump-node
tp.load_panman = load_panman
pw = make_panman_workload(os.path.join(out, "panman"), seed=2, n_nodes=60,
                          genome_len=5000, n_pairs=500, n_blocks=6)
for argv in ([pw.reads1, pw.reads2, "-o", os.path.join(out, "from_file")],
             ["--meta", "--stop", "index"],
             ["--simulate", "--n-reads", "20", "-o",
              os.path.join(out, "panman", "sim")],
             ["--dump-node", pw.leaf, "-o", os.path.join(out, "leaf.fa")]):
    rc = main([pw.panman, *argv, "-t", "2", "-q"])
    assert rc == 0, (argv, rc)
assert os.path.exists(pw.panman + ".ptidx.npz")
assert os.path.exists(pw.panman + ".ptmidx.npz")
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "panmap_tpu")
             or k.startswith(("jax.", "jaxlib.", "panmap_tpu.")))
print(json.dumps({"bad": bad, "n_modules": len(mods),
                  "outputs": sorted(os.listdir(out)),
                  "long_outputs": sorted(os.listdir(lout)),
                  "long_device_dp": stats["device_dp"],
                  "oversized": len(arrays["extra_cigars"]),
                  "meta_route": ("device" if scored[0]["counts"]["device"]
                                 else "host"),
                  "native": native.get_lib() is not None}))
"""


def test_port_runs_without_jax_or_the_jax_package(tmp_path):
    # JAX_PLATFORMS as a CUDA host with jax installed sets it
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cuda,cpu",
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _RUN, str(tmp_path)],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    assert got["n_modules"] >= 40 and got["native"]
    assert got["oversized"] > 0
    assert got["long_device_dp"] > 0
    for ext in OUTPUTS:
        assert f"sample.{ext}" in got["outputs"], ext
        assert f"sample.{ext}" in got["long_outputs"], ext
    assert got["meta_route"] == "device"
    assert "meta.mgsr.abundance.out" in got["outputs"]
    for name in ("batch_a", "batch_b"):
        for ext in OUTPUTS:
            assert f"{name}.{ext}" in got["outputs"], (name, ext)
    for ext in ("mgsr.assignedReads.fastq", "mgsr.assignedReads.out",
                "mgsr.assignedReadsLCANode.out", "mgsr.breadths.out"):
        assert f"assign.{ext}" in got["outputs"], ext
    for ext in OUTPUTS:
        assert f"from_file.{ext}" in got["outputs"], ext
    assert "leaf.fa" in got["outputs"]


# ---- (ii) no import of jax or panmap_tpu anywhere in the port -------------

def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        if "_build" in root.split(os.sep):
            continue
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_no_import_of_jax_or_the_jax_package_at_any_depth():
    banned = ("jax", "jaxlib", "panmap_tpu")
    paths = _port_sources()
    assert len(paths) > 45
    found = []
    for path in paths:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "attr", getattr(node.func, "id", ""))
                  in ("import_module", "__import__") and node.args
                  and isinstance(node.args[0], ast.Constant)):
                names = [str(node.args[0].value)]
            for name in names:
                if name.split(".")[0] in banned:
                    found.append(f"{os.path.relpath(path, REPO)}:"
                                 f"{node.lineno}: {name}")
    assert not found, found


# ---- (iii) the carried host layers are the JAX package's code -------------

# port class -> the JAX package's class it merged (methods are compared)
MERGED = {"align/batch.py": {"TorchBatchAligner": "BatchAligner"}}

# units that differ on purpose, each with its reason
DIFFERS = {
    "native/__init__.py": {
        "_try_build": "builds into panmap_tpu_torch/_build/ under a name "
                      "made of the hash of the source, the flags and the "
                      "host's CPU features; no failure stamp file",
        "_get_lib_locked": "loads the hash-named library from _build/ "
                           "(a changed source or another CPU gets another "
                           "name, so no mtime check)",
    },
    "place/metrics.py": {
        name: "the torch twin of the jax.numpy body, under its name"
        for name in ("batched_prefix_acc", "euler_prefix", "expand_query",
                     "row_node_sums", "row_node_sums_blocked",
                     "row_node_sums_sparse", "sparse_prefix_acc")},
    "sketch/tpu.py": {
        **{name: "the torch body over int64 hashes (the u64 bit pattern), "
                 "where the JAX body carries a (hi, lo) uint32 pair"
           for name in ("_lex_lt", "_lex_min", "syncmer_scan_batch",
                        "kminmer_batch", "kminmer_batch_full")},
        "unpack_reads_2bit": "torch ops in place of jax.numpy ops",
        "encode_reads_batch": "imports the native encoder at the top of the "
                              "module, not inside a try",
    },
    "align/batch.py": {
        "TorchBatchAligner._resolve_pallas_mode":
            "the device type (or None without a device), not the Pallas "
            "mode of a JAX backend",
        "TorchBatchAligner._start_deferred":
            "an align.sw span; launches the port's banded-SW kernel; no "
            "shape tiers, no breakevens, no fallback when the device fails",
    },
    "align/longread.py": {
        "LongReadAligner.align_batch":
            "the host path only (the JAX package's device=None); the "
            "device route is TorchLongReadAligner.align_batch",
        "chain_dp": "also backtracks minimap2's anchor-disjoint chains "
                    "(mm_chain_backtrack) for the secondary score; the "
                    "best chain is the JAX package's",
        "LongReadAligner._chain_front":
            "the anchors in _anchors; the secondary score is the best "
            "anchor-disjoint chain overlapping the primary on the read "
            "(mm_set_parent), not the best f off the primary chain, so "
            "only mapq differs (ROADMAP C)",
    },
    "genotype/caller.py": {
        "resolve_device_pileup": "takes the device and returns it (or None "
                                 "for the host): auto means a CUDA device, "
                                 "not a locally attached jax accelerator",
        "tally_columns_device": "torch index_add_ on the given device, "
                                "int32 sums, no pow2 buckets and no program "
                                "cache",
        "_pileup_finish": "device_tally is the device (None: host), passed "
                          "on to tally_columns_device; genotype.columns, "
                          ".snps and .indels spans; no event list: the "
                          "IndelInput is required and goes straight to the "
                          "native indel realignment with indel_threads",
        "pileup_call": "device_tally is a device or None, not a bool; "
                       "indel_threads; no indel event list",
        "pileup_call_columnar": "device_tally is a device or None, not a "
                                "bool; a genotype.columns span; "
                                "indel_threads; no indel event list",
    },
    "genotype/indel.py": {
        "call_indels_realign":
            "native only: the per-site work is one threaded call "
            "(pt_indel_sites) and _site_record finishes each site; without "
            "the library it raises; counts on the genotype.indels span",
    },
    "meta/assign.py": {
        name: "takes the device: the fast route's batched scorer is "
              "TorchMetaScorer on it"
        for name in ("run_filter_and_assign", "_filter_assign_batches",
                     "_assign_one_batch")},
    "meta/engine.py": {
        "run_squarem": "the numpy f64 EM only: the jax branch and the "
                       "device dispatch are meta/em.py's",
    },
    "meta/driver.py": {
        "run_meta": "the port's own driver (torch scorer and EM, staged), "
                    "a run span",
        "_resolve_meta_mesh": "counts the run's CUDA cards and builds a "
                              "parallel.mesh.Mesh, not a jax Mesh",
    },
    "pipeline.py": {
        "PipelineConfig": "profile_dir's comment names torch.profiler",
        "ensure_index": "the ranks' wait for rank 0's index reads the "
                        "port's process group; no _cache_usable closure; "
                        "index.read and index.build spans, the build in "
                        "_build_index",
        "_resolve_mesh": "counts the run's CUDA cards and builds a "
                         "parallel.mesh.Mesh, not a jax Mesh",
        "_get_placer": "a TorchPlacer on the device or its mesh; no "
                       "process-wide cache (batch mode holds one placer)",
        "run_placement": "TorchPlacer instead of the jax placer, no race "
                         "with a remote link; a place.write span",
        "run_alignment": "takes the device; TorchBatchAligner and "
                         "TorchLongReadAligner run the device stages; a "
                         "missing native library raises; an align span",
        "run_pipeline": "takes the device; --profile is torch.profiler's "
                        "trace (trace.profiled)",
        "_run_pipeline_inner": "the port's stage runner (no remote-link "
                               "policy, no backend warm-up); the single "
                               "sample is _run_sample, a run span",
        "run_genotyping": "takes the device and passes it to the tally; "
                          "genotype and genotype.vcf spans; cfg.threads "
                          "to the indel realignment",
        "_batch_host_stages": "passes no device down (host DP, host tally) "
                              "instead of setting PANMAP_PALLAS=0; a "
                              "consensus span; cfg.threads 1 (the pool "
                              "fills the cores)",
        "run_batch": "one TorchPlacer for the run, the device and an "
                     "in-memory index / tree as arguments, no backend "
                     "warm-up; a run span; its loop is "
                     "_run_batch_samples",
    },
    "__main__.py": {
        "main": "the port's entry: joins a torch.distributed group "
                "for --dist-* and leaves it at the end (_main parses, "
                "builds PipelineConfig / MetaConfig with the --meta "
                "--batch loop, and runs on the CUDA device)",
    },
}

# carried modules; the number is how many units must match, source for
# source
CARRIED = {
    "__init__.py": 1,
    "__main__.py": 1, "align/adna.py": 5, "align/batch.py": 10,
    "align/bwt.py": 13, "align/core.py": 15, "align/longread.py": 6,
    "genotype/baq.py": 9, "genotype/caller.py": 23, "genotype/indel.py": 2,
    "index/builder.py": 28, "io/bam.py": 15, "io/capnp.py": 33,
    "io/fastq.py": 11, "io/index_io.py": 3, "io/panman.py": 17,
    "io/refidx.py": 14, "meta/assign.py": 7, "meta/driver.py": 2, "meta/engine.py": 39,
    "meta/events.py": 4, "meta/index.py": 7, "meta/rdg.py": 1,
    "native/__init__.py": 27, "pipeline.py": 9, "place/engine.py": 12,
    "place/metrics.py": 8, "place/refine.py": 4, "simulate.py": 7,
    "sketch/cpu.py": 14, "sketch/tpu.py": 1, "tools.py": 6, "utils/fastnp.py": 1, "ux.py": 16,
}


def _units(path, rename=None):
    """{qualified name: source} of the top-level functions, the methods of
    the top-level classes, and the classes that have no method."""
    with open(path) as fh:
        src = fh.read()
    lines = src.splitlines(keepends=True)

    def seg(node):
        first = min([node.lineno] + [d.lineno for d in node.decorator_list])
        return "".join(lines[first - 1 : node.end_lineno])

    out = {}
    for node in ast.parse(src, path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = seg(node)
        elif isinstance(node, ast.ClassDef):
            name = (rename or {}).get(node.name, node.name)
            methods = [n for n in node.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            if not methods:
                out[name] = seg(node)
            for m in methods:
                out[f"{name}.{m.name}"] = seg(m)
    return out


@pytest.mark.parametrize("module", sorted(CARRIED))
def test_carried_module_is_the_jax_packages_code(module):
    merged = MERGED.get(module, {})
    back = {v: k for k, v in merged.items()}
    port = _units(os.path.join(PORT, module))
    jaxu = _units(os.path.join(JAXPKG, module), rename=back)
    differs = DIFFERS.get(module, {})
    shared = sorted(set(port) & set(jaxu))
    same = [u for u in shared if port[u] == jaxu[u]]
    changed = sorted(set(shared) - set(same))
    assert changed == sorted(differs), (module, changed)
    assert len(same) >= CARRIED[module], (module, len(same))
    for src in port.values():  # nothing carried says jax
        assert "import jax" not in src and "from jax" not in src


# ---- (iv) convert.py and index files across the packages ------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    from panmap_tpu_torch.synthetic import make_meta_workload, make_workload

    d = tmp_path_factory.mktemp("standalone")
    w = make_workload(str(d / "reads"), seed=3, n_nodes=30, genome_len=6000,
                      n_pairs=60)
    mw = make_meta_workload(str(d / "meta"), seed=3, n_nodes=60,
                            genome_len=3000, n_pairs=100)
    return d, w, mw


def test_convert_round_trips(small):
    from panmap_tpu.place.engine import prepare_read_sketch as jax_prepare
    from panmap_tpu_torch.io import fastq
    from panmap_tpu_torch.place.engine import (prepare_read_sketch,
                                               sketch_reads)

    _, w, mw = small
    for obj, to_jax, back, jcls in (
            (w.idx, jax_index, convert.index_arrays, JaxIndexArrays),
            (mw.midx, jax_meta_index, convert.meta_index_arrays,
             JaxMetaIndexArrays)):
        there = to_jax(obj)
        assert isinstance(there, jcls)
        assert isinstance(there.params, JaxIndexParams)
        again = back(convert.as_dict(there))
        assert type(again) is type(obj)
        assert isinstance(again.params, IndexParams)
        _same_fields(convert.as_dict(obj), convert.as_dict(again))
    p = w.idx.params
    seqs = fastq.read_paired_for_placement(w.reads1, w.reads2)
    freq = sketch_reads(seqs, p.k, p.s, p.t, p.l, p.open)
    sk = prepare_read_sketch(freq, p.k, len(seqs))
    jsk = jax_read_sketch(sk)
    assert isinstance(jsk, JaxReadSketch)
    _same_fields(convert.as_dict(convert.read_sketch(convert.as_dict(jsk))),
                 convert.as_dict(sk))
    # and the JAX package's own sketch of the same reads is the same state
    _same_fields(convert.as_dict(jax_prepare(freq, p.k, len(seqs))),
                 convert.as_dict(sk))
    with pytest.raises(ValueError):
        convert.index_arrays({**convert.as_dict(w.idx), "extra": 1})


def test_index_files_load_across_packages(small):
    from panmap_tpu.io import index_io as jio
    from panmap_tpu.meta import index as jmi
    from panmap_tpu_torch.io import index_io as pio
    from panmap_tpu_torch.meta import index as pmi

    d, w, mw = small
    for compressed in (False, True):
        a, b = str(d / f"port{compressed}.npz"), str(d / f"jax{compressed}.npz")
        pio.save_index(a, w.idx, compressed=compressed)
        jio.save_index(b, jax_index(w.idx), compressed=compressed)
        want = convert.as_dict(w.idx)
        got_jax = jio.load_index(a)  # saved by the port, loaded by JAX's
        got_port = pio.load_index(b)  # and the other way round
        assert isinstance(got_jax, JaxIndexArrays)
        assert isinstance(got_port, IndexArrays)
        _same_fields(convert.as_dict(got_jax), want)
        _same_fields(convert.as_dict(got_port), want)
        assert jio.read_index_params(a) == pio.read_index_params(b)
    a, b = str(d / "port.ptmidx.npz"), str(d / "jax.ptmidx.npz")
    pmi.save_meta_index(a, mw.midx)
    jmi.save_meta_index(b, jax_meta_index(mw.midx))
    want = convert.as_dict(mw.midx)
    got_jax, got_port = jmi.load_meta_index(a), pmi.load_meta_index(b)
    assert isinstance(got_jax, JaxMetaIndexArrays)
    assert isinstance(got_port, MetaIndexArrays)
    _same_fields(convert.as_dict(got_jax), want)
    _same_fields(convert.as_dict(got_port), want)
    assert jmi.read_meta_params(a) == pmi.read_meta_params(b)


# ---- (v) the port's native library against the JAX package's --------------

def _same_result(a, b, what):
    assert type(a) is type(b), what
    if isinstance(a, dict):
        assert sorted(k for k in a if not k.startswith("_")) == sorted(
            k for k in b if not k.startswith("_")), what
        for key in a:
            if not key.startswith("_"):
                _same_result(a[key], b[key], f"{what}[{key}]")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), what
        for n, (x, y) in enumerate(zip(a, b)):
            _same_result(x, y, f"{what}[{n}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), what
    else:
        assert a == b, what


def _native_case(name, w, mw):
    """(function name, args, kwargs) on the small workloads' reads."""
    from panmap_tpu_torch.align.core import RefIndex
    from panmap_tpu_torch.io import fastq

    p = w.idx.params
    seqs = fastq.read_paired_for_placement(w.reads1, w.reads2)
    if name == "sketch_count_native":
        return (seqs, p.k, p.s, p.t, p.open, p.l), {}
    if name == "encode_reads_native":
        return (seqs, 160), {}
    if name == "align_sr_native":
        _, aseqs, _ = fastq.read_paired_for_alignment(w.reads1, w.reads2)
        ri = RefIndex(w.tree.get_string(None), 21, 11)
        return (aseqs, ri.codes2, ri.h, ri.pos, ri.strand, 21, 11), {
            "defer_dp": True}
    if name == "sketch_meta_native":
        mp = mw.midx.params
        mseqs = fastq.read_paired_for_placement(mw.reads1, mw.reads2)
        return (mseqs, mp.k, mp.s, mp.t, mp.open, mp.l), {}
    if name == "tree_accumulate_native":
        rng = np.random.default_rng(7)
        T = len(w.idx.seed_hashes)
        return ([rng.standard_normal(T) for _ in range(5)],
                [rng.integers(-1, 2, T) for _ in range(2)],
                w.idx.node_offsets.astype(np.int64), w.idx.parent_index), {}
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "sketch_count_native", "align_sr_native", "encode_reads_native",
    "sketch_meta_native", "tree_accumulate_native"])
def test_port_native_library_bit_equal_to_jax_packages(small, name):
    import panmap_tpu.native as jnat
    import panmap_tpu_torch.native as pnat

    if jnat.get_lib() is None or pnat.get_lib() is None:
        pytest.skip("native library unavailable")
    assert pnat.get_lib() is not jnat.get_lib()  # two libraries, two files
    assert os.path.dirname(pnat._so_path()) == os.path.join(PORT, "_build")
    _, w, mw = small
    args, kw = _native_case(name, w, mw)
    got = getattr(pnat, name)(*args, **kw)
    want = getattr(jnat, name)(*args, **kw)
    assert got is not None and want is not None
    _same_result(got, want, name)


@pytest.mark.parametrize("entry", ["run_pipeline", "run_meta"])
def test_main_paths_raise_when_the_native_library_is_missing(
        monkeypatch, tmp_path, entry):
    """A native library that did not build raises on the port's main paths;
    only PANMAP_TPU_NO_NATIVE sends callers to the numpy twins."""
    import torch

    import panmap_tpu_torch.native as pnat
    from panmap_tpu_torch import pipeline as tp
    from panmap_tpu_torch.meta import driver as td

    monkeypatch.setattr(pnat, "_lib", False)  # as after a failed build
    monkeypatch.setattr(pnat, "build_error", "g++: not found")
    monkeypatch.delenv("PANMAP_TPU_NO_NATIVE", raising=False)
    cpu = torch.device("cpu")
    with pytest.raises(RuntimeError, match="g\\+\\+: not found"):
        if entry == "run_pipeline":
            tp.run_pipeline(tp.PipelineConfig(panman=str(tmp_path / "x"),
                                              reads1="r.fq"), device=cpu)
        else:
            td.run_meta(td.MetaConfig(panman=str(tmp_path / "x"),
                                      reads1="r.fq"), device=cpu)
    monkeypatch.setenv("PANMAP_TPU_NO_NATIVE", "1")
    assert pnat.require_lib() is None
