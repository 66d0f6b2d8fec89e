"""The port's process group (panmap_tpu_torch/parallel/dist.py) on the CPU:
two gloo ranks, each with a mesh of 4 CPU shards, rendezvous through a
file in the test's own directory (no TCP port).

 - place_exact over index rows sharded across both ranks (8 shards)
   equals, in both ranks, the single-process placer and the f64 host
   engine;
 - the EM over reads sharded across both ranks: the same in both ranks,
   within 2e-4 of the single-process EM;
 - a manifest split over the two ranks (run_batch, each rank forking its
   own host workers after joining the group): the union of the outputs
   byte-equal to the single-process run_batch;
 - maybe_initialize() is False without flags or environment and leaves
   torch.distributed alone;
 - process_read_shard gives the JAX package's slices, and raises for a
   pid without nprocs or outside [0, nprocs).
"""

import filecmp
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from panmap_tpu.native import get_lib
from panmap_tpu.parallel import dist as jdist
from panmap_tpu_torch import pipeline as tp
from panmap_tpu_torch.meta import em
from panmap_tpu_torch.parallel import dist
from panmap_tpu_torch.place.engine import METRICS, score_nodes
from panmap_tpu_torch.place.query_torch import TorchPlacer
from panmap_tpu_torch.synthetic import make_workload
from test_torch_batch import split_fastq
from test_torch_meta import EM_CASES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("placement.tsv", "ref.fa", "bam", "vcf", "consensus.fa")
CPU = torch.device("cpu")

# one rank: join the group, run the three sharded paths, write a JSON
_RANK = r"""
import json, pickle, sys
import torch

torch.set_num_threads(1)
from panmap_tpu_torch import pipeline as tp
from panmap_tpu_torch.meta import em
from panmap_tpu_torch.parallel import dist, mesh as pm
from panmap_tpu_torch.place.query_torch import TorchPlacer

rank, world, init, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
lines = []
assert dist.maybe_initialize(init, world, rank, log=lines.append)
with open(data, "rb") as fh:
    d = pickle.load(fh)
cpu = torch.device("cpu")
mesh = pm.make_mesh(devices=[cpu] * 4)
size, mrank = mesh.size, mesh.rank
placer = TorchPlacer(d["idx"], cpu, mesh=mesh)
place = [placer.place_exact(sk) for sk in d["sketches"]]

reduced = []
real = pm.reduce_partials
pm.reduce_partials = lambda parts, m: reduced.append(m.size) or real(parts, m)
S, lens, w, names = d["em"]
res = em.run_squarem(torch.from_numpy(S.T.astype("int32")), lens, w, names,
                     mesh=mesh)
pm.reduce_partials = real

cfg = tp.PipelineConfig(panman="synthetic", batch_file=d["manifest"],
                        threads=2, log=lines.append)
rc = tp.run_batch(cfg, device=cpu, idx=d["idx"], tree=d["tree"])
dist.shutdown()
with open(out, "w") as fh:
    json.dump({"mesh_size": size, "rank": mrank, "lines": lines,
               "place": [None if r is None else
                         {m: [r.best_index[m], r.best_score[m],
                              r.tied_indices[m]] for m in r.best_index}
                         for r in place],
               "em": [res.node_names, res.props.tolist(), res.n_iterations],
               "reduced": sorted(set(reduced)), "batch_rc": rc}, fh)
"""

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native library unavailable")


def _manifest(path, samples, out_dir):
    with open(path, "w") as fh:
        for k, (a, b) in enumerate(samples):
            fh.write(f"{a} {b} {os.path.join(out_dir, f's{k}')}\n")
    return str(path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The workload, its inputs pickled for the ranks, and both ranks'
    JSON reports."""
    d = tmp_path_factory.mktemp("dist")
    w = make_workload(str(d / "reads"), seed=5, n_nodes=40, genome_len=30000,
                      n_pairs=240)
    samples = list(zip(split_fastq(w.reads1, str(d / "s{}_R1.fastq"), 4),
                       split_fastq(w.reads2, str(d / "s{}_R2.fastq"), 4)))
    sketches = []
    for reads in [(w.reads1, w.reads2)] + samples[:2]:
        cfg = tp.PipelineConfig(reads1=reads[0], reads2=reads[1])
        sketches.append(tp.read_sketch(cfg, w.idx)[0])
    S, lens, wt, names = EM_CASES["round_drop"]()
    data = str(d / "inputs.pkl")
    with open(data, "wb") as fh:
        pickle.dump(dict(idx=w.idx, tree=w.tree, sketches=sketches,
                         em=(S, lens, wt, names),
                         manifest=_manifest(d / "dist.txt", samples,
                                            str(d / "dist"))), fh)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    init = f"file://{d / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), "2", init, data,
         str(d / f"rank{r}.json")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append((p.returncode, err[-3000:]))
    assert all(rc == 0 for rc, _ in errs), errs
    reports = []
    for r in range(2):
        with open(d / f"rank{r}.json") as fh:
            reports.append(json.load(fh))
    return w, samples, sketches, (S, lens, wt, names), d, reports


def test_ranks_joined_one_group(ranks):
    *_, reports = ranks
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["mesh_size"] == 8
        assert [x for x in r["lines"] if x.startswith("[dist] process ")]


def test_place_exact_across_ranks_equals_one_process(ranks):
    w, _, sketches, _, _, reports = ranks
    one = TorchPlacer(w.idx, CPU)
    for i, sk in enumerate(sketches):
        want = one.place_exact(sk)
        exact = score_nodes(w.idx, sk)
        assert want is not None
        for r in reports:
            got = r["place"][i]
            assert got is not None, (r["rank"], i)
            for m in METRICS:
                for res in (want, exact):
                    assert got[m] == [res.best_index[m], res.best_score[m],
                                      res.tied_indices[m]], (r["rank"], i, m)


def test_em_across_ranks_within_2e4(ranks):
    *_, (S, lens, wt, names), _, reports = ranks
    one = em.run_squarem(torch.from_numpy(S.T.astype(np.int32)), lens, wt,
                         names)
    a, b = (r["em"] for r in reports)
    assert a == b  # the all_reduce gives both ranks the same sums
    assert reports[0]["reduced"] == [8]  # the sharded route ran
    assert a[0] == one.node_names
    assert np.abs(np.array(a[1]) - one.props).max() < 2e-4


def test_manifest_split_over_ranks_equals_one_process(ranks, tmp_path):
    w, samples, _, _, d, reports = ranks
    assert [r["batch_rc"] for r in reports] == [0, 0]
    for r, (lo, hi) in zip(reports, ((0, 2), (2, 4))):
        assert f"[batch] process shard: samples [{lo}, {hi}) of 4" in r[
            "lines"]
        assert [x for x in r["lines"] if "2 forked workers" in x]
    cfg = tp.PipelineConfig(
        panman="synthetic", threads=1,
        batch_file=_manifest(tmp_path / "one.txt", samples,
                             str(tmp_path / "one")),
        log=lambda *a, **k: None)
    assert tp.run_batch(cfg, device=CPU, idx=w.idx, tree=w.tree) == 0
    for k in range(4):
        for ext in OUTPUTS:
            a = os.path.join(d, "dist", f"s{k}.{ext}")
            b = os.path.join(tmp_path, "one", f"s{k}.{ext}")
            assert filecmp.cmp(a, b, shallow=False), (k, ext)


def test_maybe_initialize_false_without_flags_or_env(monkeypatch):
    for k in dist._ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.delattr(dist.maybe_initialize, "_done", raising=False)
    lines = []
    assert dist.maybe_initialize(log=lines.append) is False
    assert not lines
    # a partial set of flags: logged, one process
    assert dist.maybe_initialize("", 2, -1, log=lines.append) is False
    assert len(lines) == 1 and "go together" in lines[0]
    assert not torch.distributed.is_initialized()
    assert dist.process_rank_safe() == (0, 1)
    assert dist.process_read_shard(10) == slice(0, 10)


@pytest.mark.parametrize("n", [0, 1, 7, 10, 33])
def test_process_read_shard_equals_jax(n):
    for nprocs in (1, 2, 3, 4, 8):
        for pid in range(nprocs):
            assert (dist.process_read_shard(n, pid, nprocs)
                    == jdist.process_read_shard(n, pid, nprocs)), (pid,
                                                                    nprocs)


@pytest.mark.parametrize("pid, nprocs", [(1, None), (None, 2), (2, 2),
                                         (-1, 2), (0, 0)])
def test_process_read_shard_refuses_a_half_or_bad_rank(pid, nprocs):
    with pytest.raises(ValueError):
        dist.process_read_shard(10, pid, nprocs)
