"""A run's guards: without a card it fails instead of falling back to the
CPU, without the program beside it it fails, and the frozen generator is
deterministic per seed."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from pmbench import harness, manifest
from pmbench.frozen import panman as fpanman
from pmbench.frozen import samples as fsamples


def run_py(cwd, *extra, env=None):
    return subprocess.run(
        [sys.executable, "pmbench/run.py", "--workload", "illumina.single",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = run_py(manifest.ROOT, env=env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


PRETEND_A_CARD = """
import sys, time, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
sys.path.insert(0, ".")
from pmbench import harness
sys.exit(harness.main(["--workload", "illumina.single", "--seed", "1",
                       "--seconds", "1"], time.perf_counter()))
"""


def test_only_the_benchmark_files_no_result(tmp_path):
    """In a directory of BENCHMARK.json and pmbench/ alone (the program
    absent) a run fails, even where it finds a card."""
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "pmbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run([sys.executable, "-c", PRETEND_A_CARD], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "panmap_tpu_torch" in p.stderr
    assert p.stdout.strip() == ""


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "panmap_tpu.fake", object())
    assert harness.loaded_forbidden() == ["panmap_tpu"]
    monkeypatch.delitem(sys.modules, "panmap_tpu.fake")
    monkeypatch.setitem(sys.modules, "panmap_tpu_torchy", object())
    assert harness.loaded_forbidden() == []


def tree(seed):
    return fpanman.make_panman_model(np.random.default_rng([seed, 0]),
                                     n_nodes=200, genome_len=5000,
                                     n_blocks=6)


def test_generator_deterministic_per_seed(tmp_path):
    a, b, c = tree(11), tree(11), tree(12)
    assert np.array_equal(a.nuc_muts, b.nuc_muts)
    assert not np.array_equal(a.nuc_muts, c.nuc_muts) or \
        a.blocks[0].tobytes() != c.blocks[0].tobytes()
    fpanman.write_panman(str(tmp_path / "a"), a)
    fpanman.write_panman(str(tmp_path / "b"), b)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    leaf = a.leaves()[0]
    reads = [fsamples._simulate_pairs(np.random.default_rng(5),
                                      [a.get_string(leaf)], [1.0], 100,
                                      fsamples.NOVASEQ_ERROR)
             for _ in range(2)]
    assert all(np.array_equal(x, y) for x, y in zip(*reads))
    import random

    m1 = fsamples.simulate_mutations(a.get_string(leaf), 5, 1, 1, (1, 9),
                                     random.Random(3))
    m2 = fsamples.simulate_mutations(a.get_string(leaf), 5, 1, 1, (1, 9),
                                     random.Random(3))
    assert m1 == m2 and len(m1[1]) == 7


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    """One short run of each cell on a card: correct, and the result's
    keys as the contract names them."""
    import json

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for w in manifest.load()["workloads"]:
        p = subprocess.run(
            [sys.executable, "pmbench/run.py", "--workload", w["name"],
             "--seed", "3000000099", "--seconds", "5", "--trace", "0"],
            cwd=manifest.ROOT, capture_output=True, text=True, timeout=360)
        assert p.returncode == 0, p.stderr[-2000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["correct"], out["checks"]
        assert list(out)[-1] == "checks"
