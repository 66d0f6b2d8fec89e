"""TorchPlacer.place_exact against TpuPlacer.place_exact and the f64 host
engine (engine.score_nodes), on the cases of tests/test_tpu_paths.py.

The final placement (best index, best score, tie set per metric) must be
exactly equal, and the port must refuse (return None) in the same cases as
the JAX package.  Every case runs on both device routes: the sparse
found-rows program and the full row stream (forced by RCAP_MAX = 0).
"""

import random

import numpy as np
import pytest
import torch

from panmap_tpu.index.builder import IndexArrays, IndexParams
from panmap_tpu.place.engine import (
    METRICS,
    prepare_read_sketch,
    score_nodes,
    sketch_reads,
)
from panmap_tpu.place.query_tpu import TpuPlacer
from panmap_tpu_torch import convert
from panmap_tpu_torch.index.builder import IndexArrays as PortIndexArrays
from panmap_tpu_torch.place.engine import ReadSketch as PortReadSketch
from panmap_tpu_torch.place.engine import score_nodes as port_score_nodes
from panmap_tpu_torch.place.query_torch import TorchPlacer

from test_tpu_paths import _synthetic_index, random_dna

CPU = torch.device("cpu")
ROUTES = ["sparse", "full_stream"]


def _port(jidx):
    """The JAX package's IndexArrays as the port's own class (state crosses
    as a dict: neither package's class is the other's)."""
    idx = convert.index_arrays(convert.as_dict(jidx))
    assert isinstance(idx, PortIndexArrays)
    return idx


def _psk(sk):
    """The JAX package's ReadSketch as the port's."""
    out = convert.read_sketch(convert.as_dict(sk))
    assert isinstance(out, PortReadSketch)
    return out


def _placer(idx, route, **kw):
    p = TorchPlacer(_port(idx), CPU, **kw)
    if route == "full_stream":
        p.RCAP_MAX = 0
    return p


def _same(got, exact, ctx):
    for m in METRICS:
        assert got.best_index[m] == exact.best_index[m], (ctx, m)
        assert got.best_score[m] == exact.best_score[m], (ctx, m)
        assert got.tied_indices[m] == exact.tied_indices[m], (ctx, m)


def _small_case(seed, n_reads, dup, rng_seed=7, miss=0.25):
    k, s, t, l = 19, 8, 0, 3
    rng = random.Random(rng_seed)
    nprng = np.random.default_rng(seed)
    base = [random_dna(rng, 150) for _ in range(n_reads)]
    seqs = base + base[:dup]
    freq = sketch_reads(seqs, k, s, t, l, False)
    read_hashes = (np.sort(freq[0]) if isinstance(freq, tuple)
                   else np.array(sorted(freq), dtype=np.uint64))
    idx = _synthetic_index(nprng, read_hashes, miss=miss)
    return idx, freq, len(seqs)


@pytest.mark.parametrize("route", ROUTES)
def test_place_exact_matches_host_engine_and_jax(route):
    """incl. force_leaf and every min-read-support setting of
    test_place_exact_matches_host_engine."""
    idx, freq, n = _small_case(17, 24, 7)
    placer = _placer(idx, route)
    jax_placer = TpuPlacer(idx, pad_len=152, batch=32)
    for ms in (-1, 1, 2):
        for fl in (False, True):
            sk_ = prepare_read_sketch(freq, 19, n, min_read_support=ms)
            exact = score_nodes(idx, sk_, force_leaf=fl)
            got = placer.place_exact(_psk(sk_), force_leaf=fl)
            ref = jax_placer.place_exact(sk_, force_leaf=fl)
            assert got is not None and ref is not None, (ms, fl)
            _same(got, exact, (ms, fl))
            _same(got, ref, (ms, fl))
            _same(port_score_nodes(_port(idx), _psk(sk_), force_leaf=fl),
                  exact, (ms, fl, "port host engine"))


@pytest.mark.parametrize("route", ROUTES)
def test_place_exact_zero_wc_denominator(route):
    """Root rows matching no read seed: wc_den == 0, the wc column is
    identically zero, and place_exact still returns the exact result."""
    idx, freq, n = _small_case(23, 16, 0)
    nprng = np.random.default_rng(5)
    a, b = int(idx.node_offsets[0]), int(idx.node_offsets[1])
    idx.seed_hashes[a:b] = nprng.integers(1, 1 << 62, b - a).astype(np.uint64)
    sk_ = prepare_read_sketch(freq, 19, n, min_read_support=1)
    exact = score_nodes(idx, sk_)
    assert exact.best_score["weighted_containment"] == 0.0
    got = _placer(idx, route).place_exact(_psk(sk_))
    assert got is not None
    _same(got, exact, route)


def test_scores_the_jax_index_tensors():
    """A placer over the JAX package's DeviceIndex, carried across by
    convert.device_index, places exactly like the port's own upload."""
    from panmap_tpu.place.engine_tpu import prepare_device_index as jprep

    idx, freq, n = _small_case(17, 24, 7)
    sk_ = prepare_read_sketch(freq, 19, n, min_read_support=1)
    own = TorchPlacer(_port(idx), CPU).place_exact(_psk(sk_))
    carried = TorchPlacer(_port(idx), CPU, dev=convert.device_index(
        convert.as_dict(jprep(idx)), CPU))
    _same(carried.place_exact(_psk(sk_)), own, "carried")
    _same(own, score_nodes(idx, sk_), "host")


def _stress_index():
    """tests/test_tpu_paths.py::test_place_exact_large_index_stress's
    20k-node / ~600k-row preorder tree with counts up to 100."""
    nprng = np.random.default_rng(41)
    NN = 20000
    parent = np.zeros(NN, np.uint32)
    chain = [0]
    for i in range(1, NN):
        d = int(nprng.integers(0, len(chain)))
        parent[i] = chain[d]
        chain = chain[: d + 1] + [i]
    rows = nprng.integers(8, 52, NN)
    offs = np.zeros(NN + 1, np.uint64)
    offs[1:] = np.cumsum(rows)
    T = int(offs[-1])
    hashes = nprng.integers(1, 1 << 62, T).astype(np.uint64)
    read_h = np.unique(nprng.choice(hashes, size=T // 3))
    freq = {int(h): int(c)
            for h, c in zip(read_h, nprng.integers(1, 40, len(read_h)))}
    matched = np.isin(hashes, read_h)
    pc = nprng.integers(0, 100, T).astype(np.int16)
    cc = nprng.integers(0, 100, T).astype(np.int16)
    pc[matched] = nprng.integers(0, 3, int(matched.sum()))
    cc[matched] = nprng.integers(1, 100, int(matched.sum()))
    idx = IndexArrays(
        params=IndexParams(), node_ids=[f"n{i}" for i in range(NN)],
        parent_index=parent, identical_to_parent=np.zeros(NN, bool),
        block_ranges=np.zeros((1, 2), np.uint32), seed_hashes=hashes,
        parent_counts=pc, child_counts=cc, node_offsets=offs)
    return idx, freq


@pytest.mark.parametrize("route", ROUTES)
def test_place_exact_large_index_stress(route):
    """At scale the result is exact or refused, never a wrong tie set."""
    idx, freq = _stress_index()
    sk_ = prepare_read_sketch(freq, 19, 100000, min_read_support=1)
    exact = score_nodes(idx, sk_)
    got = _placer(idx, route).place_exact(_psk(sk_))
    if got is not None:
        _same(got, exact, route)


def test_place_exact_closure_guard_refuses_bad_candidate_set():
    """Clearing the true best node's candidate bit must make the closure
    guard refuse (None), never return a wrong tie set."""
    idx, freq, n = _small_case(59, 24, 0)
    sk_ = prepare_read_sketch(freq, 19, n, min_read_support=1)
    exact = score_nodes(idx, sk_)
    placer = TorchPlacer(_port(idx), CPU)
    got = placer.place_exact(_psk(sk_))
    assert got is not None and got.best_index == exact.best_index
    inner = placer._score_sparse_dispatch
    victim = exact.best_index[METRICS[0]]
    assert victim is not None

    def tampered(*args, **kw):
        out = inner(*args, **kw)
        assert out is not None, "sparse path must be in use on this index"
        cand, best, col = out
        cand = cand.clone()
        cand[victim, 0] = False
        return cand, best, col

    placer._score_sparse_dispatch = tampered
    assert placer.place_exact(_psk(sk_)) is None


@pytest.mark.parametrize("route", ROUTES)
def test_place_exact_adversarial_sweep(route):
    """Deep chains, wide fans, large counts, heavy hash aliasing: exact or
    refused, refusing exactly when the JAX package refuses; a tree with at
    most WITNESS_J nodes (complete closure) is never refused."""
    refused = matched = 0
    for seed in range(8):
        nprng = np.random.default_rng(100 + seed)
        NN = int(nprng.choice([6, 40, 300, 1500]))
        parent = np.zeros(NN, np.uint32)
        chain = [0]
        for i in range(1, NN):
            d = (len(chain) - 1 if seed % 2 == 0
                 else int(nprng.integers(0, len(chain))))
            parent[i] = chain[d]
            chain = chain[: d + 1] + [i]
        rows = nprng.integers(2, 30, NN)
        offs = np.zeros(NN + 1, np.uint64)
        offs[1:] = np.cumsum(rows)
        T = int(offs[-1])
        pool = nprng.integers(1, 1 << 62, max(T // 4, 8)).astype(np.uint64)
        hashes = pool[nprng.integers(0, len(pool), T)]
        read_h = np.unique(nprng.choice(pool, size=len(pool) // 2))
        freq = {int(h): int(c) for h, c in
                zip(read_h, nprng.integers(1, 200, len(read_h)))}
        cmax = 120 if seed % 3 == 0 else 5
        idx = IndexArrays(
            params=IndexParams(), node_ids=[f"n{i}" for i in range(NN)],
            parent_index=parent, identical_to_parent=np.zeros(NN, bool),
            block_ranges=np.zeros((1, 2), np.uint32), seed_hashes=hashes,
            parent_counts=nprng.integers(0, cmax, T).astype(np.int16),
            child_counts=nprng.integers(0, cmax, T).astype(np.int16),
            node_offsets=offs)
        sk_ = prepare_read_sketch(freq, 19, 5000, min_read_support=1)
        exact = score_nodes(idx, sk_)
        placer = _placer(idx, route)
        got = placer.place_exact(_psk(sk_))
        if NN <= placer.WITNESS_J:
            assert got is not None, (seed, NN)
        if route == "sparse":
            ref = TpuPlacer(idx).place_exact(sk_)
            assert (got is None) == (ref is None), seed
        if got is None:
            refused += 1
            continue
        matched += 1
        _same(got, exact, seed)
    assert matched >= refused, (matched, refused)
