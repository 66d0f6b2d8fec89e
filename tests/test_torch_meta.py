"""The port's metagenomic abundance slice (--meta) against the JAX package
on the CPU, at a small size: a make_meta_workload of a few hundred nodes, a
5 kb genome and five haplotypes.

 - Scorer (exact equality): TorchMetaScorer's host prep, per-chunk
   presence bitmaps and scores equal TpuMetaScorer's (NODE_CHUNK forced to
   64 on both, so carries cross several chunks) and the host scorer
   MetaScorer.score_all's; some reads hold no seedmer of the index.
 - EM (2e-4, the recorded f32/f64 bound): the torch EM against
   run_squarem on a JAX device array and the numpy f64 EM, with the same
   surviving names and identical-column groups; each matrix keeps its
   proportions clear of the drop threshold at every round, asserted.
 - Driver and CLI: the port's run_meta / `--meta` against the JAX
   package's (mesh 1: conftest gives JAX 8 virtual CPU devices) on the
   device route, the host route, --em-f64 and --host-score.

The port runs on CPU tensors, passed on purpose; JAX runs on its CPU
backend.  The workload is the port's (synthetic.py); the JAX package gets
its own MetaIndexArrays, MetaRead and MetaConfig objects, built from the
port's through plain dicts (convert.py).
"""

import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from panmap_tpu.meta import driver as hd
from panmap_tpu.meta.engine import PROP_THRESHOLD_TO_REMOVE, MetaScorer
from panmap_tpu.meta.engine import MetaRead as JaxMetaRead
from panmap_tpu.meta.engine import run_squarem as jax_run_squarem
from panmap_tpu.meta.engine_tpu import TpuMetaScorer
from panmap_tpu_torch.meta.index import save_meta_index
from panmap_tpu.native import get_lib
from panmap_tpu_torch import convert, trace
from panmap_tpu_torch.__main__ import main as torch_main
from panmap_tpu_torch.meta import driver as td
from panmap_tpu_torch.meta import em
from panmap_tpu_torch.meta.engine import MetaRead
from panmap_tpu_torch.meta.engine import MetaScorer as PortMetaScorer
from panmap_tpu_torch.meta.engine import run_squarem as port_f64_squarem
from panmap_tpu_torch.meta.engine_torch import (
    TorchMetaScorer,
    meta_inputs,
    presence_chunk,
    presence_events_torch,
    score_block,
)
from panmap_tpu_torch.meta.events import (
    overlap_coefficients_from_events,
    presence_events,
)
from panmap_tpu_torch.synthetic import make_meta_workload
from test_meta_em import _synthetic
from test_torch_standalone import jax_meta_index

CPU = torch.device("cpu")

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native library unavailable")


def _workload(path, n_pairs, seed=1):
    return make_meta_workload(str(path), seed=seed, n_nodes=300,
                              genome_len=5000, n_pairs=n_pairs)


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """A 300-node workload's sketch plus 6 reads of seedmers absent from
    the index, scored by both device scorers with 64-node chunks."""
    w = _workload(tmp_path_factory.mktemp("meta_scorer"), 600)
    cfg = td.MetaConfig(reads1=w.reads1, reads2=w.reads2,
                        log=lambda *a, **k: None)
    reads, _ = td.sketch(cfg, w.midx)
    rng = np.random.default_rng(5)
    for _ in range(6):
        k = int(rng.integers(3, 12))
        reads.append(MetaRead(hashes=rng.integers(1, 1 << 62, k).astype(
            np.uint64), revs=rng.random(k) < 0.5, n_dup=1))
    saved = TpuMetaScorer.NODE_CHUNK, TorchMetaScorer.NODE_CHUNK
    TpuMetaScorer.NODE_CHUNK = TorchMetaScorer.NODE_CHUNK = 64
    # the same state as the JAX package's own objects
    w.jmidx = jax_meta_index(w.midx)
    w.jreads = [JaxMetaRead(**convert.as_dict(r)) for r in reads]
    try:
        jx = TpuMetaScorer(w.jmidx, w.jreads)
        pt = TorchMetaScorer(w.midx, reads, CPU)
    finally:
        TpuMetaScorer.NODE_CHUNK, TorchMetaScorer.NODE_CHUNK = saved
    return w, reads, jx, pt


def _tpu_rows(pt, jx):
    """TpuMetaScorer's bitmap row of each of the port's rows: the port
    lays out [fwd U | rev U | dummy], TpuMetaScorer pads each half to
    Upad (a power of two) before its dummy row."""
    U = pt.U
    return np.concatenate([np.arange(U), jx.Upad + np.arange(U),
                           [jx.n_rows - 1]])


def _port_row_of(pt, jx):
    """The inverse map: the port's row of each TpuMetaScorer row (-1 on
    its padding rows)."""
    lut = np.full(jx.n_rows, -1, dtype=np.int64)
    lut[_tpu_rows(pt, jx)] = np.arange(pt.n_rows)
    return lut


def test_host_prep_equals_tpu_scorer(scored):
    _, reads, jx, pt = scored
    assert pt.NODE_CHUNK == jx.NODE_CHUNK == 64 and pt.n_chunks > 4
    assert pt.U == jx.U and pt.n_rows == 2 * pt.U + 1 < jx.n_rows
    assert np.array_equal(pt.read_hashes, jx.read_hashes)
    rows, lut = _tpu_rows(pt, jx), _port_row_of(pt, jx)
    assert np.array_equal(pt._evp_key.cpu().numpy(), lut[jx._evp_key])
    for a, b in ((pt._evp_pos, jx._evp_pos), (pt._evp_delta, jx._evp_delta)):
        assert np.array_equal(a.cpu().numpy(), b)
    assert pt._chunk_lo == jx._chunk_lo
    assert len(pt._carries) == len(jx._carries)
    for mine, theirs in zip(pt._carries.cpu().numpy(), jx._carries):
        assert np.array_equal(mine, theirs[rows])
        assert not theirs[lut < 0].any()
    # TpuMetaScorer pads reads to 4,096-row blocks and slots to a power of
    # two: its extra rows and slots all point at the dummy row
    R, S = len(reads), pt.n_slots
    dummy = pt.n_rows - 1
    for mine, dev in ((pt._fwd_t, jx._occ_fwd_dev),
                      (pt._rev_t, jx._occ_rev_dev)):
        theirs = lut[np.asarray(dev).reshape(-1, jx.n_slots)]
        assert np.array_equal(mine.cpu().numpy(), theirs[:R, :S])
        assert (theirs[R:] == dummy).all() and (theirs[:, S:] == dummy).all()
    assert (pt._fwd_t[-6:] == dummy).all()  # the absent reads


def test_presence_chunk_equals_tpu_scorer(scored):
    _, _, jx, pt = scored
    rows, lut = _tpu_rows(pt, jx), _port_row_of(pt, jx)
    for ci in range(pt.n_chunks):
        got = pt.presence(ci)
        theirs = np.asarray(jx._p_chunk(ci))
        assert got.dtype == torch.uint8 and int(got.max()) <= 1
        assert np.array_equal(got.numpy(), theirs[rows])
        assert not theirs[lut < 0].any()


def test_presence_chunk_carry_only():
    """With no events a chunk's rows are their carry-in state throughout."""
    carry = torch.tensor([0, 2, -1, 1], dtype=torch.int32)
    e = torch.empty(0, dtype=torch.int64)
    P = presence_chunk(carry, e, e, e.to(torch.int32), 4, 8)
    assert P.tolist() == [[0] * 8, [1] * 8, [0] * 8, [1] * 8]


@pytest.mark.parametrize("S", [7, 300])
def test_score_block_sums_slots(S):
    """score_block against a direct count, below and above 256 slots (the
    slot sum runs in uint8 below, int32 above)."""
    rng = np.random.default_rng(S)
    P = (rng.random((50, 20)) < 0.5).astype(np.uint8)
    P[-1] = 0  # the dummy row
    fk, rk = rng.integers(0, 50, (2, 4, S))
    fwd = P[fk].sum(1)
    rev = P[rk].sum(1)
    m, sc = score_block(torch.from_numpy(P), torch.from_numpy(fk),
                        torch.from_numpy(rk), 13)
    assert np.array_equal(sc.numpy(), np.maximum(fwd, rev))
    assert np.array_equal(m.numpy(), np.maximum(fwd, rev)[:, :13].max(1))


def _last_partial_chunk(n, C):
    return list(range((n - 1) // C * C, n))


@pytest.mark.parametrize("which", ["none", "all", "subset", "last_chunk"])
def test_score_all_equals_tpu_and_host_scorer(scored, which):
    w, reads, jx, pt = scored
    n = len(w.midx.node_ids)
    cand = {"none": [], "all": list(range(n)),
            "subset": np.random.default_rng(3).choice(n, 40, replace=False)
            .tolist(),
            "last_chunk": _last_partial_chunk(n, 64)}[which]
    assert n % 64 != 0
    ms, snap = pt.score_all(cand)
    assert snap.shape == (len(reads), len(cand)) and snap.dtype == torch.int16
    jms, jsnap = jx.score_all(cand)
    hms, hsnap = MetaScorer(w.jmidx, w.jreads).score_all(cand)
    pms, psnap = PortMetaScorer(w.midx, reads).score_all(cand)
    assert ms.dtype == np.int32
    assert np.array_equal(ms, jms) and np.array_equal(ms, hms)
    assert np.array_equal(pms, hms) and np.array_equal(psnap, hsnap)
    got = snap.numpy().T.astype(np.int64)
    assert np.array_equal(got, jsnap.astype(np.int64))
    assert np.array_equal(got, hsnap.astype(np.int64))
    assert (ms[-6:] == 0).all() and ms[:-6].max() > 20


def test_device_scorer_routing(scored):
    """The device scorer takes >= 2,000 read sets, unless --host-score,
    --pseudochain or the scores TSV asks for the host scorer."""
    w, reads, _, _ = scored
    reads = (reads * 2)[:2000]
    cfg = td.MetaConfig(log=lambda *a, **k: None)
    assert td.make_scorers(cfg, w.midx, reads, CPU)[1] is not None
    assert td.make_scorers(cfg, w.midx, reads[:1999], CPU)[1] is None
    for opt in ("host_score", "pseudochain", "write_read_scores_unfiltered"):
        c = td.MetaConfig(log=lambda *a, **k: None, **{opt: True})
        assert td.make_scorers(c, w.midx, reads, CPU)[1] is None


# ---- the scorer's build against the host oracles ------------------------

def _host_build(midx, reads, C):
    """The scorer's state as numpy built it on the host before the build
    moved to the device (TorchMetaScorer.__init__ then): the read hashes,
    the event table by position, the chunk carries and bounds, each
    event's column and the reads' key slots."""
    all_h = (np.concatenate([r.hashes for r in reads])
             if reads else np.empty(0, np.uint64))
    uniq_h = np.unique(all_h)
    idx_h = np.unique(np.asarray(midx.seed_hash, dtype=np.uint64))
    if len(idx_h) and len(uniq_h):
        ii = np.minimum(np.searchsorted(idx_h, uniq_h), len(idx_h) - 1)
        read_hashes = uniq_h[idx_h[ii] == uniq_h]
    else:
        read_hashes = uniq_h[:0]
    ev = presence_events(midx, read_hashes)
    U = len(read_hashes)
    n_rows = 2 * U + 1
    n_nodes = len(midx.node_ids)
    key = (np.where(ev["ev_rev"], U, 0) + ev["ev_uid"]).astype(np.int64)
    order = np.argsort(ev["ev_node"], kind="stable")
    evp_pos = ev["ev_node"][order].astype(np.int64)
    evp_key = key[order]
    evp_delta = ev["ev_delta"][order].astype(np.int32)
    R = len(reads)
    nseeds = np.array([len(r.hashes) for r in reads], dtype=np.int64)
    if U:
        occ_pos = np.minimum(np.searchsorted(read_hashes, all_h), U - 1)
        occ_found = read_hashes[occ_pos] == all_h
    else:
        occ_pos = np.zeros(len(all_h), dtype=np.int64)
        occ_found = np.zeros(len(all_h), dtype=bool)
    occ_uid = occ_pos.astype(np.int64)
    occ_rev = (np.concatenate([np.asarray(r.revs, dtype=bool) for r in reads])
               if reads else np.empty(0, bool))
    S = max(int(nseeds.max()) if R else 1, 1)
    dummy = n_rows - 1
    fwd_sl = np.full((R, S), dummy, dtype=np.int32)
    rev_sl = np.full((R, S), dummy, dtype=np.int32)
    row_of = np.repeat(np.arange(R, dtype=np.int64), nseeds)
    slot_of = (np.arange(len(occ_uid), dtype=np.int64)
               - np.repeat(np.cumsum(nseeds) - nseeds, nseeds))
    fwd_sl[row_of, slot_of] = np.where(
        ~occ_found, dummy, np.where(occ_rev, U + occ_uid, occ_uid))
    rev_sl[row_of, slot_of] = np.where(
        ~occ_found, dummy, np.where(occ_rev, occ_uid, U + occ_uid))
    chunk_lo = list(range(0, n_nodes + 1, C))
    carries = []
    state = np.zeros(n_rows, dtype=np.int32)
    prev = 0
    for lo in chunk_lo:
        cut = np.searchsorted(evp_pos, lo)
        np.add.at(state, evp_key[prev:cut], evp_delta[prev:cut])
        prev = cut
        carries.append(state.copy())
    bounds = np.searchsorted(evp_pos, chunk_lo + [n_nodes + 1])
    ev_col = evp_pos - np.repeat(np.asarray(chunk_lo, np.int64),
                                 np.diff(bounds))
    return dict(read_hashes=read_hashes, ev=ev, evp_pos=evp_pos,
                evp_key=evp_key, evp_delta=evp_delta, chunk_lo=chunk_lo,
                carries=np.stack(carries), bounds=bounds, ev_col=ev_col,
                fwd=fwd_sl, rev=rev_sl, S=S)


def _absent_reads(rng, n):
    return [MetaRead(hashes=rng.integers(1, 1 << 62, k).astype(np.uint64),
                     revs=rng.random(k) < 0.5, n_dup=1)
            for k in rng.integers(3, 12, n)]


def _build_case(scored, case):
    """(midx, reads, node chunk) of a build case: the scored fixture's
    sketch with 64-node or default chunks; reads none of whose hashes the
    index holds (U = 0); reads whose every other occurrence is absent."""
    w, reads, _, _ = scored
    rng = np.random.default_rng(17)
    if case == "no_read_hash_in_index":
        reads = _absent_reads(rng, 40)
    elif case == "absent_mixed":
        mixed = []
        for r in reads[:200]:
            h = r.hashes.copy()
            h[::2] = rng.integers(1, 1 << 62, len(h[::2])).astype(np.uint64)
            mixed.append(MetaRead(hashes=h, revs=r.revs, n_dup=1))
        reads = mixed + _absent_reads(rng, 3)
    C = 64 if case in ("chunk64", "absent_mixed") else (
        TorchMetaScorer.NODE_CHUNK)
    return w.midx, reads, C


BUILD_CASES = ["chunk64", "default_chunk", "no_read_hash_in_index",
               "absent_mixed"]


def _scorer(midx, reads, C, device):
    saved = TorchMetaScorer.NODE_CHUNK
    TorchMetaScorer.NODE_CHUNK = C
    try:
        return TorchMetaScorer(midx, reads, device)
    finally:
        TorchMetaScorer.NODE_CHUNK = saved


@pytest.mark.parametrize("case", BUILD_CASES)
def test_device_event_table_equals_presence_events(scored, case):
    """presence_events_torch's read hashes, occurrence uids and event
    table against the host's restriction and events.presence_events,
    element for element and in the host's order."""
    midx, reads, C = _build_case(scored, case)
    host = _host_build(midx, reads, C)
    t = {k: torch.from_numpy(x) for k, x in meta_inputs(midx, reads).items()}
    read_hashes, occ_uid, ev = presence_events_torch(t)
    rh = host["read_hashes"]
    assert np.array_equal(read_hashes.numpy().view(np.uint64), rh)
    assert (len(rh) == 0) == (case == "no_read_hash_in_index")
    all_h = np.concatenate([r.hashes for r in reads])
    want_uid = np.full(len(all_h), -1, dtype=np.int64)
    if len(rh):
        pos = np.minimum(np.searchsorted(rh, all_h), len(rh) - 1)
        want_uid = np.where(rh[pos] == all_h, pos, -1)
    assert np.array_equal(occ_uid.numpy(), want_uid)
    if case == "absent_mixed":
        assert (want_uid < 0).any() and (want_uid >= 0).any()
    want = presence_events(midx, rh)
    assert set(ev) == set(want)
    for k, v in want.items():
        assert np.array_equal(ev[k].numpy(), v), k
    assert len(want["den_node"]) > 0
    assert (len(want["ev_node"]) > 0) == (case != "no_read_hash_in_index")


@pytest.mark.parametrize("case", BUILD_CASES)
def test_device_build_equals_host_build(scored, case):
    """The scorer's event order, carries, chunk bounds, event columns and
    key slots against the numpy build, element for element; its overlap
    coefficients against overlap_coefficients_from_events, bit for bit."""
    midx, reads, C = _build_case(scored, case)
    host = _host_build(midx, reads, C)
    pt = _scorer(midx, reads, C, CPU)
    assert pt.NODE_CHUNK == C and pt._chunk_lo == host["chunk_lo"]
    assert (pt.n_chunks > 4) == (C == 64)
    assert pt.U == len(host["read_hashes"]) and pt.n_slots == host["S"]
    assert np.array_equal(pt.read_hashes, host["read_hashes"])
    assert all(x is y for x, y in zip(pt._ev_on[CPU], (
        pt._evp_key, pt._evp_pos, pt._evp_delta, pt._carries)))
    for got, want in ((pt._evp_pos, "evp_pos"), (pt._evp_key, "evp_key"),
                      (pt._evp_delta, "evp_delta"),
                      (pt._carries, "carries"), (pt._fwd_t, "fwd"),
                      (pt._rev_t, "rev")):
        assert got.dtype == torch.from_numpy(host[want]).dtype, want
        assert np.array_equal(got.numpy(), host[want]), want
    assert np.array_equal(pt._ev_bounds, host["bounds"])
    # the columns presence() hands presence_chunk: position - chunk start
    b = pt._ev_bounds
    col = np.concatenate([pt._evp_pos[b[ci]:b[ci + 1]].numpy() - lo
                          for ci, lo in enumerate(pt._chunk_lo)])
    assert np.array_equal(col, host["ev_col"])
    assert len(col) == len(host["ev_col"]) and (col < C).all()
    oc = pt.overlap_coefficients()
    want = overlap_coefficients_from_events(host["ev"], len(midx.node_ids))
    assert oc.dtype == np.float64
    assert np.array_equal(oc.view(np.int64), want.view(np.int64))
    if case != "no_read_hash_in_index":
        assert oc.max() > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", BUILD_CASES)
def test_cuda_build_matches_cpu(scored, case):
    """The card's build equals the build on CPU tensors, tensor for
    tensor."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    midx, reads, C = _build_case(scored, case)
    cpu = _scorer(midx, reads, C, CPU)
    gpu = _scorer(midx, reads, C, "cuda")
    for name in ("_evp_pos", "_evp_key", "_evp_delta", "_carries", "_fwd_t",
                 "_rev_t"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    assert np.array_equal(gpu.read_hashes, cpu.read_hashes)
    assert np.array_equal(gpu._ev_bounds, cpu._ev_bounds)
    assert np.array_equal(gpu.overlap_coefficients().view(np.int64),
                          cpu.overlap_coefficients().view(np.int64))


# ---- EM ----------------------------------------------------------------

def _round_drop_matrix():
    """tests/test_meta_em.py::test_device_em_rescales_after_round_drop's
    matrix: two haplotypes and ten trap columns that each dominate 4
    reads by ~106 nats and drop after round 1."""
    rng = np.random.default_rng(11)
    R, M = 1000, 12
    lens = np.full(R, 40, dtype=np.int64)
    S = np.zeros((M, R), dtype=np.uint16)
    owner = rng.choice([0, 1], R, p=[0.7, 0.3])
    for j in range(R):
        S[owner[j], j] = 40
        S[1 - owner[j], j] = 40 - int(rng.integers(3, 7))
    for t in range(40):
        S[:, t] = 0
        S[2 + t % 10, t] = 40
        S[1, t] = 20
        S[0, t] = 15
    return S, lens, np.ones(R), [f"n{i}" for i in range(M)]


def _duplicates_matrix():
    """_synthetic with more identical columns, some far apart (1 = 7 = 11,
    0 = 13) and a near-duplicate of column 2 that differs in one read."""
    S, lens, w, _ = _synthetic(M=14, R=600, seed=4)
    S[7] = S[11] = S[1]
    S[13] = S[0]
    S[5] = S[2]
    S[5, 17] = S[2, 17] + 1
    return S, lens, w, [f"n{i}" for i in range(14)]


EM_CASES = {"synthetic": lambda: _synthetic(),
            "round_drop": _round_drop_matrix,
            "duplicates": _duplicates_matrix}


def _drop_margin(S, lens, w):
    """The smallest |p - drop threshold| over the rounds of the torch EM
    (one round at a time, on the surviving columns)."""
    St = torch.from_numpy(S.T.astype(np.int32))
    cols = np.arange(S.shape[0])
    margin = 1.0
    for _ in range(5):
        p, _, _ = em.squarem(St[:, torch.from_numpy(cols)],
                             torch.from_numpy(lens), torch.from_numpy(w),
                             max_rounds=1)
        p = p.numpy()
        margin = min(margin, float(np.abs(p - PROP_THRESHOLD_TO_REMOVE)
                                   .min()))
        keep = p >= PROP_THRESHOLD_TO_REMOVE
        if keep.all():
            break
        cols = cols[keep]
    return margin


@pytest.mark.parametrize("case", sorted(EM_CASES))
def test_em_matches_jax_device_em_and_f64(case):
    import jax.numpy as jnp

    S, lens, w, names = EM_CASES[case]()
    # a proportion within ~1e-4 of the threshold may survive in one f32
    # implementation and drop in the other: these matrices keep clear
    assert _drop_margin(S, lens, w) > 5e-4
    got = em.run_squarem(torch.from_numpy(S.T.astype(np.int32)), lens, w,
                         names)
    jx = jax_run_squarem(jnp.asarray(S.T), lens, w, names)
    f64 = jax_run_squarem(S, lens, w, names, backend="numpy")
    mine = port_f64_squarem(S, lens, w, names)  # the carried numpy f64 EM
    assert mine.node_names == f64.node_names
    assert np.array_equal(mine.props, f64.props)
    assert mine.identical_groups == f64.identical_groups
    assert got.n_iterations > 0
    for other in (jx, f64):
        assert got.node_names == other.node_names
        assert {k: sorted(v) for k, v in got.identical_groups.items()} == {
            k: sorted(v) for k, v in other.identical_groups.items()}
        assert np.abs(got.props - other.props).max() < 2e-4
    if case == "duplicates":
        assert sorted(got.identical_groups) == ["n0", "n1", "n2"]
        assert sorted(got.identical_groups["n1"]) == ["n11", "n7"]
        assert "n5" not in got.identical_groups["n2"]


def test_collapse_identical_representatives():
    """First index of each class represents it; unequal columns stay."""
    S, lens, w, names = _duplicates_matrix()
    keep, groups = em.collapse_identical(
        torch.from_numpy(S.T.astype(np.int16)), len(lens), names)
    assert keep == [0, 1, 2, 4, 5, 6, 8, 9, 10, 12]
    assert groups == {"n1": ["n7", "n11"], "n2": ["n3"], "n0": ["n13"]}


def test_run_squarem_routing(monkeypatch):
    """engine.run_squarem's routing: a tensor runs the torch EM; a host
    matrix [M, R] above 5,000,000 cells runs it as [R, M] on ``device``,
    or on the CPU under prefer_cpu; one at or below runs the numpy f64
    EM."""
    calls = []
    monkeypatch.setattr(em, "run_squarem_torch",
                        lambda S, *a, **k: calls.append(("torch", S)))
    monkeypatch.setattr(em, "host_run_squarem",
                        lambda S, *a, **k: calls.append((k["backend"], S)))
    R = 2_500_000
    lens, w = np.full(R, 20), np.ones(R)
    at = np.zeros((2, R), np.uint16)
    above = np.zeros((2, R + 1), np.uint16)
    em.run_squarem(at, lens, w, ["a", "b"])
    em.run_squarem(above, lens, w, ["a", "b"], prefer_cpu=True)
    em.run_squarem(above, lens, w, ["a", "b"], device="cpu")
    em.run_squarem(torch.zeros((R, 2), dtype=torch.int16), lens, w,
                   ["a", "b"])
    assert [c for c, _ in calls] == ["numpy", "torch", "torch", "torch"]
    assert calls[0][1] is at
    for _, S in calls[1:3]:
        assert S.device == CPU and S.shape == (R + 1, 2)


@pytest.mark.parametrize("snap", ["device", "host"])
def test_em_f64_runs_the_numpy_em_above_5m_cells(monkeypatch, snap):
    """--em-f64 runs the numpy f64 EM on [M, R] uint16 whatever the
    matrix's size, as the JAX package forces backend="numpy": never the
    torch EM, which the plain routing picks past 5,000,000 cells."""
    calls = []
    monkeypatch.setattr(em, "run_squarem_torch",
                        lambda *a, **k: calls.append(("torch", None)))
    monkeypatch.setattr(td, "host_run_squarem",
                        lambda S, *a, **k: calls.append((k["backend"], S)))
    R, M = 2_000_000, 3
    S = (torch.ones((R, M), dtype=torch.int16) if snap == "device"
         else np.ones((M, R), np.uint16))
    cfg = td.MetaConfig(em_f64=True, log=lambda *a, **k: None)
    td.run_em(cfg, S, np.full(R, 20), np.ones(R), ["a", "b", "c"], CPU)
    assert [c for c, _ in calls] == ["numpy"]
    got = calls[0][1]
    assert isinstance(got, np.ndarray) and got.dtype == np.uint16
    assert got.shape == (M, R) and M * R > 5_000_000


def test_torch_em_on_a_host_matrix_matches_f64():
    """The torch EM on a host matrix (the route above 5 M cells), run on
    a small one, against the numpy f64 EM."""
    S, lens, w, names = _synthetic(M=6, R=500, seed=9)
    St = torch.from_numpy(np.ascontiguousarray(S.T.astype(np.int32)))
    got = em.run_squarem_torch(St, lens, w, names,
                               max_change_threshold=1e-5)
    f64 = jax_run_squarem(S, lens, w, names, max_change_threshold=1e-5,
                          backend="numpy")
    assert got.node_names == f64.node_names
    assert np.abs(got.props - f64.props).max() < 2e-4


# ---- driver and CLI ----------------------------------------------------

def _abundance(path):
    out = {}
    with open(path) as fh:
        for ln in fh:
            names, p = ln.rstrip("\n").split("\t")
            out[frozenset(names.split(","))] = float(p)
    return out


def _same_abundance(a, b):
    ra, rb = _abundance(a), _abundance(b)
    assert set(ra) == set(rb)
    assert max(abs(ra[k] - rb[k]) for k in ra) <= 2e-4
    return ra


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    """>= 2,000 unique read sets: the device route."""
    return _workload(tmp_path_factory.mktemp("meta_big"), 1300)


@pytest.mark.parametrize("route", ["device", "host", "em_f64", "host_score"])
def test_run_meta_matches_jax_package(tmp_path, big, route):
    w = _workload(tmp_path, 400) if route == "host" else big
    opts = {"em_f64": {"em_f64": True},
            "host_score": {"host_score": True}}.get(route, {})
    lines = []

    def cfg(mod, name):
        return mod.MetaConfig(panman="synthetic", reads1=w.reads1,
                              reads2=w.reads2, output=str(tmp_path / name),
                              em_delta_threshold=1e-5, mesh=1,
                              log=lambda m, *a, **k: lines.append(m), **opts)

    assert hd.run_meta(cfg(hd, "jax"), midx=jax_meta_index(w.midx)) == 0
    trace.take()
    with profile(activities=[ProfilerActivity.CPU]):
        assert td.run_meta(cfg(td, "torch"), midx=w.midx, device=CPU) == 0
    spans = {r["name"]: r["counts"] for r in trace.take()}
    device = spans["meta.score"]["device"]
    assert ("device" if device else "host") == (
        "device" if route in ("device", "em_f64") else "host")
    assert (spans["meta.sketch"]["read_sets"] >= 2000) == (route != "host")
    got = _same_abundance(str(tmp_path / "jax.mgsr.abundance.out"),
                          str(tmp_path / "torch.mgsr.abundance.out"))
    named = set().union(*got)
    assert set(w.haplotypes) <= named


@pytest.fixture
def saved_index(tmp_path, big):
    """``big``'s index saved as a .ptmidx.npz beside an older dummy
    panman, so both CLIs load it instead of building one."""
    panman = tmp_path / "x.panman"
    panman.write_bytes(b"")
    os.utime(panman, (0, 0))
    idx = str(tmp_path / "x.ptmidx.npz")
    save_meta_index(idx, big.midx)
    return str(panman), idx


def test_cli_meta_matches_jax_cli(tmp_path, big, saved_index, monkeypatch):
    from panmap_tpu.__main__ import main as jax_main
    from panmap_tpu_torch.utils import device

    panman, idx = saved_index
    args = [panman, big.reads1, big.reads2, "--meta", "-i", idx,
            "--em-delta-threshold", "0.00001", "-q"]
    assert jax_main(args + ["--mesh", "1", "-o", str(tmp_path / "jax")]) == 0
    monkeypatch.setattr(device, "cuda_device", lambda index=0: CPU)
    assert torch_main(args + ["-o", str(tmp_path / "torch")]) == 0
    _same_abundance(str(tmp_path / "jax.mgsr.abundance.out"),
                    str(tmp_path / "torch.mgsr.abundance.out"))


def test_cli_meta_needs_a_cuda_device(saved_index, big, monkeypatch):
    panman, idx = saved_index
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_main([panman, big.reads1, "--meta", "-i", idx])


@pytest.mark.gpu
def test_cuda_scorer_matches_cpu(scored):
    """TorchMetaScorer on the card equals it on CPU tensors, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    w, reads, _, pt = scored
    cand = list(range(0, len(w.midx.node_ids), 3))
    ms, snap = pt.score_all(cand)
    gms, gsnap = TorchMetaScorer(w.midx, reads, "cuda").score_all(cand)
    assert np.array_equal(ms, gms)
    assert torch.equal(snap, gsnap.cpu())
