"""The port's mesh path (panmap_tpu_torch/parallel/mesh.py) against the JAX
package's on its virtual 8-device CPU mesh (conftest), on the same numpy
inputs made from a seed.  The port's mesh is 8 shards on the CPU.

 - sharded_score against make_sharded_score_fn(make_mesh(8)): atol 2e-4
   (the shards' partials add up in another order than XLA's psum);
 - TorchPlacer(mesh=...).place_exact equal to TpuPlacer(mesh=make_mesh(8))
   and to the f64 host engine (the exact rescue makes it sharding-proof);
 - the index pad keeps row_node sorted, its rows inert;
 - TorchMetaScorer(mesh=...) scores bit-equal to TpuMetaScorer(mesh=...);
 - the sharded EM within 2e-4 of run_squarem(mesh=make_mesh(8)) and of the
   numpy f64 EM;
 - --mesh resolution (0 = auto, 1 = off, N capped) as the JAX package's.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from panmap_tpu import pipeline as hp
from panmap_tpu.meta import driver as hd
from panmap_tpu.meta.engine import MetaRead as JaxMetaRead
from panmap_tpu.meta.engine import run_squarem as jax_run_squarem
from panmap_tpu.meta.engine_tpu import TpuMetaScorer
from panmap_tpu.native import get_lib
from panmap_tpu.parallel.mesh import make_mesh as jax_make_mesh
from panmap_tpu.parallel.mesh import make_sharded_score_fn
from panmap_tpu.place.engine import prepare_read_sketch, score_nodes
from panmap_tpu.place.engine_tpu import \
    prepare_device_index as jax_prepare_device_index
from panmap_tpu.place.query_tpu import TpuPlacer
from panmap_tpu_torch import convert
from panmap_tpu_torch import pipeline as tp
from panmap_tpu_torch.meta import driver as td
from panmap_tpu_torch.meta import em
from panmap_tpu_torch.meta.engine_torch import TorchMetaScorer
from panmap_tpu_torch.parallel import mesh as pm
from panmap_tpu_torch.place.engine_torch import prepare_device_index
from panmap_tpu_torch.place.query_torch import TorchPlacer
from panmap_tpu_torch.synthetic import make_meta_workload
from test_torch_meta import EM_CASES
from test_torch_placer import _port, _psk, _same, _small_case
from test_torch_standalone import jax_meta_index

CPU = torch.device("cpu")


def cpu_mesh(n=8):
    return pm.make_mesh(devices=[CPU] * n)


def _rows(seed, n_nodes, T):
    rng = np.random.default_rng(seed)
    row_id = rng.integers(0, 10, T).astype(np.int32)
    rp = rng.integers(0, 3, T).astype(np.float32)
    rc = rng.integers(0, 3, T).astype(np.float32)
    row_node = np.sort(rng.integers(0, n_nodes, T)).astype(np.int32)
    read_ids = np.arange(0, 10, 2, dtype=np.int32)
    read_logc = rng.random(5).astype(np.float32)
    return row_id, rp, rc, row_node, read_ids, read_logc


@pytest.mark.parametrize("T", [64, 1000])
def test_sharded_score_matches_jax_mesh(T):
    """tests/test_tpu_paths.py::test_sharded_scoring_matches_single_device's
    rows on both meshes (T = 1000: 125 rows a shard, T = 64: 8)."""
    import jax.numpy as jnp

    n_nodes = 5
    row_id, rp, rc, row_node, read_ids, read_logc = _rows(1, n_nodes, T)
    euler_in = np.array([0, 1, 3, 5, 7], dtype=np.int32)
    euler_out = np.array([9, 2, 4, 6, 8], dtype=np.int32)
    fn = make_sharded_score_fn(jax_make_mesh(8), n_nodes)
    want = np.asarray(fn(row_id, rp, rc, row_node, jnp.asarray(euler_in),
                         jnp.asarray(euler_out), jnp.asarray(read_ids),
                         jnp.asarray(read_logc)))
    mesh = cpu_mesh()
    shards = pm.split_rows(mesh, *(torch.from_numpy(x).long() if x.dtype ==
                                   np.int32 else torch.from_numpy(x)
                                   for x in (row_id, rp, rc, row_node)))
    got = pm.sharded_score(mesh, shards, torch.from_numpy(euler_in).long(),
                           torch.from_numpy(euler_out).long(),
                           torch.from_numpy(read_ids).long(),
                           torch.from_numpy(read_logc), n_nodes)
    assert got.shape == want.shape == (n_nodes, 6)
    assert np.abs(got.numpy() - want).max() <= 2e-4
    assert np.abs(want).max() > 0.5


PLACE_CASES = {
    # the single-device exactness case of test_torch_placer.py, and an
    # index whose min-read-support 2 queries the guards refuse (the port
    # must refuse them too)
    "small": lambda: _small_case(17, 24, 7),
    "other_index": lambda: _small_case(43, 26, 4, rng_seed=9, miss=0.2),
}


@pytest.mark.parametrize("case", sorted(PLACE_CASES))
def test_place_exact_on_mesh_equals_jax_mesh_and_host_engine(case):
    idx, freq, n = PLACE_CASES[case]()
    mesh = cpu_mesh()
    placer = TorchPlacer(_port(idx), CPU, mesh=mesh)
    assert placer.dev.csc is None and len(placer.dev.shards) == 8
    jax_placer = TpuPlacer(idx, pad_len=152, batch=32, mesh=jax_make_mesh(8))
    placed = 0
    for ms in (-1, 1, 2):
        for fl in (False, True):
            sk_ = prepare_read_sketch(freq, 19, n, min_read_support=ms)
            exact = score_nodes(idx, sk_, force_leaf=fl)
            got = placer.place_exact(_psk(sk_), force_leaf=fl)
            ref = jax_placer.place_exact(sk_, force_leaf=fl)
            assert (got is None) == (ref is None), (ms, fl)
            if got is not None:
                placed += 1
                _same(got, exact, (ms, fl))
                _same(got, ref, (ms, fl))
    assert placed >= 4


def test_place_exact_on_mesh_zero_wc_denominator():
    """Root rows matching no read seed: the mesh's wc_den (from the host
    copy of the root rows) is 0 and the result stays exact."""
    idx, freq, n = _small_case(23, 16, 0)
    nprng = np.random.default_rng(5)
    a, b = int(idx.node_offsets[0]), int(idx.node_offsets[1])
    idx.seed_hashes[a:b] = nprng.integers(1, 1 << 62, b - a).astype(np.uint64)
    sk_ = prepare_read_sketch(freq, 19, n, min_read_support=1)
    exact = score_nodes(idx, sk_)
    assert exact.best_score["weighted_containment"] == 0.0
    got = TorchPlacer(_port(idx), CPU, mesh=cpu_mesh(3)).place_exact(
        _psk(sk_))
    assert got is not None
    _same(got, exact, "mesh of 3")


def test_mesh_pad_keeps_row_node_sorted():
    """The pad rows go to the tail with node n_nodes - 1 and P == C == 0;
    the shards put together are the JAX package's sharded row tensors."""
    idx, _, _ = _small_case(3, 8, 0)
    assert len(idx.seed_hashes) % 8 != 0, "the case must need padding"
    dev = prepare_device_index(_port(idx), CPU, mesh=cpu_mesh())
    assert dev.blk is None and dev.row_id is None
    rid, rp, rc, rn = (torch.cat(c).numpy() for c in zip(*dev.shards))
    assert np.all(np.diff(rn) >= 0) and rn[-1] == dev.n_nodes - 1
    T = len(idx.seed_hashes)
    assert len(rn) % 8 == 0 and len(rn) > T
    assert not rp[T:].any() and not rc[T:].any()
    jdev = jax_prepare_device_index(idx, mesh=jax_make_mesh(8))
    for got, want in ((rid, jdev.row_id), (rp, jdev.row_parent),
                      (rc, jdev.row_child), (rn, jdev.row_node)):
        assert np.array_equal(got, np.asarray(want))


@pytest.fixture(scope="module")
def meta_scored(tmp_path_factory):
    """A 300-node meta workload's reads scored by both mesh scorers with
    64-node chunks and 64-read blocks, so the reads span several blocks of
    several shards."""
    if get_lib() is None:
        pytest.skip("native library unavailable")
    w = make_meta_workload(str(tmp_path_factory.mktemp("mesh_meta")), seed=1,
                           n_nodes=300, genome_len=5000, n_pairs=600)
    cfg = td.MetaConfig(reads1=w.reads1, reads2=w.reads2,
                        log=lambda *a, **k: None)
    reads, _ = td.sketch(cfg, w.midx)
    jm = jax_meta_index(w.midx)
    jr = [JaxMetaRead(**convert.as_dict(r)) for r in reads]
    saved = [(c, c.NODE_CHUNK, c.READ_CHUNK)
             for c in (TpuMetaScorer, TorchMetaScorer)]
    for c, _, _ in saved:
        c.NODE_CHUNK = c.READ_CHUNK = 64
    try:
        jx = TpuMetaScorer(jm, jr, mesh=jax_make_mesh(8))
        pt = TorchMetaScorer(w.midx, reads, CPU, mesh=cpu_mesh())
        one = TorchMetaScorer(w.midx, reads, CPU)
    finally:
        for c, nc, rc in saved:
            c.NODE_CHUNK, c.READ_CHUNK = nc, rc
    return w, reads, jx, pt, one


@pytest.mark.parametrize("which", ["all", "subset"])
def test_meta_scorer_on_mesh_bit_equal_to_jax_mesh(meta_scored, which):
    w, reads, jx, pt, one = meta_scored
    n = len(w.midx.node_ids)
    cand = (list(range(n)) if which == "all" else
            np.random.default_rng(3).choice(n, 40, replace=False).tolist())
    assert len(pt._shards) == 8 and len(reads) > 4 * 64
    ms, snap = pt.score_all(cand)
    assert snap.shape == (len(reads), len(cand))
    jms, jsnap = jx.score_all(cand)
    oms, osnap = one.score_all(cand)
    assert np.array_equal(ms, jms) and np.array_equal(ms, oms)
    assert np.array_equal(snap.numpy().T.astype(np.int64),
                          jsnap.astype(np.int64))
    assert torch.equal(snap, osnap)
    with pytest.raises(ValueError):
        pt.assignment_pass(np.ones(n, bool), np.ones(len(reads), np.int32))


@pytest.mark.parametrize("case", sorted(EM_CASES))
def test_sharded_em_matches_jax_mesh_em_and_f64(case, monkeypatch):
    import jax.numpy as jnp

    S, lens, w, names = EM_CASES[case]()
    reduced = []
    real = pm.reduce_partials

    def counting(parts, mesh):
        reduced.append(len(parts))
        return real(parts, mesh)

    monkeypatch.setattr(pm, "reduce_partials", counting)
    got = em.run_squarem(torch.from_numpy(S.T.astype(np.int32)), lens, w,
                         names, mesh=cpu_mesh())
    assert reduced and set(reduced) == {8}  # the sharded route ran
    jx = jax_run_squarem(jnp.asarray(S.T), lens, w, names,
                         mesh=jax_make_mesh(8))
    f64 = jax_run_squarem(S, lens, w, names, backend="numpy")
    assert got.n_iterations > 0
    for other in (jx, f64):
        assert got.node_names == other.node_names
        assert {k: sorted(v) for k, v in got.identical_groups.items()} == {
            k: sorted(v) for k, v in other.identical_groups.items()}
        assert np.abs(got.props - other.props).max() < 2e-4


def test_sharded_squarem_equals_one_shard_within_2e4():
    """squarem with its reads on 8 shards against squarem on one, the
    same rows (a multiple of 8), every round."""
    S, lens, w, _ = EM_CASES["round_drop"]()
    St = torch.from_numpy(S.T.astype(np.int32))
    lt, wt = torch.from_numpy(lens), torch.from_numpy(w)
    p8, a8, it8 = em.squarem(St, lt, wt, mesh=cpu_mesh())
    p1, a1, it1 = em.squarem(St, lt, wt)
    assert torch.equal(a8, a1) and abs(it8 - it1) <= 8
    assert (p8 - p1).abs().max() < 2e-4


def _devices(monkeypatch, n):
    monkeypatch.setattr(pm, "local_devices", lambda: [CPU] * n)


@pytest.mark.parametrize("want", [0, 1, 2, 3, 16])
def test_resolve_mesh_like_jax(monkeypatch, want):
    """JAX sees 8 devices (conftest); so does the port here."""
    _devices(monkeypatch, 8)
    jlog, tlog = [], []
    jm = hp._resolve_mesh(hp.PipelineConfig(mesh=want, log=jlog.append))
    tm = tp._resolve_mesh(tp.PipelineConfig(mesh=want, log=tlog.append))
    assert (jm is None) == (tm is None)
    if jm is not None:
        assert tm.size == jm.devices.size == len(tm.devices)
    assert len(jlog) == len(tlog)
    jmm = hd._resolve_meta_mesh(SimpleNamespace(mesh=want))
    tmm = td._resolve_meta_mesh(td.MetaConfig(mesh=want))
    assert (jmm is None) == (tmm is None)
    if jmm is not None:
        assert tmm.size == jmm.devices.size


@pytest.mark.parametrize("want", [0, 1, 2])
def test_resolve_mesh_on_one_card(monkeypatch, want):
    """One card: auto and 1 give no mesh (the single-card paths); 2 is
    logged and capped to a mesh of that card."""
    _devices(monkeypatch, 1)
    log = []
    m = tp._resolve_mesh(tp.PipelineConfig(mesh=want, log=log.append))
    if want < 2:
        assert m is None and not log
    else:
        assert m.size == 1 and "using 1" in log[0]
    mm = td._resolve_meta_mesh(td.MetaConfig(mesh=want))
    assert (mm is None) == (want < 2)


def test_cpu_callers_get_no_mesh(monkeypatch):
    """A caller that passes CPU tensors gets the single-device placer,
    whatever --mesh says."""
    _devices(monkeypatch, 8)
    idx, _, _ = _small_case(17, 24, 7)
    p = tp._get_placer(_port(idx), tp.PipelineConfig(mesh=4), CPU)
    assert p.mesh is None and p.dev.csc is not None
