"""The port's placement metric bodies (panmap_tpu_torch/place/metrics.py)
against the JAX originals (panmap_tpu/place/metrics.py under jax.numpy) and
the numpy f64 oracle, on the random cases of tests/test_place_reductions.py.

Tolerances: f32 accumulators agree within atol=1e-4, the bound
test_place_reductions.py already holds the JAX bodies to (both are f32
approximations of the f64 sums, summed in different orders).  Integer
structures (BlockSegments, CscIndex, expand_query positions) are exactly
equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from panmap_tpu.place import metrics as jm
from panmap_tpu_torch import convert
from panmap_tpu_torch.place import metrics as tm
from panmap_tpu_torch.place.engine_torch import prepare_device_index

from test_place_reductions import _oracle_f64, _random_case
from test_tpu_paths import _synthetic_index

CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _preorder_case(seed):
    """_random_case on a random DFS-preorder tree, with Euler arrays built
    as engine_tpu does (the construction of
    test_place_reductions.test_sparse_prefix_acc_matches_two_stage)."""
    rng = np.random.default_rng(seed)
    T, N, NU = 900, 29, 300
    row_node, row_id, P, C, uid_logc = _random_case(rng, T, N, NU)
    parent = np.zeros(N, np.int64)
    for i in range(1, N):
        parent[i] = rng.integers(0, i)
    children = [[] for _ in range(N)]
    for i in range(1, N):
        children[parent[i]].append(i)
    order, stack = [], [0]
    while stack:
        v = stack.pop()
        order.append(v)
        stack.extend(reversed(children[v]))
    relabel = np.empty(N, np.int64)
    relabel[order] = np.arange(N)
    parent2 = np.zeros(N, np.int64)
    for i in range(1, N):
        parent2[relabel[i]] = relabel[parent[i]]
    row_node = relabel[row_node].astype(np.int32)
    srt = np.argsort(row_node, kind="stable")
    row_node, row_id, P, C = row_node[srt], row_id[srt], P[srt], C[srt]
    from panmap_tpu_torch.place.engine_torch import euler_tour

    ein, eout = euler_tour(parent2)
    return row_node, row_id, P, C, uid_logc, parent2, ein, eout, N, NU


def _pads(uid_logc, NU):
    uids = np.flatnonzero(uid_logc > 0).astype(np.int32)
    fcap = 1 << int(np.ceil(np.log2(max(len(uids), 2))))
    pu = np.full(fcap, NU, np.int32)
    pu[: len(uids)] = uids
    pl = np.zeros(fcap, np.float32)
    pl[: len(uids)] = uid_logc[uids]
    return uids, pu, pl


@pytest.mark.parametrize("seed", [0, 1])
def test_row_metric_deltas_match_jax_and_f64(seed):
    rng = np.random.default_rng(seed)
    T = 2000
    P = rng.integers(0, 6, T).astype(np.float32)
    C = rng.integers(0, 6, T).astype(np.float32)
    lrc = np.where(rng.random(T) < 0.5, rng.random(T) * 3, 0).astype(
        np.float32)
    found = lrc > 0
    got = tm.row_metric_deltas_torch(_t(lrc), _t(P), _t(C), _t(found))
    ref = jm.row_metric_deltas(jnp, jnp.asarray(lrc), jnp.asarray(P),
                               jnp.asarray(C), jnp.asarray(found))
    f64 = jm.row_metric_deltas(np, lrc.astype(np.float64),
                               P.astype(np.float64), C.astype(np.float64),
                               found)
    for g, r, o in zip(got, ref, f64):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)
        np.testing.assert_allclose(g.numpy(), o, atol=1e-5)


@pytest.mark.parametrize("zero_stats", [False, True])
def test_finalize_scores_and_wc_den_match_jax(zero_stats):
    rng = np.random.default_rng(3)
    acc = (rng.random((50, 6)) * 4 - 1).astype(np.float32)
    acc[:, 0] = np.abs(acc[:, 0])
    stats = (0.0, 0, 0.0, 0.0) if zero_stats else (7.5, 40, 21.0, 3.25)
    got = tm.finalize_scores_torch(_t(acc), *[np.float32(s) for s in stats])
    ref = jm.finalize_scores(jnp, jnp.asarray(acc),
                             *[jnp.float32(s) for s in stats])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    f64 = jm.finalize_scores(np, acc.astype(np.float64), *stats)
    np.testing.assert_allclose(got.numpy(), f64, atol=1e-5)
    C = rng.integers(0, 4, 30).astype(np.int16)
    lrc = np.where(rng.random(30) < 0.6, 1.5, 0).astype(np.float32)
    wc = tm.wc_denominator_torch(_t(lrc), _t(C), _t(lrc > 0))
    wref = jm.wc_denominator(jnp, jnp.asarray(lrc),
                             jnp.asarray(C.astype(np.float32)),
                             jnp.asarray(lrc > 0))
    np.testing.assert_allclose(float(wc), float(wref), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("L", [8, 16])
def test_blocked_sums_match_jax_and_oracle(seed, L):
    rng = np.random.default_rng(seed)
    T, N, NU = 1000, 37, 400
    row_node, row_id, P, C, uid_logc = _random_case(rng, T, N, NU)
    oracle = _oracle_f64(row_node, row_id, P, C, uid_logc, N)
    jblk = jm.make_block_segments(row_node, N, L=L)
    tblk = tm.block_segments(row_node, N, CPU, L=L)
    for name in ("lastp", "base", "has_base", "spanning", "seg_node",
                 "eb_blk", "q_flat", "has_bnd"):
        np.testing.assert_array_equal(getattr(tblk, name).numpy(),
                                      np.asarray(getattr(jblk, name)), name)
    assert (tblk.L, tblk.B, tblk.pad) == (jblk.L, jblk.B, jblk.pad)
    lrc = uid_logc[row_id]
    got = tm.row_node_sums_blocked(_t(lrc), _t(P), _t(C), _t(lrc > 0), tblk,
                                   N).numpy()
    ref = np.asarray(jm.row_node_sums_blocked(
        jnp.asarray(lrc), jnp.asarray(P), jnp.asarray(C),
        jnp.asarray(lrc > 0), jblk, N))
    np.testing.assert_allclose(got, oracle, atol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_row_node_sums_match_jax_and_oracle(seed):
    """The mesh path's segment sum (i16 counts, as uploaded)."""
    rng = np.random.default_rng(seed)
    T, N, NU = 1000, 37, 400
    row_node, row_id, P, C, uid_logc = _random_case(rng, T, N, NU)
    oracle = _oracle_f64(row_node, row_id, P, C, uid_logc, N)
    lrc = uid_logc[row_id]
    P16, C16 = P.astype(np.int16), C.astype(np.int16)
    got = tm.row_node_sums(_t(lrc), _t(P16), _t(C16), _t(lrc > 0),
                           _t(row_node).long(), N).numpy()
    ref = np.asarray(jm.row_node_sums(
        jnp.asarray(lrc), jnp.asarray(P16), jnp.asarray(C16),
        jnp.asarray(lrc > 0), jnp.asarray(row_node), N))
    assert got.dtype == np.float32 and got.shape == (N, 6)
    np.testing.assert_allclose(got, oracle, atol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_blocked_handles_trailing_empty_nodes():
    row_node = np.array([0, 0, 2, 2, 2], np.int32)  # nodes 1,3,4 of 5 empty
    N = 5
    P = np.array([0, 1, 2, 0, 1], np.int16)
    C = np.array([1, 0, 2, 3, 1], np.int16)
    lrc = np.array([0.5, 0.7, 0.0, 1.1, 0.3], np.float32)
    blk = tm.block_segments(row_node, N, CPU, L=4)  # pad = 3 rows
    got = tm.row_node_sums_blocked(_t(lrc), _t(P), _t(C), _t(lrc > 0), blk,
                                   N).numpy()
    oracle = _oracle_f64(row_node, np.arange(5), P, C, lrc, N)
    np.testing.assert_allclose(got, oracle, atol=1e-6)
    assert np.all(got[[1, 3, 4]] == 0)


@pytest.mark.parametrize("seed", [0, 5])
def test_sparse_prefix_acc_matches_jax_and_oracle(seed):
    (row_node, row_id, P, C, uid_logc, parent, ein, eout, N,
     NU) = _preorder_case(seed)
    jcsc = jm.make_csc_index(row_id, P, C, row_node, NU, N,
                             parent_index=parent)
    tcsc = tm.csc_index(row_id, P, C, row_node, NU, N, parent, CPU)
    for name in ("off", "P", "C", "node", "mag_prefix"):
        np.testing.assert_array_equal(getattr(tcsc, name).numpy(),
                                      np.asarray(getattr(jcsc, name)), name)
    uids, pu, pl = _pads(uid_logc, NU)
    F = jm.query_found_rows(jcsc, uids)
    rcap = max(1 << int(np.ceil(np.log2(max(F, 2)))), len(pu))
    # expanded row positions: exactly equal
    jexp = jm.expand_query(jnp.asarray(pu), jnp.asarray(pl), jcsc, rcap)
    texp = tm.expand_query(_t(pu), _t(pl), tcsc, rcap)
    for g, r in zip(texp, jexp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    got = tm.sparse_prefix_acc(_t(pu), _t(pl), tcsc, _t(ein), _t(eout), N,
                               rcap).numpy()
    ref = np.asarray(jm.sparse_prefix_acc(
        jnp.asarray(pu), jnp.asarray(pl), jcsc, jnp.asarray(ein),
        jnp.asarray(eout), N, rcap))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # f64 oracle: per-node sums accumulated down the tree
    node_sums = _oracle_f64(row_node, row_id, P, C, uid_logc, N)
    acc = node_sums.copy()
    for i in range(1, N):
        acc[i] += acc[parent[i]]
    np.testing.assert_allclose(got, acc, atol=1e-4)
    # the full-stream route (blocked sums + Euler prefix) agrees too
    lrc = uid_logc[row_id]
    two = tm.euler_prefix(tm.row_node_sums_blocked(
        _t(lrc), _t(P), _t(C), _t(lrc > 0),
        tm.block_segments(row_node, N, CPU, L=16), N), _t(ein), _t(eout), N)
    np.testing.assert_allclose(two.numpy(), acc, atol=1e-4)
    jtwo = jm.euler_prefix(jnp.asarray(node_sums.astype(np.float32)),
                           jnp.asarray(ein), jnp.asarray(eout), N)
    ttwo = tm.euler_prefix(_t(node_sums.astype(np.float32)), _t(ein),
                           _t(eout), N)
    np.testing.assert_allclose(ttwo.numpy(), np.asarray(jtwo), atol=1e-4)


def test_sparse_empty_query():
    (row_node, row_id, P, C, _, parent, ein, eout, N,
     NU) = _preorder_case(7)
    csc = tm.csc_index(row_id, P, C, row_node, NU, N, parent, CPU)
    pu = torch.full((16,), NU, dtype=torch.int32)
    pl = torch.zeros(16)
    got = tm.sparse_prefix_acc(pu, pl, csc, _t(ein), _t(eout), N, 64)
    assert torch.all(got[:, 1:] == 0)
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  csc.mag_prefix.numpy())


def test_sparse_rcap_exact_fit():
    """rcap == F exactly (no slack slots; the mark scatter's dump slot is
    the only extra)."""
    row_node = np.array([0, 0, 1, 1], np.int32)
    row_id = np.array([2, 3, 2, 3], np.int32)
    P = np.array([1, 0, 2, 1], np.int16)
    C = np.array([0, 2, 2, 3], np.int16)
    NU, N = 4, 2
    parent = np.array([0, 0])
    csc = tm.csc_index(row_id, P, C, row_node, NU, N, parent, CPU)
    uid_logc = np.array([0, 0, 0.5, 0.9], np.float32)
    uids = np.array([2, 3], np.int32)
    assert tm.query_found_rows(csc, uids) == 4
    pu = np.full(4, NU, np.int32)
    pu[:2] = uids
    pl = np.zeros(4, np.float32)
    pl[:2] = uid_logc[uids]
    ein, eout = np.array([0, 1]), np.array([3, 2])
    got = tm.sparse_prefix_acc(_t(pu), _t(pl), csc, _t(ein), _t(eout), N,
                               4).numpy()
    acc = _oracle_f64(row_node, row_id, P, C, uid_logc, N)
    acc[1] += acc[0]
    np.testing.assert_allclose(got, acc, atol=1e-6)


def test_device_index_from_jax_equals_prepare():
    """The JAX package's DeviceIndex carried across equals the port's own
    preparation, tensor for tensor."""
    from panmap_tpu.place.engine_tpu import prepare_device_index as jprep

    nprng = np.random.default_rng(17)
    read_hashes = np.sort(nprng.integers(1, 1 << 62, 300).astype(np.uint64))
    idx = _synthetic_index(nprng, read_hashes, miss=0.25)
    own = prepare_device_index(convert.index_arrays(convert.as_dict(idx)),
                               CPU)
    carried = convert.device_index(convert.as_dict(jprep(idx)), CPU)
    np.testing.assert_array_equal(own.unique_hashes, carried.unique_hashes)
    for name in ("row_id", "row_parent", "row_child", "euler_in",
                 "euler_out"):
        a, b = getattr(own, name), getattr(carried, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name
    for name in ("lastp", "base", "has_base", "spanning", "seg_node",
                 "eb_blk", "q_flat", "has_bnd"):
        assert torch.equal(getattr(own.blk, name),
                           getattr(carried.blk, name)), name
    for name in ("off", "P", "C", "node", "mag_prefix"):
        assert torch.equal(getattr(own.csc, name),
                           getattr(carried.csc, name)), name
    np.testing.assert_array_equal(own.csc.off_np, carried.csc.off_np)
    assert own.root_rows == carried.root_rows
    assert own.n_nodes == carried.n_nodes
    np.testing.assert_array_equal(own.root_rid_np, carried.root_rid_np)
    np.testing.assert_array_equal(own.root_child_np, carried.root_child_np)


def test_prepare_rejects_non_preorder_tree():
    nprng = np.random.default_rng(2)
    read_hashes = np.sort(nprng.integers(1, 1 << 62, 50).astype(np.uint64))
    idx = _synthetic_index(nprng, read_hashes)
    idx.parent_index = np.array([0, 0, 0, 1, 1, 0, 4, 4, 6], np.uint32)
    with pytest.raises(ValueError):
        prepare_device_index(convert.index_arrays(convert.as_dict(idx)), CPU)
