"""Metagenomic (mgsr) index: per-node positioned k-min-mer deltas.

The meta twin of the single-sample builder (reference: mgsrIndexBuilder,
src/mgsr.cpp:2624-4144): instead of hash-count deltas it records which
*positioned, oriented* k-min-mers appear/disappear at each node — what
per-read scoring and the EM consume.  It runs the same DFS as the single
builder (index/builder.py run_dfs) with a positional-diff emitter: a changed
hash/orientation at a kept position emits delete+add, matching the reference's
delta encoding (seedDeltaIndices + seedDeltaIsDeleted, index_lite.capnp:55-60).
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from ..index.builder import IndexParams, _use_incremental_counts, run_dfs
from ..io.panman import PanmanTree


@dataclass
class MetaIndexArrays:
    """Flat meta index: positioned-seed table + per-node delta ranges (CSR),
    plus the alignment-gap change stream that lets the runtime maintain
    degapped coordinates (reference: gapRunDeltas/invertedBlocks +
    seed end positions, index_lite.capnp:27-34,55-60)."""

    params: IndexParams
    node_ids: list
    parent_index: np.ndarray  # u32[N]
    seed_hash: np.ndarray  # u64[S]
    seed_rev: np.ndarray  # bool[S]
    seed_pos: np.ndarray  # i64[S]
    delta_seed: np.ndarray  # i32[D] indices into the seed table
    delta_is_del: np.ndarray  # bool[D]
    node_offsets: np.ndarray  # i64[N+1]
    # --- degap tracking (format v2; absent in v1 caches -> rebuilt) ---
    seed_end: np.ndarray = None  # i64[S] inclusive end scalar
    gev_offsets: np.ndarray = None  # i64[N+1] char gap-flip events CSR
    gev_pos: np.ndarray = None  # i64[G] forward scalar
    gev_nongap: np.ndarray = None  # bool[G] new state
    bev_offsets: np.ndarray = None  # i64[N+1] block events CSR
    bev_block: np.ndarray = None  # i32[B]
    bev_code: np.ndarray = None  # i8[B] 0=off 1=on-fwd 2=on-rev
    block_lo: np.ndarray = None  # i64[NB]
    block_hi: np.ndarray = None  # i64[NB]
    nongap0: np.ndarray = None  # u8 packed bits over n_scalar columns
    n_scalar: int = 0


_EMPTY_NODE = (np.empty(0, np.int64), np.empty(0, np.uint64),
               np.empty(0, bool), np.empty(0, bool), np.empty(0, np.int64))
_EMPTY_GAPS = (np.empty(0, np.int64), np.empty(0, bool),
               np.empty(0, np.int32), np.empty(0, np.int8))


def _meta_node_delta(parent_state, child_state):
    """Positioned-seed delta between full parent/child states: ONE shared
    diff implementation (builder._positioned_diff) serves both this
    full-rebuild oracle and the incremental splice path, so the two can
    never drift apart."""
    from ..index.builder import _positioned_diff

    out = _positioned_diff(
        (parent_state[7], parent_state[5], parent_state[6], parent_state[8]),
        (child_state[7], child_state[5], child_state[6], child_state[8]))
    if len(out[0]) == 0:
        return _EMPTY_NODE
    return out


# fork-inherited worker context for build_meta_index(workers > 1)
_META_PAR_CTX: dict = {}


def _meta_range_worker(rng):
    a, b = rng
    tree = _META_PAR_CTX["tree"]
    params = _META_PAR_CTX["params"]
    deltas: dict = {}
    gaps: dict = {}

    def gap_emit(dfs_index, ch_pos, ch_ng, b_id, b_code):
        if a <= dfs_index < b and (ch_pos or b_id):
            gaps[dfs_index] = (np.asarray(ch_pos, np.int64),
                               np.asarray(ch_ng, bool),
                               np.asarray(b_id, np.int32),
                               np.asarray(b_code, np.int8))

    if _use_incremental_counts():
        def emit_meta(dfs_index, delta, changed):
            if a <= dfs_index < b:
                deltas[dfs_index] = (_EMPTY_NODE if delta is None else delta)

        run_dfs(tree, params, None, dfs_range=(a, b), gap_emit=gap_emit,
                emit_meta=emit_meta)
    else:
        def emit(dfs_index, parent_state, child_state, changed):
            if a <= dfs_index < b:
                deltas[dfs_index] = (
                    _EMPTY_NODE if not changed
                    else _meta_node_delta(parent_state, child_state))

        run_dfs(tree, params, emit, dfs_range=(a, b), gap_emit=gap_emit)
    pos = np.concatenate([deltas[i][0] for i in range(a, b)]) if b > a else np.empty(0, np.int64)
    hsh = np.concatenate([deltas[i][1] for i in range(a, b)]) if b > a else np.empty(0, np.uint64)
    rev = np.concatenate([deltas[i][2] for i in range(a, b)]) if b > a else np.empty(0, bool)
    isdel = np.concatenate([deltas[i][3] for i in range(a, b)]) if b > a else np.empty(0, bool)
    end = np.concatenate([deltas[i][4] for i in range(a, b)]) if b > a else np.empty(0, np.int64)
    sizes = np.array([len(deltas[i][0]) for i in range(a, b)], dtype=np.int64)
    gl = [gaps.get(i, _EMPTY_GAPS) for i in range(a, b)]
    gpos = np.concatenate([g[0] for g in gl]) if gl else np.empty(0, np.int64)
    gng = np.concatenate([g[1] for g in gl]) if gl else np.empty(0, bool)
    bid = np.concatenate([g[2] for g in gl]) if gl else np.empty(0, np.int32)
    bcode = np.concatenate([g[3] for g in gl]) if gl else np.empty(0, np.int8)
    gsizes = np.array([len(g[0]) for g in gl], dtype=np.int64)
    bsizes = np.array([len(g[2]) for g in gl], dtype=np.int64)
    return a, pos, hsh, rev, isdel, end, sizes, gpos, gng, bid, bcode, gsizes, bsizes


def build_meta_index(tree: PanmanTree, params: IndexParams | None = None,
                     progress=None, workers: int = 0) -> MetaIndexArrays:
    from ..index.builder import GAP, ScalarSpace

    params = params or IndexParams()
    n_nodes = len(tree.dfs_order)

    if workers and workers > 1 and n_nodes > workers:
        import multiprocessing as mp

        bounds = np.linspace(0, n_nodes, workers + 1).astype(np.int64)
        ranges = [(int(bounds[i]), int(bounds[i + 1])) for i in range(workers)
                  if bounds[i] < bounds[i + 1]]
        _META_PAR_CTX["tree"] = tree
        _META_PAR_CTX["params"] = params
        try:
            ctx = mp.get_context("fork")
            with ctx.Pool(len(ranges)) as pool:
                results = pool.map(_meta_range_worker, ranges)
        finally:
            _META_PAR_CTX.clear()
        results.sort(key=lambda r: r[0])
        pos_all = np.concatenate([r[1] for r in results])
        hash_all = np.concatenate([r[2] for r in results])
        rev_all = np.concatenate([r[3] for r in results])
        del_all = np.concatenate([r[4] for r in results])
        end_all = np.concatenate([r[5] for r in results])
        sizes = np.concatenate([r[6] for r in results])
        gev_pos = np.concatenate([r[7] for r in results])
        gev_ng = np.concatenate([r[8] for r in results])
        bev_block = np.concatenate([r[9] for r in results])
        bev_code = np.concatenate([r[10] for r in results])
        gsizes = np.concatenate([r[11] for r in results])
        bsizes = np.concatenate([r[12] for r in results])
    else:
        node_deltas: list = [_EMPTY_NODE] * n_nodes
        node_gaps: list = [_EMPTY_GAPS] * n_nodes

        def gap_emit(dfs_index, ch_pos, ch_ng, b_id, b_code):
            if ch_pos or b_id:
                node_gaps[dfs_index] = (np.asarray(ch_pos, np.int64),
                                        np.asarray(ch_ng, bool),
                                        np.asarray(b_id, np.int32),
                                        np.asarray(b_code, np.int8))

        if _use_incremental_counts():
            # incremental positioned mode (builder.run_dfs emit_meta):
            # affected-window splice + local delta; _meta_node_delta over
            # full states is the oracle (PANMAP_TPU_INCR=0)
            def emit_meta(dfs_index, delta, changed):
                if delta is not None:
                    node_deltas[dfs_index] = delta

            run_dfs(tree, params, None, progress, gap_emit=gap_emit,
                    emit_meta=emit_meta)
        else:
            def emit(dfs_index, parent_state, child_state, changed):
                if changed:
                    node_deltas[dfs_index] = _meta_node_delta(parent_state,
                                                              child_state)

            run_dfs(tree, params, emit, progress, gap_emit=gap_emit)
        pos_all = np.concatenate([d[0] for d in node_deltas])
        hash_all = np.concatenate([d[1] for d in node_deltas])
        rev_all = np.concatenate([d[2] for d in node_deltas])
        del_all = np.concatenate([d[3] for d in node_deltas])
        end_all = np.concatenate([d[4] for d in node_deltas])
        sizes = np.array([len(d[0]) for d in node_deltas], dtype=np.int64)
        gev_pos = np.concatenate([g[0] for g in node_gaps])
        gev_ng = np.concatenate([g[1] for g in node_gaps])
        bev_block = np.concatenate([g[2] for g in node_gaps])
        bev_code = np.concatenate([g[3] for g in node_gaps])
        gsizes = np.array([len(g[0]) for g in node_gaps], dtype=np.int64)
        bsizes = np.array([len(g[2]) for g in node_gaps], dtype=np.int64)

    node_offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    node_offsets[1:] = np.cumsum(sizes)
    gev_offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    gev_offsets[1:] = np.cumsum(gsizes)
    bev_offsets = np.zeros(n_nodes + 1, dtype=np.int64)
    bev_offsets[1:] = np.cumsum(bsizes)

    # global interning of (pos, hash, rev) -> seed id, vectorized; the end
    # coordinate rides with the first occurrence (the reference's seedInfos
    # are unique records with start+end)
    order = np.lexsort((rev_all, hash_all, pos_all))
    sp, sh, sr = pos_all[order], hash_all[order], rev_all[order]
    se = end_all[order]
    if len(sp):
        first = np.concatenate(([True], (sp[1:] != sp[:-1])
                                | (sh[1:] != sh[:-1]) | (sr[1:] != sr[:-1])))
    else:
        first = np.empty(0, bool)
    sid_sorted = np.cumsum(first) - 1
    delta_seed = np.empty(len(pos_all), dtype=np.int32)
    delta_seed[order] = sid_sorted.astype(np.int32)

    parent_index = np.zeros(n_nodes, dtype=np.uint32)
    for node in tree.dfs_order:
        parent_index[node.dfs_index] = node.parent.dfs_index if node.parent else 0

    space = ScalarSpace(tree)
    nongap0 = np.packbits((space.char0 != GAP).astype(np.uint8),
                          bitorder="little")

    return MetaIndexArrays(
        params=params,
        node_ids=[n.identifier for n in tree.dfs_order],
        parent_index=parent_index,
        seed_hash=sh[first],
        seed_rev=sr[first],
        seed_pos=sp[first],
        delta_seed=delta_seed,
        delta_is_del=del_all,
        node_offsets=node_offsets,
        seed_end=se[first],
        gev_offsets=gev_offsets,
        gev_pos=gev_pos,
        gev_nongap=gev_ng,
        bev_offsets=bev_offsets,
        bev_block=bev_block,
        bev_code=bev_code,
        block_lo=space.block_ranges[:, 0].astype(np.int64),
        block_hi=space.block_ranges[:, 1].astype(np.int64),
        nongap0=nongap0,
        n_scalar=space.n,
    )


META_FORMAT_VERSION = 3  # v3: seed ends walk the non-gap grid


def save_meta_index(path: str, idx: MetaIndexArrays):
    header = {
        "format_version": META_FORMAT_VERSION,
        "k": idx.params.k, "s": idx.params.s, "t": idx.params.t,
        "l": idx.params.l, "open": idx.params.open, "hpc": idx.params.hpc,
        "flank_mask_bp": idx.params.flank_mask_bp,
        "n_scalar": idx.n_scalar,
    }
    np.savez(
        path,
        header=np.frombuffer(json.dumps(header).encode(), dtype=np.uint8),
        node_ids=np.frombuffer("\n".join(idx.node_ids).encode(), dtype=np.uint8),
        parent_index=idx.parent_index,
        seed_hash=idx.seed_hash,
        seed_rev=idx.seed_rev,
        seed_pos=idx.seed_pos,
        delta_seed=idx.delta_seed,
        delta_is_del=idx.delta_is_del,
        node_offsets=idx.node_offsets,
        seed_end=idx.seed_end,
        gev_offsets=idx.gev_offsets,
        gev_pos=idx.gev_pos,
        gev_nongap=idx.gev_nongap,
        bev_offsets=idx.bev_offsets,
        bev_block=idx.bev_block,
        bev_code=idx.bev_code,
        block_lo=idx.block_lo,
        block_hi=idx.block_hi,
        nongap0=idx.nongap0,
    )


def read_meta_params(path: str) -> dict:
    with np.load(path) as z:
        return json.loads(bytes(z["header"]).decode())


def load_meta_index(path: str) -> MetaIndexArrays:
    z = np.load(path)
    header = json.loads(bytes(z["header"]).decode())
    if header.get("format_version") != META_FORMAT_VERSION:
        raise RuntimeError("Meta index format mismatch; rebuild the .ptmidx")
    params = IndexParams(
        k=header["k"], s=header["s"], t=header["t"], l=header["l"],
        open=header["open"], hpc=header["hpc"],
        flank_mask_bp=header["flank_mask_bp"],
    )
    return MetaIndexArrays(
        params=params,
        node_ids=bytes(z["node_ids"]).decode().split("\n"),
        parent_index=z["parent_index"],
        seed_hash=z["seed_hash"],
        seed_rev=z["seed_rev"],
        seed_pos=z["seed_pos"],
        delta_seed=z["delta_seed"],
        delta_is_del=z["delta_is_del"],
        node_offsets=z["node_offsets"],
        seed_end=z["seed_end"],
        gev_offsets=z["gev_offsets"],
        gev_pos=z["gev_pos"],
        gev_nongap=z["gev_nongap"],
        bev_offsets=z["bev_offsets"],
        bev_block=z["bev_block"],
        bev_code=z["bev_code"],
        block_lo=z["block_lo"],
        block_hi=z["block_hi"],
        nongap0=z["nongap0"],
        n_scalar=header["n_scalar"],
    )
