"""Placement scoring engine — exact (float64) parity path.

Computes the reference's five per-node similarity metrics from the index's
per-node seed-count delta rows (src/placement.cpp:242-345 computeChildMetrics,
src/placement.hpp:108-155 NodeMetrics) as array programs:

 - per-row metric deltas are vectorized over the whole row table;
 - per-node totals accumulate parent->child down the DFS with the same
   sequential f64 addition order as the reference's BFS (row order within a
   node is the on-disk hash-sorted order, matching the index writer).

Best-node / tie selection follows the tolerance rule of src/placement.cpp:355-401:
tolerance = max(best * 1e-4, 1e-9); ties resolve to the lowest DFS index.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field

import numpy as np

from ..index.builder import IndexArrays
from ..sketch.cpu import U64, read_kminmer_counts, rol
from .metrics import METRICS, finalize_scores, row_metric_deltas, wc_denominator


def homopolymer_hashes(k: int) -> list[int]:
    """Canonical hashes of all-A/C/G/T k-mers (src/placement.cpp:41-76)."""
    from ..sketch.cpu import _HASH_A, _HASH_C, _HASH_G, _HASH_T

    vals = {"A": _HASH_A, "C": _HASH_C, "G": _HASH_G, "T": _HASH_T}
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    out = []
    for base in "ACGT":
        f = np.uint64(0)
        r = np.uint64(0)
        for i in range(k):
            f ^= rol(vals[base], k - i - 1)
            r ^= rol(vals[comp[base]], k - i - 1)
        out.append(int(min(f, r)))
    return out


@dataclass
class ReadSketch:
    """Read-side seed statistics (PlacementGlobalState equivalent)."""

    seed_freq: dict  # hash -> read count (pre-filtering)
    sorted_hashes: np.ndarray = field(default_factory=lambda: np.empty(0, U64))
    log_counts: np.ndarray = field(default_factory=lambda: np.empty(0, np.float64))
    read_unique_seed_count: int = 0
    total_read_seed_frequency: int = 0
    log_read_magnitude: float = 0.0
    log_containment_denominator: float = 0.0
    min_support: int = 1
    total_reads: int = 0


def _sketch_reads_py(seqs: list, k: int, s: int, t: int, l: int, open_: bool,
                     dedup_reads: bool = False, trim_start: int = 0,
                     trim_end: int = 0) -> dict:
    """Pure-Python seedFreqInReads (count-exact oracle for the native path)."""
    uniq = Counter(seqs)
    useqs = list(uniq.keys())
    mult = None if dedup_reads else [uniq[x] for x in useqs]
    return read_kminmer_counts(useqs, k, s, t, l, open_, mult, trim_start, trim_end)


def sketch_reads(seqs: list, k: int, s: int, t: int, l: int, open_: bool,
                 dedup_reads: bool = False, trim_start: int = 0, trim_end: int = 0,
                 hpc: bool = False):
    """seedFreqInReads: canonical k-min-mer counts over deduplicated reads.
    Returns a (hashes u64, counts i64) pair from the threaded native sketcher
    when available, else a dict (both accepted by prepare_read_sketch)."""
    if hpc:
        from ..sketch.cpu import hpc_compress

        seqs = [hpc_compress(x) for x in seqs]
    if dedup_reads:
        seqs = list(Counter(seqs).keys())
        dedup_reads = False  # already collapsed to one copy per unique read
    from ..native import sketch_count_native

    res = sketch_count_native(seqs, k, s, t, bool(open_), l,
                              trim_start=trim_start, trim_end=trim_end)
    if res is not None:
        return res[0], res[1].astype(np.int64)
    return _sketch_reads_py(seqs, k, s, t, l, open_, dedup_reads,
                            trim_start, trim_end)


def sketch_reads_quality(seqs: list, quals: list, k: int, s: int, t: int,
                         l: int, open_: bool, min_seed_quality: float,
                         trim_start: int = 0, trim_end: int = 0) -> dict:
    """Quality-filtered sketch (--min-seed-quality; placement.cpp:1388-1545):
    a syncmer passes when the mean Phred over its k-mer reaches the threshold
    and its start is inside the primer-trim range; a k-min-mer counts only
    when all l member syncmers pass.  Vectorized per read (prefix-sum mean
    quals, sliding all-pass window); counts accumulate with one np.unique in
    first-appearance order so the dict matches the per-element loop it
    replaced (the top-fraction mask tie-breaks on insertion order)."""
    from ..sketch.cpu import kminmer_hashes_oriented, syncmer_list

    parts = []
    for seq, qual in zip(seqs, quals):
        pos, H, rev = syncmer_list(seq, k, s, open_, t)
        if len(H) < l:
            continue
        q = np.frombuffer(qual.encode(), dtype=np.uint8).astype(np.float64) \
            - 33.0
        cq = np.concatenate(([0.0], np.cumsum(q)))
        p = np.asarray(pos, dtype=np.int64)
        avg = (cq[np.minimum(p + k, len(q))] - cq[p]) / k
        passes = ((p >= trim_start) & (p <= len(seq) - trim_end - k)
                  & (avg >= min_seed_quality))
        if l == 1:
            parts.append(H[passes])
            continue
        km, valid, _ = kminmer_hashes_oriented(H, k, l, rev)
        cp = np.concatenate(([0], np.cumsum(passes.astype(np.int64))))
        win_ok = (cp[l:] - cp[:-l]) == l  # all l member syncmers pass
        parts.append(km[valid & win_ok[: len(km)]])
    if not parts:
        return {}
    allh = np.concatenate(parts)
    uniq, first, counts = np.unique(allh, return_index=True,
                                    return_counts=True)
    order = np.argsort(first)
    return {int(h): int(c) for h, c in zip(uniq[order], counts[order])}


def resolve_min_read_support(seed_freq: dict, configured: int) -> int:
    """Auto min-read-support from estimated coverage (src/placement.cpp:931-955)."""
    if configured >= 0:
        return configured
    s = 0
    n = 0
    for cnt in seed_freq.values():
        if cnt >= 2:
            s += cnt
            n += 1
    est = s / n if n else 0.0
    return 2 if est > 3.0 else 1


def prepare_read_sketch(seed_freq, k: int, total_reads: int,
                        min_read_support: int = -1,
                        seed_mask_fraction: float = 0.0) -> ReadSketch:
    """Homopolymer removal, optional top-fraction masking, magnitudes
    (src/placement.cpp:1703-1851, 957-984).  seed_freq is a dict or a
    (hashes u64, counts i64) pair from the native sketcher; masking uses the
    dict path (its tie-break follows dict insertion order)."""
    if isinstance(seed_freq, tuple) and seed_mask_fraction > 0.0:
        seed_freq = dict(zip(seed_freq[0].tolist(), seed_freq[1].tolist()))
    if isinstance(seed_freq, tuple):
        hashes, counts = seed_freq
        counts = counts.astype(np.int64, copy=False)
        homo = np.fromiter(homopolymer_hashes(k), dtype=U64)
        keep_h = ~np.isin(hashes, homo)
        hashes, counts = hashes[keep_h], counts[keep_h]
        sk = ReadSketch(seed_freq=None, total_reads=total_reads)
        if min_read_support >= 0:
            sk.min_support = min_read_support
        else:
            big = counts >= 2
            n = int(big.sum())
            est = float(counts[big].sum()) / n if n else 0.0
            sk.min_support = 2 if est > 3.0 else 1
    else:
        seed_freq = dict(seed_freq)
        for h in homopolymer_hashes(k):
            seed_freq.pop(h, None)

        if seed_mask_fraction > 0.0 and seed_freq:
            n_mask = int(seed_mask_fraction * len(seed_freq))
            if n_mask > 0:
                by_freq = sorted(seed_freq.items(), key=lambda kv: -kv[1])
                for h, _ in by_freq[:n_mask]:
                    del seed_freq[h]

        sk = ReadSketch(seed_freq=seed_freq, total_reads=total_reads)
        sk.min_support = resolve_min_read_support(seed_freq, min_read_support)

        hashes = np.fromiter(seed_freq.keys(), dtype=U64, count=len(seed_freq))
        counts = np.fromiter(seed_freq.values(), dtype=np.int64, count=len(seed_freq))
    sk.total_read_seed_frequency = int(counts.sum()) if len(counts) else 0
    order = np.argsort(hashes)
    hashes, counts = hashes[order], counts[order]
    keep = counts >= sk.min_support
    sk.sorted_hashes = hashes[keep]
    sk.log_counts = np.log1p(counts[keep].astype(np.float64))
    sk.read_unique_seed_count = int(keep.sum())
    sk.log_read_magnitude = math.sqrt(float(np.sum(sk.log_counts * sk.log_counts)))
    sk.log_containment_denominator = float(np.sum(sk.log_counts))
    return sk


@dataclass
class PlacementScores:
    """Per-node metric scores + best/tie selections."""

    scores: np.ndarray  # f64[N,5], metric order = METRICS
    best_index: dict = field(default_factory=dict)  # metric -> dfs index
    best_score: dict = field(default_factory=dict)
    tied_indices: dict = field(default_factory=dict)  # metric -> sorted list


def score_nodes(index: IndexArrays, sk: ReadSketch, force_leaf: bool = False,
                skip_node_index: int | None = None) -> PlacementScores:
    H = index.seed_hashes
    P = index.parent_counts.astype(np.int64)
    C = index.child_counts.astype(np.int64)
    n_nodes = len(index.node_offsets) - 1
    offs = index.node_offsets.astype(np.int64)

    # hash -> logReadCount lookup over the sorted read table
    if len(sk.sorted_hashes):
        ii = np.searchsorted(sk.sorted_hashes, H)
        ii_c = np.minimum(ii, len(sk.sorted_hashes) - 1)
        found = sk.sorted_hashes[ii_c] == H
        lrc = np.where(found, sk.log_counts[ii_c], 0.0)
    else:
        found = np.zeros(len(H), dtype=bool)
        lrc = np.zeros(len(H))

    # shared f64 metric-delta body (place/metrics.py — one definition site
    # for every scoring path; this numpy-f64 call is the parity oracle)
    Pf = P.astype(np.float64)
    Cf = C.astype(np.float64)
    (mag_delta, lograw_delta, logcos_delta, wc_delta, logcont_delta,
     presence_f) = row_metric_deltas(np, lrc, Pf, Cf, found)
    presence_delta = presence_f.astype(np.int64)
    uniq_delta = (C > 0).astype(np.int64) - (P > 0).astype(np.int64)

    # weighted-containment denominator from the root's rows, in stored order
    # (src/placement.cpp:1861-1876)
    root_rows = slice(int(offs[0]), int(offs[1]))
    wc_den = float(wc_denominator(np, lrc[root_rows], Cf[root_rows],
                                  found[root_rows])) if offs[1] > offs[0] else 0.0

    # accumulate parent->child with sequential f64 adds (reference add order)
    f64_metrics = (mag_delta, lograw_delta, logcos_delta, wc_delta, logcont_delta)
    int_metrics = (uniq_delta, presence_delta)
    parent = index.parent_index
    from ..native import tree_accumulate_native

    acc = tree_accumulate_native(list(f64_metrics), list(int_metrics),
                                 offs, parent)
    if acc is not None:
        acc_f, acc_i = acc
    else:
        acc_f = np.zeros((n_nodes, len(f64_metrics)))
        acc_i = np.zeros((n_nodes, len(int_metrics)), dtype=np.int64)
        for i in range(n_nodes):
            a, b = int(offs[i]), int(offs[i + 1])
            p = int(parent[i]) if i else None
            if p is None:
                base_f = np.zeros(len(f64_metrics))
                base_i = np.zeros(len(int_metrics), dtype=np.int64)
            else:
                base_f = acc_f[p]
                base_i = acc_i[p]
            if a == b:
                acc_f[i] = base_f
                acc_i[i] = base_i
                continue
            for m, arr in enumerate(f64_metrics):
                acc_f[i, m] = np.cumsum(np.concatenate(([base_f[m]], arr[a:b])))[-1]
            for m, arr in enumerate(int_metrics):
                acc_i[i, m] = base_i[m] + arr[a:b].sum()

    acc = np.concatenate([acc_f, acc_i[:, 1:2].astype(np.float64)], axis=1)
    scores = finalize_scores(np, acc, sk.log_read_magnitude,
                             sk.read_unique_seed_count,
                             sk.log_containment_denominator, wc_den)
    return select_best(scores, parent, force_leaf=force_leaf,
                       skip_node_index=skip_node_index)


def rescore_paths(index: IndexArrays, sk: ReadSketch, nodes) -> np.ndarray:
    """Exact f64 scores for a SMALL set of nodes by replaying each node's
    root->node delta path with the same sequential f64 addition order as
    score_nodes (the reference's built-in verify_scores idea,
    placement.cpp:776-791).  This is the exact-rescue stage of the default
    device placement path: the device selects tie candidates with a widened
    f32 tolerance, and this replay recomputes their scores bit-identically
    to the host engine.  Returns f64 [len(nodes), 5] in METRICS order.
    """
    parent = index.parent_index
    offs = index.node_offsets.astype(np.int64)
    nodes = [int(n) for n in nodes]
    seen: set = set()
    for n in nodes:
        i = n
        while i not in seen:
            seen.add(i)
            if i == 0:
                break
            i = int(parent[i])
    order = sorted(seen)  # DFS indices: parents precede children
    if not order:
        return np.zeros((0, 5))
    if order[0] != 0:
        order.insert(0, 0)  # root rows always needed for wc_den

    row_idx = np.concatenate(
        [np.arange(offs[i], offs[i + 1]) for i in order]) if order else \
        np.empty(0, np.int64)
    H = index.seed_hashes[row_idx]
    Pf = index.parent_counts[row_idx].astype(np.float64)
    Cf = index.child_counts[row_idx].astype(np.float64)
    if len(sk.sorted_hashes):
        ii = np.searchsorted(sk.sorted_hashes, H)
        iic = np.minimum(ii, len(sk.sorted_hashes) - 1)
        found = sk.sorted_hashes[iic] == H
        lrc = np.where(found, sk.log_counts[iic], 0.0)
    else:
        found = np.zeros(len(H), dtype=bool)
        lrc = np.zeros(len(H))
    deltas = row_metric_deltas(np, lrc, Pf, Cf, found)
    presence_int = deltas[5].astype(np.int64)

    root_m = int(offs[1] - offs[0])
    wc_den = float(wc_denominator(np, lrc[:root_m], Cf[:root_m],
                                  found[:root_m])) if root_m else 0.0

    acc_f: dict = {}
    acc_i: dict = {}
    pos = 0
    for i in order:
        m = int(offs[i + 1] - offs[i])
        base_f = acc_f[int(parent[i])] if i else np.zeros(5)
        base_i = acc_i[int(parent[i])] if i else 0
        vals = base_f.copy()
        for mth in range(5):
            arr = deltas[mth][pos : pos + m]
            if m:
                vals[mth] = np.cumsum(
                    np.concatenate(([base_f[mth]], arr)))[-1]
        acc_f[i] = vals
        acc_i[i] = base_i + int(presence_int[pos : pos + m].sum())
        pos += m

    acc = np.stack(
        [np.concatenate([acc_f[n], [float(acc_i[n])]]) for n in nodes])
    return finalize_scores(np, acc, sk.log_read_magnitude,
                           sk.read_unique_seed_count,
                           sk.log_containment_denominator, wc_den)


def select_best(scores: np.ndarray, parent_index: np.ndarray,
                force_leaf: bool = False,
                skip_node_index: int | None = None) -> PlacementScores:
    """Tolerance-aware best/tie selection over a [N,5] score matrix
    (src/placement.cpp:355-401); shared by the f64 engine and the TPU path."""
    n_nodes = scores.shape[0]
    result = PlacementScores(scores=scores)
    eligible = np.ones(n_nodes, dtype=bool)
    if skip_node_index is not None:
        eligible[skip_node_index] = False
    if force_leaf:
        is_parent = np.zeros(n_nodes, dtype=bool)
        is_parent[parent_index[1:]] = True
        eligible &= ~is_parent

    for m, name in enumerate(METRICS):
        col = np.where(eligible, scores[:, m], -np.inf)
        best = float(col.max()) if n_nodes else 0.0
        tol = max(best * 1e-4, 1e-9)
        tied = np.flatnonzero((col >= best - tol) & (col > 0))
        result.best_score[name] = best if best > -np.inf else 0.0
        result.tied_indices[name] = tied.tolist()
        result.best_index[name] = int(tied[0]) if len(tied) else None
    return result


def write_placement_tsv(path: str, index: IndexArrays, res: PlacementScores):
    """.placement.tsv writer (src/placement.cpp:1952-2009 format)."""
    with open(path, "w") as fh:
        fh.write("metric\tscore\tnodes\n")
        for name in METRICS:
            score = res.best_score[name]
            tied = res.tied_indices[name]
            ids = ",".join(index.node_ids[i] for i in tied)
            fh.write(f"{name}\t{score:.6f}\t{ids}\n")
