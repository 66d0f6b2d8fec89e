"""Metagenomic read scoring + SQUAREM abundance EM.

Reimplements the reference's mgsr runtime (src/mgsr.cpp):

 - read seedmer lists with in-read duplicates and per-occurrence orientation,
   deduplicated across reads by identical lists (:1850-1990);
 - DUST low-complexity filter (:1518-1568);
 - tree collapsing: delta-free nodes, then nodes whose deltas never touch a
   read seedmer (:777-847), accumulating identicalNodeIdentifiers for output;
 - overlap coefficients (distinct node hashes present in the read set over
   distinct node hashes, :5685-5791) with shared-rank assignment (:141-154);
 - per-read forward/reverse match counters maintained down the DFS: a read
   occurrence of hash h gains/loses a forward (orientation-agreeing) or
   reverse match when the node's per-orientation presence of h flips
   (:7225-7470); score = max(fwd, rev);
 - SQUAREM-accelerated EM over probs(j,i) = err^(m_j - s_ij) (1-err)^s_ij with
   read-duplicate weights, likelihood-guarded extrapolation, low-proportion
   node dropping between rounds (:4341-4491, :7988-8201).
"""

from __future__ import annotations

import os
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from ..sketch.cpu import kminmer_hashes_oriented, syncmer_list
from .index import MetaIndexArrays

ERROR_RATE = 0.005
PROP_THRESHOLD_TO_REMOVE = 0.005

# DUST constants (mgsr.cpp getDust: 3-mer window algorithm)
_DUST_K = 3
_DUST_MASK = (1 << (2 * _DUST_K)) - 1
_DUST_BASE = np.full(256, 255, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _DUST_BASE[ord(_c)] = _i
    _DUST_BASE[ord(_c.lower())] = _i


def dust_score(seq: str, window_size: int = 64) -> float:
    """Prinseq-scale low-complexity score (mgsr.cpp:1518-1568)."""
    kmer_counts = np.zeros(1 << (2 * _DUST_K), dtype=np.int64)
    window_kmers = np.zeros(window_size, dtype=np.int64)
    cur_score = 0
    max_score = 0
    cur = 0
    valid = -_DUST_K
    for ch in seq.encode():
        b = _DUST_BASE[ch]
        if b > 3:
            continue
        cur = ((cur << 2) | int(b)) & _DUST_MASK
        valid += 1
        if valid < 0:
            continue
        wp = valid % window_size
        if valid >= window_size:
            out = window_kmers[wp]
            if kmer_counts[out] > 0:
                kmer_counts[out] -= 1
                cur_score -= kmer_counts[out]
            cur_score += kmer_counts[cur]
            kmer_counts[cur] += 1
            max_score = max(max_score, cur_score)
        else:
            cur_score += kmer_counts[cur]
            kmer_counts[cur] += 1
        window_kmers[wp] = cur
    n_kmers = valid + 1
    if valid >= window_size:
        return (200.0 * max_score) / (window_size * (window_size - 1))
    if n_kmers > 1:
        return (200.0 * cur_score) / (valid * (valid + 1))
    return 0.0


@dataclass
class MetaRead:
    """One deduplicated read: its seedmer occurrence list + duplicate count."""

    hashes: np.ndarray  # u64 per occurrence
    revs: np.ndarray  # bool per occurrence
    n_dup: int = 1
    max_score: int = 0
    qbeg: np.ndarray | None = None  # i64 read-coordinate begin per seedmer
    qend: np.ndarray | None = None  # i64 read-coordinate end (inclusive)


_AMPLICON_TSV_CACHE: dict = {}


def _load_amplicon_tsv(path: str):
    """Parse (and cache by path+mtime) the amplicon TSV — batch streaming
    calls load_amplicon_groups once per batch and must not re-read the
    file each time."""
    key = (path, os.path.getmtime(path))
    hit = _AMPLICON_TSV_CACHE.get(key)
    if hit is not None:
        return hit
    primer_to_group: dict = {}
    read_to_group: dict = {}
    with open(path) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 2:
                continue
            rid, pid = parts[0], parts[1]
            if pid not in primer_to_group:
                primer_to_group[pid] = len(primer_to_group)
            read_to_group[rid] = primer_to_group[pid]
    _AMPLICON_TSV_CACHE.clear()  # keep at most one parsed file
    _AMPLICON_TSV_CACHE[key] = (read_to_group, len(primer_to_group))
    return read_to_group, len(primer_to_group)


def load_amplicon_groups(path: str, names: list):
    """Amplicon-depth TSV (readId \t primerId; mgsr.cpp:1218-1265): returns
    (group_of int[n_reads], n_groups) with unlisted reads in the LAST group."""
    read_to_group, n_primers = _load_amplicon_tsv(path)
    n_groups = n_primers + 1
    group_of = np.full(len(names), n_groups - 1, dtype=np.int64)
    for i, nm in enumerate(names):
        g = read_to_group.get(nm.split()[0].rsplit("/", 1)[0], None)
        if g is None:
            g = read_to_group.get(nm, n_groups - 1)
        group_of[i] = g
    return group_of, n_groups


def apply_seed_masking(reads: list, dup_index: list, mask_reads: int = 0,
                       mask_seeds: int = 0, group_size: int = 0,
                       mask_reads_rf: float = 0.0,
                       mask_seeds_rf: float = 0.0, is_last_group: bool = True):
    """Low-occurrence k-min-mer masking over one amplicon group
    (mgsr.cpp:2049-2160): counts are per unique hash weighted by read
    duplicates; mask-reads drops reads containing any seedmer at or below the
    threshold, mask-seeds strips those seedmers instead.  Relative-frequency
    thresholds scale with the group size; the catch-all last group always
    uses the absolute thresholds.  Returns (reads, dup_index, n_masked)."""
    active = sum(x > 0 for x in (mask_reads, mask_seeds,
                                 mask_reads_rf, mask_seeds_rf))
    if active == 0:
        return reads, dup_index, 0
    if active > 1:
        raise ValueError("Only one masking parameter can be set at a time")
    counts: dict = {}
    for r, members in zip(reads, dup_index):
        for h in set(r.hashes.tolist()):
            counts[h] = counts.get(h, 0) + len(members)
    read_thr = int(mask_reads_rf * group_size) if mask_reads_rf > 0 else mask_reads
    seed_thr = int(mask_seeds_rf * group_size) if mask_seeds_rf > 0 else mask_seeds
    if is_last_group:
        read_thr = mask_reads
        seed_thr = mask_seeds
    n_masked = 0
    out_reads, out_dups = [], []
    if read_thr > 0:
        for r, members in zip(reads, dup_index):
            if any(counts[h] <= read_thr for h in r.hashes.tolist()):
                n_masked += 1
                continue
            out_reads.append(r)
            out_dups.append(members)
    elif seed_thr > 0:
        for r, members in zip(reads, dup_index):
            keep = np.array([counts[h] > seed_thr for h in r.hashes.tolist()])
            n_masked += int((~keep).sum())
            if not keep.any():
                continue
            if not keep.all():
                r = MetaRead(hashes=r.hashes[keep], revs=r.revs[keep],
                             n_dup=r.n_dup)
            out_reads.append(r)
            out_dups.append(members)
    else:
        return reads, dup_index, 0
    return out_reads, out_dups, n_masked


def _sketch_meta_reads_native(seqs: list, k, s, t, l, open_, orig_idx):
    """Native CSR scan + vectorized exact dedup of identical seedmer lists.
    Returns (reads, dup_index) or None when the native library is absent."""
    from ..native import sketch_meta_native

    out = sketch_meta_native(seqs, k, s, t, open_, l)
    if out is None:
        return None
    ro, H, RV, QB, QE, fp1, fp2 = out
    lens = np.diff(ro)
    fps = (fp1, fp2)  # order-dependent content fingerprints from the kernel
    keep = lens > 0  # reads with no seedmers are dropped entirely
    ki = np.flatnonzero(keep)
    order = ki[np.lexsort((fps[1][ki], fps[0][ki], lens[ki]))]
    # exact adjacent verification (fingerprint collisions split groups)
    same = np.zeros(len(order), dtype=bool)
    if len(order) > 1:
        a, b = order[:-1], order[1:]
        cand = ((lens[a] == lens[b]) & (fps[0][a] == fps[0][b])
                & (fps[1][a] == fps[1][b]))
        ci = np.flatnonzero(cand)
        if len(ci):
            # gather both streams and compare elementwise per pair
            la = lens[a[ci]]
            seg = np.concatenate(([0], np.cumsum(la)))
            rel = np.arange(seg[-1]) - np.repeat(seg[:-1], la)
            ga = np.repeat(ro[a[ci]], la) + rel
            gb = np.repeat(ro[b[ci]], la) + rel
            eq = ((H[ga] == H[gb]) & (RV[ga] == RV[gb]) & (QB[ga] == QB[gb])
                  & (QE[ga] == QE[gb]))
            ecs = np.concatenate(([0], np.cumsum(eq.astype(np.int64))))
            all_eq = (ecs[seg[1:]] - ecs[seg[:-1]]) == la
            same[ci + 1] = all_eq
    if len(order) == 0:
        return [], []
    # vectorized group build: compact CSR of group representatives; the
    # MetaRead arrays are views into it (a python per-group copy loop cost
    # ~25s at 223k groups)
    gid = np.cumsum(~same) - 1
    counts = np.bincount(gid)
    first_pos = np.concatenate(([0], np.cumsum(counts)[:-1]))
    reps = order[first_pos]
    rl = lens[reps]
    new_ro = np.concatenate(([0], np.cumsum(rl)))
    relx = np.arange(new_ro[-1]) - np.repeat(new_ro[:-1], rl)
    src = np.repeat(ro[reps], rl) + relx
    H2 = H[src]
    RV2 = RV[src]
    QB2 = QB[src].astype(np.int64)
    QE2 = QE[src].astype(np.int64)
    members_all = np.asarray(orig_idx)[order]
    lo = new_ro[:-1].tolist()
    hi = new_ro[1:].tolist()
    reads = [
        MetaRead(hashes=H2[a:b], revs=RV2[a:b], n_dup=int(c),
                 qbeg=QB2[a:b], qend=QE2[a:b])
        for a, b, c in zip(lo, hi, counts.tolist())
    ]
    dup_index = np.split(members_all, np.cumsum(counts)[:-1])
    return reads, dup_index


def sketch_meta_reads_full(seqs: list, k: int, s: int, t: int, l: int,
                           open_: bool, dust_threshold: float = 100.0,
                           mask_read_ends: int = 0):
    """Read seedmer lists, dust filter, dedup identical lists.

    Returns (reads: list[MetaRead], dup_index: list[list[int]] mapping each
    unique set to the original read indices, n_low_complexity)."""
    n_dust = 0
    if len(seqs) >= 512:
        # native batched scan (dust/end-mask applied on the host first)
        work = seqs
        orig = np.arange(len(seqs), dtype=np.int64)
        if mask_read_ends > 0:
            work = [x[mask_read_ends : len(x) - mask_read_ends]
                    if len(x) > 2 * mask_read_ends else x for x in work]
        if dust_threshold < 100.0:
            ok = np.array([dust_score(x) <= dust_threshold for x in work])
            n_dust = int((~ok).sum())
            orig = orig[ok]
            work = [work[i] for i in np.flatnonzero(ok)]
        got = _sketch_meta_reads_native(work, k, s, t, l, open_, orig)
        if got is not None:
            return got[0], got[1], n_dust
        n_dust = 0  # fall through to the python path

    lists: dict[bytes, list] = {}
    for idx, seq in enumerate(seqs):
        if mask_read_ends > 0 and len(seq) > 2 * mask_read_ends:
            # aDNA end-damage trim (mgsr.cpp:1274-1308)
            seq = seq[mask_read_ends : len(seq) - mask_read_ends]
        if dust_threshold < 100.0 and dust_score(seq) > dust_threshold:
            n_dust += 1
            continue
        pos, H, rev = syncmer_list(seq, k, s, open_, t)
        if len(H) < l:
            key = b""
        else:
            km, valid, km_rev = kminmer_hashes_oriented(H, k, l, rev)
            # seedmer i spans syncmers [i, i+l-1]: read-coordinate extent
            qb = pos[: len(km)][valid].astype(np.int64)
            qe = pos[l - 1 : l - 1 + len(km)][valid] + (k - 1)
            kmv = km[valid]
            rvv = km_rev[valid]
            key = (kmv.tobytes() + rvv.tobytes() + qb.tobytes()
                   + qe.astype(np.int64).tobytes())
        ent = lists.get(key)
        if ent is None:
            arrays = None if not len(key) else (kmv, rvv, qb,
                                                qe.astype(np.int64))
            lists[key] = (arrays, [idx])
        else:
            ent[1].append(idx)
    reads = []
    dup_index = []
    for arrays, members in lists.values():
        if arrays is None:
            continue
        kmv, rvv, qb, qe = arrays
        reads.append(MetaRead(hashes=kmv, revs=rvv, n_dup=len(members),
                              qbeg=qb, qend=qe))
        dup_index.append(members)
    return reads, dup_index, n_dust


def sketch_meta_reads(seqs: list, k: int, s: int, t: int, l: int, open_: bool,
                      dust_threshold: float = 100.0, mask_read_ends: int = 0):
    reads, _, n_dust = sketch_meta_reads_full(seqs, k, s, t, l, open_,
                                              dust_threshold, mask_read_ends)
    return reads, n_dust


def sketch_meta_reads_grouped(seqs: list, names: list, p, cfg):
    """Per-amplicon-group sketch + mask pipeline (the masking thresholds are
    group-relative when --amplicon-depth is given).  Returns
    (reads, dup_index, n_dust, n_masked)."""
    if getattr(cfg, "amplicon_depth", ""):
        group_of, n_groups = load_amplicon_groups(cfg.amplicon_depth, names)
    else:
        group_of = np.zeros(len(seqs), dtype=np.int64)
        n_groups = 1
    all_reads, all_dups = [], []
    n_dust_total = n_masked_total = 0
    for g in range(n_groups):
        idxs = np.flatnonzero(group_of == g)
        if len(idxs) == 0:
            continue
        gseqs = [seqs[i] for i in idxs]
        reads, dups, n_dust = sketch_meta_reads_full(
            gseqs, p.k, p.s, p.t, p.l, p.open,
            dust_threshold=cfg.dust, mask_read_ends=cfg.mask_read_ends)
        dups = [[int(idxs[j]) for j in mem] for mem in dups]
        reads, dups, n_masked = apply_seed_masking(
            reads, dups, mask_reads=cfg.mask_reads, mask_seeds=cfg.mask_seeds,
            group_size=len(idxs), mask_reads_rf=cfg.mask_reads_rf,
            mask_seeds_rf=cfg.mask_seeds_rf,
            is_last_group=(g == n_groups - 1))
        all_reads.extend(reads)
        all_dups.extend(dups)
        n_dust_total += n_dust
        n_masked_total += n_masked
    return all_reads, all_dups, n_dust_total, n_masked_total


@dataclass
class CollapsedTree:
    """Meta tree after empty/irrelevant-node collapsing."""

    keep: np.ndarray  # bool[N] survives
    collapsed_parent: np.ndarray  # i32[N] surviving ancestor (self if kept)
    identical_members: dict  # kept node -> [absorbed node indices]
    children: list  # kept-node adjacency (indices)


def collapse_tree(midx: MetaIndexArrays, node_relevant_counts) -> CollapsedTree:
    """Collapse nodes with no relevant delta rows into their parents
    (collapseEmptyNodes + collapseIdenticalScoringNodes combined).
    node_relevant_counts: int array [N] of read-relevant delta rows per node."""
    n = len(midx.node_ids)
    parent = midx.parent_index.astype(np.int64)
    keep = np.asarray(node_relevant_counts) > 0
    keep[0] = True
    collapsed_parent = np.zeros(n, dtype=np.int64)
    identical_members: dict = defaultdict(list)
    for i in range(n):
        if keep[i]:
            collapsed_parent[i] = i
        else:
            cp = collapsed_parent[parent[i]]
            collapsed_parent[i] = cp
            identical_members[cp].append(i)
    children: list = [[] for _ in range(n)]
    for i in range(1, n):
        if keep[i]:
            p = collapsed_parent[parent[i]]
            children[p].append(i)
    return CollapsedTree(keep=keep, collapsed_parent=collapsed_parent,
                         identical_members=identical_members, children=children)



class _Fenwick:
    """Binary-indexed tree over int counts (0-based API)."""

    __slots__ = ("n", "t")

    def __init__(self, n: int):
        self.n = n
        self.t = np.zeros(n + 1, np.int64)

    def build(self, vals: np.ndarray):
        cs = np.concatenate(([0], np.cumsum(vals, dtype=np.int64)))
        idx = np.arange(1, self.n + 1, dtype=np.int64)
        low = idx & (-idx)
        self.t = np.zeros(self.n + 1, np.int64)
        self.t[1:] = cs[idx] - cs[idx - low]

    def update(self, i: int, d: int):
        i += 1
        t = self.t
        n = self.n
        while i <= n:
            t[i] += d
            i += i & (-i)

    def prefix(self, i: int) -> int:
        s = 0
        t = self.t
        i += 1
        while i > 0:
            s += t[i]
            i -= i & (-i)
        return int(s)

    def range(self, a: int, b: int) -> int:
        if b < a:
            return 0
        return self.prefix(b) - (self.prefix(a - 1) if a else 0)


class GapTracker:
    """Dynamic degapped-coordinate index over the forward scalar space
    (reference: the per-node gapMap + getLocalGap, mgsr.cpp:2273-2622 and
    :5280-5310).  Replays the meta index's per-node gap events (character
    gap-ness flips + block presence/strand changes) alongside the scoring
    DFS; local_gap(a, b) equals the reference's getLocalGap: the number of
    non-gap columns of the CURRENT node's alignment in the reading-order
    interval between two (non-gap) reading scalars."""

    def __init__(self, midx):
        n = int(midx.n_scalar)
        bits = np.unpackbits(midx.nongap0, bitorder="little")[:n].astype(bool)
        self.midx = midx
        self.nb = len(midx.block_lo)
        self.block_lo = midx.block_lo.astype(np.int64)
        self.block_hi = midx.block_hi.astype(np.int64)
        self.present = np.zeros(self.nb, bool)
        self.strand = np.ones(self.nb, bool)
        self.fen = _Fenwick(n)
        self.fen.build(bits.astype(np.int64))
        cs = np.concatenate(([0], np.cumsum(bits, dtype=np.int64)))
        self.tot = cs[self.block_hi + 1] - cs[self.block_lo]
        self.bfen = _Fenwick(self.nb)  # totals of PRESENT blocks only

    def _block_of(self, sc: int) -> int:
        return int(np.searchsorted(self.block_lo, sc, side="right")) - 1

    def enter(self, node: int) -> list:
        """Apply the node's gap events; returns the undo token for leave()."""
        undo = []
        m = self.midx
        for i in range(int(m.bev_offsets[node]), int(m.bev_offsets[node + 1])):
            b = int(m.bev_block[i])
            code = int(m.bev_code[i])
            old = (bool(self.present[b]), bool(self.strand[b]))
            newp = code != 0
            if self.present[b] != newp:
                self.bfen.update(b, int(self.tot[b]) if newp
                                 else -int(self.tot[b]))
            self.present[b] = newp
            self.strand[b] = code != 2
            undo.append((1, b, old))
        for i in range(int(m.gev_offsets[node]), int(m.gev_offsets[node + 1])):
            sc = int(m.gev_pos[i])
            d = 1 if m.gev_nongap[i] else -1
            self.fen.update(sc, d)
            b = self._block_of(sc)
            self.tot[b] += d
            if self.present[b]:
                self.bfen.update(b, d)
            undo.append((0, sc, b, d))
        return undo

    def leave(self, undo: list):
        for item in reversed(undo):
            if item[0] == 0:
                _, sc, b, d = item
                self.fen.update(sc, -d)
                self.tot[b] -= d
                if self.present[b]:
                    self.bfen.update(b, -d)
            else:
                _, b, (op, os) = item
                if bool(self.present[b]) != op:
                    self.bfen.update(b, int(self.tot[b]) if op
                                     else -int(self.tot[b]))
                self.present[b] = op
                self.strand[b] = os

    def _F(self, x: int) -> int:
        """Non-gap columns at reading scalars <= x (x itself included)."""
        b = self._block_of(x)
        lo = int(self.block_lo[b])
        hi = int(self.block_hi[b])
        if self.strand[b]:
            inblk = self.fen.range(lo, x)
        else:
            fx = lo + hi - x
            inblk = self.fen.range(fx, hi)
        return (self.bfen.prefix(b - 1) if b else 0) + inblk

    def local_gap(self, a: int, b: int) -> int:
        return abs(self._F(b) - self._F(a))


class MetaScorer:
    """DFS scorer over the collapsed tree."""

    def __init__(self, midx: MetaIndexArrays, reads: list,
                 relevant_hashes: np.ndarray | None = None,
                 shared_tree=None):
        self.midx = midx
        self.reads = reads
        self.n_nodes = len(midx.node_ids)

        # sorted unique read hashes (vectorized; the python inverted index
        # and per-node row lists below are built lazily — the TPU fast path
        # only needs tree.keep / identical_members from this object).
        # relevant_hashes overrides the read-derived set: batch streaming
        # passes the UNION over all batches so the collapsed tree (and thus
        # node keep/identical sets) is identical for every batch split.
        # shared_tree = (tree, relevant, rh_sorted) reuses a previous
        # scorer's hash-dependent state (valid only for the same
        # relevant_hashes), skipping the per-row relevance scan + collapse.
        if shared_tree is not None:
            self.tree, self._relevant, self._rh_sorted = shared_tree
            self._occ_read = None
            self._occ_rev = None
            self._rows_per_node = None
            self._read_hash_set = None
            return
        if relevant_hashes is not None:
            all_h = np.asarray(relevant_hashes, dtype=np.uint64)
        else:
            all_h = (np.concatenate([r.hashes for r in reads])
                     if reads else np.empty(0, np.uint64))
        self._rh_sorted = np.unique(all_h)

        # relevant rows (hash in read set) + per-node counts, vectorized
        offs = midx.node_offsets
        row_hash = midx.seed_hash[midx.delta_seed]
        if len(self._rh_sorted):
            ii = np.searchsorted(self._rh_sorted, row_hash)
            iic = np.minimum(ii, len(self._rh_sorted) - 1)
            relevant = self._rh_sorted[iic] == row_hash
        else:
            relevant = np.zeros(len(row_hash), dtype=bool)
        self._relevant = relevant
        o = np.asarray(offs, dtype=np.int64)
        cs = np.concatenate(([0], np.cumsum(relevant.astype(np.int64))))
        node_counts = cs[o[1:]] - cs[o[:-1]]

        # nodes with ANY deltas (for empty-collapse parity the reference first
        # collapses delta-free nodes, then read-irrelevant ones; combined here)
        self.tree = collapse_tree(midx, node_counts)
        self._occ_read = None
        self._occ_rev = None
        self._rows_per_node = None
        self._read_hash_set = None

    @property
    def read_hash_set(self):
        if self._read_hash_set is None:
            self._read_hash_set = set(self._rh_sorted.tolist())
        return self._read_hash_set

    @property
    def rows_per_node(self):
        if self._rows_per_node is None:
            offs = self.midx.node_offsets
            self._rows_per_node = [
                (np.flatnonzero(
                    self._relevant[int(offs[i]) : int(offs[i + 1])])
                 + int(offs[i])).tolist()
                for i in range(self.n_nodes)
            ]
        return self._rows_per_node

    def _build_occ(self):
        # inverted index hash -> (read idx array, occ rev array), vectorized:
        # one stable sort of all occurrences grouped by hash
        reads = self.reads
        all_h = (np.concatenate([r.hashes for r in reads])
                 if reads else np.empty(0, np.uint64))
        all_rev = (np.concatenate([np.asarray(r.revs, dtype=bool)
                                   for r in reads])
                   if reads else np.empty(0, bool))
        row_of = np.repeat(
            np.arange(len(reads), dtype=np.int64),
            [len(r.hashes) for r in reads]) if reads else np.empty(0, np.int64)
        order = np.argsort(all_h, kind="stable")
        hs = all_h[order]
        ro = row_of[order]
        rv = all_rev[order]
        starts = np.flatnonzero(
            np.concatenate(([True], hs[1:] != hs[:-1])))
        bounds = np.append(starts, len(hs))
        self._occ_read = {}
        self._occ_rev = {}
        for gi in range(len(starts)):
            a, b = bounds[gi], bounds[gi + 1]
            h = int(hs[a])
            self._occ_read[h] = ro[a:b]
            self._occ_rev[h] = rv[a:b]

    @property
    def occ_read(self):
        if self._occ_read is None:
            self._build_occ()
        return self._occ_read

    @property
    def occ_rev(self):
        if self._occ_rev is None:
            self._build_occ()
        return self._occ_rev

    # ------------------------------------------------------------------
    def overlap_coefficients(self):
        """(node_index -> OC): vectorized via presence events (equal to the
        sequential DFS oracle `overlap_coefficients_ref`, which
        PANMAP_TPU_NO_NATIVE=1 forces)."""
        if not os.environ.get("PANMAP_TPU_NO_NATIVE"):
            from .events import (overlap_coefficients_from_events,
                                 presence_events)

            ev = presence_events(self.midx, self._rh_sorted)
            arr = overlap_coefficients_from_events(ev, self.n_nodes)
            return {n: float(arr[n]) for n in range(self.n_nodes)}
        return self.overlap_coefficients_ref()

    def overlap_coefficients_ref(self):
        """(node_index -> OC) over surviving nodes, via delta DFS."""
        midx = self.midx
        offs = midx.node_offsets
        counts: dict = defaultdict(lambda: [0, 0])  # hash -> [fwd, rev]
        overlap = 0
        oc: dict = {}
        read_set = self.read_hash_set

        def apply_row(r, sign):
            nonlocal overlap
            sid = midx.delta_seed[r]
            h = int(midx.seed_hash[sid])
            rv = bool(midx.seed_rev[sid])
            isdel = bool(midx.delta_is_del[r]) ^ (sign < 0)
            c = counts[h]
            if not isdel:
                c[1 if rv else 0] += 1
                if c[0] + c[1] == 1 and h in read_set:
                    overlap += 1
            else:
                was = c[0] + c[1]
                c[1 if rv else 0] -= 1
                if was == 1 and h in read_set:
                    overlap -= 1
                if c[0] + c[1] == 0:
                    del counts[h]

        stack = [(0, False)]
        while stack:
            node, done = stack.pop()
            rows = range(int(offs[node]), int(offs[node + 1]))
            if done:
                for r in reversed(rows):
                    apply_row(r, -1)
                continue
            for r in rows:
                apply_row(r, +1)
            denom = len(counts)
            oc[node] = overlap / denom if denom else 0.0
            stack.append((node, True))
            kids = self.tree.children[node] if self.tree.keep[node] else []
            # traverse the FULL tree (oc recorded for kept nodes only)
            for c in reversed(self._raw_children(node)):
                stack.append((c, False))
        return oc

    def _raw_children(self, node):
        if not hasattr(self, "_rawch"):
            n = self.n_nodes
            ch: list = [[] for _ in range(n)]
            par = self.midx.parent_index
            for i in range(1, n):
                ch[par[i]].append(i)
            self._rawch = ch
        return self._rawch[node]

    # ------------------------------------------------------------------
    def score_all(self, candidate_nodes: list, collect_node_scores: bool = False):
        """DFS applying presence-flip events to per-read fwd/rev counters.

        Returns (max_score i32[R], score_matrix u16[len(candidates), R]) and,
        when collect_node_scores, a third dict node -> [(read, score-after)]
        (the sparse readScoreDeltas the assignment pass replays).

        The native core (pt_score_simple, bit-equal — this python stays as
        its oracle) handles the common case; PANMAP_TPU_NO_NATIVE=1 forces
        the python path."""
        if not os.environ.get("PANMAP_TPU_NO_NATIVE"):
            res = self._score_simple_native(candidate_nodes,
                                            collect_node_scores)
            if res is not None:
                return res
        R = len(self.reads)
        fwd = np.zeros(R, dtype=np.int32)
        rev = np.zeros(R, dtype=np.int32)
        max_score = np.zeros(R, dtype=np.int32)
        cand_set = {n: i for i, n in enumerate(candidate_nodes)}
        snap = np.zeros((len(candidate_nodes), R), dtype=np.uint16)
        counts: dict = defaultdict(lambda: [0, 0])
        node_scores: dict = {}
        midx = self.midx

        def apply_row(r, sign):
            sid = midx.delta_seed[r]
            h = int(midx.seed_hash[sid])
            rv = bool(midx.seed_rev[sid])
            isdel = bool(midx.delta_is_del[r]) ^ (sign < 0)
            c = counts[h]
            oi = 1 if rv else 0
            if not isdel:
                c[oi] += 1
                fire = c[oi] == 1
                delta = 1
            else:
                fire = c[oi] == 1
                c[oi] -= 1
                delta = -1
            if not fire:
                return None
            ri = self.occ_read.get(h)
            if ri is None:
                return None
            agree = self.occ_rev[h] == rv
            np.add.at(fwd, ri[agree], delta)
            np.add.at(rev, ri[~agree], delta)
            return ri

        stack = [(0, False)]
        while stack:
            node, done = stack.pop()
            rows = self.rows_per_node[node]
            if done:
                for r in reversed(rows):
                    apply_row(r, -1)
                continue
            touched = []
            for r in rows:
                ri = apply_row(r, +1)
                if ri is not None:
                    touched.append(ri)
            if touched:
                tr = np.unique(np.concatenate(touched))
                sc = np.maximum(fwd[tr], rev[tr])
                max_score[tr] = np.maximum(max_score[tr], sc)
                if collect_node_scores:
                    node_scores[node] = list(zip(tr.tolist(), sc.tolist()))
            ci = cand_set.get(node)
            if ci is not None:
                snap[ci] = np.maximum(fwd, rev).astype(np.uint16)
            stack.append((node, True))
            for c in reversed(self._raw_children(node)):
                stack.append((c, False))
        if collect_node_scores:
            return max_score, snap, node_scores
        return max_score, snap

    # ------------------------------------------------------------------
    @staticmethod
    def _rdg_perm(read_off, read_hash, lens):
        """Component-DFS read permutation for the native scorer (reference
        lowMemory readDebruijnGraph.sortReads, mgsr.cpp:2160-2162) and the
        gathered (off, hash-index) CSR it induces.  Opt-out with
        PANMAP_TPU_RDG=0; see PARITY.md for the locality measurement."""
        if os.environ.get("PANMAP_TPU_RDG", "1") == "0":
            return None
        from .rdg import debruijn_read_order

        perm = debruijn_read_order(read_off, read_hash)
        lp = lens[perm]
        starts = read_off[:-1][perm]
        tot = int(lp.sum())
        csum = np.concatenate(([0], np.cumsum(lp)))
        gather = (np.repeat(starts, lp)
                  + (np.arange(tot) - np.repeat(csum[:-1], lp)))
        return perm, csum, gather

    def _score_simple_native(self, candidate_nodes: list,
                             collect_node_scores: bool):
        """Call the native simple-mode core; None when unavailable.  Reads
        are fed in de-Bruijn component order (affected-read updates touch
        contiguous ranges) and results scattered back to original ids."""
        from ..native import score_simple_native

        reads = self.reads
        lens = np.array([len(r.hashes) for r in reads], dtype=np.int64)
        read_off = np.concatenate(([0], np.cumsum(lens)))
        if read_off[-1] == 0:
            return None
        read_hash = np.concatenate([r.hashes for r in reads])
        read_rev = np.concatenate([np.asarray(r.revs, bool) for r in reads])
        # node_scores' per-node emission order is part of the python-oracle
        # contract (the assignment replay and dump TSVs preserve it), so the
        # locality permutation only applies to the pure-scoring case
        p = (None if collect_node_scores
             else self._rdg_perm(read_off, read_hash, lens))
        if p is not None:
            perm, read_off, gather = p
            read_hash = read_hash[gather]
            read_rev = read_rev[gather]
        res = score_simple_native(
            self.midx, read_off, read_hash, read_rev, self._relevant,
            np.asarray(candidate_nodes, np.int64),
            emit_node_scores=collect_node_scores)
        if res is None:
            return None
        max_score, snap, node_scores = res
        if p is not None:
            ms = np.empty_like(max_score)
            ms[perm] = max_score
            max_score = ms
            sn = np.empty_like(snap)
            sn[:, perm] = snap
            snap = sn
        if collect_node_scores:
            return max_score, snap, node_scores
        return max_score, snap

    # ------------------------------------------------------------------
    def _score_pseudo_native(self, candidate_nodes: list, maximum_gap: int):
        """Call the native pseudochain core; None when the library or the
        gap-event arrays (format-v1 caches) are unavailable."""
        from ..native import score_pseudo_native

        midx = self.midx
        if midx.seed_end is None or midx.gev_offsets is None:
            return None
        reads = self.reads
        lens = np.array([len(r.hashes) for r in reads], dtype=np.int64)
        read_off = np.concatenate(([0], np.cumsum(lens)))
        if read_off[-1] == 0:
            return None
        read_hash = (np.concatenate([r.hashes for r in reads]) if reads
                     else np.empty(0, np.uint64))
        read_rev = (np.concatenate([np.asarray(r.revs, bool) for r in reads])
                    if reads else np.empty(0, bool))
        if any(r.qbeg is None or r.qend is None for r in reads):
            return None
        read_qbeg = np.concatenate([np.asarray(r.qbeg, np.int64)
                                    for r in reads])
        read_qend = np.concatenate([np.asarray(r.qend, np.int64)
                                    for r in reads])
        p = self._rdg_perm(read_off, read_hash, lens)
        if p is not None:
            perm, read_off, gather = p
            read_hash = read_hash[gather]
            read_rev = read_rev[gather]
            read_qbeg = read_qbeg[gather]
            read_qend = read_qend[gather]
        res = score_pseudo_native(
            midx, read_off, read_hash, read_rev, read_qbeg, read_qend,
            self._relevant, np.asarray(candidate_nodes, np.int64),
            maximum_gap=maximum_gap)
        if res is not None and p is not None:
            max_score, snap = res
            ms = np.empty_like(max_score)
            ms[perm] = max_score
            sn = np.empty_like(snap)
            sn[:, perm] = snap
            res = (ms, sn)
        return res

    def score_all_pseudo(self, candidate_nodes: list,
                         collect_node_scores: bool = False,
                         maximum_gap: int = 50):
        """Pseudochain scoring (--pseudochain; mgsr.cpp:4616-5526): per node,
        affected reads are rescored as minichains — maximal runs of read
        seedmers uniquely present in the node's seed set with consistent
        orientation and ADJACENT reference positions — and the score is the
        longest chain plus same-orientation chains colinear with it
        (|qgap - rgap| < maximumGap, preset 50; mgsr.hpp:826).

        Ref gaps are degapped through the per-node gap-event stream
        (GapTracker = the reference's gapMap + getLocalGap); chains are
        rebuilt from scratch for affected reads instead of incrementally
        patched, which is strictly more accurate.

        The threaded native core (pt_score_pseudo, bit-equal to this python
        which stays as its oracle) handles the common no-node-scores case;
        set PANMAP_TPU_NO_NATIVE=1 to force the python path."""
        if (not collect_node_scores
                and not os.environ.get("PANMAP_TPU_NO_NATIVE")):
            res = self._score_pseudo_native(candidate_nodes, maximum_gap)
            if res is not None:
                return res
        midx = self.midx
        R = len(self.reads)
        score = np.zeros(R, dtype=np.int32)
        max_score = np.zeros(R, dtype=np.int32)
        cand_set = {n: i for i, n in enumerate(candidate_nodes)}
        snap = np.zeros((len(candidate_nodes), R), dtype=np.uint16)
        node_scores: dict = {}
        gap = GapTracker(midx)

        hash_pos: dict = defaultdict(dict)  # h -> {pos: (refRev, endPos)}
        pos_arr = np.empty(0, dtype=np.int64)  # sorted active positions

        def apply_row(r, sign):
            """Returns the hash whose uniqueness state may have changed."""
            nonlocal pos_arr
            sid = midx.delta_seed[r]
            h = int(midx.seed_hash[sid])
            rv = bool(midx.seed_rev[sid])
            p = int(midx.seed_pos[sid])
            en = int(midx.seed_end[sid])
            isdel = bool(midx.delta_is_del[r]) ^ (sign < 0)
            d = hash_pos[h]
            i = np.searchsorted(pos_arr, p)
            if not isdel:
                d[p] = (rv, en)
                pos_arr = np.insert(pos_arr, i, p)
            else:
                d.pop(p, None)
                if i < len(pos_arr) and pos_arr[i] == p:
                    pos_arr = np.delete(pos_arr, i)
                if not d:
                    del hash_pos[h]
            return h

        def chain_score(rd) -> int:
            hs = rd.hashes
            rvs = rd.revs
            n = len(hs)
            chains = []  # (beg_i, end_i, rev, rpos_of_beg, rpos_of_end)
            i = 0
            while i < n:
                h = int(hs[i])
                d = hash_pos.get(h)
                c = 1
                if d is not None and len(d) == 1:
                    p, (refrev, _) = next(iter(d.items()))
                    rev = bool(rvs[i]) != refrev
                    j = i
                    curp = p
                    ia = int(np.searchsorted(pos_arr, curp))
                    while j + 1 < n:
                        nd = hash_pos.get(int(hs[j + 1]))
                        if nd is None or len(nd) != 1:
                            break
                        np_, (nrefrev, _) = next(iter(nd.items()))
                        if (bool(rvs[j + 1]) != nrefrev) != rev:
                            break
                        if rev:
                            if ia == 0 or pos_arr[ia - 1] != np_:
                                break
                            ia -= 1
                        else:
                            if ia + 1 >= len(pos_arr) or pos_arr[ia + 1] != np_:
                                break
                            ia += 1
                        j += 1
                        curp = np_
                        c += 1
                    chains.append((i, j, rev, p, curp))
                i += c
            if not chains:
                return 0
            if len(chains) == 1:
                b, e, *_ = chains[0]
                return e - b + 1
            li = max(range(len(chains)),
                     key=lambda x: chains[x][1] - chains[x][0])
            lb, le, lrev, lpb, lpe = chains[li]
            total = le - lb + 1

            def end_of(idx):  # active END scalar
                return next(iter(hash_pos[int(hs[idx])].items()))[1][1]

            for x, (b, e, rev, pb, pe) in enumerate(chains):
                if x == li or rev != lrev:
                    continue
                first, second = ((chains[li], chains[x]) if li < x
                                 else (chains[x], chains[li]))
                f_b, f_e, _, f_pb, f_pe = first
                s_b, s_e, _, s_pb, s_pe = second
                # isColinearFromMinichains (mgsr.cpp:5312-5388): qgap between
                # chain1's query end and chain2's query begin; rgap degapped
                # via getLocalGap between the facing reference endpoints
                qgap = abs(int(rd.qbeg[s_b]) - int(rd.qend[f_e]))
                if not rev:
                    rgap = gap.local_gap(s_pb, end_of(f_e))
                    ok = f_pb < s_pb and abs(qgap - rgap) < maximum_gap
                else:
                    # reverse chains: chain2 sits left of chain1 on the ref;
                    # gap spans END(chain2's first seedmer)..BEG(chain1's
                    # last); ordering compares the chains' leftmost BEGs
                    rgap = gap.local_gap(f_pe, end_of(s_b))
                    ok = s_pe < f_pe and abs(qgap - rgap) < maximum_gap
                if ok:
                    total += e - b + 1
            return total

        def touched_reads(rows):
            touched = set()
            for r in rows:
                h = int(midx.seed_hash[midx.delta_seed[r]])
                ri = self.occ_read.get(h)
                if ri is not None:
                    touched.update(ri.tolist())
            return touched

        stack = [(0, False, None)]
        while stack:
            node, done, gundo = stack.pop()
            rows = self.rows_per_node[node]
            if done:
                for r in reversed(rows):
                    apply_row(r, -1)
                gap.leave(gundo)
                # scores are cached per read, so ascending must restore the
                # parent's values for reads this node perturbed
                for ridx in touched_reads(rows):
                    score[ridx] = chain_score(self.reads[ridx])
                continue
            gundo = gap.enter(node)
            touched = set()
            for r in rows:
                apply_row(r, +1)
            touched = touched_reads(rows)
            if touched:
                tr = sorted(touched)
                for ridx in tr:
                    score[ridx] = chain_score(self.reads[ridx])
                np.maximum.at(max_score, tr, score[tr])
                if collect_node_scores:
                    node_scores[node] = [(x, int(score[x])) for x in tr]
            ci = cand_set.get(node)
            if ci is not None:
                snap[ci] = score.astype(np.uint16)
            stack.append((node, True, gundo))
            for c in reversed(self._raw_children(node)):
                stack.append((c, False, None))
        if collect_node_scores:
            return max_score, snap, node_scores
        return max_score, snap


def count_epp(node_scores: dict, max_score: np.ndarray, parent: np.ndarray,
              keep: np.ndarray, n_reads: int) -> np.ndarray:
    """Equally-parsimonious-placement counts: per read, the number of kept
    nodes at which its running score equals its max (mgsr.hpp:491-516 epp)."""
    n_nodes = len(parent)
    children: list = [[] for _ in range(n_nodes)]
    for i in range(1, n_nodes):
        children[parent[i]].append(i)
    cur = np.zeros(n_reads, dtype=np.int64)
    is_max = np.zeros(n_reads, dtype=bool)
    epp = np.zeros(n_reads, dtype=np.int64)
    stack = [(0, None)]
    while stack:
        node, back = stack.pop()
        if back is not None:
            for ridx, old_sc, old_m in reversed(back):
                cur[ridx] = old_sc
                is_max[ridx] = old_m
            continue
        backtrack = []
        for ridx, sc in node_scores.get(node, []):
            if max_score[ridx] == 0:
                continue
            backtrack.append((ridx, int(cur[ridx]), bool(is_max[ridx])))
            cur[ridx] = sc
            is_max[ridx] = sc == max_score[ridx]
        if keep[node]:
            epp[is_max] += 1
        stack.append((node, backtrack))
        for c in reversed(children[node]):
            stack.append((c, None))
    return epp


def write_read_scores_tsv(path: str, reads: list, dup_index: list,
                          max_score: np.ndarray, epp: np.ndarray,
                          overmax=None, append: bool = False,
                          index_base: int = 0):
    """<out>.read_scores_info.*.tsv (main.cpp:446-470 writeMetaReadScores).
    append/index_base support per-batch streaming."""
    with open(path, "a" if append else "w") as fh:
        if not append:
            fh.write("ReadIndex\tNumDuplicates\tTotalScore\tMaxScore"
                     "\tNumMaxScoreNodes\t")
            if overmax is not None:
                fh.write("OvermaximumTaxonNumber\t")
            fh.write("RawReadsIndices\n")
        for i, rd in enumerate(reads):
            if max_score[i] == 0:
                continue
            fh.write(f"{index_base + i}\t{len(dup_index[i])}\t{len(rd.hashes)}"
                     f"\t{max_score[i]}\t{epp[i]}\t")
            if overmax is not None:
                fh.write(f"{int(overmax[i])}\t")
            fh.write(",".join(map(str, dup_index[i])) + "\n")


# ----------------------------------------------------------------------
# SQUAREM EM (mgsr.cpp:4341-4443, squareEM ctor :7988-8201)
# ----------------------------------------------------------------------
@dataclass
class EMResult:
    node_names: list  # representative per column
    props: np.ndarray
    identical_groups: dict  # representative -> [other node names]
    n_iterations: int = 0  # SQUAREM steps across rounds (each = 2 EM steps)


def run_squarem(score_matrix, read_lens: np.ndarray,
                read_weights: np.ndarray, node_names: list,
                eta: float = 1e-5, max_change_threshold: float = 0.0,
                max_iterations: int = 1000, max_rounds: int = 5,
                backend: str = "numpy") -> EMResult:
    """The numpy float64 SQUAREM (reference precision).  score_matrix:
    [nodes, reads] u16 (numpy); read_lens m_j; weights = duplicate counts.
    The f32 device EM and the routing between the two by matrix size (the
    JAX package's backend="auto") are meta/em.py's: this function is what
    that router and --em-f64 call with backend="numpy"."""
    if backend != "numpy":
        raise ValueError(f"meta.engine.run_squarem is the numpy f64 EM "
                         f"(backend {backend!r}): route through "
                         f"meta/em.py::run_squarem")
    # collapse identical score vectors into groups
    uniq_cols: dict = {}
    identical_groups: dict = defaultdict(list)
    reps = []
    keep_rows = []
    for i, name in enumerate(node_names):
        key = score_matrix[i].tobytes()
        if key in uniq_cols:
            identical_groups[uniq_cols[key]].append(name)
        else:
            uniq_cols[key] = name
            reps.append(name)
            keep_rows.append(i)
    Su = score_matrix[keep_rows]  # [M, R] u16
    M, R = Su.shape
    w = read_weights.astype(np.float64)
    names = list(reps)

    S = Su.astype(np.float64)  # [M, R]
    probs = (ERROR_RATE ** (read_lens[None, :] - S)) * ((1 - ERROR_RATE) ** S)
    probs = probs.T  # [R, M]

    def em_step(p):
        denoms = probs @ p
        inv = np.where(denoms > 0, 1.0 / denoms, 0.0)
        out = (w[:, None] * probs * p[None, :] * inv[:, None]).sum(axis=0)
        return out / w.sum()

    def normalize(p):
        p = np.where(p <= 0, 1e-12, p)
        return p / p.sum()

    def llh(p):
        v = probs @ p
        return float((w * np.log(np.where(v > 0, v, 1e-300))).sum())

    def run_once():
        m = probs.shape[1]
        p = np.full(m, 1.0 / m)
        cur_llh = -np.inf
        for _ in range(max_iterations):
            p0 = p
            p1 = normalize(em_step(p0))
            p2 = normalize(em_step(p1))
            r = p1 - p0
            v = (p2 - p1) - r
            vn = np.linalg.norm(v)
            alpha = -np.linalg.norm(r) / vn if vn > 0 else -1.0
            psq = normalize(p0 - 2.0 * alpha * r + alpha * alpha * v)
            l2 = llh(p2)
            lsq = llh(psq)
            if lsq > l2 - eta:
                p = psq
                diff = lsq - cur_llh
                cur_llh = lsq
            else:
                p = p2
                diff = l2 - cur_llh
                cur_llh = l2
            if max_change_threshold == 0:
                if abs(diff) < eta:
                    break
            elif np.abs(p - p0).max() < max_change_threshold:
                break
        return p

    p = np.full(probs.shape[1], 1.0 / probs.shape[1])
    for _round in range(max_rounds):
        p = run_once()
        passed = p >= PROP_THRESHOLD_TO_REMOVE
        if passed.all():
            break
        probs = probs[:, passed]
        names = [nm for nm, ok in zip(names, passed) if ok]
        if probs.shape[1] == 0:
            break
        # the reference resets to uniform and re-runs in the next round
        p = np.full(probs.shape[1], 1.0 / probs.shape[1])
    return EMResult(node_names=names, props=p,
                    identical_groups=dict(identical_groups))
