"""Placement queries on the device: TorchPlacer, the twin of
panmap_tpu/place/query_tpu.py::TpuPlacer.

**place_exact** (the CLI's path): the device scores every node in f32 from
the query's found index rows (the sparse CSC program; the blocked full row
stream when the query touches more than RCAP_MAX rows), selects a widened
candidate superset per metric, and the host replays the candidates'
root->node paths in f64 (engine.rescore_paths) under measured-error guards.
When every guard holds the result equals engine.score_nodes exactly;
otherwise place_exact returns None and the caller runs the f64 host engine.
Carried over unchanged: the selection rule (tol = max(best*1e-4, 1e-9),
cutoff best - (2*tol + 1e-5)), WITNESS_J, GUARD_FACTOR and every guard of
the host rescue.

**The all-device query** (place, place_best; query_tpu.py:108-414): the
reads are encoded and 2-bit packed on the host, unpacked and sketched on the
device (sketch/tpu.py: hashes as int64 bit patterns), every k-min-mer slot
sorted, run lengths counted by a reversed cummin, homopolymers removed, the
auto min-read-support and the log statistics taken, the kept distinct seeds
compacted into MAXU slots and joined to the index, then every index row
scored (_score_rows).  **The join** is an int64 searchsorted of the
sign-flipped keys (sketch.tpu.u64_key) in the index's sorted unique hashes,
where the JAX package probes a two-table cuckoo hash (build_cuckoo_table):
the key table is unique_hashes itself, so there is no host build and no
rebuild on a collision, and one searchsorted over 2^18 queries is cheap on
a GPU; both find exactly the hashes equal to a read seed, so the found set
is the same.  The JAX package's sparse N-mask upload (MAXN) shrank a
transfer over a remote link; here the dense mask goes up, with the same
result.

**The hybrid and batched queries** (place_best_host[_async],
place_best_host_batch, score_batch_dispatch; query_tpu.py:575-756): the
native host sketch, count and join (sketch_host), then device scoring with
the exact best/tie rule of query_tpu.py:519-528 (exact_ties, not the
widened rule); a batch of B samples is scored in one row-stream pass
(metrics.batched_prefix_acc).  The candidate and tie masks come back as
bools (the JAX package bit-packs them to shrink a remote fetch).  Eager
torch has no compile cache, so the JAX package's program factories
(_make_finalize_score, _make_select_fn, _batch_score_fn,
_make_host_score_fn) are plain methods here: _finalize_score,
_batch_score_fn, _full_stream_scores, with exact_ties as the selection.

Under a mesh (--mesh; parallel/mesh.py) there is no sparse program and no
batched one, as in the JAX package (its CscIndex and BlockSegments are None
there): the rows are scored per shard, the partials reduced over the mesh
(parallel.mesh.sharded_score), and place_best_host_batch places sample by
sample.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from ..index.builder import IndexArrays
from ..native import join_u64_native, sketch_count_native
from ..parallel.mesh import sharded_score
from ..sketch.tpu import (
    SENTINEL,
    encode_reads_batch,
    kminmer_batch,
    pack_reads_2bit,
    syncmer_scan_batch,
    u64_key,
    unpack_reads_2bit,
)
from . import metrics as tm
from .engine import METRICS, PlacementScores, homopolymer_hashes, rescore_paths
from .engine_torch import prepare_device_index


def widened_candidates(scores, eligible):
    """Candidate superset per metric: every eligible node within the exact
    tie tolerance plus an f32 error budget of the best (twin of the
    selection in query_tpu.py:534-539).  Returns (cand bool[N,5], best[5],
    col[N,5] with -inf at ineligible nodes)."""
    col = torch.where(eligible[:, None], scores, -torch.inf)
    best = col.max(dim=0).values
    tol = (best * 1e-4).clamp_min(1e-9)
    cutoff = best - (2.0 * tol + 1e-5)
    cand = (col >= cutoff) & (col > -1e-5)
    return cand, best, col


def exact_ties(scores, eligible):
    """Best score and tie set per metric with the exact rule of
    placement.cpp:355-401 (query_tpu.py:372-378, 519-528, 598-603):
    tol = max(best*1e-4, 1e-9), tied = (col >= best - tol) & (col > 0).
    ``scores`` [N,5] or [N,B,5] (a batch); returns (best [5] or [B,5],
    tied bool shaped like scores)."""
    shape = (-1,) + (1,) * (scores.dim() - 1)
    col = torch.where(eligible.view(shape), scores, -torch.inf)
    best = col.max(dim=0).values
    tol = (best * 1e-4).clamp_min(1e-9)
    tied = (col >= best - tol) & (col > 0)
    return best, tied


def placement_scores(best: np.ndarray, tied: np.ndarray) -> PlacementScores:
    """PlacementScores with the best/tie fields (and an empty score matrix)
    from one query's best [5] and tie mask [N,5]."""
    res = PlacementScores(scores=np.zeros((0, 5)))
    for m, name in enumerate(METRICS):
        b = float(best[m])
        idxs = np.flatnonzero(tied[:, m])
        res.best_score[name] = b if np.isfinite(b) else 0.0
        res.tied_indices[name] = idxs.tolist()
        res.best_index[name] = int(idxs[0]) if len(idxs) else None
    return res


class TorchPlacer:
    """Device index tensors for repeated placement queries."""

    # expanded-row capacity ceiling for the sparse found-rows scoring path;
    # queries touching more index rows fall back to the blocked full stream
    RCAP_MAX = 1 << 20
    # closure witnesses rescored in f64 per metric, and the safety factor the
    # evasion gap must clear over the largest observed f32 error (see
    # place_exact)
    WITNESS_J = 16
    GUARD_FACTOR = 8.0
    # compacted read-seed slots of the all-device query (>= distinct seeds
    # in any sample)
    MAXU = 1 << 18

    def __init__(self, idx: IndexArrays, device, dev=None, mesh=None,
                 pad_len: int = 160, batch: int = 16384):
        """``dev``: an already prepared DeviceIndex (e.g. from
        convert.device_index); built from ``idx`` otherwise.  ``mesh``: a
        parallel.mesh.Mesh whose first device is ``device``; the index rows
        shard over it (twin of TpuPlacer(mesh=...)).  ``pad_len`` (rounded
        up to a multiple of 8, for the 2-bit packing) and ``batch``: the
        read length and the reads per chunk of the device sketch."""
        self.idx = idx
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None and mesh.devices[0] != self.device:
            raise ValueError(f"the mesh's partials reduce on "
                             f"{mesh.devices[0]}, not on {self.device}")
        self.params = idx.params
        self.pad_len = ((pad_len + 7) // 8) * 8
        self.batch = batch
        self.hp = np.array(homopolymer_hashes(self.params.k), dtype=np.uint64)
        self._elig = None
        self._keys = None
        with trace.span("place.upload", rows=len(idx.seed_hashes)):
            self.dev = dev if dev is not None else prepare_device_index(
                idx, self.device, mesh)
            self._ensure_elig()

    def _ensure_elig(self):
        """(all nodes, leaves only) eligibility masks on the device."""
        if self._elig is None:
            n = self.dev.n_nodes
            is_parent = np.zeros(n, dtype=bool)
            is_parent[self.idx.parent_index[1:]] = True
            self._elig = (torch.ones(n, dtype=torch.bool, device=self.device),
                          torch.from_numpy(~is_parent).to(self.device))
        return self._elig

    def _join_keys(self):
        """(the index's sorted unique hashes, the homopolymer hashes) as
        u64_key int64 tensors on the device, made at the first device
        query."""
        if self._keys is None:
            U = np.ascontiguousarray(self.dev.unique_hashes, np.uint64)
            self._keys = tuple(
                u64_key(torch.from_numpy(x.view(np.int64)).to(self.device))
                for x in (U, self.hp))
        return self._keys

    # ---- the all-device query ----------------------------------------

    def sketch_device(self, seqs: list):
        """The reads' k-min-mers on the device, ``batch`` reads a chunk:
        (km int64, valid bool), flat over every chunk's [reads, slots]
        (invalid slots carry -1).  The dense N mask goes up with the 2-bit
        reads (see the module docstring); a short last chunk is not
        padded."""
        p = self.params
        d, L = self.device, self.pad_len
        kms, vals = [], []
        for off in range(0, len(seqs), self.batch):
            reads, lens = encode_reads_batch(seqs[off : off + self.batch],
                                             pad_to=L)
            packed, nmask = pack_reads_2bit(reads)
            codes = unpack_reads_2bit(torch.from_numpy(packed).to(d),
                                      torch.from_numpy(nmask).to(d), L)
            h, is_sync = syncmer_scan_batch(
                codes, torch.from_numpy(lens).to(d), p.k, p.s, p.t, p.open)
            km, valid = kminmer_batch(h, is_sync, p.k, p.l)
            kms.append(km.reshape(-1))
            vals.append(valid.reshape(-1))
        if not kms:
            return (torch.empty(0, dtype=torch.int64, device=d),
                    torch.empty(0, dtype=torch.bool, device=d))
        return torch.cat(kms), torch.cat(vals)

    def _finalize_stats(self, skey, min_support_cfg: float):
        """Over the sorted u64_key seeds of every slot: run-length counts,
        homopolymer removal, the auto min-read-support
        (placement.cpp:931-955), the log-count statistics, and the join of
        the kept distinct seeds against the index (twin of
        TpuPlacer._finalize_stats).  Invalid slots carry the all-ones
        sentinel, so they form one trailing run and a run's count is its
        length (a genuine all-ones seed hash, p ~ 2^-64, would be dropped).
        The kept seeds are compacted into MAXU slots before the join.
        Returns (uid_logc f32[NU] with > 0 marking a found and kept seed,
        log_mag, nuniq, lden) as 0-d tensors."""
        U, hp = self._join_keys()
        MAXU, nU = self.MAXU, U.shape[0]
        n, d = skey.shape[0], skey.device
        iota = torch.arange(n, device=d)
        first = torch.ones(n, dtype=torch.bool, device=d)
        first[1:] = skey[1:] != skey[:-1]
        # run length without a scatter: the next run start per position by
        # a reversed cummin; the count at a run start is nxt - iota
        cand = torch.where(first, iota, n)
        nxt = torch.cat([torch.cummin(cand[1:].flip(0), 0).values.flip(0),
                         torch.full((1,), n, device=d)])
        is_seed = first & (skey != u64_key(SENTINEL)) & ~torch.isin(skey, hp)
        counts = torch.where(is_seed, (nxt - iota).to(torch.float32), 0.0)

        multi = is_seed & (counts >= 2)
        msum = torch.where(multi, counts, 0.0).sum()
        mcnt = multi.sum()
        est = torch.where(mcnt > 0, msum / mcnt.clamp_min(1), 0.0)
        if min_support_cfg < 0:
            ms = torch.where(est > 3.0, 2.0, 1.0)
        else:
            ms = float(min_support_cfg)
        keep = is_seed & (counts >= ms)

        logc = torch.where(keep, torch.log1p(counts), 0.0)
        log_mag = torch.sqrt((logc * logc).sum())
        lden = logc.sum()
        nuniq = keep.sum()

        # compaction: kept run i -> slot i; the rest (and any kept run past
        # MAXU, which _check_capacity refuses) -> the dump slot MAXU
        slot = torch.where(keep, torch.cumsum(keep, 0) - 1, MAXU).clamp_max(
            MAXU)
        rq = torch.full((MAXU + 1,), u64_key(SENTINEL), dtype=torch.int64,
                        device=d)
        rq_lc = torch.zeros(MAXU + 1, dtype=torch.float32, device=d)
        rq[slot] = skey
        rq_lc[slot] = logc
        rq, rq_lc = rq[:MAXU], rq_lc[:MAXU]
        rq_ok = torch.arange(MAXU, device=d) < nuniq
        pos = torch.searchsorted(U, rq).clamp_max(nU - 1)
        hit = (U[pos] == rq) & rq_ok
        # misses go to the dump slot nU (distinct kept seeds: distinct uids)
        uid_logc = torch.zeros(nU + 1, dtype=torch.float32, device=d)
        uid_logc[torch.where(hit, pos, nU)] = rq_lc
        return uid_logc[:nU], log_mag, nuniq, lden

    def _score_rows(self, uid_logc):
        """Row-delta accumulation + Euler-tour prefix over every index row
        from a dense per-uid log-count table (twin of
        TpuPlacer._score_rows): (acc [N,6], wc_den f32 from the root rows).
        uid_logc > 0 exactly marks the found and kept seeds (log1p of a
        count >= 1), so one gather gives value and flag.  Under a mesh the
        shards join the table's nonzero entries
        (parallel.mesh.sharded_score)."""
        d = self.dev
        if d.shards is not None:
            ids = torch.nonzero(uid_logc > 0).squeeze(1)
            acc = sharded_score(self.mesh, d.shards, d.euler_in, d.euler_out,
                                ids, uid_logc[ids], d.n_nodes)
            rid = torch.from_numpy(d.root_rid_np.astype(np.int64)).to(
                self.device)
            lrc_root = uid_logc[rid]
            wc_den = tm.wc_denominator_torch(
                lrc_root, torch.from_numpy(d.root_child_np).to(self.device),
                lrc_root > 0)
            return acc, wc_den
        a, b = d.root_rows
        lrc_root = uid_logc[d.row_id[a:b]]
        wc_den = tm.wc_denominator_torch(lrc_root, d.row_child[a:b],
                                         lrc_root > 0)
        lrc = uid_logc[d.row_id]
        node_sums = tm.row_node_sums_blocked(lrc, d.row_parent, d.row_child,
                                             lrc > 0, d.blk, d.n_nodes)
        return tm.euler_prefix(node_sums, d.euler_in, d.euler_out,
                               d.n_nodes), wc_den

    _score_by_table = _score_rows  # TpuPlacer's name for the same program

    def _finalize_score(self, km, min_read_support: int):
        """Sort of every k-min-mer slot (u64 order), _finalize_stats, then
        _score_rows (TpuPlacer._make_finalize_score's program): (acc,
        wc_den, log_mag, nuniq, lden) on the device."""
        skey = torch.sort(u64_key(km)).values
        uid_logc, log_mag, nuniq, lden = self._finalize_stats(
            skey, float(min_read_support))
        acc, wc_den = self._score_rows(uid_logc)
        return acc, wc_den, log_mag, nuniq, lden

    def _check_capacity(self, nuniq):
        if int(nuniq) > self.MAXU:
            raise RuntimeError(
                f"distinct read seeds ({int(nuniq)}) exceed the device "
                f"compaction capacity ({self.MAXU}); use the host engine")

    def place(self, seqs: list, min_read_support: int = -1):
        """All-device placement: scores [N,5] in METRICS order, finalized on
        the host in f64 from the device's f32 accumulator."""
        km, _ = self.sketch_device(seqs)
        acc, wc_den, log_mag, nuniq, lden = self._finalize_score(
            km, min_read_support)
        self._check_capacity(nuniq)
        self._last_wc_den = float(wc_den)
        return self._finish_scores(acc.cpu().numpy(), float(log_mag),
                                   int(nuniq), float(lden))

    def _finish_scores(self, acc, log_mag, read_unique, logcont_den):
        wc_den = getattr(self, "_last_wc_den", 0.0)
        return tm.finalize_scores(np, acc.astype(np.float64), log_mag,
                                  read_unique, logcont_den, wc_den)

    def place_best(self, seqs: list, min_read_support: int = -1,
                   force_leaf: bool = False):
        """All-device placement with the best/tie selection on the device:
        a PlacementScores with the best/tie fields filled and an empty
        score matrix (place() gives the per-node scores)."""
        elig_all, elig_leaf = self._ensure_elig()
        km, _ = self.sketch_device(seqs)
        acc, wc_den, log_mag, nuniq, lden = self._finalize_score(
            km, min_read_support)
        scores = tm.finalize_scores_torch(acc, log_mag, nuniq, lden, wc_den)
        best, tied = exact_ties(scores, elig_leaf if force_leaf else elig_all)
        self._check_capacity(nuniq)
        return placement_scores(best.cpu().numpy(), tied.cpu().numpy())

    # ---- the hybrid query: host sketch, device scoring ---------------

    def sketch_host(self, seqs: list, min_read_support: int = -1):
        """Host-side native sketch+count+join: returns (uids, logc, log_mag,
        nuniq, lden) over found+kept read seeds, or None when the native
        library is unavailable.  The filtering of the device finalize
        (_finalize_stats), in numpy on the native sketch's (H, C)."""
        p = self.params
        out = sketch_count_native(seqs, p.k, p.s, p.t, p.open, p.l)
        if out is None:
            return None
        H, C = out
        if len(H) == 0:
            return (np.empty(0, np.int32), np.empty(0, np.float32), 0.0, 0,
                    0.0)
        if len(self.hp):
            m = np.ones(len(H), dtype=bool)
            for h in self.hp:
                m &= H != h
            H, C = H[m], C[m]
        multi = C >= 2
        est = (C[multi].mean() if multi.any() else 0.0)
        auto_ms = 2.0 if est > 3.0 else 1.0
        ms = auto_ms if min_read_support < 0 else float(min_read_support)
        keep = C >= ms
        H, C = H[keep], C[keep]
        logc = np.log1p(C.astype(np.float32))
        log_mag = float(np.sqrt(np.float32(logc @ logc)))
        lden = float(np.sum(logc, dtype=np.float32))
        nuniq = int(len(H))
        U = self.dev.unique_hashes
        j = join_u64_native(H, U)
        if j is not None:
            posc, found = j
        else:
            pos = np.searchsorted(U, H)
            posc = np.minimum(pos, max(len(U) - 1, 0)).astype(np.int32)
            found = (len(U) > 0) & (U[posc] == H)
        return (posc[found], logc[found], log_mag, nuniq, lden)

    def place_best_host(self, seqs: list, min_read_support: int = -1,
                        force_leaf: bool = False):
        """Hybrid path: native host sketch+count+join, device row scoring +
        the exact selection; the same results as place_best."""
        return self.place_best_host_async(seqs, min_read_support,
                                          force_leaf)()

    def place_best_host_async(self, seqs: list, min_read_support: int = -1,
                              force_leaf: bool = False):
        """place_best_host with the device work enqueued: the host sketch
        runs now, and the returned zero-arg resolver waits on the device.
        Without the native library (sketch_host None) this is place_best,
        as in the JAX package."""
        sk = self.sketch_host(seqs, min_read_support)
        if sk is None:
            res = self.place_best(seqs, min_read_support, force_leaf)
            return lambda: res
        uids, lc, log_mag, nuniq, lden = sk
        elig_all, elig_leaf = self._ensure_elig()
        srt = np.argsort(uids, kind="stable")
        elig = elig_leaf if force_leaf else elig_all
        out = self._score_sparse_dispatch(uids[srt], lc[srt], log_mag, nuniq,
                                          lden, elig)
        if out is None:
            out = exact_ties(self._full_stream_scores(uids, lc, log_mag,
                                                      nuniq, lden), elig)
        best, tied = out

        def resolve():
            return placement_scores(best.cpu().numpy(), tied.cpu().numpy())

        return resolve

    # ---- B queries in one row-stream pass ------------------------------

    def _batch_score_fn(self, pu, pl, stats, eligible):
        """The B-query batched program (metrics.batched_prefix_acc): one
        row-stream pass scores B queries; (best [B,5], tied [N,B,5]).
        ``pu`` int64 [B, F] / ``pl`` f32 [B, F]: each query's found uids and
        log counts, padded with the uid NU and 0 (the dropped column);
        ``stats`` f32 [4, B]: log_mag, nuniq, lden, wc_den."""
        d = self.dev
        nu = len(d.unique_hashes)
        tab = torch.zeros((pu.shape[0], nu + 1), dtype=torch.float32,
                          device=self.device)
        tab.scatter_(1, pu, pl)
        acc = tm.batched_prefix_acc(tab[:, :nu].t().contiguous(), d.row_id,
                                    d.row_parent, d.row_child, d.blk,
                                    d.euler_in, d.euler_out, d.n_nodes,
                                    d.csc.mag_prefix)
        scores = tm.finalize_scores_batch_torch(acc, *stats)
        return exact_ties(scores, eligible)

    def place_best_host_batch(self, samples, min_read_support: int = -1,
                              force_leaf: bool = False):
        """Score B samples' read sets in one device pass.  ``samples`` is a
        list of read-sequence lists; returns a list of PlacementScores
        (best/tie fields, like place_best_host).  Places sample by sample
        when the native sketcher is unavailable or under a mesh (no blocked
        structure), as the JAX package does."""
        if self.dev.blk is None or self.dev.csc is None:
            return [self.place_best_host(s, min_read_support, force_leaf)
                    for s in samples]
        sks = [self.sketch_host(s, min_read_support) for s in samples]
        if any(sk is None for sk in sks):
            return [self.place_best_host(s, min_read_support, force_leaf)
                    for s in samples]
        return self.score_batch_dispatch(sks, force_leaf)()

    def score_batch_dispatch(self, sks, force_leaf: bool = False):
        """Enqueue the batched program over B host sketches
        [(uids, logc, log_mag, nuniq, lden), ...]; returns a zero-arg
        finisher producing the list of PlacementScores."""
        elig_all, elig_leaf = self._ensure_elig()
        Bq = len(sks)
        fcap = max(max(len(sk[0]) for sk in sks), 1)
        nu = len(self.dev.unique_hashes)
        pu = np.full((Bq, fcap), nu, np.int64)
        pl = np.zeros((Bq, fcap), np.float32)
        stats = np.zeros((4, Bq), np.float32)
        for b, (uids, lc, log_mag, nuniq, lden) in enumerate(sks):
            pu[b, : len(uids)] = uids
            pl[b, : len(uids)] = lc
            stats[0, b] = log_mag
            stats[1, b] = nuniq
            stats[2, b] = lden
            stats[3, b] = self._wc_den_host(np.sort(uids))
        d = self.device
        best, tied = self._batch_score_fn(
            torch.from_numpy(pu).to(d), torch.from_numpy(pl).to(d),
            torch.from_numpy(stats).to(d),
            elig_leaf if force_leaf else elig_all)

        def resolve():
            b_, t_ = best.cpu().numpy(), tied.cpu().numpy()
            return [placement_scores(b_[b], t_[:, b]) for b in range(Bq)]

        return resolve

    # ---- device scoring of a host read table ---------------------------

    def _wc_den_host(self, uids):
        """f64 weighted-containment denominator from the compact sorted
        found-uid table (root-row replay on the host, sequential
        accumulation order like placement.cpp:1861-1876)."""
        dev = self.dev
        rid = dev.root_rid_np
        if rid is None or len(rid) == 0:
            return 0.0
        if len(uids):
            pos = np.searchsorted(uids, rid)
            posc = np.minimum(pos, len(uids) - 1)
            found = uids[posc] == rid
        else:
            found = np.zeros(len(rid), dtype=bool)
        return float(tm.wc_denominator(np, np.zeros(len(rid)),
                                       dev.root_child_np, found))

    def _score_sparse_dispatch(self, uids, logc, log_mag, nuniq, lden, elig,
                               widened=False, wc_den=None):
        """Enqueue the sparse found-rows program (metrics.sparse_prefix_acc
        + finalize) over the sorted found uids and its selection: exact_ties
        (best, tied), or widened_candidates (cand, best, col) with
        ``widened``.  None under a mesh or when the query touches more than
        RCAP_MAX rows (the caller then runs the full row stream).  wc_den
        defaults to the f64 host denominator.  Shapes are the query's own:
        eager torch has no compile cache to bucket for."""
        csc = self.dev.csc
        if csc is None:
            return None
        F = tm.query_found_rows(csc, uids)
        if F > self.RCAP_MAX:
            return None
        nu = len(self.dev.unique_hashes)
        fcap = max(len(uids), 1)
        pu = np.full(fcap, nu, np.int64)  # sentinel: empty CSC range
        pu[: len(uids)] = uids
        pl = np.zeros(fcap, np.float32)
        pl[: len(uids)] = logc
        if wc_den is None:
            wc_den = self._wc_den_host(uids)
        d = self.device
        acc = tm.sparse_prefix_acc(torch.from_numpy(pu).to(d),
                                   torch.from_numpy(pl).to(d), csc,
                                   self.dev.euler_in, self.dev.euler_out,
                                   self.dev.n_nodes, max(F, 1))
        scores = tm.finalize_scores_torch(acc, np.float32(log_mag),
                                          np.int32(nuniq), np.float32(lden),
                                          np.float32(wc_den))
        return (widened_candidates if widened else exact_ties)(scores, elig)

    def _full_stream_scores(self, uids, logc, log_mag, nuniq, lden):
        """f32 scores [N,5] from the full row stream (twin of the
        host-table programs of query_tpu.py:678-696, 758-787): the found
        uids' log counts scattered into a dense per-uid table, _score_rows,
        finalize; wc_den from the root rows in f32."""
        uid_logc = torch.zeros(len(self.dev.unique_hashes),
                               dtype=torch.float32, device=self.device)
        uid_logc[torch.from_numpy(np.asarray(uids, np.int64)).to(
            self.device)] = torch.from_numpy(np.asarray(logc, np.float32)).to(
            self.device)
        acc, wc_den = self._score_rows(uid_logc)
        return tm.finalize_scores_torch(acc, np.float32(log_mag),
                                        np.int32(nuniq), np.float32(lden),
                                        wc_den)

    # ---- place_exact: the CLI's path -----------------------------------

    def place_exact(self, sk, force_leaf: bool = False):
        """Device scoring + widened tie selection, then the exact f64
        path-replay rescue of the candidates on the host.  The widened
        cutoff's f32-error budget is verified per query, as in
        TpuPlacer.place_exact:

        (a) the measured |f32 - f64| error at every candidate must stay
            within half the widening budget;
        (b) the top-J (J = WITNESS_J) f32 nodes outside each metric's
            candidate set are rescored in f64 and must all fall strictly
            below best - tol; with <= J excluded finite nodes the closure is
            complete and the result exact by enumeration;
        (c) otherwise the evasion gap G = (best - tol) - (lowest rescored
            witness f32) must reach max(GUARD_FACTOR * e_obs, 1e-5).

        Returns the PlacementScores that engine.score_nodes would return on
        the same sketch, or None on any suspicion (the caller then runs the
        f64 host engine)."""
        return self.place_exact_async(sk, force_leaf)()

    @trace.spanned("place.select")
    def place_exact_async(self, sk, force_leaf: bool = False):
        """Host prep + enqueue of the device selection program; returns a
        zero-arg finisher that waits on the device result and completes the
        exact f64 rescue.  Host work between the two overlaps the device."""
        elig_all, elig_leaf = self._ensure_elig()

        # f32 device read table derived from the SAME f64 sketch the exact
        # rescore uses (the join/filtering is identical by construction)
        U = self.dev.unique_hashes
        H = sk.sorted_hashes
        pos = np.searchsorted(U, H)
        posc = np.minimum(pos, max(len(U) - 1, 0)).astype(np.int64)
        found = (len(U) > 0) & (len(H) > 0) & (U[posc] == H)
        uids = posc[found]
        lc = sk.log_counts[found].astype(np.float32)

        # a metric whose f64 denominator is 0 has an identically-zero score
        # column (finalize_scores): best 0.0, no ties, no candidates needed
        offs = self.idx.node_offsets.astype(np.int64)
        ra, rb = int(offs[0]), int(offs[1])
        Hr = self.idx.seed_hashes[ra:rb]
        Cr = self.idx.child_counts[ra:rb].astype(np.float64)
        if len(sk.sorted_hashes) and rb > ra:
            ri = np.searchsorted(sk.sorted_hashes, Hr)
            ric = np.minimum(ri, len(sk.sorted_hashes) - 1)
            rfound = sk.sorted_hashes[ric] == Hr
        else:
            rfound = np.zeros(rb - ra, dtype=bool)
        wc_den64 = float(tm.wc_denominator(np, np.zeros(rb - ra), Cr,
                                           rfound)) if rb > ra else 0.0
        dens = (sk.log_read_magnitude, sk.log_read_magnitude,
                float(sk.read_unique_seed_count), wc_den64,
                sk.log_containment_denominator)
        zero_metric = [d == 0.0 for d in dens]
        elig = elig_leaf if force_leaf else elig_all
        stats = (sk.log_read_magnitude, sk.read_unique_seed_count,
                 sk.log_containment_denominator)
        out = self._score_sparse_dispatch(uids, lc, *stats, elig,
                                          widened=True, wc_den=wc_den64)
        if out is None:
            out = widened_candidates(
                self._full_stream_scores(uids, lc, *stats), elig)
        cand, _best32, col32 = out  # best32: the guards check every candidate

        def _finish():
            return self._place_exact_finish(sk, cand, col32, zero_metric)

        return _finish

    def _place_exact_finish(self, sk, cand, col32, zero_metric):
        """Back half of place_exact: device fetch + exact f64 rescue + guards
        (TpuPlacer._place_exact_finish)."""
        with trace.span("place.fetch"):
            col32 = col32.double().cpu().numpy()  # [n_nodes, 5], -inf inelig
            cand = cand.cpu().numpy().copy()
        with trace.span("place.rescue"):
            return self._rescue(sk, cand, col32, zero_metric)

    def _rescue(self, sk, cand, col32, zero_metric):
        """The exact f64 rescue of the fetched candidates and its guards
        (host numpy carried over line for line); counts the candidates and
        witnesses on the span open."""
        cand[:, zero_metric] = False  # identically-zero columns: no rescue
        union = np.flatnonzero(cand.any(axis=1))
        if len(union) > 16384:
            return None  # exactness not guaranteed: full host engine instead
        # closure witnesses: the top-J f32 nodes OUTSIDE each metric's
        # candidate set, rescored in f64 alongside the candidates
        J = self.WITNESS_J
        out_col = np.where(cand, -np.inf, col32)
        wit_m: list = []
        closure_complete = []
        for m in range(5):
            if zero_metric[m]:
                wit_m.append(np.empty(0, np.int64))
                closure_complete.append(True)
                continue
            fin = np.flatnonzero(np.isfinite(out_col[:, m]))
            closure_complete.append(len(fin) <= J)
            if len(fin) > J:
                fin = fin[np.argpartition(-out_col[fin, m], J - 1)[:J]]
            wit_m.append(fin.astype(np.int64))
        witnesses = (np.unique(np.concatenate(wit_m)) if any(
            len(w) for w in wit_m) else np.empty(0, np.int64))
        witnesses = witnesses[~np.isin(witnesses, union)]
        trace.count("candidates", len(union))
        trace.count("witnesses", len(witnesses))
        allnodes = np.concatenate([union, witnesses]).astype(np.int64)
        exact = rescore_paths(self.idx, sk, allnodes)  # f64 [len, 5]
        rank = {int(n): i for i, n in enumerate(allnodes)}

        res = PlacementScores(scores=np.zeros((0, 5)))
        nu_rows = np.arange(len(union))
        for m, name in enumerate(METRICS):
            if zero_metric[m]:
                # engine.select_best on an all-zero column: best 0.0, no ties
                res.best_score[name] = 0.0
                res.tied_indices[name] = []
                res.best_index[name] = None
                continue
            in_cand = cand[union, m]
            if not in_cand.any():
                return None  # widened f32 set empty => f64 best unknowable
            col = np.where(in_cand, exact[nu_rows, m], -np.inf)
            best = float(col.max())
            if best <= 0:
                # every candidate non-positive: the f64 max over ALL nodes may
                # sit below the f32 candidate floor — not provably exact
                return None
            tol = max(best * 1e-4, 1e-9)
            # measured error guard: the cutoff budgeted (tol + 1e-5) of f32
            # error; a candidate already eating half of it voids the budget
            err = np.abs(col32[union[in_cand], m] - exact[nu_rows[in_cand], m])
            e_obs = float(err.max())
            if e_obs > 0.5 * (tol + 1e-5):
                return None
            # closure guard: every rescored witness outside the candidate set
            # must sit strictly below the exact tie cutoff in f64
            wm = wit_m[m]
            if len(wm):
                wrows = np.fromiter((rank[int(w)] for w in wm), np.int64,
                                    len(wm))
                wex = exact[wrows, m]
                if float(wex.max()) >= best - tol:
                    return None
                e_obs = max(e_obs, float(np.abs(col32[wm, m] - wex).max()))
                if not closure_complete[m]:
                    # evasion-gap guard: an undetected true tie would need a
                    # single-node f32 error >= G
                    G = (best - tol) - float(col32[wm, m].min())
                    if G < max(self.GUARD_FACTOR * e_obs, 1e-5):
                        return None
            tied = union[(col >= best - tol) & (col > 0)]
            res.best_score[name] = best if best > -np.inf else 0.0
            res.tied_indices[name] = tied.tolist()
            res.best_index[name] = int(tied[0]) if len(tied) else None
        return res
