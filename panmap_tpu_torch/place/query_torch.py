"""Placement query on the device: TorchPlacer, the twin of the place_exact
path of panmap_tpu/place/query_tpu.py::TpuPlacer (:468-573, :758-992).

The device scores every node in f32 from the query's found index rows (the
sparse CSC program; the blocked full row stream when the query touches more
than RCAP_MAX rows), selects a widened candidate superset per metric, and
the host replays the candidates' root->node paths in f64
(engine.rescore_paths) under measured-error guards.  When every guard holds
the result equals engine.score_nodes exactly; otherwise place_exact returns
None and the caller runs the f64 host engine.

Carried over unchanged from the JAX package: the selection rule
(tol = max(best*1e-4, 1e-9), cutoff best - (2*tol + 1e-5)), WITNESS_J,
GUARD_FACTOR and every guard of the host rescue.  Left out: the candidate
bit-packing (it shrank the fetch over a remote link; here the [N,5] mask
comes back as bools), the cuckoo table and device sketch, and batch
scoring.

Under a mesh (--mesh; parallel/mesh.py) there is no sparse program, as in
the JAX package (its CscIndex is None there): every query runs the full row
stream, each shard summing its own rows per node, the partials reduced over
the mesh (parallel.mesh.sharded_score), then the same selection and rescue.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.builder import IndexArrays
from . import metrics as tm
from .engine import METRICS, PlacementScores, rescore_paths
from ..parallel.mesh import sharded_score
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


class TorchPlacer:
    """Device index tensors for repeated exact placement queries."""

    # expanded-row capacity ceiling for the sparse found-rows scoring path;
    # queries touching more index rows fall back to the blocked full stream
    RCAP_MAX = 1 << 20
    # closure witnesses rescored in f64 per metric, and the safety factor the
    # evasion gap must clear over the largest observed f32 error (see
    # place_exact)
    WITNESS_J = 16
    GUARD_FACTOR = 8.0

    def __init__(self, idx: IndexArrays, device, dev=None, mesh=None):
        """``dev``: an already prepared DeviceIndex (e.g. from
        convert.device_index); built from ``idx`` otherwise.  ``mesh``: a
        parallel.mesh.Mesh whose first device is ``device``; the index rows
        shard over it (twin of TpuPlacer(mesh=...))."""
        self.idx = idx
        self.device = torch.device(device)
        self.mesh = mesh
        if mesh is not None and mesh.devices[0] != self.device:
            raise ValueError(f"the mesh's partials reduce on "
                             f"{mesh.devices[0]}, not on {self.device}")
        self.dev = dev if dev is not None else prepare_device_index(
            idx, self.device, mesh)
        self._elig = None

    def _ensure_elig(self):
        """(all nodes, leaves only) eligibility masks on the device."""
        if self._elig is None:
            n = self.dev.n_nodes
            is_parent = np.zeros(n, dtype=bool)
            is_parent[self.idx.parent_index[1:]] = True
            self._elig = (torch.ones(n, dtype=torch.bool, device=self.device),
                          torch.from_numpy(~is_parent).to(self.device))
        return self._elig

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
                               wc_den=None):
        """Enqueue the sparse found-rows program (metrics.sparse_prefix_acc
        + finalize + widened selection) and return its (cand, best, col)
        device tensors, or None under a mesh or when the query touches more
        than RCAP_MAX rows (the caller then runs the full row stream).
        Shapes are the query's own: eager torch has no compile cache to
        bucket for."""
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
        return widened_candidates(scores, elig)

    def _score_full_stream(self, uids, logc, log_mag, nuniq, lden, elig):
        """The full-row-stream fallback (twin of query_tpu.py:758-787 over
        _score_rows): every index row gathers its read log-count from a
        dense per-uid table, the blocked per-node reduction and the Euler
        prefix follow, and wc_den comes from the root rows in f32.  Under a
        mesh the rows are the shards' (parallel.mesh.sharded_score) and the
        root rows' found flags come from the host copy of their ids, as the
        shards may put the root node anywhere."""
        d = self.dev
        if d.shards is not None:
            ids = torch.from_numpy(np.asarray(uids, np.int64)).to(self.device)
            acc = sharded_score(self.mesh, d.shards, d.euler_in, d.euler_out,
                                ids, torch.from_numpy(np.asarray(
                                    logc, np.float32)).to(self.device),
                                d.n_nodes)
            found = torch.from_numpy(np.isin(d.root_rid_np, uids)).to(
                self.device)
            wc_den = tm.wc_denominator_torch(
                acc[:0, 0], torch.from_numpy(d.root_child_np).to(self.device),
                found)
            scores = tm.finalize_scores_torch(
                acc, np.float32(log_mag), np.int32(nuniq), np.float32(lden),
                wc_den)
            return widened_candidates(scores, elig)
        uid_logc = torch.zeros(len(d.unique_hashes), dtype=torch.float32,
                               device=self.device)
        uid_logc[torch.from_numpy(np.asarray(uids, np.int64)).to(
            self.device)] = torch.from_numpy(np.asarray(logc, np.float32)).to(
            self.device)
        a, b = d.root_rows
        lrc_root = uid_logc[d.row_id[a:b]]
        wc_den = tm.wc_denominator_torch(lrc_root, d.row_child[a:b], lrc_root > 0)
        lrc = uid_logc[d.row_id]
        node_sums = tm.row_node_sums_blocked(lrc, d.row_parent, d.row_child,
                                             lrc > 0, d.blk, d.n_nodes)
        acc = tm.euler_prefix(node_sums, d.euler_in, d.euler_out, d.n_nodes)
        scores = tm.finalize_scores_torch(acc, np.float32(log_mag),
                                    np.int32(nuniq), np.float32(lden), wc_den)
        return widened_candidates(scores, elig)

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
        out = self._score_sparse_dispatch(
            uids, lc, sk.log_read_magnitude, sk.read_unique_seed_count,
            sk.log_containment_denominator, elig, wc_den=wc_den64)
        if out is None:
            out = self._score_full_stream(
                uids, lc, sk.log_read_magnitude, sk.read_unique_seed_count,
                sk.log_containment_denominator, elig)
        cand, _best32, col32 = out  # best32: the guards check every candidate

        def _finish():
            return self._place_exact_finish(sk, cand, col32, zero_metric)

        return _finish

    def _place_exact_finish(self, sk, cand, col32, zero_metric):
        """Back half of place_exact: device fetch + exact f64 rescue + guards
        (host numpy carried over line for line from
        TpuPlacer._place_exact_finish)."""
        col32 = col32.double().cpu().numpy()  # [n_nodes, 5], -inf inelig
        cand = cand.cpu().numpy().copy()
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
