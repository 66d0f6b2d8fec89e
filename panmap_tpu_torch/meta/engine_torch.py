"""Metagenomic read scoring over a dense presence bitmap on the GPU
(counterpart of panmap_tpu/meta/engine_tpu.py::TpuMetaScorer, B5).

A read's max-parsimony score at node n is max(fwd, rev), the number of its
seedmer occurrences whose (hash, orientation) is present at n in the same
(fwd) or the opposite (rev) orientation.  Presence-flip events
(panmap_tpu.meta.events.presence_events) densify, one node chunk at a time,
into a bitmap P[(orientation, uid), node] by a scatter-add and a prefix sum
(presence_chunk); a read block's scores over the chunk are row gathers of P
at its slotted seedmer keys summed over the slots (score_block).

The host prep is carried over from TpuMetaScorer.__init__ (its module
imports jax at the top, so it cannot be imported here); what existed only
for the TPU link or XLA recompiles is left out: the mesh, the pow2 padding
of events, bitmap rows, read rows and slots, the chunk groups with their
3 GB cap, the 512-wide candidate tiles and col_map, and the u32
bit-packing of P (it cut
TPU HBM gather traffic; PERF.md holds the H100 profile that would decide
on it).  All device arithmetic is integer, so every result is bit-equal to
TpuMetaScorer's and to the host scorer MetaScorer.score_all.

sketch_meta_reads_batch is the JAX package's batched read sketch for the
meta path (the device scan of sketch/tpu.py per chunk of reads, identical
seedmer lists merged on the host); no CLI path calls it, in either package.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .events import (
    overlap_coefficients_from_events,
    presence_events,
)
from ..sketch.tpu import (encode_reads_batch, kminmer_batch_full,
                          syncmer_scan_batch)
from ..utils.device import as_device
from .engine import MetaRead, dust_score


def sketch_meta_reads_batch(seqs: list, k: int, s: int, t: int, l: int,
                            open_: bool, dust_threshold: float = 100.0,
                            mask_read_ends: int = 0, batch: int = 16384,
                            pad_len: int | None = None, device=None):
    """Batched twin of engine.sketch_meta_reads_full for l >= 2 (twin of
    meta/engine_tpu.py::sketch_meta_reads_batch): the syncmer / k-min-mer
    scan runs on ``device`` (None: the CUDA card) per ``batch`` reads, and
    identical reads are merged by the row bytes of their canonical (hash,
    rev, qbeg, qend) lists, in first-seen order.  Returns (reads,
    dup_index, n_dust)."""
    device = as_device(device)
    if mask_read_ends > 0:
        seqs = [x[mask_read_ends : len(x) - mask_read_ends]
                if len(x) > 2 * mask_read_ends else x for x in seqs]
    keep_idx = np.arange(len(seqs))
    n_dust = 0
    if dust_threshold < 100.0:
        ok = np.array([dust_score(x) <= dust_threshold for x in seqs])
        n_dust = int((~ok).sum())
        keep_idx = keep_idx[ok]
        seqs = [seqs[i] for i in keep_idx]
    pad = pad_len or max((len(x) for x in seqs), default=k)
    pad = max(pad, k + 1)

    lists: dict = {}
    for off in range(0, len(seqs), batch):
        chunk = seqs[off : off + batch]
        enc, lens = encode_reads_batch(chunk, pad_to=pad)
        h, is_sync = syncmer_scan_batch(torch.from_numpy(enc).to(device),
                                        torch.from_numpy(lens).to(device),
                                        k, s, t, open_)
        km, valid, rv, qb, qe = (x.cpu().numpy() for x in kminmer_batch_full(
            h, is_sync, k, l))
        H = np.where(valid, km.view(np.uint64), np.uint64(0))
        nvalid = valid.sum(axis=1)
        # canonical row key: invalid slots are zeroed and the count is part
        # of the key
        for j in range(len(chunk)):
            nv = int(nvalid[j])
            if nv == 0:
                continue
            key = (nv, H[j].tobytes(), rv[j].tobytes(), qb[j].tobytes(),
                   qe[j].tobytes())
            orig = int(keep_idx[off + j])
            ent = lists.get(key)
            if ent is None:
                m = valid[j]
                lists[key] = [MetaRead(hashes=H[j][m], revs=rv[j][m],
                                       n_dup=0,
                                       qbeg=qb[j][m].astype(np.int64),
                                       qend=qe[j][m].astype(np.int64)),
                              [orig]]
            else:
                ent[1].append(orig)
    reads = []
    dup_index = []
    for rd, members in lists.values():
        rd.n_dup = len(members)
        reads.append(rd)
        dup_index.append(members)
    return reads, dup_index, n_dust


def presence_chunk(carry: torch.Tensor, ev_key: torch.Tensor,
                   ev_col: torch.Tensor, ev_delta: torch.Tensor, n_rows: int,
                   C: int) -> torch.Tensor:
    """Presence bitmap uint8 0/1 [n_rows, C] of one node chunk: the chunk's
    flip events (row key, column in the chunk, +-1) scatter-added into an
    int32 plane, the carry-in state (int32 [n_rows], flips before the
    chunk) added at column 0, then a prefix sum along the nodes, > 0.
    Integer scatter-adds are exact in any order."""
    flat = torch.zeros(n_rows * C, dtype=torch.int32, device=carry.device)
    flat.index_add_(0, ev_key * C + ev_col, ev_delta)
    M = flat.view(n_rows, C)
    M[:, 0] += carry
    return (torch.cumsum(M, dim=1, dtype=torch.int32) > 0).view(torch.uint8)


def score_block(P: torch.Tensor, fwd_key: torch.Tensor, rev_key: torch.Tensor,
                n_valid: int | None = None):
    """Scores of a read block over a chunk: (max over the first ``n_valid``
    columns [B], sc = max(fwd, rev) [B, C]), uint8 while a read has fewer
    than 256 slots, else int32.  ``fwd_key`` / ``rev_key`` int [B, S] are
    the reads' bitmap rows per seedmer slot (empty slots point at the
    all-zero dummy row).  Materialises one orientation's gathered
    [B, S, C] uint8 at a time and sums it in its own type: a cast of it to
    int32 first took 60% of a chunk's device time (PERF.md)."""
    B, S = fwd_key.shape
    C = P.shape[1]
    acc = torch.uint8 if S < 256 else torch.int32
    fwd = P.index_select(0, fwd_key.reshape(-1)).view(B, S, C).sum(
        dim=1, dtype=acc)
    rev = P.index_select(0, rev_key.reshape(-1)).view(B, S, C).sum(
        dim=1, dtype=acc)
    sc = torch.maximum(fwd, rev)
    n = C if n_valid is None else n_valid
    return sc[:, :n].amax(dim=1), sc


class TorchMetaScorer:
    """score_all twin of MetaScorer over chunked presence bitmaps on
    ``device``: the event and key tensors are uploaded once, then one loop
    over node chunks x read blocks."""

    NODE_CHUNK = 2048
    READ_CHUNK = 4096

    def __init__(self, midx, reads: list, device, mesh=None):
        """``mesh``: a parallel.mesh.Mesh whose first device is ``device``
        (where the scores are gathered); its shards split the reads."""
        self.midx = midx
        self.reads = reads
        self.device = torch.device(device)
        self.mesh = mesh
        self.n_nodes = len(midx.node_ids)

        with trace.span("meta.events") as sp:
            all_h = (np.concatenate([r.hashes for r in reads])
                     if reads else np.empty(0, np.uint64))
            uniq_h = np.unique(all_h)
            # only hashes that exist somewhere in the INDEX can ever flip
            # presence; error seedmers get no P row and map to the dummy row
            idx_h = np.unique(np.asarray(midx.seed_hash, dtype=np.uint64))
            if len(idx_h) and len(uniq_h):
                ii = np.minimum(np.searchsorted(idx_h, uniq_h), len(idx_h) - 1)
                self.read_hashes = uniq_h[idx_h[ii] == uniq_h]
            else:
                self.read_hashes = uniq_h[:0]
            self.ev = presence_events(midx, self.read_hashes)
            U = len(self.read_hashes)
            self.U = U
            # P row layout: [fwd uid rows | rev uid rows | one zero dummy row]
            self.n_rows = 2 * U + 1
            # TpuMetaScorer's int32 rule for its flat event scatter (on its
            # pow2-padded rows): chunks stay 2,048 nodes wide unless the plane
            # would reach 2^31 cells
            C = self.NODE_CHUNK
            while C > 32 and self.n_rows * C >= (1 << 31):
                C //= 2
            self.NODE_CHUNK = C
            sp.count("read_hashes", U)
            sp.count("events", len(self.ev["ev_node"]))

        with trace.span("meta.keys"):
            # flip events sorted by preorder position, keyed by (orient, uid)
            ev = self.ev
            key = (np.where(ev["ev_rev"], U, 0)
                   + ev["ev_uid"]).astype(np.int64)
            order = np.argsort(ev["ev_node"], kind="stable")
            self._evp_pos = ev["ev_node"][order].astype(np.int64)
            self._evp_key = key[order]
            self._evp_delta = ev["ev_delta"][order].astype(np.int32)
            self.ev_pos = self._evp_pos

            # each read gets S key slots (S = its most seedmers); scoring is a
            # row gather of P plus a sum over the slot axis
            R = len(reads)
            nseeds = np.array([len(r.hashes) for r in reads], dtype=np.int64)
            if U:
                occ_pos = np.minimum(np.searchsorted(self.read_hashes, all_h),
                                     U - 1)
                occ_found = self.read_hashes[occ_pos] == all_h
            else:
                occ_pos = np.zeros(len(all_h), dtype=np.int64)
                occ_found = np.zeros(len(all_h), dtype=bool)
            occ_uid = occ_pos.astype(np.int64)
            occ_rev = (np.concatenate([np.asarray(r.revs, dtype=bool)
                                       for r in reads])
                       if reads else np.empty(0, bool))
            S = max(int(nseeds.max()) if R else 1, 1)
            self.n_slots = S
            dummy = self.n_rows - 1  # the all-zero P row
            fwd_sl = np.full((R, S), dummy, dtype=np.int32)
            rev_sl = np.full((R, S), dummy, dtype=np.int32)
            row_of = np.repeat(np.arange(R, dtype=np.int64), nseeds)
            slot_of = (np.arange(len(occ_uid), dtype=np.int64)
                       - np.repeat(np.cumsum(nseeds) - nseeds, nseeds))
            fwd_sl[row_of, slot_of] = np.where(
                ~occ_found, dummy,
                np.where(occ_rev, U + occ_uid, occ_uid))
            rev_sl[row_of, slot_of] = np.where(
                ~occ_found, dummy,
                np.where(occ_rev, occ_uid, U + occ_uid))
            self.fwd_keys = fwd_sl
            self.rev_keys = rev_sl

            # per-node-chunk carry-in presence state (flips with pos <
            # chunk lo)
            self._chunk_lo = list(range(0, self.n_nodes + 1, C))
            self._carries = []
            state = np.zeros(self.n_rows, dtype=np.int32)
            prev = 0
            for lo in self._chunk_lo:
                cut = np.searchsorted(self._evp_pos, lo)
                np.add.at(state, self._evp_key[prev:cut],
                          self._evp_delta[prev:cut])
                prev = cut
                self._carries.append(state.copy())
            self._ev_bounds = np.searchsorted(
                self._evp_pos, self._chunk_lo + [self.n_nodes + 1])
            ev_col = self._evp_pos - np.repeat(
                np.asarray(self._chunk_lo, np.int64), np.diff(self._ev_bounds))
            self.n_chunks = len(self._chunk_lo)
            # scores are <= S: int16 snapshots unless a read has more seedmers
            self.snap_dtype = torch.int16 if S < (1 << 15) else torch.int32

        with trace.span("meta.upload") as sp:
            # ONE upload of everything the chunk loop reads: the events and
            # carries to every distinct device, the reads' keys to their shard
            ev_host = (self._evp_key, ev_col, self._evp_delta,
                       np.stack(self._carries))
            devs = [self.device] if mesh is None else list(mesh.devices)
            self._ev_on = {d: tuple(torch.from_numpy(x).to(d) for x in ev_host)
                           for d in dict.fromkeys(devs)}
            if mesh is None:
                self._fwd_t = torch.from_numpy(fwd_sl).to(self.device)
                self._rev_t = torch.from_numpy(rev_sl).to(self.device)
                self._shards = [(self.device, self._fwd_t, self._rev_t)]
            else:
                # inert blocks: every slot on the all-zero dummy row
                B, nd = self.READ_CHUNK, len(devs)
                nb = max(-(-R // B), 1)
                rpad = -(-nb // nd) * nd * B
                keys = [np.concatenate([x, np.full((rpad - R, S), dummy,
                                                   np.int32)])
                        for x in (fwd_sl, rev_sl)]
                per = rpad // nd
                self._shards = [
                    (d, *(torch.from_numpy(x[i * per:(i + 1) * per]).to(d)
                          for x in keys)) for i, d in enumerate(devs)]
            sp.count("bytes", sum(t.nbytes for ts in self._ev_on.values()
                                  for t in ts)
                     + sum(t.nbytes for _, *ts in self._shards for t in ts))

    def overlap_coefficients(self) -> np.ndarray:
        """OC per dfs index as prefix sums of the presence events."""
        return overlap_coefficients_from_events(self.ev, self.n_nodes)

    def presence(self, ci: int, device=None) -> torch.Tensor:
        """Presence bitmap of node chunk ci on ``device`` (default: the
        scorer's): uint8 [n_rows, NODE_CHUNK]."""
        key, col, delta, carries = self._ev_on[device or self.device]
        a, b = self._ev_bounds[ci], self._ev_bounds[ci + 1]
        return presence_chunk(carries[ci], key[a:b], col[a:b], delta[a:b],
                              self.n_rows, self.NODE_CHUNK)

    def score_chunk(self, ci: int, ms: list, snap: list, cand: np.ndarray):
        """Fold node chunk ci into the running max ``ms`` int32 and the
        candidate snapshots ``snap`` [rows, len(cand)] of each shard's
        reads (in place; one tensor a shard, on its device)."""
        C, B = self.NODE_CHUNK, self.READ_CHUNK
        lo = self._chunk_lo[ci]
        n_valid = min(C, self.n_nodes - lo)
        if n_valid <= 0:  # the chunk at n_nodes holds no node
            return
        sel = np.flatnonzero((cand >= lo) & (cand < lo + n_valid))
        bitmap = {}
        for (dev, fwd, rev), ms_s, snap_s in zip(self._shards, ms, snap):
            if dev not in bitmap:
                bitmap[dev] = (self.presence(ci, dev),
                               torch.from_numpy(sel).to(dev),
                               torch.from_numpy(cand[sel] - lo).to(dev))
            P, sel_t, cols_t = bitmap[dev]
            for r0 in range(0, fwd.shape[0], B):
                r1 = min(r0 + B, fwd.shape[0])
                m, sc = score_block(P, fwd[r0:r1], rev[r0:r1], n_valid)
                torch.maximum(ms_s[r0:r1], m, out=ms_s[r0:r1])
                if len(sel):
                    snap_s[r0:r1, sel_t] = sc[:, cols_t].to(snap_s.dtype)

    def score_all(self, candidate_nodes: list):
        """(max_score int32 [R] on the host, snap [R, len(candidates)] on
        the scorer's device, in candidate order; int16, or int32 past
        32,767 seedmer slots)."""
        R = len(self.reads)
        cand = np.asarray(candidate_nodes, dtype=np.int64)
        ms = [torch.zeros(fwd.shape[0], dtype=torch.int32, device=dev)
              for dev, fwd, _ in self._shards]
        snap = [torch.zeros((fwd.shape[0], len(cand)), dtype=self.snap_dtype,
                            device=dev) for dev, fwd, _ in self._shards]
        for ci in range(self.n_chunks):
            self.score_chunk(ci, ms, snap, cand)
        if self.mesh is None:
            return ms[0].cpu().numpy(), snap[0]
        return (torch.cat([m.cpu() for m in ms])[:R].numpy(),
                torch.cat([s.to(self.device) for s in snap])[:R])

    def assignment_pass(self, keep: np.ndarray, eff: np.ndarray,
                        amb_thr: int = 0, amb_ratio: float = 0.0):
        """Full-matrix assignment support (the assignReadsBatch DFS in closed
        form, twin of TpuMetaScorer.assignment_pass): per read with eff > 0,
        the kept nodes scoring == eff (max-parsimony placements) and the
        nodes scoring >= eff - threshold (near-max, for taxonomy ambiguity).
        Returns (assigned_by_node, near_iter, epp, (lca_lo, lca_hi)):
        kept node -> reads, in TpuMetaScorer's insertion order (per node
        chunk, nodes by their first read, reads ascending);
        [(read, sorted near-max nodes)] by read; per read the count of kept
        max-score nodes; per read the least and greatest preorder index among
        all max-score nodes, kept or not (-1 where none).

        A read with eff == 0 has no pair, epp 0 and no LCA whatever it
        scores, so only the reads with eff > 0 are scored: their key rows are
        gathered once and the chunk x block loop runs over them.  The
        (read, node) pairs come off the card by torch.nonzero of each
        block's masks (one sync a block) and are grouped with numpy.  The
        masks are taken in the scores' own type (uint8 below 256 seedmer
        slots): eff - threshold clamped at 0 selects the same nodes, since
        scores are >= 0."""
        if self.mesh is not None:
            raise ValueError("assignment_pass runs on one device (the "
                             "filter-and-assign path takes no mesh)")
        R = len(self.reads)
        C, B, dev = self.NODE_CHUNK, self.READ_CHUNK, self.device
        eff = np.asarray(eff).astype(np.int32)
        thr = np.maximum(amb_thr, (eff * amb_ratio).astype(np.int32))
        live = np.flatnonzero(eff > 0)
        epp = np.zeros(R, dtype=np.int64)
        lca_lo = np.full(R, -1, dtype=np.int64)
        lca_hi = np.full(R, -1, dtype=np.int64)
        if not len(live):
            return {}, [], epp, (lca_lo, lca_hi)
        narrow = self.n_slots < 256 and int(eff.max()) < 256
        cmp_t = torch.uint8 if narrow else torch.int32
        eff_l, near_l = eff[live], np.maximum(eff[live] - thr[live], 0)
        live_t = torch.from_numpy(live).to(dev)
        fwd_l, rev_l = self._fwd_t[live_t], self._rev_t[live_t]
        eff_t = torch.from_numpy(eff_l).to(dev).to(cmp_t)[:, None]
        near_t = torch.from_numpy(near_l).to(dev).to(cmp_t)[:, None]
        keep_t = torch.from_numpy(np.asarray(keep, dtype=bool)).to(dev)
        L = len(live)
        far = 1 << 30
        epp_t = torch.zeros(L, dtype=torch.int64, device=dev)
        lo_t = torch.full((L,), far, dtype=torch.int64, device=dev)
        hi_t = torch.full((L,), -1, dtype=torch.int64, device=dev)
        max_pairs, near_pairs = [], []  # per chunk: [(reads, nodes) a block]
        syncs = 0  # each nonzero waits for the card to size its result
        for ci in range(self.n_chunks):
            lo = self._chunk_lo[ci]
            n_valid = min(C, self.n_nodes - lo)
            if n_valid <= 0:
                continue
            P = self.presence(ci)
            keep_c = keep_t[lo:lo + n_valid][None, :]
            iota = torch.arange(lo, lo + n_valid, device=dev)[None, :]
            mp, nr = [], []
            for r0 in range(0, L, B):
                r1 = min(r0 + B, L)
                _, sc = score_block(P, fwd_l[r0:r1], rev_l[r0:r1], n_valid)
                sc = sc[:, :n_valid]  # columns past the tree do not count
                if sc.dtype != cmp_t:  # S >= 256, or an eff past 255
                    sc = sc.to(cmp_t)
                is_max_all = sc == eff_t[r0:r1]
                is_max = is_max_all & keep_c
                near = sc >= near_t[r0:r1]
                epp_t[r0:r1] += is_max.sum(dim=1)
                lo_t[r0:r1] = torch.minimum(lo_t[r0:r1], torch.where(
                    is_max_all, iota, far).amin(dim=1))
                hi_t[r0:r1] = torch.maximum(hi_t[r0:r1], torch.where(
                    is_max_all, iota, -1).amax(dim=1))
                for mask, acc in ((is_max, mp), (near, nr)):
                    rc = torch.nonzero(mask).cpu().numpy()  # row-major
                    syncs += 1
                    acc.append((live[rc[:, 0] + r0], rc[:, 1] + lo))
            max_pairs.append(mp)
            near_pairs.append(nr)
        self.nonzero_syncs = syncs
        self.pairs_copied = sum(len(r) for ch in max_pairs + near_pairs
                                for r, _ in ch)

        # kept node -> reads: a chunk's pairs are in (read, node) order, so
        # a stable sort by node keeps each node's reads ascending
        assigned_by_node: dict = {}
        for mp in max_pairs:
            rr = np.concatenate([r for r, _ in mp])
            nn = np.concatenate([n for _, n in mp])
            if not len(nn):
                continue
            order = np.argsort(nn, kind="stable")
            starts = np.flatnonzero(np.concatenate(
                ([True], nn[order][1:] != nn[order][:-1])))
            bounds = np.append(starts, len(nn))
            # nodes in the order of their first pair
            for g in np.argsort(order[starts], kind="stable").tolist():
                a, b = bounds[g], bounds[g + 1]
                assigned_by_node[int(nn[order[a]])] = rr[order[a:b]].tolist()
        rr = np.concatenate([r for nr in near_pairs for r, _ in nr])
        nn = np.concatenate([n for nr in near_pairs for _, n in nr])
        order = np.lexsort((nn, rr))
        rr, nn = rr[order], nn[order].astype(np.int64)
        cuts = np.flatnonzero(rr[1:] != rr[:-1]) + 1
        near_iter = [(int(ns_r), ns) for ns_r, ns in zip(
            rr[np.concatenate(([0], cuts))].tolist() if len(rr) else [],
            np.split(nn, cuts))]
        epp[live] = epp_t.cpu().numpy()
        lca_hi[live] = hi_t.cpu().numpy()
        lo_h = lo_t.cpu().numpy()
        lca_lo[live] = np.where(lo_h == far, -1, lo_h)
        return assigned_by_node, near_iter, epp, (lca_lo, lca_hi)
