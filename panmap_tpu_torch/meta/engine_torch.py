"""Metagenomic read scoring over a dense presence bitmap on the GPU
(counterpart of panmap_tpu/meta/engine_tpu.py::TpuMetaScorer, B5).

A read's max-parsimony score at node n is max(fwd, rev), the number of its
seedmer occurrences whose (hash, orientation) is present at n in the same
(fwd) or the opposite (rev) orientation.  Presence-flip events
(panmap_tpu.meta.events.presence_events) densify, one node chunk at a time,
into a bitmap P[(orientation, uid), node] by a scatter-add and a prefix sum
(presence_chunk); a read block's scores over the chunk are row gathers of P
at its slotted seedmer keys summed over the slots (score_block).

The build runs as torch ops where the scorer runs: the host uploads the
index's delta rows, seed table and tree intervals and the reads'
concatenated seedmers once (meta_inputs), and the flip events
(presence_events_torch, the twin of events.presence_events), the event
order, the read key slots and the chunk carries are sorts, cumsums,
searches and scatters over them.  What TpuMetaScorer had only for the TPU
link or XLA recompiles is left out: the pow2 padding of events, bitmap
rows, read rows and slots, the chunk groups with their 3 GB cap, the
512-wide candidate tiles and col_map, and the u32 bit-packing of P (it
cut TPU HBM gather traffic; PERF.md holds the H100 profile that would
decide on it).  All of it is integer arithmetic, so every result is
bit-equal to TpuMetaScorer's and to the host scorer MetaScorer.score_all.

sketch_meta_reads_batch is the JAX package's batched read sketch for the
meta path (the device scan of sketch/tpu.py per chunk of reads, identical
seedmer lists merged on the host); no CLI path calls it, in either package.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import trace
from .events import euler_intervals
from ..sketch.tpu import (encode_reads_batch, kminmer_batch_full,
                          syncmer_scan_batch, u64_key)
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


def meta_inputs(midx, reads: list) -> dict:
    """The host arrays the scorer's build starts from, each in the dtype it
    is uploaded in: the index's delta rows (seed id, deletion flag), its
    seed table (u64 hash as int64 bits, orientation), the node offsets of
    the delta rows and each node's last preorder position under it; the
    reads' seedmer occurrences concatenated (hash bits, orientation) with
    each read's count."""
    _, euler_out = euler_intervals(midx.parent_index.astype(np.int64))
    return dict(
        delta_seed=np.asarray(midx.delta_seed, dtype=np.int32),
        delta_is_del=np.asarray(midx.delta_is_del, dtype=bool),
        seed_hash=np.asarray(midx.seed_hash, dtype=np.uint64).view(np.int64),
        seed_rev=np.asarray(midx.seed_rev, dtype=bool),
        node_offsets=np.asarray(midx.node_offsets, dtype=np.int64),
        euler_out=euler_out,
        occ_hash=(np.concatenate([r.hashes for r in reads]) if reads
                  else np.empty(0, np.uint64)).astype(
                      np.uint64, copy=False).view(np.int64),
        occ_rev=(np.concatenate([r.revs for r in reads]) if reads
                 else np.empty(0, bool)).astype(bool, copy=False),
        nseeds=np.fromiter((len(r.hashes) for r in reads), np.int64,
                           len(reads)))


def presence_events_torch(t: dict):
    """Device twin of events.presence_events over meta_inputs' tensors
    ``t``, with the read hashes the scorer keeps: those of the reads that
    the index holds.  Returns (read_hashes int64 [U], the u64 bits in
    ascending u64 order; occ_uid int64, each occurrence's index in them or
    -1; the event dict, presence_events' keys and order).

    Each delta row makes two +-1 steps of its (hash, orientation): at its
    node's preorder position and, undone, after the node's subtree.  One
    sort by (hash group, position), the group being the hash's rank among
    the index's u64 hashes, replaces the host's unique + lexsort.  A
    group's steps sum to zero in each orientation, so the plain cumsum is
    the group's own count at every step, and zero after its last; the
    state after the last step of each (group, position) run against the
    run before it gives the flips.  Order within a run does not matter:
    only run ends are read."""
    dev = t["delta_seed"].device
    idx_keys, seed_gid = torch.unique(u64_key(t["seed_hash"]),
                                      return_inverse=True)
    read_u, occ_inv = torch.unique(u64_key(t["occ_hash"]),
                                   return_inverse=True)
    if len(idx_keys):
        ii = torch.searchsorted(idx_keys, read_u).clamp_(max=len(idx_keys) - 1)
        found = idx_keys[ii] == read_u
    else:
        ii = torch.zeros_like(read_u)
        found = torch.zeros(len(read_u), dtype=torch.bool, device=dev)
    read_keys = read_u[found]
    U = len(read_keys)
    uid_of = torch.cumsum(found, 0) - 1
    occ_uid = torch.where(found, uid_of, -1)[occ_inv]
    # uid of each index hash group, -1 where no read holds it
    g_uid = torch.full((len(idx_keys),), -1, dtype=torch.int64, device=dev)
    g_uid[ii[found]] = torch.arange(U, device=dev)
    read_hashes = u64_key(read_keys)

    D = len(t["delta_seed"])
    n = len(t["node_offsets"]) - 1
    if D == 0:
        e = torch.empty(0, dtype=torch.int64, device=dev)
        i8 = e.to(torch.int8)
        return read_hashes, occ_uid, dict(
            ev_node=e, ev_uid=e, ev_rev=e.bool(), ev_delta=i8,
            den_node=e, den_delta=i8, ov_node=e, ov_delta=i8)
    row_node = torch.repeat_interleave(
        torch.arange(n, device=dev), torch.diff(t["node_offsets"]),
        output_size=D)
    sid = t["delta_seed"].long()
    gid = seed_gid[sid]
    W = n + 1  # positions run 0..n (the undo after the last subtree)
    key = torch.cat([gid * W + row_node,
                     gid * W + t["euler_out"][row_node] + 1])
    del row_node
    key, order = torch.sort(key)
    row = order % D
    rv = t["seed_rev"][sid][row]
    s = torch.where(t["delta_is_del"][row] != (order >= D), -1, 1).to(
        torch.int32)
    del order, row, sid, gid
    c_fwd = torch.cumsum(torch.where(rv, 0, s), 0, dtype=torch.int32)
    c_rev = torch.cumsum(torch.where(rv, s, 0), 0, dtype=torch.int32)
    del rv, s
    last = torch.ones(len(key), dtype=torch.bool, device=dev)
    last[:-1] = key[1:] != key[:-1]
    lk = key[last]
    lc_fwd, lc_rev = c_fwd[last], c_rev[last]
    lfwd, lrev, lany = lc_fwd > 0, lc_rev > 0, (lc_fwd + lc_rev) > 0
    del key, c_fwd, c_rev, last, lc_fwd, lc_rev
    lg = lk // W
    lp = lk - lg * W

    def prev(x):
        """The state before each run: the previous run's, absent at a
        group's first, as the last run of every group ends at zero."""
        p = torch.zeros_like(x)
        p[1:] = x[:-1]
        return p

    uid = g_uid[lg]
    rel = uid >= 0
    out = {k: [] for k in ("ev_node", "ev_uid", "ev_rev", "ev_delta")}
    for orient, cur in ((False, lfwd), (True, lrev)):
        m = (cur != prev(cur)) & rel
        node = lp[m]
        out["ev_node"].append(node)
        out["ev_uid"].append(uid[m])
        out["ev_rev"].append(torch.full_like(node, orient, dtype=torch.bool))
        out["ev_delta"].append(torch.where(cur[m], 1, -1).to(torch.int8))
    ev = {k: torch.cat(v) for k, v in out.items()}
    ma = lany != prev(lany)
    mo = ma & rel
    ev.update(den_node=lp[ma],
              den_delta=torch.where(lany[ma], 1, -1).to(torch.int8),
              ov_node=lp[mo],
              ov_delta=torch.where(lany[mo], 1, -1).to(torch.int8))
    return read_hashes, occ_uid, ev


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
    ``device``: the raw inputs are uploaded once and the event, key and
    carry tensors built there, then one loop over node chunks x read
    blocks."""

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

        devs = [self.device] if mesh is None else list(mesh.devices)

        with trace.span("meta.upload") as sp:
            # ONE copy of the raw inputs; everything else is built on the card
            host = meta_inputs(midx, reads)
            t = {k: torch.from_numpy(x).to(self.device)
                 for k, x in host.items()}
            sp.count("bytes", sum(x.nbytes for x in t.values()))

        with trace.span("meta.events") as sp:
            # only hashes that exist somewhere in the INDEX can ever flip
            # presence; error seedmers get no P row and map to the dummy row
            read_hashes, occ_uid, ev = presence_events_torch(t)
            self.read_hashes = read_hashes.cpu().numpy().view(np.uint64)
            U = len(read_hashes)
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
            # overlap coefficients: prefix sums of the any-hash (den) and the
            # any-orientation (ov) flips over the preorder positions, then
            # events.overlap_coefficients_from_events' float64 division
            den, ov = (torch.zeros(self.n_nodes + 2, dtype=torch.int64,
                                   device=self.device).index_add_(
                0, ev[f"{x}_node"], ev[f"{x}_delta"].long())
                .cumsum(0)[:self.n_nodes] for x in ("den", "ov"))
            self._oc = torch.where(
                den > 0, ov.double() / den.clamp(min=1).double(),
                0.0).cpu().numpy()
            del read_hashes, den, ov
            sp.count("read_hashes", U)
            sp.count("events", len(ev["ev_node"]))
            sp.count("steps", 2 * len(t["delta_seed"]))

        with trace.span("meta.keys"):
            # flip events sorted by preorder position, keyed by (orient, uid):
            # the key is unique within a position, so one sort of
            # (position, key) gives the stable order by position with the
            # fwd flips before the rev ones, uids ascending
            key = torch.where(ev["ev_rev"], U, 0) + ev["ev_uid"]
            pk, order = torch.sort(ev["ev_node"] * self.n_rows + key)
            self._evp_pos = pk // self.n_rows
            self._evp_key = pk - self._evp_pos * self.n_rows
            self._evp_delta = ev["ev_delta"][order].to(torch.int32)
            self.ev_pos = self._evp_pos
            del ev, key, pk, order

            # each read gets S key slots (S = its most seedmers); scoring is a
            # row gather of P plus a sum over the slot axis
            R = len(reads)
            nseeds = t["nseeds"]
            S = max(int(host["nseeds"].max()) if R else 1, 1)
            self.n_slots = S
            dummy = self.n_rows - 1  # the all-zero P row
            # a mesh's shards take equal numbers of whole read blocks, padded
            # with inert rows (every slot on the dummy row)
            rpad = R
            if mesh is not None:
                B, nd = self.READ_CHUNK, len(devs)
                nb = max(-(-R // B), 1)
                rpad = -(-nb // nd) * nd * B
            occ_rev = t["occ_rev"]
            starts = torch.cumsum(nseeds, 0) - nseeds
            flat = torch.arange(len(occ_uid), device=self.device) + (
                torch.repeat_interleave(
                    torch.arange(R, device=self.device) * S - starts, nseeds,
                    output_size=len(occ_uid)))
            keys = []
            for on_rev in (occ_rev, ~occ_rev):  # fwd slots, then rev slots
                sl = torch.full((rpad * S,), dummy, dtype=torch.int32,
                                device=self.device)
                sl[flat] = torch.where(
                    occ_uid < 0, dummy,
                    torch.where(on_rev, U + occ_uid, occ_uid)).to(torch.int32)
                keys.append(sl.view(rpad, S))
            del host, t, nseeds, occ_uid, occ_rev, starts, flat

            # per-node-chunk carry-in presence state (flips with pos < chunk
            # lo): each event added to the row of the chunk after its own,
            # then a prefix sum over the chunks
            self._chunk_lo = list(range(0, self.n_nodes + 1, C))
            self.n_chunks = len(self._chunk_lo)
            after = self._evp_pos // C + 1
            inner = after < self.n_chunks
            plane = torch.zeros(self.n_chunks * self.n_rows, dtype=torch.int32,
                                device=self.device)
            plane.index_add_(0, (after * self.n_rows + self._evp_key)[inner],
                             self._evp_delta[inner])
            self._carries = torch.cumsum(
                plane.view(self.n_chunks, self.n_rows), 0, dtype=torch.int32)
            del after, inner, plane
            self._ev_bounds = torch.searchsorted(
                self._evp_pos, torch.tensor(
                    self._chunk_lo + [self.n_nodes + 1],
                    device=self.device)).cpu().numpy()
            # scores are <= S: int16 snapshots unless a read has more seedmers
            self.snap_dtype = torch.int16 if S < (1 << 15) else torch.int32

            # a mesh's other devices get copies of the events and carries,
            # and each shard its slice of the key slots
            ev_dev = (self._evp_key, self._evp_pos, self._evp_delta,
                      self._carries)
            self._ev_on = {d: ev_dev if d == self.device
                           else tuple(x.to(d) for x in ev_dev)
                           for d in dict.fromkeys(devs)}
            if mesh is None:
                self._fwd_t, self._rev_t = keys
                self._shards = [(self.device, *keys)]
            else:
                per = rpad // len(devs)
                self._shards = [
                    (d, *(x[i * per:(i + 1) * per].to(d) for x in keys))
                    for i, d in enumerate(devs)]

    def overlap_coefficients(self) -> np.ndarray:
        """OC per dfs index as prefix sums of the presence events."""
        return self._oc.copy()

    def presence(self, ci: int, device=None) -> torch.Tensor:
        """Presence bitmap of node chunk ci on ``device`` (default: the
        scorer's): uint8 [n_rows, NODE_CHUNK]."""
        key, pos, delta, carries = self._ev_on[device or self.device]
        a, b = self._ev_bounds[ci], self._ev_bounds[ci + 1]
        return presence_chunk(carries[ci], key[a:b],
                              pos[a:b] - self._chunk_lo[ci], delta[a:b],
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
