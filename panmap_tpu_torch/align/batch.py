"""Batched short-read alignment: the whole read set as array programs, with
the deferred full-window rows scored by the port's banded-SW kernel
(counterpart of panmap_tpu/align/batch.py).

Same semantics as align/core.py (minimap2-sr-equivalent seeding, thresholds,
verify + prefix-max soft-clip trim, DP rescue), but vectorized across the full
batch.  The host half (``batch_minimizers``, the native front end, the
columnar arrays, ``_host_dp_rows``, the numpy oracle ``_align_chunk``) is
carried over from the JAX package's BatchAligner unchanged.

The device stage is the port's: the native front end defers the reads that
need a full-window banded DP (mapped == 3); TorchBatchAligner scores those
windows with align/sw.py::banded_sw_scores, drops the rows below MIN_DP_MAX
without traceback, and runs the host DP (_host_dp_rows) for the survivors'
CIGARs.  Window padding only adds columns, so a padded score upper-bounds
the real one: the gate is exact and the outputs equal the all-host path.
Without a device (``TorchBatchAligner(ref)``, as place/refine.py builds it)
nothing is deferred and every DP runs on the host.

Not carried from the JAX stage: the Pallas route with its shape tiers, the
tunnel breakevens and the floor below which deferred windows skipped the
device (every deferred window is launched; each batch pads to its own
longest query and window), and the catch-alls that sent rows back to the
host when the device failed (a device failure raises here).
"""

from __future__ import annotations

import numpy as np
import torch

from .core import (
    Alignment,
    END_BONUS,
    KMER,
    MATCH,
    MAX_GAP,
    MIN_CHAIN_SCORE,
    MIN_CNT,
    MIN_DP_MAX,
    MISMATCH,
    WINDOW,
    Aligner,
    _hash64,
    banded_affine_dp,
    encode,
)

from ..native import get_lib
from . import sw

_RC = np.array([3, 2, 1, 0, 4], dtype=np.uint8)


def batch_minimizers(reads: np.ndarray, lens: np.ndarray, k: int = KMER,
                     w: int = WINDOW):
    """[N, L] u8 codes -> flattened minimizer anchors (read, qpos, hash, strand)."""
    N, L = reads.shape
    m = L - k + 1
    if m <= 0:
        z = np.empty(0, np.int64)
        return z, z, np.empty(0, np.uint64), np.empty(0, np.uint8)
    x = reads.astype(np.uint64)
    xr = (np.uint64(3) - np.minimum(reads, 3).astype(np.uint64))
    fwd = np.zeros((N, m), dtype=np.uint64)
    rev = np.zeros((N, m), dtype=np.uint64)
    for i in range(k):
        fwd = (fwd << np.uint64(2)) | x[:, i : i + m]
        rev |= xr[:, i : i + m] << np.uint64(2 * i)
    mask = np.uint64((1 << (2 * k)) - 1)
    fwd &= mask
    rev &= mask
    bad = (reads >= 4).astype(np.int32)
    cb = np.cumsum(bad, axis=1)
    amb = (cb[:, k - 1 :] - np.concatenate(
        [np.zeros((N, 1), np.int32), cb[:, : m - 1]], axis=1)) > 0
    in_read = (np.arange(m)[None, :] + k) <= lens[:, None]
    strand = (rev < fwd).astype(np.uint8)
    canon = np.where(strand == 1, rev, fwd)
    ok = ~amb & (fwd != rev) & in_read
    h = _hash64(canon, mask)
    BIG = np.uint64(0xFFFFFFFFFFFFFFFF)
    h = np.where(ok, h, BIG)
    if m <= w:
        jm = h.argmin(axis=1)
        sel = np.zeros((N, m), dtype=bool)
        sel[np.arange(N), jm] = h[np.arange(N), jm] != BIG
    else:
        from numpy.lib.stride_tricks import sliding_window_view

        wm = sliding_window_view(h, w, axis=1).min(axis=-1)
        nwin = wm.shape[1]
        # pad-independence: a window is real only if it lies fully within
        # the read's own k-mer positions (i + w <= lens - k + 1); windows
        # born from batch padding must not mint minimizers, else a read's
        # alignment would depend on its chunk's max length
        nvalid = (lens.astype(np.int64) - k - w + 2)[:, None]
        wm = np.where(np.arange(nwin)[None, :] < nvalid, wm, BIG)
        sel = np.zeros((N, m), dtype=bool)
        for off in range(w):
            idx = np.arange(nwin) + off
            sel[:, idx] |= h[:, idx] == wm
        sel &= h != BIG
        # reads with no full window (m_read <= w): single argmin, matching
        # core.minimizer_sketch's short-sequence branch
        short = np.flatnonzero((lens - k + 1 <= w) & (lens >= k))
        if len(short):
            jm = h[short].argmin(axis=1)
            sel[short] = False
            sel[short, jm] = h[short, jm] != BIG
    ridx, qpos = np.nonzero(sel)
    return ridx.astype(np.int64), qpos.astype(np.int64), h[ridx, qpos], strand[ridx, qpos]



def native_available() -> bool:
    """Whether the port's native host library loads (built with g++ at
    first use).  Without it the front end defers no window, so the SW
    kernel is never reached and run_alignment raises."""
    return get_lib() is not None


class TorchBatchAligner(Aligner):
    """Aligner with a vectorized batch front-end (the native C++ core; the
    numpy path below is its bit-exact oracle) whose deferred windows go to
    the banded-SW kernel on ``device`` (its plain PyTorch version for a CPU
    device; host DP only when ``device`` is None)."""

    CHUNK = 16384  # reads per vectorized pass: bounds the temporary matrices
    # (a single 102k-read pass allocated ~1.8 GB of fresh int64 planes; per-
    # chunk passes reuse the allocator's warm pages)

    use_native = True
    # rows longer than these stay on the host DP, as in the JAX package
    MAX_LQ = 512
    MAX_LW = sw.MAX_LW

    def __init__(self, ref: str, device=None, log=None,
                 stats: dict | None = None):
        """``stats``: a dict to accumulate the SW stage's counters into
        (kept as ``pallas_stats``, the JAX stage's name): deferred windows,
        device_scored, and survivors of the MIN_DP_MAX gate."""
        super().__init__(ref)
        self.device = None if device is None else torch.device(device)
        self.log = log
        self.pallas_stats = {} if stats is None else stats
        for key in ("deferred", "device_scored", "survivors"):
            self.pallas_stats.setdefault(key, 0)

    def _resolve_pallas_mode(self):
        # any true value makes the native front end defer full-window rows
        return None if self.device is None else self.device.type

    @staticmethod
    def precompute_minimizers(seqs: list, k: int = KMER, w: int = WINDOW):
        """Reference-independent phase 1 of the native aligner: per-read
        minimizer triples.  Run this while placement's device program is in
        flight (the alignment reference — the best node — is not known yet),
        then pass the handle as align_batch*(pre=...).  None without the
        native library (callers just skip the overlap)."""
        from ..native import min_sr_native

        return min_sr_native(seqs, k, w)

    def align_batch(self, seqs: list, pre: dict | None = None):
        """Returns list[Alignment] (one per read)."""
        if self.use_native:
            out = self._align_batch_native(seqs, pre)
            if out is not None:
                return out
        if len(seqs) > self.CHUNK:
            out = []
            for off in range(0, len(seqs), self.CHUNK):
                out.extend(self._align_chunk(seqs[off : off + self.CHUNK]))
            return out
        return self._align_chunk(seqs)

    _CIG_OPS = "MIDNSHP=X"

    def _align_batch_native(self, seqs: list, pre: dict | None = None):
        from ..native import align_sr_native

        mode = self._resolve_pallas_mode()
        res = align_sr_native(seqs, self.index.codes2, self.index.h,
                              self.index.pos, self.index.strand,
                              self.k, self.w, defer_dp=bool(mode), pre=pre)
        if res is None:
            return None
        if mode:
            self._resolve_deferred(seqs, res, mode)
        n = len(seqs)
        out = [Alignment() for _ in range(n)]
        mapped = res["mapped"]
        lens = res["lens"]
        cig = res["cig"]
        ncig = res["ncig"]
        OPS = self._CIG_OPS
        for i in np.flatnonzero(mapped == 1):
            a = out[i]
            a.mapped = True
            a.rev = bool(res["rev"][i])
            a.rs = int(res["rs"][i])
            a.re = int(res["re"][i])
            q0, q1 = int(res["qs"][i]), int(res["qe"][i])
            if a.rev:
                lq = int(lens[i])
                a.qs, a.qe = lq - q1, lq - q0
            else:
                a.qs, a.qe = q0, q1
            a.score = int(res["score"][i])
            a.mapq = int(res["mapq"][i])
            a.nm = int(res["nm"][i])
            row = cig[i]
            a.cigar = [(int(row[c]) >> 4, OPS[int(row[c]) & 0xF])
                       for c in range(int(ncig[i]))]
        # cigar-capacity overflows: redo with the oracle path (per-read
        # independent, so a sub-list realignment is semantics-preserving)
        over = np.flatnonzero(mapped == 2)
        if len(over):
            redo = self._align_chunk([seqs[i] for i in over])
            for j, i in enumerate(over):
                out[i] = redo[j]
        return out

    def _resolve_deferred(self, seqs: list, res: dict, mode: str):
        """Synchronous deferred resolution: dispatch + finish back-to-back."""
        fin = self._start_deferred(seqs, res, mode)
        if fin is not None:
            fin()

    def _start_deferred(self, seqs: list, res: dict, mode: str,
                        async_: bool = False):
        """Enqueue the kernel over the mapped == 3 rows; returns a zero-arg
        finisher that waits on the scores, gates on MIN_DP_MAX and runs the
        survivors' host traceback (None when no row was deferred)."""
        rows = np.flatnonzero(res["mapped"] == 3)
        if len(rows) == 0:
            return None
        stats = self.pallas_stats
        stats["deferred"] += len(rows)
        ref = self.index.codes2
        lens = res["lens"]
        queries = {}
        host_rows = []
        dev_rows = []
        for r in rows.tolist():
            codes = encode(np.frombuffer(seqs[r].encode(), dtype=np.uint8))
            if res["rev"][r]:
                codes = _RC[codes[::-1]]
            queries[r] = codes
            lw = int(res["re"][r]) - int(res["rs"][r])
            if int(lens[r]) > self.MAX_LQ or lw > self.MAX_LW:
                host_rows.append(r)
            else:
                dev_rows.append(r)
        if host_rows and self.log is not None:
            self.log(f"[align] {len(host_rows)} deferred windows above "
                     f"{self.MAX_LQ}x{self.MAX_LW}: host DP")

        out = None
        if dev_rows:
            n = len(dev_rows)
            LQ = max(len(queries[r]) for r in dev_rows)
            LW = max(int(res["re"][r]) - int(res["rs"][r]) for r in dev_rows)
            qb = np.full((n, LQ), 4, dtype=np.int8)
            rb = np.full((n, LW), 4, dtype=np.int8)
            ql = np.zeros(n, dtype=np.int32)
            for i, r in enumerate(dev_rows):
                q = queries[r]
                qb[i, : len(q)] = q
                lo, hi = int(res["rs"][r]), int(res["re"][r])
                rb[i, : hi - lo] = ref[lo:hi]
                ql[i] = len(q)
            d = self.device
            out = sw.banded_sw_scores(torch.from_numpy(qb).to(d),
                                      torch.from_numpy(rb).to(d),
                                      torch.from_numpy(ql).to(d))

        def finish():
            if out is not None:
                sc = out[:, 0].cpu().numpy()  # waits on the device
                stats["device_scored"] += len(dev_rows)
                for i, r in enumerate(dev_rows):
                    if sc[i] >= MIN_DP_MAX:
                        host_rows.append(r)  # survivor: host traceback
                    else:
                        res["mapped"][r] = 0
            stats["survivors"] += len(host_rows)
            self._host_dp_rows(seqs, res, host_rows, queries)

        return finish

    def _host_dp_rows(self, seqs: list, res: dict, host_rows: list,
                      queries: dict | None = None):
        """Exact banded DP + CIGAR traceback on host for the given deferred
        rows.  Fast path: ONE native call realigns the whole subset with the
        full DP enabled (pt_align_sr_rows — same window formula, same banded
        DP, so outputs are identical to the per-row loop below, which remains
        the fallback/oracle)."""
        if res.get("_buf") is not None and len(host_rows):
            from ..native import align_sr_rows_native

            if align_sr_rows_native(res, host_rows,
                                    cigar_cap=res["cig"].shape[1]):
                return
        ref = self.index.codes2
        if queries is None:
            queries = {}
            for r in host_rows:
                codes = encode(np.frombuffer(seqs[r].encode(), dtype=np.uint8))
                if res["rev"][r]:
                    codes = _RC[codes[::-1]]
                queries[r] = codes
        cap = res["cig"].shape[1]
        code = {c: i for i, c in enumerate(self._CIG_OPS)}
        from ..native import banded_dp_native

        def _dp_row(r):
            dp = banded_dp_native(queries[r],
                                  ref[int(res["rs"][r]) : int(res["re"][r])])
            if dp is None:
                dp = banded_affine_dp(
                    queries[r], ref[int(res["rs"][r]) : int(res["re"][r])])
            return dp

        if len(host_rows) > 64:
            # the native DP releases the GIL: thread the survivor traceback
            from concurrent.futures import ThreadPoolExecutor
            import os as _os

            with ThreadPoolExecutor(min(8, _os.cpu_count() or 1)) as ex:
                dps = list(ex.map(_dp_row, host_rows))
        else:
            dps = [_dp_row(r) for r in host_rows]

        for r, dp in zip(host_rows, dps):
            lo = int(res["rs"][r])
            votes, second = int(res["score"][r]), int(res["nm"][r])
            score, qs, qe, rsw, rew, cigar = dp
            if score < MIN_DP_MAX or not cigar:
                res["mapped"][r] = 0
                continue
            res["mapped"][r] = 1
            res["rs"][r] = lo + rsw
            res["re"][r] = lo + rew
            res["qs"][r] = qs
            res["qe"][r] = qe
            res["score"][r] = score
            res["nm"][r] = sum(ln for ln, op in cigar if op != "M")
            if votes >= 3 and second * 2 <= votes:
                res["mapq"][r] = 60
            else:
                res["mapq"][r] = max(1, min(60, int(
                    40 * (1 - (second + 1) / (votes + 1)))))
            if len(cigar) <= cap:
                res["ncig"][r] = len(cigar)
                for c, (ln, op) in enumerate(cigar):
                    res["cig"][r, c] = (ln << 4) | code[op]
            else:
                res["mapped"][r] = 2  # oracle redo downstream

    def align_batch_arrays(self, seqs: list, pre: dict | None = None,
                           deferred_async: bool = False):
        """Columnar twin of align_batch: returns the native per-read arrays
        (mapped/rev/rs/re/qs/qe ORIENTED/score/mapq/nm/ncig/cig/lens) with
        cigar-overflow rows merged back from the oracle path; `extra_cigars`
        maps row -> [(len,op)] for rows whose cigar exceeded the array
        capacity.  None when the native library is unavailable.

        With ``deferred_async`` the Pallas window-scoring dispatch is left IN
        FLIGHT and ``res["_fin"]`` holds the finisher (device wait + survivor
        host DP + overflow redo); the caller must invoke it before consuming
        the row arrays — the columnar emit does, after its res-independent
        prep, so the device round-trip hides under host work."""
        from ..native import align_sr_native

        mode = self._resolve_pallas_mode()
        res = align_sr_native(seqs, self.index.codes2, self.index.h,
                              self.index.pos, self.index.strand,
                              self.k, self.w, defer_dp=bool(mode), pre=pre)
        if res is None:
            return None
        if mode:
            if deferred_async:
                fin = self._start_deferred(seqs, res, mode, async_=True)
                if fin is not None:
                    res["extra_cigars"] = {}

                    def _finish():
                        fin()
                        self._fix_overflow_arrays(seqs, res)

                    res["_fin"] = _finish
                    return res
            else:
                self._resolve_deferred(seqs, res, mode)
        self._fix_overflow_arrays(seqs, res)
        return res

    def _fix_overflow_arrays(self, seqs: list, res: dict):
        """Redo cigar-capacity-overflow rows (mapped==2) with the oracle
        path and record oversized cigars in res["extra_cigars"]."""
        res["extra_cigars"] = {}
        over = np.flatnonzero(res["mapped"] == 2)
        if len(over):
            redo = self._align_chunk([seqs[i] for i in over])
            OPS = self._CIG_OPS
            code = {c: i for i, c in enumerate(OPS)}
            cap = res["cig"].shape[1]
            for j, i in enumerate(over):
                a = redo[j]
                if not a.mapped:
                    res["mapped"][i] = 0
                    continue
                res["mapped"][i] = 1
                res["rev"][i] = a.rev
                res["rs"][i] = a.rs
                res["re"][i] = a.re
                lq = len(seqs[i])
                # arrays hold ORIENTED coords; Alignment has original-strand
                q0, q1 = ((lq - a.qe, lq - a.qs) if a.rev else (a.qs, a.qe))
                res["qs"][i] = q0
                res["qe"][i] = q1
                res["score"][i] = a.score
                res["mapq"][i] = a.mapq
                res["nm"][i] = a.nm
                if len(a.cigar) <= cap:
                    res["ncig"][i] = len(a.cigar)
                    for c, (ln, op) in enumerate(a.cigar):
                        res["cig"][i, c] = (ln << 4) | code[op]
                else:
                    res["ncig"][i] = 0
                    res["extra_cigars"][int(i)] = list(a.cigar)
        return res

    def _align_chunk(self, seqs: list):
        N = len(seqs)
        out = [Alignment() for _ in range(N)]
        if N == 0:
            return out
        L = max(len(s) for s in seqs)
        from ..sketch.tpu import encode_reads_batch

        reads, lens = encode_reads_batch(seqs, pad_to=L)
        ridx, qpos, qh, qstrand = batch_minimizers(reads, lens, self.k, self.w)

        start, end = self.index.lookup_many(qh)
        counts = (end - start).astype(np.int64)
        tot = int(counts.sum())
        if tot == 0:
            return out
        # expand anchor hits
        rep = np.repeat(np.arange(len(qh)), counts)
        within = np.arange(tot) - np.repeat(
            np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
        tpos = self.index.pos[np.repeat(start, counts) + within].astype(np.int64)
        a_read = ridx[rep]
        a_qpos = qpos[rep]
        a_rel = (self.index.strand[np.repeat(start, counts) + within]
                 ^ qstrand[rep]).astype(np.int64)
        a_len = lens[a_read].astype(np.int64)
        diag = np.where(a_rel == 0, tpos - a_qpos,
                        tpos - (a_len - self.k - a_qpos))
        a_qv = np.where(a_rel == 0, a_qpos, a_len - self.k - a_qpos)

        # cluster per (read, strand): sort then split on diag jumps
        order = np.lexsort((diag, a_rel, a_read))
        r_s = a_read[order]
        rel_s = a_rel[order]
        d_s = diag[order]
        qv_s = a_qv[order]
        new_grp = np.concatenate(
            ([True],
             (r_s[1:] != r_s[:-1]) | (rel_s[1:] != rel_s[:-1])
             | (np.diff(d_s) > MAX_GAP)))
        gstart = np.flatnonzero(new_grp)
        gend = np.append(gstart[1:], len(r_s))
        votes = gend - gstart
        qmin = np.minimum.reduceat(qv_s, gstart)
        qmax = np.maximum.reduceat(qv_s, gstart)
        span = np.minimum(qmax - qmin + self.k, lens[r_s[gstart]])
        dmin = d_s[gstart]
        dmax = d_s[gend - 1]
        # median diagonal per cluster
        med = d_s[(gstart + gend - 1) // 2]
        g_read = r_s[gstart]
        g_rel = rel_s[gstart]

        # best + second-best votes per read
        corder = np.lexsort((-votes, g_read))
        first_of_read = np.concatenate(
            ([True], g_read[corder][1:] != g_read[corder][:-1]))
        best_rows = corder[first_of_read]
        second_votes = np.zeros(N, dtype=np.int64)
        rest = corder[~first_of_read]
        if len(rest):
            fr = np.concatenate(
                ([True], g_read[rest][1:] != g_read[rest][:-1]))
            second_rows = rest[fr]
            second_votes[g_read[second_rows]] = votes[second_rows]

        sel = best_rows[(votes[best_rows] >= MIN_CNT)
                        & (span[best_rows] >= MIN_CHAIN_SCORE)]
        if len(sel) == 0:
            return out

        # ---- vectorized verify for single-diagonal clusters ----
        ref = self.index.codes2
        lr = len(ref)
        b_read = g_read[sel]
        b_rel = g_rel[sel]
        b_diag = med[sel]
        b_single = dmin[sel] == dmax[sel]
        b_votes = votes[sel]
        b_sec = second_votes[b_read]

        oriented = np.where(b_rel[:, None] == 0, reads[b_read],
                            _RC[reads[b_read][:, ::-1]])
        lq = lens[b_read].astype(np.int64)
        # align oriented reads so base j corresponds to original padded... for
        # reversed reads the padding ends up on the LEFT; shift per row
        pad = (reads.shape[1] - lq)
        shift = np.where(b_rel == 1, pad, 0)
        # gather ref at diag + j - shift (reversed reads' content starts at pad)
        j = np.arange(reads.shape[1])[None, :]
        qcol = j - shift[:, None]
        rpos = b_diag[:, None] + qcol
        okcol = (qcol >= 0) & (qcol < lq[:, None]) & (rpos >= 0) & (rpos < lr)
        refg = np.where(okcol, ref[np.clip(rpos, 0, lr - 1)], 255)
        qg = oriented
        match = okcol & (qg == refg) & (qg < 4)
        contrib = np.where(okcol, np.where(match, MATCH, -MISMATCH),
                           0).astype(np.int32)

        # best sub-segment with end bonuses, batched prefix-max over columns
        S = np.concatenate(
            [np.zeros((len(sel), 1), np.int32),
             np.cumsum(contrib, axis=1, dtype=np.int32)], axis=1)
        n_col = contrib.shape[1]
        q_lo = np.maximum(0, -b_diag)  # first in-ref query column
        q_hi = np.minimum(lq, lr - b_diag)
        col = np.arange(n_col + 1)[None, :]
        lo_col = (np.maximum(q_lo, 0) + shift)[:, None]
        hi_col = (q_hi + shift)[:, None]
        NEG = np.int32(-(1 << 29))
        start_bonus = np.where(col == lo_col,
                               np.where(q_lo == 0, END_BONUS, 0)[:, None], 0)
        lead = np.where((col >= lo_col) & (col <= hi_col), -S + start_bonus, NEG)
        best_lead = np.maximum.accumulate(lead, axis=1)
        end_bonus = np.where(col == hi_col,
                             np.where(q_hi == lq, END_BONUS, 0)[:, None], 0)
        totals = np.where((col >= lo_col) & (col <= hi_col),
                          S + end_bonus + best_lead, NEG)
        jbest = np.argmax(totals[:, 1:], axis=1) + 1
        rows = np.arange(len(sel))
        score = totals[rows, jbest]
        # recover the segment start: first column (<= jbest) where lead hits
        # the prefix max at jbest
        target = best_lead[rows, jbest]
        hitmask = (lead == target[:, None]) & (col <= jbest[:, None])
        ibest = np.argmax(hitmask, axis=1)

        qs_o = ibest - shift
        qe_o = jbest - shift
        rawsc = score.copy()
        rawsc -= np.where((q_lo == 0) & (qs_o == q_lo), END_BONUS, 0)
        rawsc -= np.where((q_hi == lq) & (qe_o == q_hi), END_BONUS, 0)
        clip5 = qs_o
        clip3 = lq - qe_o
        needs_dp = (~b_single) | (clip5 >= 10) | (clip3 >= 10) | (score <= 0)
        fast_ok = (~needs_dp) & (rawsc >= MIN_DP_MAX) & (qe_o - qs_o >= self.k)

        # nm per fast row: mismatches inside the kept segment
        seg_mask = (col[:, :-1] >= (shift + qs_o)[:, None]) & (
            col[:, :-1] < (shift + qe_o)[:, None])
        nm_all = (seg_mask & ~match).sum(axis=1)
        mapq_all = np.where(
            (b_votes >= 3) & (b_sec * 2 <= b_votes), 60,
            np.clip((40 * (1 - (b_sec + 1) / (b_votes + 1))).astype(np.int64), 1, 60))

        for r in np.flatnonzero(fast_ok):
            i = int(b_read[r])
            aln = out[i]
            aln.mapped = True
            aln.score = int(rawsc[r])
            aln.rev = bool(b_rel[r])
            q0, q1 = int(qs_o[r]), int(qe_o[r])
            aln.rs = int(b_diag[r]) + q0
            aln.re = int(b_diag[r]) + q1
            aln.cigar = [(q1 - q0, "M")]
            aln.nm = int(nm_all[r])
            aln.mapq = int(mapq_all[r])
            if aln.rev:
                aln.qs, aln.qe = int(lq[r]) - q1, int(lq[r]) - q0
            else:
                aln.qs, aln.qe = q0, q1

        b_dmin = dmin[sel]
        b_dmax = dmax[sel]
        for r in np.flatnonzero(~fast_ok):
            i = int(b_read[r])
            res = self._extend(
                oriented[r, shift[r] : shift[r] + lq[r]].copy(),
                int(b_diag[r]), int(b_dmin[r]), int(b_dmax[r]),
                int(b_votes[r]), int(b_sec[r]))
            if res.mapped:
                res.rev = bool(b_rel[r])
                if res.rev:
                    res.qs, res.qe = int(lq[r]) - res.qe, int(lq[r]) - res.qs
                out[i] = res
        return out

    def align_pairs_batch(self, seqs: list, paired: bool):
        alns = self.align_batch(seqs)
        out = []
        if paired:
            for i in range(0, len(seqs) - 1, 2):
                a1, a2 = alns[i], alns[i + 1]
                if a1.mapped and a2.mapped:
                    a1.proper_frag = a2.proper_frag = self._proper(a1, a2)
                else:
                    a1.mapped = a2.mapped = False
                out.append((a1, a2))
        else:
            out = [(a, None) for a in alns]
        return out


# the name the carried host code (place/refine.py) builds its aligner under
BatchAligner = TorchBatchAligner
