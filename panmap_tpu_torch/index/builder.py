"""Single-sample index builder: per-node k-min-mer count deltas over the PanMAN DFS.

Reimplements the *semantics* of the reference's incremental builder
(src/index_single_mode.cpp processNode / computeNewSyncmerRangesJump /
buildIndexParallel) as array programs:

 - the genome lives in "scalar coordinate" space: the flattened MSA slots of all
   blocks (gap slots first, then the main consensus char per position; the 'x'
   block sentinel owns no scalar), matching panmap_utils.hpp:323-712 GlobalCoords;
 - per node we apply block/nuc mutations (panmap_utils.hpp:725-878 rules) and
   update the parent's syncmer state only inside the *recompute windows*: each
   mutation's coordinate span expanded by k-1 non-gap characters on both sides
   (index_single_mode.cpp:28-259), with window merging when expansions touch;
 - each update obeys the hard flank mask of index_single_mode.cpp:1851-1854
   ("hard-masked: no adds, no deletes" — masked positions keep the parent's
   state verbatim), which makes per-node seed sets path-dependent exactly like
   the reference;
 - k-min-mers are recombined over the position-sorted syncmer set (a pure
   function of it, index_single_mode.cpp:1946-2101) and per-node count deltas
   (hash, parentCount, childCount) are emitted sorted by hash, the on-disk row
   order of index_single_mode.cpp:2530-2561.

The flank mask boundaries are the flankMaskBp-th non-gap base from each end
(panmap_utils.hpp:893-970 computeExtentFromGapMap with flankSize); if the genome
is shorter than the two flanks every position is masked and the child inherits
the parent state unchanged.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..io.panman import NUC_CODE_BYTE, NUC_FROM_CODE, PanmanTree, COMP_TABLE
from ..sketch.cpu import U64, kminmer_hashes_oriented, rolling_syncmers, hpc_compress_with_mapping

GAP = ord("-")
_COMP_LUT = np.frombuffer(COMP_TABLE, dtype=np.uint8)


@dataclass
class IndexParams:
    k: int = 19
    s: int = 8
    t: int = 0
    l: int = 3
    open: bool = False
    hpc: bool = False
    flank_mask_bp: int = 250
    impute_amb: bool = False
    # Guard seed deletions at genome extent boundaries (main.cpp --extent-guard):
    # when on and flank_mask_bp == 0, the hard mask becomes the genome extent
    # [first non-gap scalar, last non-gap scalar] instead of unbounded, so seeds
    # in flank regions (missing data, not true gaps) survive gap mutations
    # (index_single_mode.cpp:811-816,1746-1765; hpp:70).  With flank_mask_bp > 0
    # the flank hard mask is strictly inside the extent, so the guard is a no-op
    # there — same as the reference, where hardMaskStart/End is recomputed with
    # flankSize and subsumes the extent check.
    extent_guard: bool = False


@dataclass
class IndexArrays:
    """The built index: flat SoA mirroring LiteIndex V4 (src/index_lite.capnp:36-70)."""

    params: IndexParams
    node_ids: list
    parent_index: np.ndarray  # u32[N]
    identical_to_parent: np.ndarray  # bool[N]
    block_ranges: np.ndarray  # u32[B,2] scalar [start,end] per block
    seed_hashes: np.ndarray  # u64[T]
    parent_counts: np.ndarray  # i16[T]
    child_counts: np.ndarray  # i16[T]
    node_offsets: np.ndarray  # u64[N+1]
    substitution_matrix: np.ndarray = field(default_factory=lambda: np.zeros(16))


class ScalarSpace:
    """Flattened MSA coordinates for all blocks (GlobalCoords equivalent)."""

    def __init__(self, tree: PanmanTree):
        blocks = tree.blocks
        nb = len(blocks)
        gap_slots: list[dict[int, int]] = [dict() for _ in range(nb)]
        for g in tree.gaps:
            d = gap_slots[g.block_id]
            for pos, ln in zip(g.nuc_positions.tolist(), g.nuc_gap_lengths.tolist()):
                d[int(pos)] = int(ln)

        chars = []
        self.main_scalar: list[np.ndarray] = []
        self.gap_scalar_start: list[dict[int, int]] = []
        cur = 0
        self.block_ranges = np.zeros((nb, 2), dtype=np.uint32)
        blk_lens = np.zeros(nb, dtype=np.int64)
        for b in range(nb):
            cons = NUC_FROM_CODE[blocks[b].consensus_codes].view(np.uint8)
            blen = len(cons)
            start_scalar = cur
            # gap runs sit BEFORE their slot's main column (slot blen is a
            # trailing sentinel); vectorized layout: ms[j] = start + j +
            # (total gap length at slots <= j), gap run at slot j starts at
            # start + j + (total gap length at slots < j)
            slots = sorted(jj for jj in gap_slots[b] if 0 <= jj <= blen)
            if slots:
                gj = np.asarray(slots, dtype=np.int64)
                gl = np.asarray([gap_slots[b][jj] for jj in slots],
                                dtype=np.int64)
                cum = np.concatenate(([0], np.cumsum(gl)))
                jarr = np.arange(blen, dtype=np.int64)
                ms = (start_scalar + jarr
                      + cum[np.searchsorted(gj, jarr, side="right")])
                g_begin = start_scalar + gj + cum[:-1]
                gstart = dict(zip(gj.tolist(), g_begin.tolist()))
                total = blen + int(cum[-1])
            else:
                ms = start_scalar + np.arange(blen, dtype=np.int64)
                gstart = {}
                total = blen
            seg = np.full(total, GAP, dtype=np.uint8)
            seg[ms - start_scalar] = cons
            chars.append(seg)
            cur += total
            blk_lens[b] = total
            self.main_scalar.append(ms)
            self.gap_scalar_start.append(gstart)
            self.block_ranges[b] = (start_scalar, cur - 1)
        self.char0 = np.concatenate(chars) if chars else np.empty(0, np.uint8)
        self.block_of = (np.repeat(np.arange(nb, dtype=np.int32), blk_lens)
                         if nb else np.empty(0, np.int32))
        self.n = cur
        self.nb = nb
        self.block_len = [len(self.main_scalar[b]) + 1 for b in range(nb)]  # incl. sentinel
        self.block_len_arr = np.asarray(self.block_len, dtype=np.int64)

    def scalar_of(self, block: int, nuc_pos: int, gap_pos: int) -> int:
        """-1 if the coordinate is out of range / the sentinel."""
        if gap_pos == -1:
            ms = self.main_scalar[block]
            if nuc_pos >= len(ms):
                return -1
            return int(ms[nuc_pos])
        start = self.gap_scalar_start[block].get(nuc_pos)
        if start is None:
            return -1
        return start + gap_pos

    def flat_lookup(self):
        """Vectorized twin of scalar_of: (ms_flat, ms_off, gap_key sorted,
        gap_start) — ms_flat[ms_off[b] + npos] for main coords; gap starts
        via searchsorted on key = b << 32 | nuc_pos.  Built lazily."""
        if not hasattr(self, "_flat"):
            ms_off = np.zeros(self.nb + 1, dtype=np.int64)
            for b in range(self.nb):
                ms_off[b + 1] = ms_off[b] + len(self.main_scalar[b])
            ms_flat = (np.concatenate(self.main_scalar)
                       if self.nb else np.empty(0, np.int64))
            keys = []
            starts = []
            for b in range(self.nb):
                for p, st in self.gap_scalar_start[b].items():
                    keys.append((b << 32) | p)
                    starts.append(st)
            gk = np.asarray(keys, dtype=np.int64)
            gs = np.asarray(starts, dtype=np.int64)
            order = np.argsort(gk)
            self._flat = (ms_flat, ms_off, gk[order], gs[order])
        return self._flat


class _BuildFrame:
    __slots__ = ("node", "child_iter", "undo_chars", "undo_blocks", "state",
                 "seqtok", "rcundo")

    def __init__(self, node, child_iter, undo_chars, undo_blocks, state,
                 seqtok=None, rcundo=None):
        self.node = node
        self.child_iter = child_iter
        self.undo_chars = undo_chars
        self.undo_blocks = undo_blocks
        self.state = state
        self.seqtok = seqtok
        self.rcundo = rcundo


def _empty_meta_state():
    return (
        np.empty(0, np.int64), np.empty(0, U64), np.empty(0, bool),
        (np.empty(0, np.int64), np.empty(0, U64), np.empty(0, bool),
         np.empty(0, np.int64)),
    )


def _empty_state():
    return (
        np.empty(0, np.int64),  # syncmer positions (reading-order scalar), sorted
        np.empty(0, U64),  # syncmer hashes (position order)
        np.empty(0, bool),  # syncmer is_reverse flags
        np.empty(0, U64),  # unique kminmer hashes (sorted)
        np.empty(0, np.int64),  # counts per unique kminmer hash
        np.empty(0, U64),  # positioned kminmer hashes
        np.empty(0, bool),  # positioned kminmer orientations
        np.empty(0, np.int64),  # positioned kminmer start positions
        np.empty(0, np.int64),  # positioned kminmer end positions (incl.)
    )


@dataclass
class _NodeEdits:
    """What a node's mutations touched, in reading-scalar space."""

    spans: list  # [a, b] mutation coordinate spans (reading scalars, inclusive)
    potential_dels: list  # base->'-' positions (potentialSyncmerDeletions)
    blocks_turned_off: list  # block ids whose existence flipped on->off


def subtree_ends(tree: PanmanTree) -> np.ndarray:
    """dfs_index -> exclusive end of the node's DFS interval."""
    n_nodes = len(tree.dfs_order)
    end = np.arange(1, n_nodes + 1, dtype=np.int64)
    for node in reversed(tree.dfs_order):
        if node.parent is not None:
            p = node.parent.dfs_index
            if end[node.dfs_index] > end[p]:
                end[p] = end[node.dfs_index]
    return end


def _apply_nuc_legacy(node, space, chars, block_exists, block_strand,
                      reading_scalar, params, old_exists, old_strand,
                      undo_chars, edits):
    """Scalar nuc-mutation application (panmap_utils.hpp:725-878) — the
    oracle for _apply_nuc_fast and the path for --impute / duplicate-scalar
    nodes."""
    for nm in node.nuc_mutations:
        bid = nm.block_id
        blen = space.block_len[bid]
        b_old_exists = old_exists.get(bid, bool(block_exists[bid]))
        b_old_strand = old_strand.get(bid, bool(block_strand[bid]))
        last_offset_sc = -1
        first_offset_sc = -1
        for i in range(nm.length):
            if nm.nuc_gap_position == -1:
                npos, gpos = nm.nuc_position + i, -1
                # skip the sentinel main slot / out-of-range (panmap_utils.hpp:792-794)
                if npos == blen - 1 or npos >= blen:
                    continue
            else:
                npos, gpos = nm.nuc_position, nm.nuc_gap_position + i
                if npos >= blen:
                    continue
            sc = space.scalar_of(bid, npos, gpos)
            if sc < 0:
                continue
            rs = reading_scalar(sc, bid)
            if first_offset_sc == -1:
                first_offset_sc = rs
            last_offset_sc = rs
            old = int(chars[sc])
            new = int(NUC_CODE_BYTE[nm.codes[i]])
            if old == new:
                continue
            if params.impute_amb and _canonical_to_amb(old, new):
                continue
            undo_chars.append((sc, old))
            chars[sc] = new
            # potentialSyncmerDeletions (panmap_utils.hpp:810-823)
            if (new == GAP and b_old_exists and block_exists[bid]
                    and block_strand[bid] == b_old_strand):
                edits.potential_dels.append(rs)
        # nuc mutation range (panmap_utils.hpp:834-841)
        if (last_offset_sc != -1 and block_exists[bid] and b_old_exists
                and block_strand[bid] == b_old_strand):
            a, b = sorted((first_offset_sc, last_offset_sc))
            edits.spans.append([a, b])


def _apply_nuc_small(node, space, chars, block_exists, block_strand, br,
                     old_exists, old_strand, undo_chars, edits) -> None:
    """Scalar twin of _apply_nuc_fast for FEW-mutation nodes (the typical
    case: 1-5 substitutions), working straight off the packed nm_* arrays —
    no numpy call overhead, no nuc_mutations object materialization.
    Sequential char application, so duplicate scalars are handled like the
    legacy walk (no bail-out needed)."""
    nmb, nmp = node.nm_block, node.nm_pos
    nmg, nmk = node.nm_gap, node.nm_packed
    code_byte = NUC_CODE_BYTE
    for i in range(len(nmb)):
        bid = int(nmb[i])
        packed = int(nmk[i])
        ln = (packed & 0xFF) >> 4
        if ln == 0:
            continue
        blen = space.block_len[bid]
        b_ex = bool(block_exists[bid])
        b_st = bool(block_strand[bid])
        bo_ex = old_exists.get(bid, b_ex)
        bo_st = old_strand.get(bid, b_st)
        base_p = int(nmp[i])
        gapp = int(nmg[i])
        lo = int(br[bid, 0])
        hi = int(br[bid, 1])
        first_rs = last_rs = -1
        for o in range(ln):
            if gapp == -1:
                npos, gpos = base_p + o, -1
                if npos >= blen - 1:
                    continue
            else:
                npos, gpos = base_p, gapp + o
                if npos >= blen:
                    continue
            sc = space.scalar_of(bid, npos, gpos)
            if sc < 0:
                continue
            rs = sc if b_st else lo + hi - sc
            if first_rs == -1:
                first_rs = rs
            last_rs = rs
            old = int(chars[sc])
            new = int(code_byte[(packed >> (8 + 4 * (ln - 1 - o))) & 0xF])
            if old == new:
                continue
            undo_chars.append((sc, old))
            chars[sc] = new
            if new == GAP and bo_ex and b_ex and b_st == bo_st:
                edits.potential_dels.append(rs)
        if last_rs != -1 and b_ex and bo_ex and b_st == bo_st:
            a, b = (first_rs, last_rs) if first_rs <= last_rs \
                else (last_rs, first_rs)
            edits.spans.append([a, b])


def _apply_nuc_fast(node, space, chars, block_exists, block_strand, br,
                    old_exists, old_strand, undo_chars, edits) -> bool:
    """Vectorized twin of _apply_nuc_legacy over the node's nm_* arrays.
    Returns False (having changed nothing) when the node mutates the same
    scalar twice — sequential semantics then require the legacy walk."""
    n_mut = len(node.nm_block)
    if n_mut == 0:
        return True
    nmb = node.nm_block.astype(np.int64)
    nmp = node.nm_pos.astype(np.int64)
    nmg = node.nm_gap.astype(np.int64)
    nmk = node.nm_packed.astype(np.int64)
    lens_ = (nmk & 0xFF) >> 4
    T = int(lens_.sum())
    if T == 0:
        return True
    rec = np.repeat(np.arange(n_mut), lens_)
    off = np.arange(T) - np.repeat(
        np.concatenate(([0], np.cumsum(lens_)[:-1])), lens_)
    bidv = nmb[rec]
    isg = nmg[rec] != -1
    npos = np.where(isg, nmp[rec], nmp[rec] + off)
    blenv = space.block_len_arr[bidv]
    code = (nmk[rec] >> (8 + 4 * (lens_[rec] - 1 - off))) & 0xF
    ms_flat, ms_off, gkey, gstart = space.flat_lookup()
    sc = np.full(T, -1, np.int64)
    main_rows = (~isg) & (npos < blenv - 1)
    sc[main_rows] = ms_flat[ms_off[bidv[main_rows]] + npos[main_rows]]
    gap_rows = isg & (npos < blenv)
    if gap_rows.any():
        key = (bidv[gap_rows] << 32) | npos[gap_rows]
        if len(gkey):
            ii = np.minimum(np.searchsorted(gkey, key), len(gkey) - 1)
            found = gkey[ii] == key
            sc[gap_rows] = np.where(
                found, gstart[ii] + nmg[rec[gap_rows]] + off[gap_rows], -1)
    valid = sc >= 0
    vrows = np.flatnonzero(valid)
    if len(vrows) == 0:
        return True
    scv = sc[vrows]
    su = np.unique(scv)
    if len(su) != len(scv):
        return False  # duplicate scalar in one node: sequential semantics
    # per-record old block state (dicts are tiny)
    bo_ex = np.fromiter(
        (old_exists.get(int(b), bool(block_exists[b])) for b in nmb),
        bool, n_mut)
    bo_st = np.fromiter(
        (old_strand.get(int(b), bool(block_strand[b])) for b in nmb),
        bool, n_mut)
    lo = br[bidv, 0]
    hi = br[bidv, 1]
    strandv = block_strand[bidv]
    rs_ = np.where(strandv, sc, lo + hi - sc)
    # char changes, in row order
    oldv = chars[scv]
    newv = NUC_CODE_BYTE[code[vrows]]
    chg = oldv != newv
    crows = vrows[chg]
    if len(crows):
        undo_chars.extend(zip(scv[chg].tolist(), oldv[chg].tolist()))
        chars[scv[chg]] = newv[chg]
        pd = ((newv[chg] == GAP) & bo_ex[rec[crows]]
              & block_exists[bidv[crows]]
              & (block_strand[bidv[crows]] == bo_st[rec[crows]]))
        edits.potential_dels.extend(rs_[crows[pd]].tolist())
    # per-record spans over VALID offsets (first/last in offset order)
    vrec = rec[vrows]
    firsts = np.concatenate(([True], vrec[1:] != vrec[:-1]))
    lasts = np.concatenate((firsts[1:], [True]))
    f_idx = vrows[firsts]
    l_idx = vrows[lasts]
    recs_u = vrec[firsts]
    keepspan = (block_exists[nmb[recs_u]] & bo_ex[recs_u]
                & (block_strand[nmb[recs_u]] == bo_st[recs_u]))
    a_sp = np.minimum(rs_[f_idx], rs_[l_idx])
    b_sp = np.maximum(rs_[f_idx], rs_[l_idx])
    for rr in np.flatnonzero(keepspan).tolist():
        edits.spans.append([int(a_sp[rr]), int(b_sp[rr])])
    return True


def run_dfs(tree: PanmanTree, params: IndexParams, emit, progress=None,
            dfs_range=None, gap_emit=None, state_probe=None,
            emit_delta=None, emit_meta=None):
    """Shared builder DFS: applies mutations down the tree maintaining the
    syncmer/k-min-mer state, calling emit(dfs_index, parent_state, child_state,
    changed) at every node.  Returns the identical-to-parent flags.
    Both the single-sample count-delta index and the meta positional-delta
    index are emitters over this walk.

    dfs_range=(a, b) restricts the walk to subtrees intersecting the DFS
    interval [a, b): out-of-range subtrees are pruned entirely, ancestors on
    paths into the range are applied (state must be exact) but the emitter
    decides what to record — the chunked-DFS parallel build
    (index_single_mode.cpp:2291-2571 buildIndexParallel) partitions on this.

    gap_emit(dfs_index, ch_pos, ch_nongap, b_id, b_code), when given, receives
    each node's NET alignment-gap changes vs its parent: forward-scalar
    positions whose gap-ness flipped, and touched blocks' new (presence,
    strand) coded 0=off / 1=on-forward / 2=on-inverted — the wire data for
    the runtime degap tracker (reference: gapRunDeltas + invertedBlocks,
    index_lite.capnp:55-60).

    state_probe(dfs_index, chars, block_exists, block_strand), when given,
    observes the LIVE builder state at each node (read-only; test oracles).

    emit_delta(dfs_index, (hashes, pcounts i16, ccounts i16), changed), when
    given INSTEAD of relying on full per-node count tables, switches the
    walk to INCREMENTAL COUNTS MODE (the reference's runningCounts scheme,
    index_single_mode.cpp:1946-2101 + backtrackNode): a mutable running
    k-min-mer count table is maintained with per-node undo, and each node's
    count delta is computed from only the AFFECTED k-min-mer windows (those
    containing a changed syncmer or crossing a pure insertion/deletion
    boundary) instead of rebuilding and diffing the full genome table —
    O(edit windows) per node instead of O(genome).  `emit` is not called in
    this mode and states carry only the syncmer arrays.  Bit-identical to
    the full-table path (tests/test_e2e.py::test_incremental_counts_mode)."""
    space = ScalarSpace(tree)
    k, s, t, l = params.k, params.s, params.t, params.l
    flank = params.flank_mask_bp

    chars = space.char0.copy()
    block_exists = np.zeros(space.nb, dtype=bool)
    block_strand = np.ones(space.nb, dtype=bool)
    block_of = space.block_of
    br = space.block_ranges.astype(np.int64)

    n_nodes = len(tree.dfs_order)
    identical = np.zeros(n_nodes, dtype=bool)
    counts_mode = emit_delta is not None
    # meta (positioned) incremental mode: emit_meta(dfs_index, delta|None,
    # changed) receives each node's positioned-seed delta; states carry the
    # syncmer arrays + spliced k-min-mer arrays (no mutable table needed —
    # deltas are local to each node)
    meta_mode = emit_meta is not None
    run_counts: dict = {}  # counts mode: mutable running k-min-mer table

    def reading_scalar(sc: int, b: int) -> int:
        """Forward scalar -> reading-order scalar (mirrored inside inverted blocks)."""
        if block_strand[b]:
            return sc
        return int(br[b, 0] + br[b, 1] - sc)

    def apply_node(node):
        """Apply mutations (panmap_utils.hpp:725-878) and collect recompute spans."""
        undo_chars: list[tuple[int, int]] = []
        undo_blocks: list[tuple[int, bool, bool]] = []
        edits = _NodeEdits(spans=[], potential_dels=[], blocks_turned_off=[])
        if not node.block_mutations and len(node.nm_block) == 0:
            identical[node.dfs_index] = True
            return undo_chars, undo_blocks, edits

        old_exists = {}
        old_strand = {}
        for bm in node.block_mutations:
            bid = bm.block_id
            old_exists.setdefault(bid, bool(block_exists[bid]))
            old_strand.setdefault(bid, bool(block_strand[bid]))
            undo_blocks.append((bid, bool(block_exists[bid]), bool(block_strand[bid])))
            was = bool(block_exists[bid])
            if bm.is_insertion:
                block_exists[bid] = True
                block_strand[bid] = not bm.is_inversion
            elif bm.is_inversion:
                block_strand[bid] = not block_strand[bid]
            else:
                block_exists[bid] = False
                block_strand[bid] = True
            if was and not block_exists[bid]:
                edits.blocks_turned_off.append(bid)
            # whole block becomes a mutation range (reading-scalar span)
            edits.spans.append([int(br[bid, 0]), int(br[bid, 1])])

        if params.impute_amb:
            _apply_nuc_legacy(node, space, chars, block_exists, block_strand,
                              reading_scalar, params, old_exists, old_strand,
                              undo_chars, edits)
        elif len(node.nm_block) <= 8:
            # typical node: a handful of substitutions — the scalar walk
            # beats the vectorized path's fixed numpy overhead (~0.2 ms)
            _apply_nuc_small(node, space, chars, block_exists, block_strand,
                             br, old_exists, old_strand, undo_chars, edits)
        elif not _apply_nuc_fast(
                node, space, chars, block_exists, block_strand, br,
                old_exists, old_strand, undo_chars, edits):
            _apply_nuc_legacy(node, space, chars, block_exists, block_strand,
                              reading_scalar, params, old_exists, old_strand,
                              undo_chars, edits)
        return undo_chars, undo_blocks, edits

    def simple_edits_of(node, undo_chars):
        """[(sc, new_char)] when the node only substitutes characters (no
        block events, no gap-ness flips) — the incremental seq/nz patch
        path; None when a rebuild is needed."""
        if node.block_mutations:
            return None
        seen: dict = {}
        for sc, old in undo_chars:
            if sc not in seen:
                seen[sc] = old
        out = []
        for sc, old in seen.items():
            new = int(chars[sc])
            if (old == GAP) != (new == GAP):
                return None
            out.append((sc, new))
        return out

    def gap_events(dfs_index, undo_chars, undo_blocks):
        seen: dict = {}
        for sc, old in undo_chars:
            if sc not in seen:
                seen[sc] = old
        ch_pos, ch_ng = [], []
        for sc, old in seen.items():
            now = int(chars[sc]) != GAP
            if (old != GAP) != now:
                ch_pos.append(sc)
                ch_ng.append(now)
        firstb: dict = {}
        for bid, ex, st_ in undo_blocks:
            if bid not in firstb:
                firstb[bid] = (ex, st_)
        b_id, b_code = [], []
        for bid, (oex, ost) in firstb.items():
            nex = bool(block_exists[bid])
            nst = bool(block_strand[bid])
            if (oex, ost) != (nex, nst):
                b_id.append(bid)
                b_code.append(0 if not nex else (1 if nst else 2))
        gap_emit(dfs_index, ch_pos, ch_ng, b_id, b_code)

    def undo_node(undo_chars, undo_blocks):
        for sc, old in reversed(undo_chars):
            chars[sc] = old
        for bid, ex, st_ in reversed(undo_blocks):
            block_exists[bid] = ex
            block_strand[bid] = st_

    def rebuild_seq_nz():
        """Reading-order sequence of the CURRENT chars/block state: blocks in
        id order, inverted blocks rev-complemented; (seq u8, nz scalars)."""
        segs = []
        segpos = []
        for b in range(space.nb):
            if not block_exists[b]:
                continue
            lo, hi = br[b]
            seg = chars[lo : hi + 1]
            pos = np.arange(lo, hi + 1, dtype=np.int64)
            if not block_strand[b]:
                seg = _COMP_LUT[seg[::-1]]
                pos = np.int64(lo) + np.int64(hi) - pos[::-1]
            segs.append(seg)
            segpos.append(pos)
        if segs:
            rseq = np.concatenate(segs)
            rpos = np.concatenate(segpos)
        else:
            rseq = np.empty(0, np.uint8)
            rpos = np.empty(0, np.int64)
        mask_nongap = rseq != GAP
        nzi = np.flatnonzero(mask_nongap)
        return rseq[nzi].copy(), rpos[nzi]

    # incrementally-maintained reading-order view (substitution-only nodes
    # patch it in place; gap/block-changing nodes rebuild — the reference
    # keeps the same invariant through its gap map)
    cur = {"seq": None, "nz": None}

    def advance_seq_nz(simple_edits):
        """Returns the undo token.  simple_edits = [(sc, new_char)] for a
        substitution-only node (no block events, no gap-ness flips); None
        forces a rebuild."""
        if params.hpc or cur["seq"] is None or simple_edits is None:
            old = (cur["seq"], cur["nz"])
            s, z = rebuild_seq_nz()
            if params.hpc and len(s):
                comp_seq, mapping = hpc_compress_with_mapping(
                    s.tobytes().decode("latin1"))
                s = np.frombuffer(comp_seq.encode("latin1"),
                                  dtype=np.uint8).copy()
                z = z[mapping]
            cur["seq"], cur["nz"] = s, z
            return ("swap", old)
        seq, nz = cur["seq"], cur["nz"]
        idxs = []
        olds = []
        for sc, new in simple_edits:
            b = int(space.block_of[sc])
            if not block_exists[b]:
                continue
            rs = sc if block_strand[b] else int(br[b, 0] + br[b, 1] - sc)
            i = int(np.searchsorted(nz, rs))
            if i < len(nz) and nz[i] == rs:
                idxs.append(i)
                olds.append(int(seq[i]))
                seq[i] = new if block_strand[b] else int(_COMP_LUT[new])
        return ("patch", idxs, olds)

    def retreat_seq_nz(token):
        if token[0] == "swap":
            cur["seq"], cur["nz"] = token[1]
        else:
            _, idxs, olds = token
            seq = cur["seq"]
            for i, o in zip(reversed(idxs), reversed(olds)):
                seq[i] = o

    def compute_state(parent_state, edits: _NodeEdits,
                      want_delta: bool = True):
        """Windowed syncmer-state update + full k-min-mer recombination over
        the maintained reading-order view."""
        seq, nz = cur["seq"], cur["nz"]
        # genome extent (computeExtentFromGapMap with flankSize=0); under HPC
        # nz holds run starts, whose first/last equal the pre-HPC extent
        ext = (int(nz[0]), int(nz[-1])) if len(nz) else None
        nnz = len(nz)

        # hard flank mask: [hms, hme] is the unmasked span
        if flank > 0:
            if nnz >= 2 * flank and nz[flank - 1] <= nz[nnz - flank]:
                hms = int(nz[flank - 1])
                hme = int(nz[nnz - flank])
            else:
                hms, hme = None, None  # everything masked: no seed ops at all
        elif params.extent_guard:
            # hard mask = genome extent (hardMaskStart/End default to
            # first/lastNonGapScalar when flankMaskBp == 0 and extentGuard is on)
            hms, hme = ext if ext is not None else (None, None)
        else:
            hms, hme = 0, 1 << 62

        p_pos, p_hash, p_rev = parent_state[0], parent_state[1], parent_state[2]

        merge_info = None  # (keep, add_pos) when the merge branch runs
        if hms is None or (not edits.spans and not edits.potential_dels
                           and not edits.blocks_turned_off):
            child_pos, child_hash, child_rev = p_pos, p_hash, p_rev
        else:
            last_scalar = space.n - 1
            # ---- recompute windows (computeNewSyncmerRangesJump semantics) ----
            spans = sorted(edits.spans)
            merged = []
            for a, b in spans:
                if merged and merged[-1][1] + 1 >= a:
                    merged[-1][1] = max(merged[-1][1], b)
                else:
                    merged.append([a, b])

            # batched searchsorted for the common no-swallow walk (the
            # python-loop scalar searches were ~40% of compute_state self)
            marr = np.asarray(merged, dtype=np.int64)
            ib_all = np.searchsorted(nz, marr[:, 1], side="right") - 1
            ia_all = np.searchsorted(nz, marr[:, 0], side="left")

            ranges = []  # (ja, jb, walk_beg, walk_end, reached_end)
            i = 0
            while i < len(merged):
                gi = i  # group start: a (and ia) never change on swallow
                a, b = merged[i]
                ib = int(ib_all[i])
                while True:
                    end_idx = ib + (k - 1)
                    reached_end = end_idx >= nnz or b >= last_scalar
                    jb = min(end_idx, nnz - 1)
                    swallow_limit = last_scalar if reached_end else (
                        int(nz[jb]) if jb >= 0 else b)
                    if i + 1 < len(merged) and merged[i + 1][0] <= swallow_limit:
                        i += 1
                        if merged[i][1] > b:
                            b = merged[i][1]
                            ib = int(ib_all[i])
                        continue
                    break
                ia = int(ia_all[gi])
                ja = max(ia - (k - 1), 0)
                beg_scalar = int(nz[ja]) if ja < nnz else a
                walk_beg = min(a, beg_scalar)
                walk_end = max(b, int(nz[jb])) if jb >= 0 else b
                if ranges and walk_beg <= ranges[-1][3]:
                    pj, pjb, pwb, pwe, pre = ranges.pop()
                    ja = pj
                    walk_beg = pwb
                    jb = max(jb, pjb)
                    walk_end = max(walk_end, pwe)
                    reached_end = reached_end or pre
                ranges.append((ja, jb, walk_beg, walk_end, reached_end))
                i += 1

            # ---- window-local scans (a syncmer at p depends only on bases
            # [p, p+k-1], so scanning seq[ja:jb+1] is exact for positions
            # ja..jb-k+1 — no full-genome rescan per node) ----
            idx_parts, hash_parts, rev_parts, sync_parts = [], [], [], []
            live = []  # (ja, hi_idx) per scanned range
            for ja, jb, _, _, _ in ranges:
                hi_idx = min(jb - k + 1, nnz - k) if nnz >= k else -1
                if hi_idx < ja:
                    continue
                live.append((ja, jb, hi_idx))
            multi = None
            if len(live) > 1 and not os.environ.get("PANMAP_TPU_NO_NATIVE"):
                from ..native import rolling_syncmers_multi_native

                multi = rolling_syncmers_multi_native(
                    seq, np.array([x[0] for x in live], np.int64),
                    np.array([x[1] for x in live], np.int64),
                    k, s, t, params.open)
            if multi is not None:
                mh, mr, ms_, moff = multi
                for r, (ja, jb, hi_idx) in enumerate(live):
                    nloc = hi_idx - ja + 1
                    o = moff[r]
                    idx_parts.append(np.arange(ja, hi_idx + 1, dtype=np.int64))
                    hash_parts.append(mh[o : o + nloc])
                    rev_parts.append(mr[o : o + nloc].astype(bool))
                    sync_parts.append(ms_[o : o + nloc].astype(bool))
            else:
                for ja, jb, hi_idx in live:
                    h_w, r_w, s_w = rolling_syncmers(seq[ja : jb + 1], k, s,
                                                     params.open, t)
                    nloc = hi_idx - ja + 1
                    idx_parts.append(np.arange(ja, hi_idx + 1, dtype=np.int64))
                    hash_parts.append(h_w[:nloc])
                    rev_parts.append(r_w[:nloc])
                    sync_parts.append(s_w[:nloc])
            if idx_parts:
                scan_idx = np.concatenate(idx_parts)
                pos_scan = nz[scan_idx]
                hash_scan = np.concatenate(hash_parts)
                rev_scan = np.concatenate(rev_parts)
                sync_scan = np.concatenate(sync_parts)
            else:
                scan_idx = np.empty(0, np.int64)
                pos_scan = np.empty(0, np.int64)
                hash_scan = np.empty(0, U64)
                rev_scan = np.empty(0, bool)
                sync_scan = np.empty(0, bool)
            unm = (pos_scan >= hms) & (pos_scan <= hme)
            pos_scan, sync_scan, hash_scan, rev_scan = (
                pos_scan[unm], sync_scan[unm], hash_scan[unm], rev_scan[unm])

            # ---- explicit deletions ----
            dels = []
            if len(p_pos):
                nz_set = nz
                # batched walked-range bounds (one searchsorted pair for ALL
                # ranges instead of two python-level calls per range)
                wbs = np.fromiter((r[2] for r in ranges), np.int64,
                                  len(ranges))
                wes = np.fromiter((r[3] for r in ranges), np.int64,
                                  len(ranges))
                los = np.searchsorted(p_pos, wbs, side="left")
                his = np.searchsorted(p_pos, wes, side="right")
                cand_parts = [p_pos[lo:hi] for lo, hi in
                              zip(los.tolist(), his.tolist()) if hi > lo]
                if cand_parts:
                    cand = (np.concatenate(cand_parts)
                            if len(cand_parts) > 1 else cand_parts[0])
                    on_nz = np.zeros(len(cand), dtype=bool)
                    if nnz:
                        iic = np.minimum(np.searchsorted(nz_set, cand),
                                         nnz - 1)
                        on_nz = nz_set[iic] == cand
                    gap_seeds = cand[~on_nz]
                    if len(gap_seeds):
                        # only positions inside existing blocks (the range
                        # walk skips non-existing blocks, cpp:331-339)
                        bsel = block_exists[block_of[gap_seeds]]
                        dels.append(gap_seeds[bsel])
                for ja, jb, wb, we, reached_end in ranges:
                    if reached_end and nnz:
                        # tail: last k-1 non-gap positions can't seed a k-mer
                        tail = nz[max(jb - (k - 2), 0) : jb + 1]
                        dels.append(tail)
                if edits.potential_dels:
                    dels.append(np.array(sorted(set(edits.potential_dels)), dtype=np.int64))
                for bid in edits.blocks_turned_off:
                    lo_s, hi_s = int(br[bid, 0]), int(br[bid, 1])
                    lo = int(np.searchsorted(p_pos, lo_s, side="left"))
                    hi = int(np.searchsorted(p_pos, hi_s, side="right"))
                    dels.append(p_pos[lo:hi])

            del_pos = (np.unique(np.concatenate(dels)) if dels
                       else np.empty(0, np.int64))
            del_pos = del_pos[(del_pos >= hms) & (del_pos <= hme)]

            # ---- merge: drop touched parent entries, insert scanned syncmers ----
            touched = np.unique(np.concatenate([pos_scan, del_pos]))
            if len(p_pos) and len(touched):
                ii = np.searchsorted(touched, p_pos)
                iic = np.minimum(ii, len(touched) - 1)
                keep = touched[iic] != p_pos
            else:
                keep = np.ones(len(p_pos), dtype=bool)
            add_pos = pos_scan[sync_scan]
            add_hash = hash_scan[sync_scan]
            add_rev = rev_scan[sync_scan]
            child_pos = np.concatenate([p_pos[keep], add_pos])
            child_hash = np.concatenate([p_hash[keep], add_hash])
            child_rev = np.concatenate([p_rev[keep], add_rev])
            order = np.argsort(child_pos, kind="stable")
            child_pos = child_pos[order]
            child_hash = child_hash[order]
            child_rev = child_rev[order]
            merge_info = (keep, add_pos)

        if counts_mode:
            # incremental path: running-table delta from affected windows
            # only; no full k-min-mer rebuild, no positioned arrays
            if merge_info is None:
                return (child_pos, child_hash, child_rev, _EMPTY_DELTA, [])
            rows, undo = _incremental_count_delta(
                p_pos, p_hash, p_rev, merge_info[0], merge_info[1],
                child_pos, child_hash, child_rev, k, l, run_counts)
            return (child_pos, child_hash, child_rev, rows, undo)

        if meta_mode:
            # incremental positioned path: splice the parent's k-min-mer
            # arrays, recomputing only the affected position ranges
            if merge_info is None:
                pk = parent_state[3]
                if edits.spans or edits.potential_dels \
                        or edits.blocks_turned_off:
                    # fully-masked genome (hms is None) with edits applied:
                    # seeds are preserved verbatim but the non-gap grid may
                    # have changed, so END scalars must refresh against the
                    # CURRENT nz (the full-rebuild oracle recomputes them);
                    # (pos, hash, rev) are unchanged -> delta stays empty
                    pk_pos = pk[0]
                    if len(pk_pos):
                        w = np.searchsorted(child_pos, pk_pos)
                        last = child_pos[np.minimum(
                            w + l - 1, len(child_pos) - 1)]
                        pk = (pk[0], pk[1], pk[2], _km_ends(last, nz, k))
                return (child_pos, child_hash, child_rev, pk, None)
            ck, delta = _incremental_meta_delta(
                p_pos, p_hash, p_rev, parent_state[3], merge_info[0],
                merge_info[1], child_pos, child_hash, child_rev, nz, k, l,
                want_delta=want_delta)
            return (child_pos, child_hash, child_rev, ck, delta)

        # ---- k-min-mers over the position-sorted syncmer list ----
        # (measured: the vectorized numpy recombine beats a scalar C++
        # port at genome scale — 0.36 vs 0.58 ms at 5k syncmers — so this
        # stays numpy; _count_delta below is where native wins 10x)
        km, valid, km_rev = kminmer_hashes_oriented(child_hash, k, l, child_rev)
        km_pos = child_pos[: len(km)][valid]
        # end = scalar of the last member syncmer's k-mer's LAST BASE
        # (seedInfos endPos, index_lite.capnp:28-29): the k-mer covers k
        # NON-GAP characters, so walk k-1 steps on the current node's
        # non-gap grid (nz), not in raw scalar arithmetic — gap columns
        # inside the terminal k-mer would otherwise shrink the recorded
        # span and miscount pseudochain rgaps.  Seeds preserved verbatim in
        # hard-masked flanks may sit off the current grid; those keep the
        # plain-arithmetic end (their creating node's grid is gone).
        last_start = child_pos[l - 1 : l - 1 + len(km)][valid]
        if len(last_start) and nnz:
            ii = np.searchsorted(nz, last_start)
            iic = np.minimum(ii, nnz - 1)
            on_grid = (nz[iic] == last_start) & (iic + k - 1 < nnz)
            km_end = np.where(on_grid, nz[np.minimum(iic + k - 1, nnz - 1)],
                              last_start + (k - 1))
        else:
            km_end = last_start + (k - 1)
        km_hash = km[valid]
        km_rev = km_rev[valid]
        uniq, counts = np.unique(km_hash, return_counts=True)
        return (child_pos, child_hash, child_rev, uniq, counts.astype(np.int64),
                km_hash, km_rev, km_pos, km_end)

    if dfs_range is not None:
        a, b = dfs_range
        end = subtree_ends(tree)

        def in_walk(node):
            i = node.dfs_index
            return i < b and end[i] > a

        def in_emit_range(i):
            return a <= i < b
    else:
        def in_walk(node):
            return True

        def in_emit_range(i):
            return True

    # iterative DFS with explicit state stack
    root = tree.root
    stack: list[_BuildFrame] = []
    undo_c, undo_b, edits = apply_node(root)
    if gap_emit is not None:
        gap_events(root.dfs_index, undo_c, undo_b)
    if state_probe is not None:
        state_probe(root.dfs_index, chars, block_exists, block_strand)
    root_tok = advance_seq_nz(None)  # first view: always a build
    if counts_mode:
        st5 = compute_state(_empty_state(), edits)
        root_state = st5[:3]
        emit_delta(root.dfs_index, st5[3], True)
        root_rcundo = st5[4]
    elif meta_mode:
        st5 = compute_state(_empty_meta_state(), edits,
                            want_delta=in_emit_range(root.dfs_index))
        root_state = st5[:4]
        emit_meta(root.dfs_index, st5[4], True)
        root_rcundo = None
    else:
        root_state = compute_state(_empty_state(), edits)
        emit(root.dfs_index, _empty_state(), root_state, True)
        root_rcundo = None
    stack.append(_BuildFrame(root, iter(root.children), undo_c, undo_b,
                             root_state, root_tok, root_rcundo))
    processed = 1

    while stack:
        frame = stack[-1]
        child = next(frame.child_iter, None)
        if child is None:
            undo_node(frame.undo_chars, frame.undo_blocks)
            retreat_seq_nz(frame.seqtok)
            if frame.rcundo:
                # counts mode: revert the running table (backtrackNode)
                for h, old in reversed(frame.rcundo):
                    if old:
                        run_counts[h] = old
                    else:
                        run_counts.pop(h, None)
            stack.pop()
            continue
        if not in_walk(child):
            continue
        undo_c, undo_b, edits = apply_node(child)
        if gap_emit is not None:
            gap_events(child.dfs_index, undo_c, undo_b)
        if state_probe is not None:
            state_probe(child.dfs_index, chars, block_exists, block_strand)
        tok = advance_seq_nz(simple_edits_of(child, undo_c))
        rcundo = None
        if not edits.spans and not edits.potential_dels and not edits.blocks_turned_off:
            state = frame.state
            if counts_mode:
                emit_delta(child.dfs_index, _EMPTY_DELTA, False)
            elif meta_mode:
                emit_meta(child.dfs_index, None, False)
            else:
                emit(child.dfs_index, frame.state, state, False)
        elif counts_mode:
            st5 = compute_state(frame.state, edits)
            state = st5[:3]
            emit_delta(child.dfs_index, st5[3], True)
            rcundo = st5[4]
        elif meta_mode:
            st5 = compute_state(frame.state, edits,
                                want_delta=in_emit_range(child.dfs_index))
            state = st5[:4]
            emit_meta(child.dfs_index, st5[4], True)
        else:
            state = compute_state(frame.state, edits)
            emit(child.dfs_index, frame.state, state, True)
        processed += 1
        if progress and processed % 2000 == 0:
            progress(processed, n_nodes)
        stack.append(_BuildFrame(child, iter(child.children), undo_c, undo_b,
                                 state, tok, rcundo))

    return identical, space


_EMPTY_DELTA = (np.empty(0, U64), np.empty(0, np.int16), np.empty(0, np.int16))


def _merged_affected_intervals(nw, members, bridges, l):
    """Merged [a, b] window-start intervals (inclusive) affected by changed
    member indices ([m-l+1, m]) and pure insertion/deletion boundaries
    (strictly-crossing windows, [b-l+1, b-1]).  Scalar loop for the typical
    few-edit case (numpy call overhead dominates below ~32 sites), numpy
    merge above it (the root node covers the whole genome)."""
    if nw <= 0:
        return []
    if len(members) + len(bridges) <= 32:
        iv = []
        for m in members.tolist():
            iv.append((m - (l - 1), m))
        if l > 1:
            for b in bridges.tolist():
                iv.append((b - (l - 1), b - 1))
        if not iv:
            return []
        iv.sort()
        merged = []
        for a, b in iv:
            a = max(a, 0)
            b = min(b, nw - 1)
            if a > b:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged
    members = np.asarray(members, dtype=np.int64)
    if l > 1 and len(bridges):
        bridges = np.asarray(bridges, dtype=np.int64)
        starts = np.concatenate([members - (l - 1), bridges - (l - 1)])
        ends = np.concatenate([members, bridges - 1])
    else:
        starts = members - (l - 1)
        ends = members.copy()
    if len(starts) == 0:
        return []
    # exact clamping of the scalar rule: floor starts at 0, cap ends at
    # nw-1, DROP inverted intervals — never widen coverage (counts mode
    # needs each side to cover exactly its own affected windows)
    np.maximum(starts, 0, out=starts)
    np.minimum(ends, nw - 1, out=ends)
    ok = starts <= ends
    starts, ends = starts[ok], ends[ok]
    if len(starts) == 0:
        return []
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    emax = np.maximum.accumulate(e)
    new = np.concatenate(([True], s[1:] > emax[:-1]))
    gi = np.flatnonzero(new)
    a_arr = s[gi]
    b_arr = np.maximum.reduceat(e, gi)
    return list(zip(a_arr.tolist(), b_arr.tolist()))


def _affected_window_counts(pos, hsh, rev, members, bridges, k, l):
    """Canonical k-min-mer hash -> count over the AFFECTED windows of one
    syncmer array: windows containing a changed member index, plus windows
    strictly crossing a pure insertion/deletion boundary.  Unaffected
    windows pair off 1:1 between parent and child (same consecutive
    surviving syncmers, same hashes), so the two sides' affected multisets
    differ by exactly the true count delta."""
    n = len(pos)
    nw = n - l + 1
    out: dict = {}
    for a, b in _merged_affected_intervals(nw, members, bridges, l):
        km, valid, _r = kminmer_hashes_oriented(
            hsh[a : b + l], k, l, rev[a : b + l])
        for h in km[valid].tolist():
            out[h] = out.get(h, 0) + 1
    return out


def _change_sites(p_pos, keep, add_pos, child_pos):
    """(dropped parent idx, added child idx, parent bridge idx, child bridge
    idx): the changed member indices per side plus the boundary insertion
    points of locations absent from that side (pure insertions bridge
    parent windows, pure deletions bridge child windows)."""
    dropped = np.flatnonzero(~keep)
    drop_pos = p_pos[dropped]
    if len(add_pos) and len(p_pos):
        ii = np.searchsorted(p_pos, add_pos)
        iic = np.minimum(ii, len(p_pos) - 1)
        pure_ins = add_pos[p_pos[iic] != add_pos]
        p_bridge = np.searchsorted(p_pos, pure_ins)
    else:
        p_bridge = np.zeros(len(add_pos), np.int64)
    if len(drop_pos) and len(child_pos):
        jj = np.searchsorted(child_pos, drop_pos)
        jjc = np.minimum(jj, len(child_pos) - 1)
        pure_del = drop_pos[child_pos[jjc] != drop_pos]
        c_bridge = np.searchsorted(child_pos, pure_del)
    elif len(drop_pos):
        c_bridge = np.zeros(len(drop_pos), np.int64)
    else:
        c_bridge = np.empty(0, np.int64)
    added_idx = (np.searchsorted(child_pos, add_pos) if len(add_pos)
                 else np.empty(0, np.int64))
    return dropped, added_idx, p_bridge, c_bridge


def _incremental_count_delta(p_pos, p_hash, p_rev, keep, add_pos,
                             child_pos, child_hash, child_rev, k, l, rc):
    """Counts-mode node delta: apply the affected-window count change to the
    running table ``rc`` and return (sorted delta rows, undo list).  The
    full-table `_count_delta` over complete per-node tables is the oracle
    (PANMAP_TPU_INCR=0 forces it; equality asserted by e2e)."""
    if (len(p_pos) - int(keep.sum())) == 0 and len(add_pos) == 0:
        return _EMPTY_DELTA, []
    if not os.environ.get("PANMAP_TPU_NO_NATIVE"):
        from ..native import incr_count_delta_native

        nat = incr_count_delta_native(p_pos, p_hash, p_rev, keep, add_pos,
                                      child_pos, child_hash, child_rev, k, l)
        if nat is not None:
            hh, dd = nat  # sorted by hash; python applies the running table
            if not len(hh):
                return _EMPTY_DELTA, []
            undo = []
            pp = np.empty(len(hh), np.int16)
            for i, (h, d) in enumerate(zip(hh.tolist(), dd.tolist())):
                o = rc.get(h, 0)
                rc[h] = o + d
                undo.append((h, o))
                pp[i] = o
            cc = pp + dd.astype(np.int16)
            return (hh, pp, cc), undo
    dropped, added_idx, p_bridge, c_bridge = _change_sites(
        p_pos, keep, add_pos, child_pos)

    old = _affected_window_counts(p_pos, p_hash, p_rev, dropped, p_bridge,
                                  k, l)
    new = _affected_window_counts(child_pos, child_hash, child_rev,
                                  added_idx, c_bridge, k, l)
    net = new
    for h, c in old.items():
        net[h] = net.get(h, 0) - c
    rows = []
    undo = []
    for h, d in net.items():
        if d == 0:
            continue
        o = rc.get(h, 0)
        rc[h] = o + d
        undo.append((h, o))
        rows.append((h, o, o + d))
    if not rows:
        return _EMPTY_DELTA, undo
    rows.sort()
    hh = np.fromiter((r[0] for r in rows), U64, len(rows))
    pp = np.fromiter((r[1] for r in rows), np.int64, len(rows)) \
        .astype(np.int16)
    cc = np.fromiter((r[2] for r in rows), np.int64, len(rows)) \
        .astype(np.int16)
    return (hh, pp, cc), undo


def _count_delta(parent_state, child_state):
    ph, pc = parent_state[3], parent_state[4]
    ch, cc = child_state[3], child_state[4]
    from ..native import count_delta_native

    nat = count_delta_native(ph, pc, ch, cc)
    if nat is not None:
        return nat
    allh = np.union1d(ph, ch)
    pcnt = np.zeros(len(allh), dtype=np.int64)
    if len(ph):
        ii = np.searchsorted(ph, allh)
        ok = (ii < len(ph)) & (ph[np.minimum(ii, len(ph) - 1)] == allh)
        pcnt[ok] = pc[ii[ok]]
    ccnt = np.zeros(len(allh), dtype=np.int64)
    if len(ch):
        ii = np.searchsorted(ch, allh)
        ok = (ii < len(ch)) & (ch[np.minimum(ii, len(ch) - 1)] == allh)
        ccnt[ok] = cc[ii[ok]]
    diff = pcnt != ccnt
    return allh[diff], pcnt[diff].astype(np.int16), ccnt[diff].astype(np.int16)


_EMPTY_META_DELTA = (np.empty(0, np.int64), np.empty(0, U64),
                     np.empty(0, bool), np.empty(0, bool),
                     np.empty(0, np.int64))


def _km_ends(last_start, nz, k):
    """End scalar of each k-min-mer (last member syncmer's k-mer's last
    base): walk k-1 steps on the non-gap grid when the start sits on it,
    plain arithmetic otherwise (compute_state's full-tail rule)."""
    nnz = len(nz)
    if len(last_start) and nnz:
        ii = np.searchsorted(nz, last_start)
        iic = np.minimum(ii, nnz - 1)
        on_grid = (nz[iic] == last_start) & (iic + k - 1 < nnz)
        return np.where(on_grid, nz[np.minimum(iic + k - 1, nnz - 1)],
                        last_start + (k - 1))
    return last_start + (k - 1)


def _positioned_diff(dp, dc):
    """Raw-array twin of meta.index._meta_node_delta (the oracle): diff two
    positioned (pos, hash, rev, end) row sets, deletions before additions
    at equal positions."""
    p_pos, p_hash, p_rev, p_end = dp
    c_pos, c_hash, c_rev, c_end = dc
    np_, nc = len(p_pos), len(c_pos)
    if np_ == 0 and nc == 0:
        return _EMPTY_META_DELTA
    if nc:
        ii = np.clip(np.searchsorted(c_pos, p_pos), 0, nc - 1)
        same_p = ((c_pos[ii] == p_pos) & (c_hash[ii] == p_hash)
                  & (c_rev[ii] == p_rev))
    else:
        same_p = np.zeros(np_, bool)
    if np_:
        jj = np.clip(np.searchsorted(p_pos, c_pos), 0, np_ - 1)
        same_c = ((p_pos[jj] == c_pos) & (p_hash[jj] == c_hash)
                  & (p_rev[jj] == c_rev))
    else:
        same_c = np.zeros(nc, bool)
    dm = ~same_p
    am = ~same_c
    pos = np.concatenate([p_pos[dm], c_pos[am]]).astype(np.int64)
    hsh = np.concatenate([p_hash[dm], c_hash[am]]).astype(np.uint64)
    rev = np.concatenate([p_rev[dm], c_rev[am]]).astype(bool)
    end = np.concatenate([p_end[dm], c_end[am]]).astype(np.int64)
    isdel = np.concatenate([np.ones(int(dm.sum()), bool),
                            np.zeros(int(am.sum()), bool)])
    order = np.lexsort((~isdel, pos))
    return pos[order], hsh[order], rev[order], isdel[order], end[order]


def _incremental_meta_delta(p_pos, p_hash, p_rev, pk, keep, add_pos,
                            c_pos, c_hash, c_rev, nz, k, l,
                            want_delta: bool = True):
    """Positioned-mode (meta) incremental step: splice the child's
    positioned k-min-mer arrays from the parent's (pk = (km_pos, km_hash,
    km_rev, km_end)) by recomputing only the AFFECTED position ranges, and
    return (child_km 4-tuple, delta rows).  The full-rebuild + full-diff
    path (meta.index._meta_node_delta over complete states) is the oracle
    (PANMAP_TPU_INCR=0).

    Soundness of splicing the ends: an unaffected k-min-mer's end can only
    change if the non-gap grid changed inside one of its member syncmers'
    k-mer spans — but any such change puts those syncmers inside the
    recompute window (the span expansion is exactly k-1 non-gap chars), so
    they are dropped-and-readded and the k-min-mer is AFFECTED."""
    pk_pos, pk_hash, pk_rev, pk_end = pk
    dropped, added_idx, p_bridge, c_bridge = _change_sites(
        p_pos, keep, add_pos, c_pos)
    if len(dropped) == 0 and len(add_pos) == 0:
        return pk, None
    p_iv = _merged_affected_intervals(len(p_pos) - l + 1, dropped, p_bridge,
                                      l)
    c_iv = _merged_affected_intervals(len(c_pos) - l + 1, added_idx,
                                      c_bridge, l)
    # union of affected POSITION ranges across both sides (window-start pos)
    ranges = ([(int(p_pos[a]), int(p_pos[b])) for a, b in p_iv]
              + [(int(c_pos[a]), int(c_pos[b])) for a, b in c_iv])
    if not ranges:
        return pk, None
    ranges.sort()
    mr = []
    for a, b in ranges:
        if mr and a <= mr[-1][1]:
            mr[-1][1] = max(mr[-1][1], b)
        else:
            mr.append([a, b])
    t0s = np.fromiter((r[0] for r in mr), np.int64, len(mr))
    t1s = np.fromiter((r[1] for r in mr), np.int64, len(mr))
    # parent rows inside the ranges: replaced (and diffed)
    if len(pk_pos):
        ri = np.searchsorted(t0s, pk_pos, side="right") - 1
        inr = (ri >= 0) & (pk_pos <= t1s[np.maximum(ri, 0)])
    else:
        inr = np.zeros(0, bool)
    # child windows whose start position falls in the ranges: recomputed
    new_pos = new_hash = new_rev = new_end = None
    if not os.environ.get("PANMAP_TPU_NO_NATIVE"):
        from ..native import meta_kminmers_native

        nat = meta_kminmers_native(c_pos, c_hash, c_rev, t0s, t1s, nz, k, l)
        if nat is not None:
            new_pos, new_hash, new_rev, new_end = nat
    if new_pos is None:
        parts_pos, parts_hash, parts_rev, parts_end = [], [], [], []
        nwc = len(c_pos) - l + 1
        for t0, t1 in zip(t0s.tolist(), t1s.tolist()):
            if nwc <= 0:
                break
            w0 = int(np.searchsorted(c_pos, t0, side="left"))
            w1 = min(int(np.searchsorted(c_pos, t1, side="right")) - 1,
                     nwc - 1)
            if w0 > w1:
                continue
            km, valid, kmr = kminmer_hashes_oriented(
                c_hash[w0 : w1 + l], k, l, c_rev[w0 : w1 + l])
            kpos = c_pos[w0 : w0 + len(km)][valid]
            last = c_pos[w0 + l - 1 : w0 + l - 1 + len(km)][valid]
            parts_pos.append(kpos)
            parts_hash.append(km[valid])
            parts_rev.append(kmr[valid])
            parts_end.append(_km_ends(last, nz, k))
        if parts_pos:
            new_pos = np.concatenate(parts_pos)
            new_hash = np.concatenate(parts_hash)
            new_rev = np.concatenate(parts_rev)
            new_end = np.concatenate(parts_end)
        else:
            new_pos = np.empty(0, np.int64)
            new_hash = np.empty(0, U64)
            new_rev = np.empty(0, bool)
            new_end = np.empty(0, np.int64)
    # child positioned arrays: unaffected parent rows + recomputed rows,
    # merged by position (ranges are disjoint and sorted, so the recomputed
    # block is itself position-sorted)
    keep_rows = ~inr
    ck_pos = np.concatenate([pk_pos[keep_rows], new_pos])
    order = np.argsort(ck_pos, kind="stable")
    ck = (ck_pos[order],
          np.concatenate([pk_hash[keep_rows], new_hash])[order],
          np.concatenate([pk_rev[keep_rows], new_rev])[order],
          np.concatenate([pk_end[keep_rows], new_end])[order])
    if not want_delta:
        # out-of-range node in a chunked-DFS worker: the spliced state is
        # needed (descendants may be in range) but its delta is discarded —
        # skip the diff (the root's diff is the whole genome)
        return ck, None
    delta = _positioned_diff(
        (pk_pos[inr], pk_hash[inr], pk_rev[inr], pk_end[inr]),
        (new_pos, new_hash, new_rev, new_end))
    return ck, delta


# fork-inherited worker context for build_index(workers > 1)
_PAR_CTX: dict = {}


def _use_incremental_counts() -> bool:
    import os

    return os.environ.get("PANMAP_TPU_INCR", "1") != "0"


def _build_range_worker(rng):
    a, b = rng
    tree = _PAR_CTX["tree"]
    params = _PAR_CTX["params"]
    deltas: dict = {}

    if _use_incremental_counts():
        def emit_delta(dfs_index, delta, changed):
            if a <= dfs_index < b:
                deltas[dfs_index] = delta

        identical, _ = run_dfs(tree, params, None, dfs_range=(a, b),
                               emit_delta=emit_delta)
    else:
        def emit(dfs_index, parent_state, child_state, changed):
            if a <= dfs_index < b:
                deltas[dfs_index] = (
                    _EMPTY_DELTA if not changed
                    else _count_delta(parent_state, child_state))

        identical, _ = run_dfs(tree, params, emit, dfs_range=(a, b))
    hh = np.concatenate([deltas[i][0] for i in range(a, b)]) if b > a else np.empty(0, U64)
    pp = np.concatenate([deltas[i][1] for i in range(a, b)]) if b > a else np.empty(0, np.int16)
    cc = np.concatenate([deltas[i][2] for i in range(a, b)]) if b > a else np.empty(0, np.int16)
    sizes = np.array([len(deltas[i][0]) for i in range(a, b)], dtype=np.int64)
    return a, hh, pp, cc, sizes, identical[a:b]


def build_index(tree: PanmanTree, params: IndexParams | None = None,
                progress=None, workers: int = 0) -> IndexArrays:
    params = params or IndexParams()
    n_nodes = len(tree.dfs_order)
    if workers and workers > 1 and n_nodes > workers:
        return _build_index_parallel(tree, params, workers)
    node_deltas: list[tuple | None] = [None] * n_nodes
    empty_delta = _EMPTY_DELTA
    count_delta = _count_delta

    if _use_incremental_counts():
        def emit_delta(dfs_index, delta, changed):
            node_deltas[dfs_index] = delta

        identical, space = run_dfs(tree, params, None, progress,
                                   emit_delta=emit_delta)
    else:
        # full-table oracle path (PANMAP_TPU_INCR=0): per-node complete
        # count tables diffed by _count_delta
        def emit(dfs_index, parent_state, child_state, changed):
            if not changed:
                node_deltas[dfs_index] = empty_delta
            else:
                node_deltas[dfs_index] = count_delta(parent_state, child_state)

        identical, space = run_dfs(tree, params, emit, progress)

    # flatten per-node deltas (already hash-sorted from union1d)
    total = sum(len(d[0]) for d in node_deltas)
    seed_hashes = np.empty(total, dtype=U64)
    parent_counts = np.empty(total, dtype=np.int16)
    child_counts = np.empty(total, dtype=np.int16)
    node_offsets = np.zeros(n_nodes + 1, dtype=np.uint64)
    off = 0
    for i, d in enumerate(node_deltas):
        node_offsets[i] = off
        hh, pp, cc = d
        seed_hashes[off : off + len(hh)] = hh
        parent_counts[off : off + len(hh)] = pp
        child_counts[off : off + len(hh)] = cc
        off += len(hh)
    node_offsets[n_nodes] = off

    parent_index = np.zeros(n_nodes, dtype=np.uint32)
    for node in tree.dfs_order:
        parent_index[node.dfs_index] = node.parent.dfs_index if node.parent else 0

    return IndexArrays(
        params=params,
        node_ids=[n.identifier for n in tree.dfs_order],
        parent_index=parent_index,
        identical_to_parent=identical,
        block_ranges=space.block_ranges,
        seed_hashes=seed_hashes,
        parent_counts=parent_counts,
        child_counts=child_counts,
        node_offsets=node_offsets,
        substitution_matrix=compute_substitution_spectrum(tree),
    )


def _build_index_parallel(tree: PanmanTree, params: IndexParams,
                          workers: int) -> IndexArrays:
    """Chunked-DFS parallel build (index_single_mode.cpp:2291-2571): the DFS
    order is split into contiguous ranges; each forked worker prunes to the
    subtrees intersecting its range (ancestor paths are replayed for exact
    state, emission happens only inside the range)."""
    import multiprocessing as mp

    n_nodes = len(tree.dfs_order)
    # one contiguous range per worker (finer chunks were measured SLOWER:
    # each extra chunk pays an ancestor-path replay that outweighs the
    # load-balance win on these trees)
    bounds = np.linspace(0, n_nodes, workers + 1).astype(np.int64)
    ranges = [(int(bounds[i]), int(bounds[i + 1])) for i in range(workers)
              if bounds[i] < bounds[i + 1]]

    _PAR_CTX["tree"] = tree
    _PAR_CTX["params"] = params
    try:
        ctx = mp.get_context("fork")
        with ctx.Pool(len(ranges)) as pool:
            fut = pool.map_async(_build_range_worker, ranges)
            # the serial substitution-spectrum pass (~3 s on sars_20000)
            # rides inside the workers' wall time instead of after it
            spectrum = compute_substitution_spectrum(tree)
            results = fut.get()
    finally:
        _PAR_CTX.clear()

    results.sort(key=lambda r: r[0])
    seed_hashes = np.concatenate([r[1] for r in results])
    parent_counts = np.concatenate([r[2] for r in results])
    child_counts = np.concatenate([r[3] for r in results])
    sizes = np.concatenate([r[4] for r in results])
    identical = np.concatenate([r[5] for r in results])
    node_offsets = np.zeros(n_nodes + 1, dtype=np.uint64)
    node_offsets[1:] = np.cumsum(sizes)

    parent_index = np.zeros(n_nodes, dtype=np.uint32)
    for node in tree.dfs_order:
        parent_index[node.dfs_index] = node.parent.dfs_index if node.parent else 0

    space = ScalarSpace(tree)
    return IndexArrays(
        params=params,
        node_ids=[n.identifier for n in tree.dfs_order],
        parent_index=parent_index,
        identical_to_parent=identical,
        block_ranges=space.block_ranges,
        seed_hashes=seed_hashes,
        parent_counts=parent_counts,
        child_counts=child_counts,
        node_offsets=node_offsets,
        substitution_matrix=spectrum,
    )


_CANONICAL = {ord(c) for c in "ATCG"}


def _canonical_to_amb(old: int, new: int) -> bool:
    return (
        new != GAP and new != ord("x") and old in _CANONICAL and new not in _CANONICAL
    )


_NUC_IDX = {ord("A"): 0, ord("C"): 1, ord("G"): 2, ord("T"): 3}


def compute_substitution_spectrum(tree: PanmanTree) -> np.ndarray:
    """4x4 substitution rate matrix from tree mutations
    (index_single_mode.cpp:1408-1558)."""
    space = ScalarSpace(tree)
    chars = space.char0.copy()
    block_exists = np.zeros(space.nb, dtype=bool)
    sub_counts = np.zeros((4, 4), dtype=np.int64)
    n_branches = 0

    # NS=0 / NSNPS=3 are substitutions (panman NucMutationType)
    node_iter = [(tree.root, iter(tree.root.children))]
    undo_stack = []

    def apply(node, count_subs):
        nonlocal n_branches
        undo_c = []
        undo_b = []
        for bm in node.block_mutations:
            undo_b.append((bm.block_id, bool(block_exists[bm.block_id])))
            if bm.is_insertion:
                block_exists[bm.block_id] = True
            elif not bm.is_inversion:
                block_exists[bm.block_id] = False
        if count_subs:
            n_branches += 1
        for nm in node.nuc_mutations:
            blen = space.block_len[nm.block_id]
            # spectrum pass skips only out-of-range, not the sentinel (cpp:1445)
            for i in range(nm.length):
                if nm.nuc_gap_position == -1:
                    npos, gpos = nm.nuc_position + i, -1
                else:
                    npos, gpos = nm.nuc_position, nm.nuc_gap_position + i
                if npos >= blen:
                    continue
                sc = space.scalar_of(nm.block_id, npos, gpos)
                if sc < 0:
                    continue
                old = int(chars[sc])
                new = int(NUC_CODE_BYTE[nm.codes[i]])
                undo_c.append((sc, old))
                chars[sc] = new
                if count_subs and nm.mut_type in (0, 3) and block_exists[nm.block_id]:
                    oi = _NUC_IDX.get(old, -1)
                    ni = _NUC_IDX.get(new, -1)
                    if oi >= 0 and ni >= 0 and oi != ni:
                        sub_counts[oi][ni] += 1
        return undo_c, undo_b

    while node_iter:
        node, it = node_iter[-1]
        if len(undo_stack) < len(node_iter):
            undo_stack.append(apply(node, node is not tree.root))
        child = next(it, None)
        if child is None:
            uc, ub = undo_stack.pop()
            for sc, old in reversed(uc):
                chars[sc] = old
            for bid, ex in reversed(ub):
                block_exists[bid] = ex
            node_iter.pop()
            continue
        node_iter.append((child, iter(child.children)))

    # median genome length over up to 10 evenly spaced leaves
    leaves = [n for n in tree.dfs_order if not n.children]
    lengths = []
    if leaves:
        step = max(1, len(leaves) // min(10, len(leaves)))
        for i in range(0, len(leaves), step):
            if len(lengths) >= 10:
                break
            lengths.append(len(tree.get_string(leaves[i].identifier)))
    genome_len = sorted(lengths)[len(lengths) // 2] if lengths else 0

    mat = np.zeros(16)
    total = sub_counts.sum() - np.trace(sub_counts)
    if n_branches > 0 and genome_len > 0 and total >= 0:
        base_count = genome_len // 4
        for frm in range(4):
            off_diag = 0.0
            for to in range(4):
                if frm != to and base_count > 0:
                    rate = sub_counts[frm][to] / (n_branches * base_count)
                    mat[frm * 4 + to] = rate
                    off_diag += rate
            mat[frm * 4 + frm] = 1.0 - off_diag
    else:
        mat[[0, 5, 10, 15]] = 1.0
    return mat
