"""PanMAN file reader: lzma-compressed Cap'n Proto pangenome trees.

Schema reverse-engineered from the wire format of TurakhiaLab/panman v0.1.4 files
(the reference consumes them via the panman library; see
src/main.cpp:313-325 `loadPanMAN` and the consumer API usage in
src/panmap_utils.hpp:229-279 `BlockSequences`).

Wire layout (validated against examples/expected/single_sample/isolate.ref.fa):

  TreeGroup: struct{ptrs: [List(Tree), List(ComplexMutation)]}
  Tree:      struct{ptrs: [newick Text, List(Node), List(ConsensusSeqToBlockIds),
                           List(GapList), blockGaps, circular, rotation, inverted, ...]}
  Node:      struct{ptrs: [List(Mutation), List(Text) annotations]}
  Mutation:  struct{data: blockId i64 @0; flags byte8: bit0=blockGapExist,
                    bit1=blockMutExist, bit2=blockMutInfo(insertion), bit3=blockInversion;
                    ptrs: [List(NucMut)]}
  NucMut:    struct{data 2w: nucPosition i32 @0, nucGapPosition i32 @4,
                    (unused u32 @8), packed u32 @12 = mutInfo u8 | nuc nibbles}
  ConsensusSeqToBlockIds: struct{ptrs: [List(u64) blockIds, List(u32) nibble-packed
                    consensus, List(bool) blockGapExist]}
  GapList:   struct{data: blockId i64; ptrs: [List(i32) nucPosition, List(i32) nucGapLength]}

Nucleotide codes are one-hot IUPAC (A=1,C=2,G=4,T=8; combinations = ambiguity codes;
0 terminates a consensus block / encodes '-' in mutations), decoded identically to
panman's getNucleotideFromCode as used throughout the reference.
"""

from __future__ import annotations

import lzma
from dataclasses import dataclass

import numpy as np

from .capnp import CapnpMessage

# code -> nucleotide character (index = 4-bit one-hot/IUPAC code)
NUC_FROM_CODE = np.frombuffer(b"-ACMGRSVTWYHKDBN", dtype="S1")
NUC_CODE_BYTE = NUC_FROM_CODE.view(np.uint8)  # same table as raw byte values
_COMP = {
    "A": "T", "T": "A", "C": "G", "G": "C",
    "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
    "B": "V", "V": "B", "D": "H", "H": "D", "N": "N", "-": "-", "x": "x",
}
COMP_TABLE = bytes(
    ord(_COMP.get(chr(c), "N")) if chr(c) in _COMP else c for c in range(256)
)


def nuc_from_code(code: int) -> str:
    return NUC_FROM_CODE[code].decode()


@dataclass
class NucMutation:
    """One nucleotide mutation record (1..6 bases)."""

    block_id: int
    nuc_position: int
    nuc_gap_position: int  # -1 when targeting the main nucleotide
    length: int
    codes: tuple  # new nucleotide codes, one per offset
    mut_type: int = 0  # panman NucMutationType (NS=0/ND=1/NI=2/NSNPS=3/...)


@dataclass
class BlockMutation:
    block_id: int
    is_insertion: bool  # blockMutInfo
    is_inversion: bool


class PanmanNode:
    """Tree node.  Nucleotide mutations are stored as flat numpy columns
    (nm_block/nm_pos/nm_gap/nm_packed, decoded vectorized at load); the
    `nuc_mutations` object list is materialized lazily for consumers that
    want per-record access (index builder)."""

    __slots__ = ("identifier", "parent", "children", "branch_length",
                 "block_mutations", "annotations", "dfs_index",
                 "nm_block", "nm_pos", "nm_gap", "nm_packed", "_nm_objs")

    def __init__(self, identifier: str, parent: "PanmanNode | None" = None):
        self.identifier = identifier
        self.parent = parent
        self.children: list = []
        self.branch_length = 0.0
        self.block_mutations: list = []
        self.annotations: list = []
        self.dfs_index = -1
        self.nm_block = _EMPTY_I64
        self.nm_pos = _EMPTY_I32
        self.nm_gap = _EMPTY_I32
        self.nm_packed = _EMPTY_U32
        self._nm_objs = None

    @property
    def nuc_mutations(self) -> list:
        if self._nm_objs is None:
            objs = []
            for bid, pos, gap, packed in zip(
                    self.nm_block.tolist(), self.nm_pos.tolist(),
                    self.nm_gap.tolist(), self.nm_packed.tolist()):
                mut_info = packed & 0xFF
                length = mut_info >> 4
                codes = tuple((packed >> (8 + 4 * (length - 1 - i))) & 0xF
                              for i in range(length))
                objs.append(NucMutation(
                    block_id=bid, nuc_position=pos, nuc_gap_position=gap,
                    length=length, codes=codes, mut_type=mut_info & 0x7))
            self._nm_objs = objs
        return self._nm_objs

    def set_nuc_mutation_arrays(self, block, pos, gap, packed):
        self.nm_block, self.nm_pos = block, pos
        self.nm_gap, self.nm_packed = gap, packed
        self._nm_objs = None


_EMPTY_I64 = np.empty(0, np.int64)
_EMPTY_I32 = np.empty(0, np.int32)
_EMPTY_U32 = np.empty(0, np.uint32)


@dataclass
class Block:
    block_id: int
    consensus_codes: np.ndarray  # uint8 nucleotide codes (1..15), 0-terminator stripped


@dataclass
class GapList:
    block_id: int
    nuc_positions: np.ndarray
    nuc_gap_lengths: np.ndarray


class PanmanTree:
    """One tree of a PanMAN: topology + blocks + gaps + per-node mutations."""

    def __init__(self):
        self.root: PanmanNode | None = None
        self.all_nodes: dict[str, PanmanNode] = {}
        self.dfs_order: list[PanmanNode] = []
        self.blocks: list[Block] = []
        self.gaps: list[GapList] = []
        self.newick: str = ""

    # ------------------------------------------------------------------
    # Materialization (mirrors panmap_utils.cpp:7-190 getStringFromReference)
    # ------------------------------------------------------------------
    def path_from_root(self, identifier: str) -> list[PanmanNode]:
        node = self.all_nodes[identifier]
        path = []
        while node is not None:
            path.append(node)
            node = node.parent
        path.reverse()
        return path

    def get_string(self, identifier: str, aligned: bool = False) -> str:
        """Materialize a node's sequence (ungapped unless aligned=True)."""
        path = self.path_from_root(identifier)

        nblocks = len(self.blocks)
        # final block presence along the path (panmap_utils.cpp:29-43)
        block_on = np.zeros(nblocks + 1, dtype=bool)
        for node in path:
            for bm in node.block_mutations:
                if bm.is_insertion:
                    block_on[bm.block_id] = True
                elif not bm.is_inversion:
                    block_on[bm.block_id] = False

        # main-sequence chars per block (consensus + 'x' sentinel), gap arrays
        main: list[np.ndarray | None] = [None] * nblocks
        gaps_per_pos: list[dict | None] = [None] * nblocks
        for b in self.blocks:
            if block_on[b.block_id]:
                arr = np.concatenate(
                    [NUC_FROM_CODE[b.consensus_codes], np.frombuffer(b"x", dtype="S1")]
                ).copy()
                main[b.block_id] = arr
                gaps_per_pos[b.block_id] = {}
        for g in self.gaps:
            if block_on[g.block_id] and gaps_per_pos[g.block_id] is not None:
                gp = gaps_per_pos[g.block_id]
                for pos, ln in zip(g.nuc_positions.tolist(), g.nuc_gap_lengths.tolist()):
                    gp[int(pos)] = np.full(int(ln), b"-", dtype="S1")

        block_exists = np.zeros(nblocks, dtype=bool)
        block_strand = np.ones(nblocks, dtype=bool)

        for node in path:
            for bm in node.block_mutations:
                bid = bm.block_id
                if not block_on[bid]:
                    continue
                if bm.is_insertion:
                    block_exists[bid] = True
                    block_strand[bid] = not bm.is_inversion
                elif bm.is_inversion:
                    block_strand[bid] = not block_strand[bid]
                else:
                    block_exists[bid] = False
                    block_strand[bid] = True
            for bid, pos0, gapp, packed in zip(
                    node.nm_block.tolist(), node.nm_pos.tolist(),
                    node.nm_gap.tolist(), node.nm_packed.tolist()):
                if not block_on[bid] or main[bid] is None:
                    continue
                seq = main[bid]
                blen = len(seq)
                length = (packed & 0xFF) >> 4
                for i in range(length):
                    code = (packed >> (8 + 4 * (length - 1 - i))) & 0xF
                    if gapp == -1:
                        pos = pos0 + i
                        # skip sentinel & out-of-range (panmap_utils.cpp:121-125)
                        if pos >= blen - 1:
                            continue
                        seq[pos] = NUC_FROM_CODE[code]
                    else:
                        if pos0 >= blen:
                            continue
                        garr = gaps_per_pos[bid].get(pos0)
                        gpos = gapp + i
                        if garr is None or gpos >= len(garr):
                            continue
                        garr[gpos] = NUC_FROM_CODE[code]

        out = []
        for bid in range(nblocks):
            if not block_exists[bid]:
                if aligned and main[bid] is not None:
                    # inactive-but-decoded blocks contribute '-' runs in aligned mode
                    out.append(b"-" * (len(main[bid]) - 1))
                continue
            seq = main[bid]
            gp = gaps_per_pos[bid] or {}
            parts = []
            for pos in range(len(seq)):
                if pos in gp:
                    parts.append(gp[pos].tobytes())
                parts.append(seq[pos].tobytes())
            s = b"".join(parts)
            if block_strand[bid]:
                if aligned:
                    out.append(s.replace(b"x", b""))
                else:
                    out.append(s.replace(b"-", b"").replace(b"x", b""))
            else:
                rc = s.translate(COMP_TABLE)[::-1]
                if aligned:
                    out.append(rc.replace(b"x", b""))
                else:
                    out.append(rc.replace(b"-", b"").replace(b"x", b""))
        return b"".join(out).decode()


# ----------------------------------------------------------------------
# Newick parsing (names, including internal labels, are stored verbatim)
# ----------------------------------------------------------------------
def parse_newick(newick: str) -> PanmanNode:
    """Parse a newick string into PanmanNode topology (preorder dfs matches the
    capnp nodes list order used by the panman writer)."""
    s = newick.strip()
    if s.endswith(";"):
        s = s[:-1]
    pos = 0

    def parse_node(parent):
        nonlocal pos
        node = PanmanNode(identifier="", parent=parent)
        if pos < len(s) and s[pos] == "(":
            pos += 1
            while True:
                child = parse_node(node)
                node.children.append(child)
                if pos < len(s) and s[pos] == ",":
                    pos += 1
                    continue
                break
            assert s[pos] == ")", f"newick parse error at {pos}"
            pos += 1
        # label
        start = pos
        while pos < len(s) and s[pos] not in ",():;":
            pos += 1
        node.identifier = s[start:pos]
        if pos < len(s) and s[pos] == ":":
            pos += 1
            start = pos
            while pos < len(s) and s[pos] not in ",()":
                pos += 1
            node.branch_length = float(s[start:pos])
        return node

    root = parse_node(None)
    assert pos == len(s), f"trailing newick content at {pos}"
    return root


def _decode_consensus(words: np.ndarray) -> np.ndarray:
    """Unpack 8 4-bit codes per u32 (big-nibble-first), stop at first 0 code."""
    w = words.astype(np.uint32)
    shifts = np.arange(7, -1, -1, dtype=np.uint32) * 4
    codes = ((w[:, None] >> shifts[None, :]) & 0xF).astype(np.uint8).reshape(-1)
    zeros = np.flatnonzero(codes == 0)
    if len(zeros):
        codes = codes[: zeros[0]]
    return codes


def _decode_mutations_scalar(nodes, order) -> None:
    """Reference decode path: per-record pointer walk (oracle for the
    vectorized decoder; also the fallback for layouts it rejects)."""
    for i, node in enumerate(order):
        nrec = nodes.struct(i)
        muts = nrec.ptr(0)
        node.block_mutations = []
        blocks, poss, gaps, packeds = [], [], [], []
        if muts is not None:
            for m in muts.structs():
                # blockId packs (primaryBlockId << 32 | secondary); secondary
                # is retired in panmap (always 0/none), keep the primary
                block_id = m.i64(0) >> 32
                flags = m.u8(8)
                if flags & 2:  # blockMutExist
                    node.block_mutations.append(
                        BlockMutation(
                            block_id=block_id,
                            is_insertion=bool(flags & 4),
                            is_inversion=bool(flags & 8),
                        )
                    )
                nm_list = m.ptr(0)
                if nm_list is not None:
                    for s in nm_list.structs():
                        blocks.append(block_id)
                        poss.append(s.i32(0))
                        gaps.append(s.i32(4) if (s.u8(8) & 1) else -1)
                        packeds.append(s.u32(12))
        node.set_nuc_mutation_arrays(
            np.asarray(blocks, np.int64), np.asarray(poss, np.int32),
            np.asarray(gaps, np.int32), np.asarray(packeds, np.uint32))


def _resolve_list_ptrs(seg_u32, pseg, pword):
    """Vectorized resolve of capnp list pointers located at word (pseg[i],
    pword[i]).  Handles intra-segment pointers and single-word far pointers.
    Returns (tseg, tag_word, empty) where tag_word indexes the composite
    list's tag word, or None when a layout outside the panman writer's
    repertoire shows up (two-word landing pads, non-composite lists)."""
    n = len(pword)
    tseg = np.asarray(pseg, np.int64).copy()
    pw = np.asarray(pword, np.int64).copy()
    plo = np.empty(n, np.int64)
    phi = np.empty(n, np.int64)
    for s in np.unique(tseg):
        m = tseg == s
        su = seg_u32[s]
        plo[m] = su[pw[m] * 2]
        phi[m] = su[pw[m] * 2 + 1]
    empty = (plo | phi) == 0
    kind = plo & 3
    if np.any(~empty & (kind != 1) & (kind != 2)):
        return None
    far = ~empty & (kind == 2)
    if np.any(far):
        if np.any((plo[far] >> 2) & 1):  # two-word landing pad
            return None
        fseg = phi[far] & 0xFFFFFFFF
        fword = (plo[far] >> 3) & 0x1FFFFFFF
        tseg[far] = fseg
        pw[far] = fword
        plo2 = np.empty(int(far.sum()), np.int64)
        phi2 = np.empty(int(far.sum()), np.int64)
        for s in np.unique(fseg):
            m2 = fseg == s
            su = seg_u32[s]
            plo2[m2] = su[fword[m2] * 2]
            phi2[m2] = su[fword[m2] * 2 + 1]
        if np.any((plo2 & 3) != 1):  # pad must be a direct list pointer
            return None
        plo[far] = plo2
        phi[far] = phi2
    if np.any((phi[~empty] & 7) != 7):  # composite lists only
        return None
    off = ((plo >> 2) | ((phi & 0x3FFFFFFF) << 30)) & 0x3FFFFFFF
    off = off - ((off & 0x20000000) << 1)
    tag_word = pw + 1 + off
    return tseg, tag_word, empty


def _decode_mutations_fast(msg, nodes, order) -> bool:
    """Vectorized mutation decode: gathers every Mutation record and NucMut
    row across all nodes with numpy segment views instead of per-field
    pointer walks (_decode_mutations_scalar is its oracle/fallback).
    Returns False — leaving nodes untouched — when the wire layout deviates
    from what the panman writers emit."""
    n_nodes = len(order)
    seg_u32 = [np.frombuffer(s, "<u4") for s in msg.segments]
    # phase 1: per node, locate the Mutation list region (cheap pointer walk)
    rseg = np.zeros(n_nodes, np.int64)
    rstart = np.zeros(n_nodes, np.int64)  # first element word
    rcount = np.zeros(n_nodes, np.int64)
    mdw = mstride = 0  # Mutation struct layout, must be uniform
    for i in range(n_nodes):
        muts = nodes.struct(i).ptr(0)
        if muts is None or muts.count == 0:
            continue
        # layout: blockId i64 @0, flags u8 @8, NucMut list = first pointer;
        # data-word count varies by writer version — require uniformity
        if muts.esize != 7 or muts._tag_dw < 2 or muts._tag_pw < 1:
            return False
        if mdw == 0:
            mdw, mstride = muts._tag_dw, muts._tag_dw + muts._tag_pw
        elif (muts._tag_dw, muts._tag_dw + muts._tag_pw) != (mdw, mstride):
            return False
        rseg[i] = muts.seg
        rstart[i] = muts.woff + 1
        rcount[i] = muts.count
    total = int(rcount.sum())
    if total == 0:
        for node in order:
            node.set_nuc_mutation_arrays(_EMPTY_I64, _EMPTY_I32, _EMPTY_I32,
                                         _EMPTY_U32)
        return True
    # phase 2: expand to per-record word indices; read blockId/flags and
    # resolve each record's NucMut list pointer
    rec_node = np.repeat(np.arange(n_nodes), rcount)
    csum = np.concatenate(([0], np.cumsum(rcount)))
    within = np.arange(total) - np.repeat(csum[:-1], rcount)
    rec_seg = np.repeat(rseg, rcount)
    rec_word = np.repeat(rstart, rcount) + mstride * within
    rec_block = np.empty(total, np.int64)   # primary block id
    rec_flags = np.empty(total, np.int64)
    for s in np.unique(rec_seg):
        m = rec_seg == s
        su = seg_u32[s]
        rw = rec_word[m]
        rec_block[m] = su[rw * 2 + 1].astype(np.int32)  # high word of i64
        rec_flags[m] = su[rw * 2 + 2] & 0xFF
    res = _resolve_list_ptrs(seg_u32, rec_seg, rec_word + mdw)
    if res is None:
        return False
    nm_seg, tag_word, empty = res
    # read composite tags: element count + stride
    nm_count = np.zeros(total, np.int64)
    nm_target = np.zeros(total, np.int64)
    nmstride = 0                            # NucMut stride, must be uniform
    live0 = ~empty
    for s in np.unique(nm_seg[live0]):
        m = live0 & (nm_seg == s)
        su = seg_u32[s]
        tw = tag_word[m]
        tlo = su[tw * 2].astype(np.int64)
        thi = su[tw * 2 + 1].astype(np.int64)
        cnt = (tlo >> 2) & 0x3FFFFFFF
        strides = (thi & 0xFFFF) + ((thi >> 16) & 0xFFFF)
        live = cnt > 0
        # NucMut: pos i32 @0, gapPos i32 @4, gapExist u8 @8, packed u32 @12
        if np.any((thi[live] & 0xFFFF) < 2):
            return False
        ustr = np.unique(strides[live])
        if len(ustr) > 1:
            return False
        if len(ustr):
            if nmstride and nmstride != int(ustr[0]):
                return False
            nmstride = int(ustr[0])
        nm_count[m] = np.where(live, cnt, 0)
        nm_target[m] = np.where(live, tw + 1, 0)
    # phase 3: gather all NucMut rows
    if nmstride == 0:
        nmstride = 2
    nm_total = int(nm_count.sum())
    nm_node = np.repeat(rec_node, nm_count)
    nm_blockv = np.repeat(rec_block, nm_count)
    ncsum = np.concatenate(([0], np.cumsum(nm_count)))
    nwithin = np.arange(nm_total) - np.repeat(ncsum[:-1], nm_count)
    row_word = np.repeat(nm_target, nm_count) + nmstride * nwithin
    row_seg = np.repeat(nm_seg, nm_count)
    nm_pos = np.empty(nm_total, np.int32)
    nm_gapraw = np.empty(nm_total, np.int32)
    nm_ge = np.empty(nm_total, bool)
    nm_packed = np.empty(nm_total, np.uint32)
    for s in np.unique(row_seg):
        m = row_seg == s
        su = seg_u32[s]
        rw = row_word[m]
        nm_pos[m] = su[rw * 2].astype(np.int32)
        nm_gapraw[m] = su[rw * 2 + 1].astype(np.int32)
        nm_ge[m] = (su[(rw + 1) * 2] & 1).astype(bool)
        nm_packed[m] = su[(rw + 1) * 2 + 1]
    nm_gap = np.where(nm_ge, nm_gapraw, np.int32(-1)).astype(np.int32)
    # per-node assignment (records and rows are already in node order)
    node_counts = np.bincount(nm_node, minlength=n_nodes)
    noff = np.concatenate(([0], np.cumsum(node_counts)))
    for i, node in enumerate(order):
        a, b = int(noff[i]), int(noff[i + 1])
        node.set_nuc_mutation_arrays(nm_blockv[a:b], nm_pos[a:b],
                                     nm_gap[a:b], nm_packed[a:b])
    # block mutations (few; objects are fine)
    for node in order:
        node.block_mutations = []
    bm = np.flatnonzero(rec_flags & 2)
    for r in bm.tolist():
        f = int(rec_flags[r])
        order[int(rec_node[r])].block_mutations.append(
            BlockMutation(block_id=int(rec_block[r]),
                          is_insertion=bool(f & 4),
                          is_inversion=bool(f & 8)))
    return True


def load_panman(path: str, tree_index: int = 0) -> PanmanTree:
    with lzma.open(path, "rb") as fh:
        data = fh.read()
    msg = CapnpMessage(data)
    tg = msg.root()
    trees = tg.ptr(0)
    t = trees.struct(tree_index)

    tree = PanmanTree()
    tree.newick = t.text(0)
    tree.root = parse_newick(tree.newick)

    # preorder DFS; must match writer's node order
    stack = [tree.root]
    order = []
    while stack:
        node = stack.pop()
        node.dfs_index = len(order)
        order.append(node)
        tree.all_nodes[node.identifier] = node
        stack.extend(reversed(node.children))
    tree.dfs_order = order

    # The writer emits one record per node in DFS preorder plus one trailing empty
    # record (observed in every v0.1.4 file; the extra record carries no mutations).
    nodes = t.ptr(1)
    assert len(nodes) in (len(order), len(order) + 1), (
        f"{len(nodes)} capnp nodes vs {len(order)} newick nodes"
    )
    if not _decode_mutations_fast(msg, nodes, order):
        _decode_mutations_scalar(nodes, order)
    for i, node in enumerate(order):
        nrec = nodes.struct(i)
        ann = nrec.ptr(1)
        if ann is not None and ann.count:
            for j in range(ann.count):
                p = ann.ptr(j)
                if p is not None:
                    raw = bytes(p.raw_bytes())
                    node.annotations.append(raw[:-1].decode() if raw else "")

    # consensus blocks
    cmap = t.ptr(2)
    blocks: dict[int, Block] = {}
    if cmap is not None:
        for e in cmap.structs():
            block_ids = e.ptr(0).as_numpy("<u8") >> np.uint64(32)
            codes = _decode_consensus(e.ptr(1).as_numpy("<u4"))
            for bid in block_ids.tolist():
                blocks[int(bid)] = Block(block_id=int(bid), consensus_codes=codes)
    tree.blocks = [blocks[k] for k in sorted(blocks)]

    gaps = t.ptr(3)
    if gaps is not None and gaps.count:
        for g in gaps.structs():
            bid = g.i64(0) >> 32
            # wire order: ptr0 = nucGapLength, ptr1 = nucPosition
            lenl = g.ptr(0)
            posl = g.ptr(1)
            tree.gaps.append(
                GapList(
                    block_id=bid,
                    nuc_positions=posl.as_numpy("<i4") if posl is not None else np.empty(0, "<i4"),
                    nuc_gap_lengths=lenl.as_numpy("<i4") if lenl is not None else np.empty(0, "<i4"),
                )
            )
    return tree
