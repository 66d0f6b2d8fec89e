"""Frozen copy of the PanMAN tree model and writer that the benchmark
makes its trees with.

Copied from panmap_tpu_torch/synthetic.py (deep_preorder_parents, the
PanMAN constants, pack_nuc_mut, PanmanModel, write_panman,
make_panman_model) and panmap_tpu_torch/io/refidx.py (_CapnpEncoder, less
f64_list), as of commit 3519e45, so that a later change to the program
cannot change the benchmark's inputs.  It imports nothing of the program.
"""

from __future__ import annotations

import lzma
import random
import struct
from dataclasses import dataclass

import numpy as np


class _CapnpEncoder:
    """Minimal single-segment Cap'n Proto encoder (exactly the subset the
    LiteIndex schema needs) — the writer half of the interop story: an index
    built HERE can be handed to reference-binary users."""

    def __init__(self):
        self.words = [0]  # word 0 = root pointer

    def alloc(self, n):
        off = len(self.words)
        self.words.extend([0] * n)
        return off

    def put_struct_ptr(self, at, target, data_words, ptr_words):
        off = target - at - 1
        self.words[at] = ((off & 0x3FFFFFFF) << 2) | 0 \
            | (data_words << 32) | (ptr_words << 48)

    def put_list_ptr(self, at, target, esize, count):
        off = target - at - 1
        self.words[at] = ((off & 0x3FFFFFFF) << 2) | 1 \
            | (esize << 32) | (count << 35)

    def prim_list(self, at, values, esize, bytes_per):
        """esize code: 2=1B, 3=2B, 4=4B, 5=8B."""
        values = np.asarray(values)
        n = len(values)
        nwords = (n * bytes_per + 7) // 8
        tgt = self.alloc(nwords)
        dt = {1: "<u1", 2: "<i2", 4: "<u4", 8: "<u8"}[bytes_per]
        buf = np.zeros(nwords * 8, np.uint8)
        buf[: n * bytes_per] = np.ascontiguousarray(
            values.astype(dt)).view(np.uint8)
        w = buf.view("<u8")
        for i in range(nwords):
            self.words[tgt + i] = int(w[i])
        self.put_list_ptr(at, tgt, esize, n)

    def text(self, at, s: str):
        b = s.encode() + b"\x00"
        nwords = (len(b) + 7) // 8
        tgt = self.alloc(nwords)
        for w in range(nwords):
            chunk = b[w * 8 : w * 8 + 8].ljust(8, b"\x00")
            self.words[tgt + w] = struct.unpack("<Q", chunk)[0]
        self.put_list_ptr(at, tgt, 2, len(b))

    def composite_list(self, at, count, data_words, ptr_words):
        per = data_words + ptr_words
        tgt = self.alloc(1 + count * per)
        self.words[tgt] = ((count & 0x3FFFFFFF) << 2) | 0 \
            | (data_words << 32) | (ptr_words << 48)
        self.put_list_ptr(at, tgt, 7, count * per)
        return tgt + 1  # element 0 (past the tag word)

    def message(self) -> bytes:
        seg = b"".join(struct.pack("<Q", w & 0xFFFFFFFFFFFFFFFF)
                       for w in self.words)
        return struct.pack("<II", 0, len(self.words)) + seg


def deep_preorder_parents(rng, n_nodes: int) -> np.ndarray:
    """Like random_preorder_parents, but each new node hangs off the node
    geometric(0.5) - 1 steps above the chain's end, so the depth is a
    critical random walk: ~180 on average and ~20,000 leaves at 39,999
    nodes, the shape of a binary tree of 20,000 genomes (the uniform pick
    gives depth <= 9 there)."""
    parent = np.zeros(n_nodes, np.uint32)
    chain = [0]
    ups = rng.geometric(0.5, n_nodes) - 1
    for i in range(1, n_nodes):
        d = max(len(chain) - 1 - int(ups[i]), 0)
        parent[i] = chain[d]
        del chain[d + 1:]
        chain.append(i)
    return parent


# block mutation flags of a Mutation record (io/panman.py's wire layout)
BLOCK_MUT, BLOCK_INS, BLOCK_INV = 2, 4, 8
# panman's NucMutationType (the low bits of a NucMut's mutInfo)
NS, ND, NI, NSNPS = 0, 1, 2, 3
_BASE_OF_CODE = np.frombuffer(b"-ACMGRSVTWYHKDBN", np.uint8)
_ACGT_CODES = np.array([1, 2, 4, 8], np.uint8)
_COMPLEMENT_CODE = np.zeros(16, np.uint8)
_COMPLEMENT_CODE[[1, 2, 4, 8]] = [8, 4, 2, 1]


def pack_nuc_mut(mut_type: int, codes) -> int:
    """A NucMut's ``packed`` word: mutInfo (length << 4 | type) in the low
    byte, then the 1-6 codes as nibbles, the first base highest."""
    n = len(codes)
    if not 1 <= n <= 6:
        raise ValueError(f"a NucMut holds 1-6 bases, not {n}")
    word = (n << 4) | mut_type
    for i, c in enumerate(codes):
        word |= int(c) << (8 + 4 * (n - 1 - i))
    return word


@dataclass
class PanmanModel:
    """One PanMAN tree as write_panman writes it.

    names: node identifiers in DFS preorder (the root first); parent: each
    node's parent's preorder index (the root's is 0); blocks: each block's
    consensus as uint8 one-hot codes (A=1, C=2, G=4, T=8); gaps: [g, 3]
    int64 rows (block, slot, length), a run of ``length`` gap columns
    before main column ``slot`` (the GapList); block_muts: [b, 3] rows
    (node, block, flags), flags BLOCK_INS for an insertion (with BLOCK_INV
    inverted), BLOCK_INV for an inversion, 0 for a deletion; nuc_muts:
    [m, 5] rows (node, block, position, gap position or -1, packed) in the
    order a node applies them (by block, as the file groups them)."""

    names: list
    parent: np.ndarray
    blocks: list
    gaps: np.ndarray
    block_muts: np.ndarray
    nuc_muts: np.ndarray

    def __post_init__(self):
        self.index = {n: i for i, n in enumerate(self.names)}
        n = len(self.names)
        self._bm_off = np.searchsorted(self.block_muts[:, 0], np.arange(n + 1))
        self._nm_off = np.searchsorted(self.nuc_muts[:, 0], np.arange(n + 1))

    def leaves(self) -> list:
        has_child = np.zeros(len(self.names), bool)
        has_child[self.parent[1:]] = True
        return [self.names[i] for i in np.flatnonzero(~has_child)]

    def newick(self) -> str:
        """The topology with a branch length of 1 everywhere, built from
        the leaves up (a preorder index is above its parent's), without
        recursion: the tree may be hundreds of levels deep."""
        kids = [[] for _ in self.names]
        for i in range(1, len(self.names)):
            kids[int(self.parent[i])].append(i)
        text = [""] * len(self.names)
        for i in range(len(self.names) - 1, -1, -1):
            inner = (f"({','.join(text[c] for c in kids[i])})" if kids[i]
                     else "")
            text[i] = inner + self.names[i] + (":1" if i else "")
            for c in kids[i]:
                text[c] = ""
        return text[0] + ";"

    def get_string(self, identifier: str, aligned: bool = False) -> str:
        """The node's sequence from the model alone: each block switched
        on or off and turned along the path from the root, its consensus
        and gap runs overwritten by the path's mutations in order; a block
        that is off is left out, an inverted one reverse-complemented;
        ``aligned`` keeps the '-' columns of the blocks that are on."""
        path = [self.index[identifier]]
        while path[-1]:
            path.append(int(self.parent[path[-1]]))
        nb = len(self.blocks)
        on = np.zeros(nb, bool)
        fwd = np.ones(nb, bool)
        main = [b.copy() for b in self.blocks]
        runs = {(int(b), int(s)): np.zeros(int(n), np.uint8)
                for b, s, n in self.gaps}
        for node in reversed(path):
            for _, b, flags in self.block_muts[self._bm_off[node]:
                                               self._bm_off[node + 1]]:
                if flags & BLOCK_INS:
                    on[b], fwd[b] = True, not flags & BLOCK_INV
                elif flags & BLOCK_INV:
                    fwd[b] = not fwd[b]
                else:
                    on[b] = False
            for _, b, pos, gap, packed in self.nuc_muts[
                    self._nm_off[node]:self._nm_off[node + 1]]:
                n = (int(packed) & 0xFF) >> 4
                codes = [(int(packed) >> (8 + 4 * (n - 1 - i))) & 0xF
                         for i in range(n)]
                if gap < 0:
                    main[b][pos:pos + n] = codes
                else:
                    runs[(int(b), int(pos))][gap:gap + n] = codes
        out = []
        for b in range(nb):
            if not on[b]:
                continue
            parts = []
            for p in range(len(main[b]) + 1):
                if (b, p) in runs:
                    parts.append(runs[(b, p)])
                parts.append(main[b][p:p + 1])
            codes = np.concatenate(parts)
            if not fwd[b]:
                codes = _COMPLEMENT_CODE[codes[::-1]]
            if not aligned:
                codes = codes[codes != 0]
            out.append(_BASE_OF_CODE[codes].tobytes())
        return b"".join(out).decode()


def write_panman(path: str, model: PanmanModel):
    """Write ``model`` as an xz-compressed PanMAN file, the layout that
    io/panman.py's load_panman decodes:

      TreeGroup {ptrs: [List(Tree)]}
      Tree {ptrs: [newick Text, List(Node), List(ConsensusSeqToBlockIds),
                   List(GapList)]}
      Node {ptrs: [List(Mutation), annotations (null)]}, one record per
           node in preorder plus the trailing empty record
      Mutation {blockId << 32 @0, flags @8; ptrs: [List(NucMut)]}, one per
           block a node touches, every list of 2 data words and 1 pointer
           (the layout the vectorised decoder takes)
      NucMut {pos i32 @0, gapPos i32 @4, gapExist bit @8, packed u32 @12}
      ConsensusSeqToBlockIds {ptrs: [List(u64) blockId << 32, List(u32)
           8 codes a word, big nibble first, ended by a 0 code,
           List(bool) blockGapExist]}
      GapList {blockId << 32 @0; ptrs: [List(i32) lengths, List(i32)
           positions]} (the wire order, the reverse of the schema's)"""
    n = len(model.names)
    e = _CapnpEncoder()
    group = e.alloc(2)
    e.put_struct_ptr(0, group, 0, 2)
    tree = e.composite_list(group, 1, 0, 4)
    e.text(tree, model.newick())
    nodes = e.composite_list(tree + 1, n + 1, 0, 2)
    bm, nm = model.block_muts, model.nuc_muts
    gap = np.where(nm[:, 3] < 0, 0, nm[:, 3])
    nm_words = np.stack([
        (nm[:, 2] & 0xFFFFFFFF) | ((gap & 0xFFFFFFFF) << 32),
        (nm[:, 3] >= 0).astype(np.int64) | (nm[:, 4] << 32)], 1
    ).astype(np.uint64)
    for i in range(n):
        rows = np.arange(model._nm_off[i], model._nm_off[i + 1])
        flags = dict(zip(bm[model._bm_off[i]:model._bm_off[i + 1], 1].tolist(),
                         bm[model._bm_off[i]:model._bm_off[i + 1], 2].tolist()))
        touched = sorted(set(flags) | set(nm[rows, 1].tolist()))
        if not touched:
            continue
        rec = e.composite_list(nodes + 2 * i, len(touched), 2, 1)
        for r, b in enumerate(touched):
            at = rec + 3 * r
            e.words[at] = b << 32
            e.words[at + 1] = (flags.get(b, 0)
                               | (BLOCK_MUT if b in flags else 0))
            mine = rows[nm[rows, 1] == b]
            if len(mine):
                first = e.composite_list(at + 2, len(mine), 2, 0)
                e.words[first:first + 2 * len(mine)] = \
                    nm_words[mine].reshape(-1).tolist()
    cmap = e.composite_list(tree + 2, len(model.blocks), 0, 3)
    for b, cons in enumerate(model.blocks):
        codes = np.concatenate([cons, np.zeros(8 - len(cons) % 8, np.uint8)])
        words = (codes.reshape(-1, 8).astype(np.uint32)
                 << np.arange(28, -1, -4, dtype=np.uint32)).sum(1)
        e.prim_list(cmap + 3 * b, [b << 32], 5, 8)
        e.prim_list(cmap + 3 * b + 1, words, 4, 4)
        e.prim_list(cmap + 3 * b + 2, [0], 1, 1)  # one bit: False
    gap_blocks = np.unique(model.gaps[:, 0])
    glist = e.composite_list(tree + 3, len(gap_blocks), 1, 2)
    for j, b in enumerate(gap_blocks.tolist()):
        at = glist + 3 * j
        mine = model.gaps[model.gaps[:, 0] == b]
        e.words[at] = b << 32
        e.prim_list(at + 1, mine[:, 2], 4, 4)
        e.prim_list(at + 2, mine[:, 1], 4, 4)
    with lzma.open(path, "wb", preset=1) as fh:
        fh.write(e.message())


def make_panman_model(rng, n_nodes: int = 39999, genome_len: int = 29903,
                      n_blocks: int = 30,
                      indel_rate: float = 0.005) -> PanmanModel:
    """A PanMAN tree from ``rng``: deep_preorder_parents' shape (a binary
    tree of ~n_nodes / 2 genomes); a random root genome of ``genome_len``
    bp cut into ``n_blocks`` blocks of 0.5-1.5x the mean length, each the
    consensus of its block and switched on at the root; two gap runs of
    12 columns declared in every block.  Every other node carries 2-5 SNPs
    (NSNPS), with probability 0.4 a substitution of 2-6 bases (NS) and
    with probability ``indel_rate`` an indel of 1-9 bp: a deletion writes
    '-' over main columns (ND), an insertion writes bases into a declared
    gap run (NI).  One block is switched off at the root of one subtree
    and another inverted at the root of a second, disjoint one, each
    subtree 1-5% of the nodes.

    The SNP and substitution rates are fitted to the sars_20000 demo's
    index: at the default size and seed 0 the CLI's index parameters give
    2,436,878 rows (~61 a node), against the 2,422,142 rows that
    BENCH_r01.json's log records for the demo's tree."""
    gaps_per_block, gap_len, mnp_rate = 2, 12, 0.4
    parent = deep_preorder_parents(rng, n_nodes).astype(np.int64)
    weights = rng.uniform(0.5, 1.5, n_blocks)
    lens = np.floor(weights / weights.sum() * genome_len).astype(np.int64)
    lens[-1] += genome_len - lens.sum()
    boff = np.concatenate(([0], np.cumsum(lens)))
    block_of = np.repeat(np.arange(n_blocks), lens)
    cur = _ACGT_CODES[rng.integers(0, 4, genome_len)]
    blocks = [cur[boff[b]:boff[b + 1]].copy() for b in range(n_blocks)]
    gaps = np.array([(b, s, gap_len) for b in range(n_blocks)
                     for s in np.sort(rng.choice(np.arange(1, lens[b]),
                                                 gaps_per_block,
                                                 replace=False))],
                    np.int64).reshape(-1, 3)
    goff = np.concatenate(([0], np.cumsum(gaps[:, 2])))
    gcur = np.zeros(int(goff[-1]), np.uint8)

    # the block events, on two disjoint subtrees of 1-5% of the nodes
    size = np.ones(n_nodes, np.int64)
    for i in range(n_nodes - 1, 0, -1):
        size[parent[i]] += size[i]
    fit = np.flatnonzero((size >= max(2, n_nodes // 100))
                         & (size <= max(3, n_nodes // 20)))
    fit = fit[fit > 0]
    off_at = int(rng.choice(fit))
    fit = fit[(fit + size[fit] <= off_at) | (fit >= off_at + size[off_at])]
    inv_at = int(rng.choice(fit))
    off_block, inv_block = (int(b) for b in
                            rng.choice(np.arange(1, n_blocks - 1), 2,
                                       replace=False))
    block_muts = [(0, b, BLOCK_INS) for b in range(n_blocks)]
    block_muts += sorted([(off_at, off_block, 0), (inv_at, inv_block,
                                                   BLOCK_INV)])

    R = random.Random(int(rng.integers(1 << 62)))
    idx_of = np.zeros(16, np.int64)
    idx_of[_ACGT_CODES] = np.arange(4)
    rows, stack = [], [(0, [])]
    for i in range(1, n_nodes):
        while stack[-1][0] != parent[i]:
            for at, old in reversed(stack.pop()[1]):
                if at >= 0:
                    cur[at] = old
                else:
                    gcur[-at - 1] = old
        undo = []

        def substitute(g, n, mut_type):
            olds = cur[g:g + n]
            if (olds == 0).any() or block_of[g] != block_of[g + n - 1]:
                return
            new = _ACGT_CODES[(idx_of[olds] + [R.randrange(1, 4)
                                                for _ in range(n)]) % 4]
            undo.extend(zip(range(g, g + n), olds.tolist()))
            cur[g:g + n] = new
            b = int(block_of[g])
            rows.append((i, b, g - boff[b], -1, pack_nuc_mut(mut_type, new)))

        for _ in range(R.randint(2, 5)):
            substitute(R.randrange(genome_len), 1, NSNPS)
        if R.random() < mnp_rate:
            n = R.randint(2, 6)
            substitute(R.randrange(genome_len - n), n, NS)
        if R.random() < indel_rate:
            n = R.randint(1, 9)
            if R.random() < 0.5:
                g = R.randrange(genome_len - n)
                b = int(block_of[g])
                if block_of[g + n - 1] == b:
                    undo.extend(zip(range(g, g + n), cur[g:g + n].tolist()))
                    cur[g:g + n] = 0
                    for j in range(0, n, 6):
                        rows.append((i, b, g - boff[b] + j, -1,
                                     pack_nuc_mut(ND, [0] * min(6, n - j))))
            else:
                k = R.randrange(len(gaps))
                b, slot, glen = (int(x) for x in gaps[k])
                new = _ACGT_CODES[[R.randrange(4) for _ in range(min(n, glen))]]
                at = int(goff[k])
                undo.extend((-(at + j) - 1, int(gcur[at + j]))
                            for j in range(len(new)))
                gcur[at:at + len(new)] = new
                for j in range(0, len(new), 6):
                    rows.append((i, b, slot, j,
                                 pack_nuc_mut(NI, new[j:j + 6])))
        stack.append((i, undo))

    nuc = np.array(rows, np.int64).reshape(-1, 5)
    nuc = nuc[np.lexsort((nuc[:, 1], nuc[:, 0]))]  # stable: by node, block
    names = [f"node_{i}" for i in range(n_nodes)]
    has_child = np.zeros(n_nodes, bool)
    has_child[parent[1:]] = True
    for i in np.flatnonzero(~has_child):
        names[i] = f"S{i}/2020"  # leaves: sample names with a '/'
    return PanmanModel(names=names, parent=parent, blocks=blocks, gaps=gaps,
                       block_muts=np.array(block_muts, np.int64),
                       nuc_muts=nuc)
