"""Meta filter-and-assign: read -> max-parsimony node / LCA assignment.

Reimplements src/main.cpp:720-1016 filterAndAssignBatch + the assignment DFS
(src/mgsr.cpp:6415-6585):

 - reads are sketched/deduplicated with the dust + discard filters;
 - scoring as in engine.MetaScorer; a read is assigned to every collapsed node
   achieving its maximum score (equally parsimonious placements), and to the
   LCA of those nodes;
 - taxonomy: leaf taxa from the metadata TSV roll up the tree; a node whose
   taxon set exceeds --maximum-taxon-number is poisoned; reads whose
   near-maximum nodes span too many taxa are dropped (checkTaxonIndicesBatch);
 - outputs: <out>.mgsr.assignedReads.fastq (reads, write order defines the
   indices), .mgsr.assignedReads.out and .mgsr.assignedReadsLCANode.out with
   lines "node[,identical]\ttaxa\tcount\tidx,idx,...", plus the optional
   breadth-ratio table (calculateBreadthRatio, src/mgsr.cpp:6518-6585).

Carried over from panmap_tpu/meta/assign.py.  The one change: the batched
scorer of the fast route is TorchMetaScorer on the caller's device, so
run_filter_and_assign, _filter_assign_batches and _assign_one_batch take the
device; the routing rule, the replay DFS of the host route and every writer
are unchanged.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..io import fastq
from .engine import MetaScorer, sketch_meta_reads_full


def load_taxonomy(path: str, rank: str):
    """sample -> taxon index, plus the taxon name list
    (mgsr.cpp:198-257 loadTaxonomicMetadata; whitespace-delimited)."""
    taxons: list = []
    taxon_to_index: dict = {}
    sample_to_taxon: dict = {}
    with open(path) as fh:
        header = fh.readline().split()
        if rank not in header or header.index(rank) == 0:
            raise ValueError(f"taxonomic rank '{rank}' not found in {path}")
        col = header.index(rank)
        for line in fh:
            parts = line.split()
            if len(parts) <= col:
                continue
            sample, taxon = parts[0], parts[col]
            if taxon == ".":
                continue
            if taxon not in taxon_to_index:
                taxon_to_index[taxon] = len(taxons)
                taxons.append(taxon)
            sample_to_taxon[sample] = taxon_to_index[taxon]
    return sample_to_taxon, taxons


class Lca:
    """Euler-tour + sparse-table LCA over the raw tree (mgsr.cpp:542-588)."""

    def __init__(self, parent: np.ndarray):
        n = len(parent)
        children: list = [[] for _ in range(n)]
        for i in range(1, n):
            children[parent[i]].append(i)
        tour = []
        depth_at = []
        first = np.full(n, -1, dtype=np.int64)
        stack = [(0, 0, iter(children[0]))]
        tour.append(0)
        depth_at.append(0)
        first[0] = 0
        while stack:
            node, d, it = stack[-1]
            child = next(it, None)
            if child is None:
                stack.pop()
                if stack:
                    tour.append(stack[-1][0])
                    depth_at.append(stack[-1][1])
                continue
            tour.append(child)
            depth_at.append(d + 1)
            if first[child] < 0:
                first[child] = len(tour) - 1
            stack.append((child, d + 1, iter(children[child])))
        self.tour = np.array(tour, dtype=np.int64)
        self.depth = np.array(depth_at, dtype=np.int64)
        self.first = first
        m = len(tour)
        K = max(1, int(np.log2(max(m, 2))) + 1)
        sp = np.zeros((K, m), dtype=np.int64)
        sp[0] = np.arange(m)
        for k in range(1, K):
            span = 1 << k
            half = span >> 1
            prev = sp[k - 1]
            idx = np.arange(m - span + 1)
            a = prev[idx]
            b = prev[idx + half]
            sp[k, : m - span + 1] = np.where(self.depth[a] <= self.depth[b], a, b)
        self.sp = sp

    def lca(self, u: int, v: int) -> int:
        a, b = self.first[u], self.first[v]
        if a > b:
            a, b = b, a
        k = int(np.log2(max(b - a + 1, 1)))
        i1 = self.sp[k, a]
        i2 = self.sp[k, b - (1 << k) + 1]
        best = i1 if self.depth[i1] <= self.depth[i2] else i2
        return int(self.tour[best])


def run_filter_and_assign(cfg, midx, device) -> int:
    """Streams the input in --batch-size chunks (reference: the 3-stage TBB
    pipeline over 1M-read batches, main.cpp:790-933).  Multi-batch runs make
    TWO passes: pass A unions the distinct read hashes so the collapsed tree
    (node keep/identical sets) is GLOBAL — with no masking flags the
    per-node/LCA assignments are then independent of the batch split
    (pseudochain adjacency can differ marginally from a single-pass run).
    Seed/read MASKING thresholds apply per batch, exactly like the
    reference's initializeQueryDataBatch, so masked runs depend on the
    split there too."""
    batch_size = max(int(getattr(cfg, "batch_size", 0) or 1_000_000), 1)
    p = midx.params
    masking = (getattr(cfg, "mask_reads", 0) or getattr(cfg, "mask_seeds", 0)
               or getattr(cfg, "mask_reads_rf", 0.0)
               or getattr(cfg, "mask_seeds_rf", 0.0)
               or getattr(cfg, "amplicon_depth", "")
               or getattr(cfg, "mask_read_ends", 0))

    def sketch_batch(bnames, bseqs):
        if masking:
            from .engine import sketch_meta_reads_grouped

            reads, dup_index, n_dust, n_masked = sketch_meta_reads_grouped(
                bseqs, bnames, p, cfg)
        else:
            reads, dup_index, n_dust = sketch_meta_reads_full(
                bseqs, p.k, p.s, p.t, p.l, p.open, dust_threshold=cfg.dust)
            n_masked = 0
        return reads, dup_index, n_dust, n_masked

    def batches():
        return fastq.read_full_batches(cfg.reads1, cfg.reads2 or None,
                                       batch_size)

    gen = batches()
    b0 = next(gen, ([], [], []))
    b1 = next(gen, None)
    single = b1 is None
    union_hashes = None
    if single:
        first_batches = [b0]
    else:
        import itertools

        parts = []
        n_total = 0
        for bnames, bseqs, _bq in itertools.chain([b0, b1], gen):
            reads, _, _, _ = sketch_batch(bnames, bseqs)
            n_total += len(bnames)
            if reads:
                parts.append(
                    np.unique(np.concatenate([r.hashes for r in reads])))
        union_hashes = (np.unique(np.concatenate(parts)) if parts
                        else np.empty(0, np.uint64))
        cfg.log(f"[assign] pass A: {n_total} reads in batches of "
                f"{batch_size}; {len(union_hashes)} distinct seedmers")
        first_batches = None

    return _filter_assign_batches(
        cfg, midx, sketch_batch, first_batches or batches(), union_hashes,
        device)


def _filter_assign_batches(cfg, midx, sketch_batch, batch_iter,
                           union_hashes, device) -> int:
    scorer = None
    n_nodes = len(midx.node_ids)
    parent = midx.parent_index.astype(np.int64)
    lca = Lca(parent)
    children: list = [[] for _ in range(n_nodes)]
    for i in range(1, n_nodes):
        children[parent[i]].append(i)

    # taxonomy roll-up over the raw tree (read-independent; once)
    taxons: list = []
    node_taxa: list = [set() for _ in range(n_nodes)]
    node_overmax = np.zeros(n_nodes, dtype=bool)
    maxtax = max(cfg.max_taxon_number, 1)
    if cfg.taxonomy_path:
        sample_to_taxon, taxons = load_taxonomy(cfg.taxonomy_path,
                                                cfg.taxonomic_rank)
        is_parent = np.zeros(n_nodes, dtype=bool)
        is_parent[parent[1:]] = True
        for i, nm in enumerate(midx.node_ids):
            if not is_parent[i] and nm in sample_to_taxon:
                node_taxa[i].add(sample_to_taxon[nm])
        for i in range(n_nodes - 1, 0, -1):  # children before parents
            if node_overmax[i]:
                node_overmax[parent[i]] = True
            elif not node_overmax[parent[i]]:
                node_taxa[parent[i]] |= node_taxa[i]
                if len(node_taxa[parent[i]]) > maxtax:
                    node_overmax[parent[i]] = True
                    node_taxa[parent[i]] = set()

    # global accumulators across batches
    out_fq = cfg.output + ".mgsr.assignedReads.fastq"
    n_fq = 0
    node_idxs: dict = defaultdict(list)       # node -> [global fq idx]
    lca_idxs: dict = defaultdict(list)        # node -> [global fq idx]
    jp_names: list = []                       # fq idx -> read name
    jp_nodes: list = []                       # fq idx -> [nodes]
    jp_lca_nodes: list = []                   # fq idx -> [lca node]
    breadth_reads: dict = defaultdict(dict)   # node -> {hash: sum weight}
    n_in_total = 0
    n_batches = 0
    n_uniq_total = 0
    shared_tree = None  # union-hash tree is batch-independent: build once
    scorer = None

    with open(out_fq, "w") as fq_fh:
        for bnames, bseqs, bquals in batch_iter:
            n_batches += 1
            reads, dup_index, n_dust, n_masked = sketch_batch(bnames, bseqs)
            cfg.log(f"[assign] batch {n_batches}: {len(bseqs)} reads -> "
                    f"{len(reads)} unique sets ({n_dust} low-complexity"
                    + (f", {n_masked} masked)" if n_masked else ")"))
            scorer = MetaScorer(midx, reads, relevant_hashes=union_hashes,
                                shared_tree=(shared_tree
                                             if union_hashes is not None
                                             else None))
            if union_hashes is not None and shared_tree is None:
                shared_tree = (scorer.tree, scorer._relevant,
                               scorer._rh_sorted)
            n_fq = _assign_one_batch(
                cfg, midx, scorer, reads, dup_index, bnames, bseqs, bquals,
                lca, children, node_taxa, node_overmax, maxtax,
                fq_fh, n_fq, node_idxs, lca_idxs, jp_names, jp_nodes,
                jp_lca_nodes, breadth_reads, taxons,
                orig_base=n_in_total, uniq_base=n_uniq_total,
                first_batch=(n_batches == 1), device=device)
            n_in_total += len(bseqs)
            n_uniq_total += len(reads)
    cfg.log(f"[assign] {n_fq} of {n_in_total} reads written to {out_fq}")

    members_of = {}
    if scorer is not None:
        for keeper, absorbed in scorer.tree.identical_members.items():
            members_of[keeper] = [midx.node_ids[a] for a in absorbed]

    def write_out(path, mapping):
        with open(path, "w") as fh:
            for node, idxs in mapping.items():
                name = midx.node_ids[node]
                parts = [name] + members_of.get(node, [])
                taxa = (",".join(taxons[t] for t in sorted(node_taxa[node]))
                        if node_taxa[node] else ".")
                idxs = sorted(idxs)
                fh.write(",".join(parts) + f"\t{taxa}\t{len(idxs)}\t"
                         + ",".join(map(str, idxs)) + "\n")

    write_out(cfg.output + ".mgsr.assignedReads.out", node_idxs)
    write_out(cfg.output + ".mgsr.assignedReadsLCANode.out", lca_idxs)

    if getattr(cfg, "jplace", False):
        newick, edge_num = _jplace_newick(midx, children)
        for by_read, suffix in ((jp_nodes, ".mgsr.assignedReads.jplace"),
                                (jp_lca_nodes,
                                 ".mgsr.assignedReadsLCANode.jplace")):
            _write_jplace(cfg.output + suffix, by_read, jp_names, midx,
                          members_of, newick, edge_num)
        cfg.log("[assign] wrote jplace outputs")

    if cfg.breadth_ratio:
        _write_breadth_ratio(cfg, midx, breadth_reads, members_of, children)

    if getattr(cfg, "align_reads", False):
        _align_assigned_reads(cfg, midx, node_idxs, out_fq)
    return 0


def _assign_one_batch(cfg, midx, scorer, reads, dup_index, names, seqs,
                      quals, lca, children, node_taxa, node_overmax, maxtax,
                      fq_fh, fq_base, node_idxs, lca_idxs, jp_names,
                      jp_nodes, jp_lca_nodes, breadth_reads, taxons,
                      orig_base: int = 0, uniq_base: int = 0,
                      first_batch: bool = True, device=None) -> int:
    use_fast = (not getattr(cfg, "pseudochain", False)
                and len(reads) >= getattr(cfg, "fast_threshold", 2000)
                and not getattr(cfg, "host_score", False))
    fast = None
    node_scores = None
    if use_fast:
        from .engine_torch import TorchMetaScorer

        fast = TorchMetaScorer(midx, reads, device)
        max_score, _ = fast.score_all([])
        cfg.log(f"[assign] batched scoring over {len(fast.ev_pos)} events")
    elif getattr(cfg, "pseudochain", False):
        max_score, _snap, node_scores = scorer.score_all_pseudo(
            [], collect_node_scores=True)
    else:
        max_score, _snap, node_scores = scorer.score_all(
            [], collect_node_scores=True)

    read_lens = np.array([len(r.hashes) for r in reads], dtype=np.int64)
    eff = max_score.copy()
    eff[eff < read_lens * cfg.discard] = 0

    parent = midx.parent_index.astype(np.int64)
    if cfg.taxonomy_path:
        read_taxa: list = [set() for _ in range(len(reads))]
        read_overmax = np.zeros(len(reads), dtype=bool)
        if node_scores is not None:
            # drop reads spanning too many taxa among near-max TOUCHED nodes
            for node, pairs in node_scores.items():
                for ridx, sc in pairs:
                    if eff[ridx] == 0 or read_overmax[ridx]:
                        continue
                    thr = max(cfg.ambiguous_score_threshold,
                              int(eff[ridx] * cfg.ambiguous_score_threshold_ratio))
                    if sc == eff[ridx] or sc >= max(0, int(eff[ridx]) - thr):
                        if node_overmax[node]:
                            read_overmax[ridx] = True
                            read_taxa[ridx] = set()
                        else:
                            read_taxa[ridx] |= node_taxa[node]
                            if len(read_taxa[ridx]) > maxtax:
                                read_overmax[ridx] = True
                                read_taxa[ridx] = set()
            eff[read_overmax] = 0

    epp_fast = None
    if fast is not None:
        # closed-form assignment: full score matrix per batch on device
        assigned_raw, near_iter, epp_fast, (lca_lo, lca_hi) = \
            fast.assignment_pass(scorer.tree.keep, eff,
                                 cfg.ambiguous_score_threshold,
                                 cfg.ambiguous_score_threshold_ratio)
        if cfg.taxonomy_path:
            for ridx, nodes in near_iter:
                if eff[ridx] == 0:
                    continue
                tx = read_taxa[ridx]
                for node in nodes.tolist():
                    if node_overmax[node]:
                        read_overmax[ridx] = True
                        break
                    tx |= node_taxa[node]
                    if len(tx) > maxtax:
                        read_overmax[ridx] = True
                        break
                if read_overmax[ridx]:
                    read_taxa[ridx] = set()
            eff[read_overmax] = 0
            epp_fast = np.where(eff > 0, epp_fast, 0)
        assigned_by_node = defaultdict(set)
        for node, rl in assigned_raw.items():
            s = {r for r in rl if eff[r] > 0}
            if s:
                assigned_by_node[node] = s
        read_lca: dict = {}
        for ridx in np.flatnonzero(eff > 0):
            hi2 = int(lca_hi[ridx])
            if hi2 >= 0:
                lo2 = int(lca_lo[ridx])
                read_lca[int(ridx)] = (lo2 if lo2 == hi2
                                       else lca.lca(lo2, hi2))
    else:
        # assignment pass (assignReadsBatchHelper): replay the per-node score
        # deltas down the tree; a read is assigned to every collapsed node
        # where its running score equals its maximum; LCA accumulates there
        assigned_by_node = defaultdict(set)
        read_lca = {}
        cur_score = np.zeros(len(reads), dtype=np.int64)
        mps: set = set()

        stack = [(0, None)]
        while stack:
            node, back = stack.pop()
            if back is not None:
                # undo membership changes (reverse order for duplicate reads)
                for ridx, was_member, old_sc in reversed(back):
                    cur_score[ridx] = old_sc
                    if was_member:
                        mps.add(ridx)
                    else:
                        mps.discard(ridx)
                continue
            backtrack = []
            for ridx, sc in node_scores.get(node, []):
                if eff[ridx] == 0:
                    continue
                was = ridx in mps
                backtrack.append((ridx, was, int(cur_score[ridx])))
                cur_score[ridx] = sc
                if sc == eff[ridx]:
                    mps.add(ridx)
                    read_lca[ridx] = (node if ridx not in read_lca
                                      else lca.lca(read_lca[ridx], node))
                else:
                    mps.discard(ridx)
            if mps and scorer.tree.keep[node]:
                assigned_by_node[node] |= mps
            stack.append((node, backtrack))
            for c in reversed(children[node]):
                stack.append((c, None))

    assigned_by_lca: dict = defaultdict(set)
    for ridx, node in read_lca.items():
        if eff[ridx] > 0:
            assigned_by_lca[node].add(ridx)

    # append this batch's assigned reads to the fastq; write order defines
    # the GLOBAL indices (fq_base + local order)
    fq_index: dict = {}
    for node in assigned_by_node:
        for uridx in sorted(assigned_by_node[node]):
            for orig in dup_index[uridx]:
                if orig not in fq_index:
                    fq_index[orig] = fq_base + len(fq_index)
                    fq_fh.write(
                        f"@{names[orig]}\n{seqs[orig]}\n+\n{quals[orig]}\n")
                    jp_names.append(names[orig])
                    jp_nodes.append([])
                    jp_lca_nodes.append([])

    for mapping, acc, jp in ((assigned_by_node, node_idxs, jp_nodes),
                             (assigned_by_lca, lca_idxs, jp_lca_nodes)):
        for node, uris in mapping.items():
            idxs = [fq_index[orig] for u in uris for orig in dup_index[u]]
            acc[node].extend(idxs)
            for gi in idxs:
                jp[gi].append(node)

    if cfg.breadth_ratio:
        # per node accumulate hash -> summed duplicate weight (equivalent to
        # iterating each read's distinct hashes; bounds streaming memory by
        # the per-node hash diversity instead of the read count)
        for node, uris in assigned_by_node.items():
            acc = breadth_reads[node]
            for uridx in uris:
                ndup = len(dup_index[uridx])
                for h in np.unique(reads[uridx].hashes).tolist():
                    acc[h] = acc.get(h, 0) + ndup

    if getattr(cfg, "write_read_scores_filtered", False):
        from .engine import count_epp, write_read_scores_tsv

        epp = (epp_fast if epp_fast is not None
               else count_epp(node_scores, eff, parent, scorer.tree.keep,
                              len(reads)))
        read_overmax_col = (read_overmax if cfg.taxonomy_path
                            else np.zeros(len(reads), dtype=bool))
        path = cfg.output + ".read_scores_info.filtered.tsv"
        dup_global = ([[orig_base + o for o in d] for d in dup_index]
                      if orig_base else dup_index)
        write_read_scores_tsv(path, reads, dup_global, eff, epp,
                              overmax=read_overmax_col,
                              append=not first_batch,
                              index_base=uniq_base)
        cfg.log(f"[assign] wrote {path}")

    return fq_base + len(fq_index)


def _align_assigned_reads(cfg, midx, node_idxs, assigned_fq_path):
    """--align-reads: per assigned node with >= --min-num-align reads, align
    its reads (whole-read aDNA mode) and write <prefix>_mgsr_aligned/
    <node>.bam plus a combined reference.fa (main.cpp:616-718
    alignAssignedReads; reference backend is bwa aln).  Reads come back from
    the assigned fastq (node_idxs holds indices in its write order), which
    keeps the batch-streaming path memory-bounded."""
    import os

    from ..align.bwt import pick_adna_aligner
    from ..io.bam import compute_sam_flags, write_bam
    from ..io.panman import load_panman
    from ..sketch.cpu import reverse_complement

    names, seqs, quals = fastq.read_full(assigned_fq_path)
    tree = load_panman(cfg.panman)
    align_dir = cfg.output + "_mgsr_aligned"
    os.makedirs(align_dir, exist_ok=True)

    def sanitize(s):
        return "".join("_" if (c in "/\\" or c.isspace()) else c for c in s)

    min_align = max(getattr(cfg, "min_num_align", 10), 0)
    n_aligned = n_skipped = 0
    with open(os.path.join(align_dir, "reference.fa"), "w") as ref_fa:
        for node, idxs in node_idxs.items():
            origs = sorted(idxs)
            if len(origs) < min_align:
                n_skipped += 1
                continue
            node_id = midx.node_ids[node]
            ref = tree.get_string(node_id)
            if not ref:
                continue
            ref_fa.write(f">{node_id}\n")
            for i in range(0, len(ref), 80):
                ref_fa.write(ref[i : i + 80] + "\n")
            ad, _backend = pick_adna_aligner(ref, len(origs))
            entries = []
            for o in origs:
                a = ad.align_read(seqs[o])
                if not a.mapped:
                    continue
                if a.rev:
                    bam_seq = reverse_complement(seqs[o])
                    bam_qual = bytes(ord(c) - 33 for c in reversed(quals[o]))
                else:
                    bam_seq = seqs[o]
                    bam_qual = bytes(ord(c) - 33 for c in quals[o])
                flag = compute_sam_flags(False, False, a.rev, False, False, False)
                entries.append(dict(qname=names[o], flag=flag, pos=a.rs,
                                    mapq=a.mapq, cigar=a.cigar, mtid=-1,
                                    mpos=-1, tlen=0, seq=bam_seq,
                                    qual=bam_qual))
            entries.sort(key=lambda e: e["pos"])
            write_bam(os.path.join(align_dir, sanitize(node_id) + ".bam"),
                      node_id, len(ref), entries)
            n_aligned += 1
    cfg.log(f"[assign] aligned reads for {n_aligned} nodes "
            f"({n_skipped} below min-num-align={min_align})")


def _jplace_newick(midx, children):
    """Postorder newick with ":1.0{edge}" annotations; returns (newick, edge_num)
    with edge numbers assigned children-first (main.cpp:850-874 toNewick)."""
    n_nodes = len(midx.node_ids)
    edge_num = np.zeros(n_nodes, dtype=np.int64)
    parts: list = []
    cur = [0]
    stack = [(0, False)]
    # iterative postorder emit: build strings bottom-up
    frag: dict = {}
    while stack:
        node, done = stack.pop()
        if not done:
            stack.append((node, True))
            for c in reversed(children[node]):
                stack.append((c, False))
            continue
        edge_num[node] = cur[0]
        inner = ("(" + ",".join(frag.pop(c) for c in children[node]) + ")"
                 if children[node] else "")
        frag[node] = f"{inner}{midx.node_ids[node]}:1.0{{{cur[0]}}}"
        cur[0] += 1
    del parts
    return frag[0] + ";", edge_num


def _write_jplace(path, by_read, read_names, midx, members_of, newick,
                  edge_num):
    """jplace v3 with fields [edge_num, node_id, identical_subtree_nodes]
    (main.cpp:560-614 writeJplacement/writeAssignedReadsJplace).
    by_read[i] = nodes of the read at assigned-fastq index i."""
    with open(path, "w") as out:
        out.write("{\n")
        out.write('  "version": 3,\n')
        out.write('  "metadata": {},\n')
        out.write('  "fields": ["edge_num", "node_id", "identical_subtree_nodes"],\n')
        out.write(f'  "tree": "{newick}",\n')
        out.write('  "placements":\n  [\n')
        for i, name in enumerate(read_names):
            out.write('    {"p": [\n')
            nodes = by_read[i]
            for j, node in enumerate(nodes):
                ident = ",".join(members_of.get(node, []))
                out.write(f'      [{edge_num[node]}, "{midx.node_ids[node]}", "{ident}"]')
                out.write("\n" if j == len(nodes) - 1 else ",\n")
            out.write('      ],\n')
            out.write(f'    "n": ["{name}"]\n')
            out.write("    }")
            out.write("\n" if i == len(read_names) - 1 else ",\n")
        out.write("  ]\n}\n")


def _write_breadth_ratio(cfg, midx, breadth_reads, members_of, children):
    """Observed vs expected coverage breadth per node (mgsr.cpp:6518-6585).
    breadth_reads: node -> {read hash: summed duplicate weight}."""
    offs = midx.node_offsets
    # replay: per node, current distinct ref seed hashes
    out_path = cfg.output + ".mgsr.breadths.out"
    header = ("NodeId\tTotalRefSeeds\tObservedBreadthCount\tObservedBreadthRatio"
              "\tTotalDepth\tMeanDepth\tExpectedBreadthRatio"
              "\tObservedToExpectedBreadthRatio\n")
    rows = []
    counts: dict = defaultdict(int)

    stack = [(0, False)]
    while stack:
        node, done = stack.pop()
        rng = range(int(offs[node]), int(offs[node + 1]))
        if done:
            for r in reversed(rng):
                sid = midx.delta_seed[r]
                h = int(midx.seed_hash[sid])
                counts[h] += 1 if midx.delta_is_del[r] else -1
                if counts[h] == 0:
                    del counts[h]
            continue
        for r in rng:
            sid = midx.delta_seed[r]
            h = int(midx.seed_hash[sid])
            counts[h] += -1 if midx.delta_is_del[r] else 1
            if counts[h] == 0:
                del counts[h]
        if node in breadth_reads:
            seed_hits: dict = {}
            total_depth = 0
            for h, w in breadth_reads[node].items():
                if h in counts:
                    seed_hits[h] = w
                    total_depth += w
            total_ref = len(counts)
            obs = len(seed_hits)
            obs_ratio = obs / total_ref if total_ref else 0.0
            mean_depth = total_depth / total_ref if total_ref else 0.0
            exp_ratio = 1.0 - np.exp(-mean_depth) if mean_depth > 0 else 0.0
            o2e = obs_ratio / exp_ratio if exp_ratio > 0 else 0.0
            name = ",".join([midx.node_ids[node]] + members_of.get(node, []))
            rows.append(f"{name}\t{total_ref}\t{obs}\t{obs_ratio}\t{total_depth}"
                        f"\t{mean_depth}\t{exp_ratio}\t{o2e}\n")
        stack.append((node, True))
        for c in reversed(children[node]):
            stack.append((c, False))

    with open(out_path, "w") as fh:
        fh.write(header)
        fh.writelines(rows)
    cfg.log(f"[assign] wrote {out_path}")
