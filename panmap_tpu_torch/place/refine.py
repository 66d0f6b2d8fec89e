"""Alignment-based placement refinement (--refine).

Reimplements src/placement.cpp:440-698 (getNodesWithinRadius,
refineTopCandidates) and src/mm_align.c:148-199 (score_reads_vs_reference):
each metric nominates its top refine_top_pct (capped at refine_max_top_n)
positive-scoring nodes plus its unrefined best, expands them with
phylogenetic neighbors within refine_neighbor_radius hops (BFS over
parent/child edges, capped at refine_max_neighbor_n per start node), the
union of candidates is alignment-scored once (score = -sum of per-read edit
distances, unmapped reads cost their full length), and each metric picks the
best alignment score from its own expanded set (ties broken by seed score,
then lowest DFS index).

Refined results are appended to .placement.tsv as
"refined_<metric>\t<score %.0f>\t<node>" rows; the downstream pipeline keeps
using the unrefined log_containment best (main.cpp:1764)."""

from __future__ import annotations

from collections import deque

import numpy as np

from .engine import METRICS


def get_nodes_within_radius(children: list, parent: np.ndarray, start: int,
                            radius: int, max_nodes: int) -> list:
    """BFS over parent/child edges up to `radius` hops; excludes the start
    node; stops at max_nodes results (placement.cpp:440-478)."""
    if radius <= 0 or max_nodes <= 0:
        return []
    result = []
    visited = {start}
    q = deque([(start, 0)])
    while q and len(result) < max_nodes:
        node, dist = q.popleft()
        if node != start:
            result.append(node)
        if dist >= radius:
            continue
        p = int(parent[node])
        if node != 0 and p not in visited:
            visited.add(p)
            q.append((p, dist + 1))
        for c in children[node]:
            if c not in visited:
                visited.add(c)
                q.append((c, dist + 1))
    return result


def _alignment_score(ref: str, read_seqs: list, paired: bool) -> int:
    """-sum(edit distance) over reads vs one candidate genome
    (mm_align.c:148-199: blen - mlen + ambi, or read length if unmapped)."""
    from ..align.batch import BatchAligner

    aligner = BatchAligner(ref)
    pairs = aligner.align_pairs_batch(read_seqs, paired)
    total = 0
    flat = []
    for a1, a2 in pairs:
        flat.append(a1)
        if a2 is not None:
            flat.append(a2)
    for i, a in enumerate(flat[: len(read_seqs)]):
        if a is not None and a.mapped:
            total += int(a.nm)
        else:
            total += len(read_seqs[i])
    return -total


def refine_top_candidates(idx, tree, scores: np.ndarray, best_index: dict,
                          read_seqs: list, paired: bool,
                          top_pct: float = 0.01, max_top_n: int = 150,
                          neighbor_radius: int = 2, max_neighbor_n: int = 150,
                          log=print):
    """Returns {metric: (alignment_score, node_id)} (placement.cpp:518-698)."""
    n_nodes = len(idx.node_ids)
    parent = idx.parent_index.astype(np.int64)
    children: list = [[] for _ in range(n_nodes)]
    for i in range(1, n_nodes):
        children[parent[i]].append(i)

    per_metric_base = {}
    for m, name in enumerate(METRICS):
        col = scores[:, m]
        pos = np.flatnonzero(col > 0)
        cands = set()
        if len(pos):
            order = pos[np.argsort(-col[pos], kind="stable")]
            num_top = max(min(int(len(pos) * top_pct), max_top_n), 1)
            cands.update(int(i) for i in order[:num_top])
        if best_index.get(name) is not None:
            cands.add(int(best_index[name]))
        per_metric_base[name] = cands

    all_cands = set()
    per_metric_exp = {}
    for name, base in per_metric_base.items():
        exp = set(base)
        for node in base:
            exp.update(get_nodes_within_radius(
                children, parent, node, neighbor_radius, max_neighbor_n))
        per_metric_exp[name] = exp
        all_cands |= exp

    if not all_cands:
        log("[refine] skipped: no nodes with positive scores")
        return {}
    log(f"[refine] {len(all_cands)} unique candidates from all metrics")

    aln_score = {}
    for node in sorted(all_cands):
        ref = tree.get_string(idx.node_ids[node])
        aln_score[node] = _alignment_score(ref, read_seqs, paired) if ref else 0

    refined = {}
    for m, name in enumerate(METRICS):
        best_sc, best_idx = None, None
        for node in per_metric_exp[name]:
            sc = aln_score.get(node)
            if sc is None:
                continue
            if best_idx is None or sc > best_sc:
                best_sc, best_idx = sc, node
            elif sc == best_sc:
                # tie-break: higher seed score, then lowest DFS index
                sa, sb = scores[node, m], scores[best_idx, m]
                if sa > sb or (sa == sb and node < best_idx):
                    best_idx = node
        if best_idx is not None:
            refined[name] = (best_sc, idx.node_ids[best_idx])
    return refined


def append_refined_tsv(path: str, refined: dict):
    """placement.cpp:1988-2001: refined rows use %.0f scores."""
    with open(path, "a") as fh:
        for name in METRICS:
            if name in refined:
                sc, node_id = refined[name]
                fh.write(f"refined_{name}\t{sc:.0f}\t{node_id}\n")
