"""Developer dump/simulation tools (src/main.cpp:2286-2406 dev modes).

--dump-node <id>            write one node's sequence as FASTA
--dump-random-nodeIDs <N>   sample N random leaf ids (seeded, reproducible)
--dump-sequences <ids>...   write node sequences, optionally with
--simulate-snps <n>...      simulated SNPs recorded in the FASTA header
                            (panmap_utils.cpp:192-247 simulateSNPsOnSequence:
                            uniform positions with a 1kb flank guard, uniform
                            non-ref base, de-duplicated positions)
"""

from __future__ import annotations

import random

from .io.panman import load_panman


def sanitize_filename(s: str) -> str:
    return "".join("_" if c in "/\\ \t" else c for c in s)


def _wrap(fh, seq: str, width: int = 80):
    for i in range(0, len(seq), width):
        fh.write(seq[i : i + width] + "\n")


def simulate_snps_on_sequence(sequence: str, numsnps: int, rng: random.Random):
    """Returns (mutated_sequence, [(ref, alt, pos)]).  Positions sampled
    uniformly inside a 1kb flank window, never repeated; alt uniform over the
    three non-ref bases; non-ACGT positions are burned attempts (matching the
    reference's visited-position semantics)."""
    if numsnps == 0 or not sequence:
        return sequence, []
    if len(sequence) > 2000:
        lo, hi = 1000, len(sequence) - 1000
    else:
        lo, hi = 0, len(sequence) - 1
    seq = list(sequence)
    records = []
    visited = set()
    window = hi - lo + 1
    while len(records) < numsnps and len(visited) < window:
        pos = rng.randint(lo, hi)
        if pos in visited:
            continue
        visited.add(pos)
        ref = seq[pos]
        if ref not in "ACGT":
            continue
        alt = rng.choice([b for b in "ACGT" if b != ref])
        records.append((ref, alt, pos))
        seq[pos] = alt
    return "".join(seq), records


def run_dump_node(panman: str, node_id: str, output: str, log=print) -> int:
    tree = load_panman(panman)
    seq = tree.get_string(node_id)
    if not seq:
        log(f"[dump] node {node_id} not found or empty")
        return 1
    path = output or f"{panman}.{sanitize_filename(node_id)}.fa"
    with open(path, "w") as fh:
        fh.write(f">{node_id}\n")
        _wrap(fh, seq)
    print(node_id)
    return 0


def run_dump_random_node_ids(panman: str, n: int, output: str,
                             seed: str = "", log=print) -> int:
    tree = load_panman(panman)
    leaves = sorted((n.identifier for n in tree.dfs_order if not n.children),
                    reverse=True)
    rng = random.Random(seed if seed else 42)
    rng.shuffle(leaves)
    path = output + ".randomNodeIDs.txt"
    with open(path, "w") as fh:
        for nid in leaves[:n]:
            fh.write(nid + "\n")
    log(f"[dump] {min(n, len(leaves))} leaf ids -> {path}")
    return 0


def run_dump_sequences(panman: str, groups: list, numsnps: list, output: str,
                       seed: str = "", log=print) -> int:
    tree = load_panman(panman)
    node_ids = []
    for group in groups:
        node_ids.extend(group.split())
    if numsnps and len(numsnps) != len(node_ids):
        log("[dump] number of SNP parameters does not match number of node IDs")
        return 1
    rng = random.Random(seed if seed else 42)
    path = output + ".dump-sequences.fa"
    with open(path, "w") as fh:
        for i, nid in enumerate(node_ids):
            seq = tree.get_string(nid)
            if not seq:
                log(f"[dump] node {nid} not found in the tree")
                return 1
            n = numsnps[i] if numsnps else 0
            seq, records = simulate_snps_on_sequence(seq, n, rng)
            fh.write(">" + nid + " "
                     + " ".join(f"{r}{p}{a}" for r, a, p in records) + " \n")
            _wrap(fh, seq)
            log(f"[dump] {nid} with {n} SNPs -> {path}")
    return 0
