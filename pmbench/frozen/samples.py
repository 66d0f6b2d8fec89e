"""Frozen copies of the sample makers, and the benchmark's traffic
generator built on them.

simulate_mutations is copied from panmap_tpu_torch/simulate.py;
_simulate_pairs, _write_fastq_codes and META_PROPORTIONS from
panmap_tpu_torch/synthetic.py; READ_LEN, INSERT_MEAN, INSERT_SD and the
NovaSeq error rate from panmap_tpu_torch/simulate.py; all as of commit
3519e45.  The program's make_panman_workload simulates an isolate's reads
with simulate.generate_reads (one Python call a pair); the benchmark draws
them with _simulate_pairs, the same model (normal insert, uniform start,
substitutions, phred ~Q37) in numpy, so that a sample is made in about a
second.  The plate split of chip_smoke.py (8 samples of one read set) is
replaced by 8 isolates of their own leaves.  Nothing here imports the
program.
"""

from __future__ import annotations

import random

import numpy as np

READ_LEN = 150
INSERT_MEAN, INSERT_SD = 350.0, 50.0
NOVASEQ_ERROR = 0.0015
META_PROPORTIONS = (0.40, 0.25, 0.15, 0.12, 0.08)


def simulate_mutations(seq: str, n_snp: int, n_ins: int, n_del: int,
                       indel_len: tuple, rng: random.Random):
    """Apply mutations to `seq`; returns (mutated, vcf_rows) with rows as
    (pos1, ref, alt) in ORIGINAL coordinates.  1kb flank guard and
    no-overlap semantics follow the SNP simulator in tools.py.  (The
    original's mutation-spectrum options are left out: the benchmark does
    not use them.)"""
    bases = "ACGT"
    L = len(seq)
    lo, hi = (1000, L - 1001) if L > 2000 else (0, L - 1)
    if hi <= lo:
        return seq, []

    used = set()
    events = []  # (pos, kind, payload)

    def claim(p, span):
        if any(q in used for q in range(p - 1, p + span + 1)):
            return False
        used.update(range(p - 1, p + span + 1))
        return True

    tries = 0
    want = [("S", n_snp), ("I", n_ins), ("D", n_del)]
    for kind, count in want:
        made = 0
        while made < count and tries < 50 * (count + 1) + 1000:
            tries += 1
            p = rng.randint(lo, hi)
            if kind == "S":
                ref = seq[p]
                if ref not in bases or not claim(p, 1):
                    continue
                alt = rng.choice([b for b in bases if b != ref])
                events.append((p, "S", alt))
            elif kind == "I":
                if seq[p] not in bases:
                    continue
                ln = rng.randint(*indel_len)
                if not claim(p, 1):
                    continue
                ins = "".join(rng.choice(bases) for _ in range(ln))
                events.append((p, "I", ins))
            else:
                ln = rng.randint(*indel_len)
                if p + ln > hi or seq[p] not in bases:
                    continue
                if not claim(p, ln + 1):
                    continue
                events.append((p, "D", ln))
            made += 1

    # apply right-to-left so earlier coordinates stay valid
    out = list(seq)
    rows = []
    for p, kind, payload in sorted(events, reverse=True):
        if kind == "S":
            rows.append((p + 1, seq[p], payload))
            out[p] = payload
        elif kind == "I":
            # VCF convention: anchor base + insertion
            rows.append((p + 1, seq[p], seq[p] + payload))
            out[p] = seq[p] + payload
        else:
            ln = payload
            rows.append((p, seq[p - 1] + seq[p : p + ln], seq[p - 1]))
            del out[p : p + ln]
    rows.sort()
    return "".join(out), rows


def _simulate_pairs(rng, haps: list, props, n_pairs: int, err: float):
    """Paired 150 bp reads as simulate.generate_reads makes them (normal
    insert size, uniform start, substitutions at rate ``err``, phred ~Q37,
    Q12-25 on errors), drawn from ``haps`` by ``props``, vectorised.
    Returns (r1 codes, r2 codes, r1 quals, r2 quals) as uint8 arrays."""
    codes = [np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                             np.frombuffer(h.encode(), np.uint8))
             for h in haps]
    lens = np.array([len(c) for c in codes])
    offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
    allc = np.concatenate(codes).astype(np.uint8)
    hap = rng.choice(len(haps), n_pairs, p=np.asarray(props) / sum(props))
    ins = rng.normal(INSERT_MEAN, INSERT_SD, n_pairs).astype(np.int64)
    ins = np.minimum(np.maximum(ins, READ_LEN + 10), lens[hap])
    start = (rng.random(n_pairs) * (lens[hap] - ins + 1)).astype(np.int64)
    col = np.arange(READ_LEN)
    base = (offs[hap] + start)[:, None]
    r1 = allc[base + col]
    r2 = 3 - allc[base + ins[:, None] - READ_LEN + col][:, ::-1]
    out = []
    for r in (r1, r2):
        bad = rng.random(r.shape) < err
        r = np.where(bad, (r + rng.integers(1, 4, r.shape)) % 4, r)
        q = np.clip(rng.normal(37, 3, r.shape).astype(np.int64), 25, 40)
        q = np.where(bad, rng.integers(12, 26, r.shape), q)
        out.append((r.astype(np.uint8), (q + 33).astype(np.uint8)))
    return out[0][0], out[1][0], out[0][1], out[1][1]


def _write_fastq_codes(path: str, mate: int, codes, quals):
    acgt = np.frombuffer(b"ACGT", np.uint8)
    n, L = codes.shape
    seqs = acgt[codes].tobytes().decode()
    qs = quals.tobytes().decode()
    with open(path, "w") as fh:
        fh.write("".join(f"@sim_{i}/{mate}\n{seqs[i * L:(i + 1) * L]}\n+\n"
                         f"{qs[i * L:(i + 1) * L]}\n" for i in range(n)))
