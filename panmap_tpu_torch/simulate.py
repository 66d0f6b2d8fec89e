"""Standalone read/mutation simulator (dev tool).

Behavioral equivalent of the reference's simulate binary
(src/test/simulate.cpp:38-70 CLI, :329-354 spectrum-weighted indel lengths,
:357-486 genMut truth-VCF emission): pick a node (or RANDOM without
replacement per replicate), apply SNP/insertion/deletion mutations — counts,
substituted bases and indel lengths optionally modeled by a .mm mutation
matrix — then emit the mutated FASTA, a truth VCF, and simulated reads.

Deviation (documented): the reference shells out to InSilicoSeq (`iss
generate`) for reads; here reads are generated internally with an
Illumina-like error model (per-model error rates, paired-end, normal insert
sizes), so the tool has no external dependencies.
"""

from __future__ import annotations

import math
import os
import random

import numpy as np

from .io.panman import load_panman

READ_LEN = 150
INSERT_MEAN, INSERT_SD = 350.0, 50.0

# per-base substitution-error rates standing in for the InSilicoSeq models
ERROR_MODELS = {
    "HiSeq": 0.0025,
    "NextSeq": 0.0020,
    "NovaSeq": 0.0015,
    "MiSeq": 0.0040,
}


def _weighted_lengths(mat: dict, lo: int, hi: int):
    """Spectrum-weighted indel lengths (simulate.cpp:329-354 genLen): weight
    10^((minPhred - phred)/10) per length in [lo, hi]."""
    probs = [mat.get(i, None) for i in range(lo, hi + 1)]
    known = [p for p in probs if p is not None]
    if not known:
        return None
    mn = min(known)
    wgts = [10 ** ((mn - p) / 10.0) if p is not None else 0.0 for p in probs]
    tot = sum(wgts)
    if tot <= 0:
        return None
    return list(range(lo, hi + 1)), [w / tot for w in wgts]


def _snp_alt_weights(submat: np.ndarray):
    """Row-normalized substitution weights from the phred-scaled 4x4
    (lower phred = more likely)."""
    w = 10 ** (-submat / 10.0)
    np.fill_diagonal(w, 0.0)
    rows = w.sum(axis=1, keepdims=True)
    rows[rows == 0] = 1.0
    return w / rows


def simulate_mutations(seq: str, n_snp: int, n_ins: int, n_del: int,
                       indel_len: tuple, rng: random.Random,
                       mut_spec=None, spec_type: str = ""):
    """Apply mutations to `seq`; returns (mutated, vcf_rows) with rows as
    (pos1, ref, alt) in ORIGINAL coordinates.  1kb flank guard and
    no-overlap semantics follow the SNP simulator in tools.py."""
    bases = "ACGT"
    L = len(seq)
    lo, hi = (1000, L - 1001) if L > 2000 else (0, L - 1)
    if hi <= lo:
        return seq, []

    snp_w = None
    ins_lens = del_lens = None
    if mut_spec is not None and spec_type in ("snp", "both", "indel"):
        submat, insmat, delmat = mut_spec
        if spec_type in ("snp", "both"):
            snp_w = _snp_alt_weights(submat)
        if spec_type in ("indel", "both"):
            ins_lens = _weighted_lengths(insmat, *indel_len)
            del_lens = _weighted_lengths(delmat, *indel_len)

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
                if snp_w is not None:
                    alt = rng.choices(bases, weights=snp_w[bases.index(ref)])[0]
                    if alt == ref:
                        continue
                else:
                    alt = rng.choice([b for b in bases if b != ref])
                events.append((p, "S", alt))
            elif kind == "I":
                if seq[p] not in bases:
                    continue
                if ins_lens:
                    ln = rng.choices(ins_lens[0], weights=ins_lens[1])[0]
                else:
                    ln = rng.randint(*indel_len)
                if not claim(p, 1):
                    continue
                ins = "".join(rng.choice(bases) for _ in range(ln))
                events.append((p, "I", ins))
            else:
                if del_lens:
                    ln = rng.choices(del_lens[0], weights=del_lens[1])[0]
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


def _write_vcf(path: str, chrom: str, rows: list):
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write(f"##contig=<ID={chrom}>\n")
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for pos, ref, alt in rows:
            fh.write(f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t.\tPASS\t.\n")


_COMP = str.maketrans("ACGTN", "TGCAN")


def generate_reads(seq: str, n_pairs: int, err: float, rng: random.Random):
    """Paired-end Illumina-like reads: uniform fragment start, normal insert
    size, per-base substitution errors at rate `err`, phred ~ Q37 with noise."""
    L = len(seq)
    bases = "ACGT"
    out = []
    for i in range(n_pairs):
        ins = max(int(rng.gauss(INSERT_MEAN, INSERT_SD)), READ_LEN + 10)
        ins = min(ins, L)
        start = rng.randint(0, L - ins)
        frag = seq[start : start + ins]
        r1 = frag[:READ_LEN]
        r2 = frag[-READ_LEN:].translate(_COMP)[::-1]

        def noise(r):
            chars = list(r)
            quals = []
            for j, c in enumerate(chars):
                if c in bases and rng.random() < err:
                    chars[j] = rng.choice([b for b in bases if b != c])
                    quals.append(chr(33 + rng.randint(12, 25)))
                else:
                    quals.append(chr(33 + min(40, max(25, int(rng.gauss(37, 3))))))
            return "".join(chars), "".join(quals)

        s1, q1 = noise(r1)
        s2, q2 = noise(r2)
        out.append((f"sim_{i}", s1, q1, s2, q2))
    return out


def run_simulate(panman: str, ref: str, out_prefix: str, mutnum: list,
                 indel_len: list, mut_spec_path: str, mut_spec_type: str,
                 mutation_rate: float, rep: int, n_reads: int, model: str,
                 no_reads: bool, seed: str, log=print) -> int:
    tree = load_panman(panman)
    rng = random.Random(seed if seed else None)
    mut_spec = None
    if mut_spec_path:
        from .genotype.caller import load_mutation_matrix

        mut_spec = load_mutation_matrix(mut_spec_path)

    n_snp, n_ins, n_del = (list(mutnum) + [10, 0, 0])[:3] if mutnum else [10, 0, 0]
    if mutation_rate > 0:
        n_snp = max(int(round(mutation_rate * n_snp)), 0)
    err = ERROR_MODELS.get(model, ERROR_MODELS["NovaSeq"])

    leaves = [n.identifier for n in tree.dfs_order if not n.children]
    chosen = []
    if ref == "RANDOM":
        pool = leaves[:]
        rng.shuffle(pool)
        chosen = pool[:rep]
        if len(chosen) < rep:
            log(f"[sim] only {len(chosen)} distinct leaves available")
    else:
        chosen = [ref] * rep

    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)
    for r, node in enumerate(chosen):
        seq = tree.get_string(node)
        if not seq:
            log(f"[sim] node {node} not found or empty")
            return 1
        mutated, rows = simulate_mutations(
            seq, int(n_snp), int(n_ins), int(n_del),
            (indel_len[0], indel_len[1]), rng, mut_spec, mut_spec_type)
        tag = f"{out_prefix}.rep{r}" if rep > 1 else out_prefix
        safe = node.replace("/", "_")
        with open(tag + ".fa", "w") as fh:
            fh.write(f">{safe}\n")
            for i in range(0, len(mutated), 80):
                fh.write(mutated[i : i + 80] + "\n")
        _write_vcf(tag + ".truth.vcf", safe, rows)
        log(f"[sim] rep {r}: {node} +{len(rows)} mutations -> {tag}.fa, "
            f"{tag}.truth.vcf")
        if not no_reads:
            if _run_iss(tag, model, n_reads, seed, log):
                continue  # reference-exact InSilicoSeq path succeeded
            pairs = generate_reads(mutated, n_reads // 2, err, rng)
            with open(tag + "_R1.fastq", "w") as f1, \
                    open(tag + "_R2.fastq", "w") as f2:
                for name, s1, q1, s2, q2 in pairs:
                    f1.write(f"@{name}/1\n{s1}\n+\n{q1}\n")
                    f2.write(f"@{name}/2\n{s2}\n+\n{q2}\n")
            log(f"[sim] rep {r}: {len(pairs)} read pairs ({model} err={err}) "
                f"-> {tag}_R[12].fastq")
    return 0


def _run_iss(tag: str, model: str, n_reads: int, seed: str, log) -> bool:
    """The reference's exact read generator: shell out to InSilicoSeq
    (`iss generate --model <m> --genomes <fa> -n N --output <prefix> --cpus
    C --seed S`, simulate.cpp:533-540).  Used whenever `iss` is on PATH;
    this image does not bundle it, so the internal Illumina-like model above
    is the fallback (documented deviation)."""
    import shutil
    import subprocess

    if shutil.which("iss") is None:
        return False
    cmd = ["iss", "generate", "--model", model, "--genomes", tag + ".fa",
           "-n", str(n_reads), "--output", tag,
           "--cpus", str(os.cpu_count() or 1)]
    if seed:
        cmd += ["--seed", seed]
    log(f"[sim] iss cmd: {' '.join(cmd)}")
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=3600)
    except Exception as exc:
        log(f"[sim] iss failed ({exc}); internal read model instead")
        return False
    return True
