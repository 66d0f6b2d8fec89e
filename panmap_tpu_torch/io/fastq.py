"""FASTQ reading: plain or gzip, sequences-only fast path and full records.

Mirrors the reference's read-ordering conventions:
 - placement reads R1 then R2 *without* reverse-complementing, then interleaves
   pairs (src/placement.cpp:164-197 extractReadSequences + perfect_shuffle);
 - alignment reads R2 reverse-complemented with reversed quals
   (src/seeding.cpp:231-269 readFastqPaired).
"""

from __future__ import annotations

import gzip

from ..sketch.cpu import reverse_complement


def _open(path: str):
    with open(path, "rb") as fh:
        magic = fh.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "r")


# (path, mtime, size) -> (names, seqs, quals): the pipeline parses each
# FASTQ twice (placement wants seqs, alignment wants full records); one bulk
# parse serves both.  Tiny FIFO so batch mode over many samples stays
# memory-bounded.
_PARSE_CACHE: dict = {}
_PARSE_CACHE_MAX = 4


def _read_bulk(path: str):
    """Whole-file bulk FASTQ parse: one decompress, one split — ~10x the
    readline/gzip.read1 streaming loop on 100k-read files.  Returns
    (names, seqs, quals) or None when the file is FASTA/malformed (caller
    falls back to the streaming oracle parser)."""
    import os

    try:
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size)
    except OSError:
        key = None
    if key is not None and key in _PARSE_CACHE:
        return _PARSE_CACHE[key]
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    if not raw.startswith(b"@"):
        return None  # FASTA/empty: streaming parser handles it
    text = raw.decode("latin-1")
    del raw
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    if lines and lines[0].endswith("\r"):  # CRLF files: rare, stream instead
        return None
    nrec = len(lines) // 4
    if nrec * 4 != len(lines):
        return None  # wrapped/truncated records: streaming parser decides
    headers = lines[0::4]
    seqs = lines[1::4]
    pluses = lines[2::4]
    quals = lines[3::4]
    if not all(p.startswith("+") for p in pluses) \
            or not all(h.startswith("@") for h in headers):
        return None
    names = [h[1:].split(None, 1)[0] if " " in h or "\t" in h else h[1:]
             for h in headers]
    quals = [q if q else "I" * len(s) for q, s in zip(quals, seqs)]
    out = (names, seqs, quals)
    if key is not None:
        if len(_PARSE_CACHE) >= _PARSE_CACHE_MAX:
            _PARSE_CACHE.pop(next(iter(_PARSE_CACHE)))
        _PARSE_CACHE[key] = out
    return out


def read_sequences(path: str) -> list[str]:
    """Sequences only, in file order. FASTQ or FASTA."""
    bulk = _read_bulk(path)
    if bulk is not None:
        return bulk[1]
    seqs = []
    with _open(path) as fh:
        first = fh.read(1)
        if not first:
            return seqs
        if first == ">":  # FASTA
            cur = []
            for line in fh:
                line = line.rstrip("\n\r")
                if line.startswith(">"):
                    if cur:
                        seqs.append("".join(cur))
                        cur = []
                else:
                    cur.append(line)
            if cur:
                seqs.append("".join(cur))
            return seqs
        # FASTQ (first char was '@', already consumed)
        while True:
            header = fh.readline()
            if first is not None:
                header = first + header  # re-attach consumed '@'
                first = None
            if not header:
                break
            seq = fh.readline().rstrip("\n\r")
            plus = fh.readline()
            qual = fh.readline()
            if not qual and not seq:
                break
            seqs.append(seq)
    return seqs


def read_full(path: str):
    """(names, sequences, quals). FASTA quals are all-'I' (kseq convention).
    Bulk fast path for well-formed FASTQ; the streaming `_iter_records`
    remains the oracle (and the FASTA/odd-format path)."""
    bulk = _read_bulk(path)
    if bulk is not None:
        return bulk
    names, seqs, quals = [], [], []
    for nm, s, q in _iter_records(path):
        names.append(nm)
        seqs.append(s)
        quals.append(q)
    return names, seqs, quals


def perfect_shuffle(v: list) -> list:
    """Interleave halves: [a0..an, b0..bn] -> [a0, b0, a1, b1, ...]
    (src/seeding.hpp:32-43)."""
    n = len(v)
    if n < 2:
        return list(v)
    half = n // 2
    out = [None] * n
    out[0::2] = v[:half]
    out[1::2] = v[half : half * 2]
    if n % 2:
        out[-1] = v[-1]
    return out


class ReadBatch(list):
    """A list of read strings that lazily caches its joined byte buffer +
    CSR offsets — the form every native batch kernel consumes.  Joining 100k
    strings costs ~30 ms per call; batches built by the fastq readers pay it
    once.  Mutating the list after the first cached_join() is unsupported
    (the readers never do)."""

    def cached_join(self):
        j = getattr(self, "_joined", None)
        if j is None:
            import numpy as np

            buf = np.frombuffer("".join(self).encode(), dtype=np.uint8)
            lens = np.fromiter((len(s) for s in self), dtype=np.int64,
                               count=len(self))
            offsets = np.concatenate(([0], np.cumsum(lens)))
            j = self._joined = (buf, offsets, lens)
        return j


def read_paired_for_placement(path1: str, path2: str | None) -> list[str]:
    """R1 + raw R2, pair-interleaved (no revcomp) — placement convention."""
    seqs = read_sequences(path1)
    if path2:
        r2 = read_sequences(path2)
        if len(r2) != len(seqs):
            raise ValueError(f"{path2} does not contain the same number of reads as {path1}")
        seqs = perfect_shuffle(seqs + r2)
    return ReadBatch(seqs)


def read_paired_for_placement_with_quals(path1: str, path2: str | None):
    """(seqs, quals) in the placement convention (raw orientation, pair
    interleave) — used by the --min-seed-quality sketch path."""
    _, s1, q1 = read_full(path1)
    if path2:
        _, s2, q2 = read_full(path2)
        if len(s2) != len(s1):
            raise ValueError(f"{path2} does not contain the same number of reads as {path1}")
        return perfect_shuffle(s1 + s2), perfect_shuffle(q1 + q2)
    return s1, q1


def read_paired_for_alignment(path1: str, path2: str | None):
    """(names, seqs, quals) with R2 reverse-complemented and quals reversed,
    pair-interleaved — alignment convention (src/seeding.cpp:231-269)."""
    names, seqs, quals = read_full(path1)
    if path2:
        n2, s2, q2 = read_full(path2)
        if len(s2) != len(seqs):
            raise ValueError(f"{path2} does not contain the same number of reads as {path1}")
        s2 = [reverse_complement(x) for x in s2]
        q2 = [x[::-1] for x in q2]
        names = perfect_shuffle(names + n2)
        seqs = perfect_shuffle(seqs + s2)
        quals = perfect_shuffle(quals + q2)
    return names, ReadBatch(seqs), quals


def _iter_records(path: str):
    """Stream (name, seq, qual) records from a FASTA/FASTQ file without
    loading it whole (kseq-style)."""
    with _open(path) as fh:
        first = fh.read(1)
        if not first:
            return
        if first == ">":
            name, chunks = None, []
            line = ">" + fh.readline()
            while line:
                line = line.rstrip("\r\n")
                if line.startswith(">"):
                    if name is not None:
                        s = "".join(chunks)
                        yield name, s, "I" * len(s)
                    name = line[1:].split()[0]
                    chunks = []
                elif line:
                    chunks.append(line)
                line = fh.readline()
            if name is not None:
                s = "".join(chunks)
                yield name, s, "I" * len(s)
            return
        header = first + fh.readline().rstrip("\r\n")
        while header:
            seq = fh.readline().rstrip("\r\n")
            plus = fh.readline()
            if not plus.startswith("+"):
                break  # truncated trailing record (read_full drops it too)
            qual = fh.readline().rstrip("\r\n")
            yield header[1:].split()[0], seq, qual if qual else "I" * len(seq)
            header = fh.readline().rstrip("\r\n")


def read_full_batches(path1: str, path2: str | None, batch_size: int):
    """Yield (names, seqs, quals) in chunks of <= batch_size reads, parsed
    incrementally so memory stays bounded by the batch (reference: the
    filter-and-assign TBB pipeline streams 1M-read batches,
    main.cpp:790-933).  Paired inputs interleave R1/R2 with the R2
    reverse-complement convention of read_paired_for_alignment."""
    names, seqs, quals = [], [], []
    if path2:
        it1, it2 = _iter_records(path1), _iter_records(path2)
        while True:
            r1 = next(it1, None)
            r2 = next(it2, None)
            if r1 is None and r2 is None:
                break
            if r1 is None or r2 is None:
                raise ValueError(
                    f"{path2} does not contain the same number of reads "
                    f"as {path1}")
            names.append(r1[0])
            seqs.append(r1[1])
            quals.append(r1[2])
            names.append(r2[0])
            seqs.append(reverse_complement(r2[1]))
            quals.append(r2[2][::-1])
            if len(names) >= batch_size:
                yield names, seqs, quals
                names, seqs, quals = [], [], []
    else:
        for nm, s, q in _iter_records(path1):
            names.append(nm)
            seqs.append(s)
            quals.append(q)
            if len(names) >= batch_size:
                yield names, seqs, quals
                names, seqs, quals = [], [], []
    if names:
        yield names, seqs, quals
