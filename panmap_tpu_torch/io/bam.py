"""Pure-python BAM writing: BGZF container + BAM record encoding + BAI index.

Replaces the reference's htslib dependency for the alignment artifact
(src/conversion.cpp:390-538 alignAndWriteBam): coordinate-sorted records,
SAM flags / TLEN conventions identical to compute_sam_flags / compute_tlen.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# SAM flags
FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80

CIGAR_OPS = "MIDNSHP=X"
_CIGAR_CODE = {c: i for i, c in enumerate(CIGAR_OPS)}

_SEQ_NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
# byte -> nt16 code lookup (upper/lowercase), unknowns -> N(15)
_NT16_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _i in _SEQ_NT16.items():
    _NT16_LUT[ord(_c)] = _i
    _NT16_LUT[ord(_c.lower())] = _i


def _bgzf_block(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25 + 1
    header = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00\x42\x43\x02\x00"
        + struct.pack("<H", bsize - 1)
    )
    return header + comp + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))


BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


class BgzfWriter:
    def __init__(self, path: str, level: int = 6):
        self.fh = open(path, "wb")
        self.level = level
        self.buf = bytearray()

    def write(self, data: bytes):
        self.buf += data
        while len(self.buf) >= 65000:
            self.fh.write(_bgzf_block(bytes(self.buf[:65000]), self.level))
            del self.buf[:65000]

    def close(self):
        if self.buf:
            self.fh.write(_bgzf_block(bytes(self.buf), self.level))
            self.buf.clear()
        self.fh.write(BGZF_EOF)
        self.fh.close()


def encode_bam_record(qname: str, flag: int, tid: int, pos: int, mapq: int,
                      cigar: list, mtid: int, mpos: int, tlen: int,
                      seq: str, qual_phred: bytes, tags: bytes = b"") -> bytes:
    """One BAM alignment record. cigar = [(length, op_char)]; pos 0-based."""
    qname_b = qname.encode() + b"\x00"
    n_cigar = len(cigar)
    cigar_b = b"".join(struct.pack("<I", (ln << 4) | _CIGAR_CODE[op]) for ln, op in cigar)
    l_seq = len(seq)
    codes = _NT16_LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]
    if l_seq & 1:
        codes = np.concatenate([codes, np.zeros(1, dtype=np.uint8)])
    seq_nib = ((codes[0::2] << 4) | codes[1::2]).tobytes()
    # end position for bin computation
    ref_len = sum(ln for ln, op in cigar if op in "MDN=X")
    end = pos + max(ref_len, 1) - 1
    bin_ = _reg2bin(pos, end + 1)
    body = struct.pack(
        "<iiBBHHHiiii",
        tid, pos, len(qname_b), mapq, bin_, n_cigar, flag,
        l_seq, mtid, mpos, tlen,
    ) + qname_b + cigar_b + seq_nib + bytes(qual_phred) + tags
    return struct.pack("<I", len(body)) + body


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _encode_records_batch(records: list) -> bytes:
    """Batched BAM record encoding: nibble packing and bin computation run
    vectorized over the whole record set; per-record assembly only joins
    precomputed byte fragments.  Byte-identical to encode_bam_record (the
    per-record oracle, cross-checked by tests/test_bam_batch.py)."""
    nrec = len(records)
    joined_seq = "".join(r["seq"] for r in records)
    codes = _NT16_LUT[np.frombuffer(joined_seq.encode(), dtype=np.uint8)]
    lseq = np.fromiter((len(r["seq"]) for r in records), np.int64, nrec)
    off = np.concatenate(([0], np.cumsum(lseq)))
    nib_len = (lseq + 1) // 2
    nib_off = np.concatenate(([0], np.cumsum(nib_len)))
    total_nib = int(nib_off[-1])
    # global gather: nibble byte j of record r packs codes[2j], codes[2j+1]
    rec_of = np.repeat(np.arange(nrec), nib_len)
    local = np.arange(total_nib) - np.repeat(nib_off[:-1], nib_len)
    i0 = off[rec_of] + 2 * local
    i1 = i0 + 1
    pad = i1 >= off[rec_of] + lseq[rec_of]  # odd-length tail pads 0
    hi = codes[i0]
    lo = np.where(pad, 0, codes[np.minimum(i1, len(codes) - 1)])
    nibbles = ((hi << 4) | lo).astype(np.uint8).tobytes()
    # bins, vectorized _reg2bin
    pos = np.fromiter((r["pos"] for r in records), np.int64, nrec)
    ref_span = np.fromiter(
        (sum(ln for ln, op in r["cigar"] if op in "MDN=X") for r in records),
        np.int64, nrec)
    end = pos + np.maximum(ref_span, 1) - 1  # inclusive end (= _reg2bin's)
    bins = _reg2bin_vec(pos, end)
    out = []
    pk = struct.pack
    for i, r in enumerate(records):
        qname_b = r["qname"].encode() + b"\x00"
        cigar = r["cigar"]
        cigar_b = b"".join(pk("<I", (ln << 4) | _CIGAR_CODE[op])
                           for ln, op in cigar)
        tags = r.get("tags", b"")
        body = pk("<iiBBHHHiiii", 0, r["pos"], len(qname_b), r["mapq"],
                  int(bins[i]), len(cigar), r["flag"], int(lseq[i]),
                  r.get("mtid", -1), r.get("mpos", -1), r.get("tlen", 0)
                  ) + qname_b + cigar_b \
            + nibbles[int(nib_off[i]):int(nib_off[i + 1])] \
            + bytes(r["qual"]) + tags
        out.append(pk("<I", len(body)) + body)
    return b"".join(out)


def _bgzf_compress_parallel(data: bytes, level: int, threads: int = 0) -> bytes:
    """Compress a byte stream into independent 65000-byte BGZF blocks using a
    thread pool (zlib releases the GIL)."""
    import concurrent.futures as cf
    import os

    if threads <= 0:
        threads = min(os.cpu_count() or 1, 8)
    chunks = [data[i:i + 65000] for i in range(0, len(data), 65000)]
    if len(chunks) <= 2 or threads == 1:
        return b"".join(_bgzf_block(c, level) for c in chunks)
    with cf.ThreadPoolExecutor(threads) as ex:
        blocks = list(ex.map(lambda c: _bgzf_block(c, level), chunks))
    return b"".join(blocks)


def write_bam(path: str, ref_name: str, ref_len: int, records: list,
              write_bai: bool = True):
    """records: list of dicts with keys qname, flag, pos, mapq, cigar, mtid,
    mpos, tlen, seq, qual (phred bytes), already coordinate-sorted."""
    header_text = f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{ref_name}\tLN:{ref_len}\n"
    ht = header_text.encode()
    rn = ref_name.encode() + b"\x00"
    stream = (b"BAM\x01" + struct.pack("<i", len(ht)) + ht
              + struct.pack("<i", 1)
              + struct.pack("<i", len(rn)) + rn + struct.pack("<i", ref_len))
    if records:
        stream += _encode_records_batch(records)
    with open(path, "wb") as fh:
        # compress+write in bounded slices so peak memory stays O(slice),
        # not O(2x BAM) (BGZF blocks are independent)
        SLICE = 64 * 65000
        for o in range(0, len(stream), SLICE):
            fh.write(_bgzf_compress_parallel(stream[o:o + SLICE], level=6))
        fh.write(BGZF_EOF)
    if write_bai:
        _write_bai(path + ".bai", records, ref_len)


def _write_bai(path: str, records: list, ref_len: int):
    """Minimal BAI: since we don't track virtual offsets per record (records are
    written through a streaming bgzf), emit an index with a single pseudo
    interval covering the file. Readers that need random access should rebuild;
    the pipeline itself never reads it (parity artifact only)."""
    with open(path, "wb") as fh:
        fh.write(b"BAI\x01")
        fh.write(struct.pack("<i", 1))  # n_ref
        fh.write(struct.pack("<i", 0))  # n_bin
        n_intv = (ref_len >> 14) + 1
        fh.write(struct.pack("<i", n_intv))
        fh.write(struct.pack("<Q", 0) * n_intv)
        fh.write(struct.pack("<Q", len(records)))  # n_no_coor (unused slot)


def compute_sam_flags(is_paired: bool, is_read1: bool, rev: bool, mate_rev: bool,
                      proper_frag: bool, mate_unmapped: bool) -> int:
    """src/conversion.cpp:257-274."""
    flag = 0
    if is_paired:
        flag |= FPAIRED
        if proper_frag:
            flag |= FPROPER_PAIR
        if rev:
            flag |= FREVERSE
        if mate_rev:
            flag |= FMREVERSE
        if mate_unmapped:
            flag |= FMUNMAP
        flag |= FREAD1 if is_read1 else FREAD2
    else:
        if rev:
            flag |= FREVERSE
    return flag


def compute_tlen(this_rs, this_re, this_rev, mate_rs, mate_re, mate_rev) -> int:
    """src/conversion.cpp:276-286."""
    this5 = this_re - 1 if this_rev else this_rs
    mate5 = mate_re - 1 if mate_rev else mate_rs
    tlen = mate5 - this5
    if tlen > 0:
        tlen += 1
    elif tlen < 0:
        tlen -= 1
    return tlen


_BAM_HEAD_DT = np.dtype([
    ("blen", "<u4"), ("tid", "<i4"), ("pos", "<i4"), ("lqn", "u1"),
    ("mapq", "u1"), ("bin", "<u2"), ("ncig", "<u2"), ("flag", "<u2"),
    ("lseq", "<i4"), ("mtid", "<i4"), ("mpos", "<i4"), ("tlen", "<i4")])
assert _BAM_HEAD_DT.itemsize == 36


def _reg2bin_vec(pos: np.ndarray, end_incl: np.ndarray) -> np.ndarray:
    bins = np.zeros(len(pos), np.int64)
    done = np.zeros(len(pos), bool)
    for shift, base in ((14, ((1 << 15) - 1) // 7), (17, ((1 << 12) - 1) // 7),
                        (20, ((1 << 9) - 1) // 7), (23, ((1 << 6) - 1) // 7),
                        (26, ((1 << 3) - 1) // 7)):
        hit = ~done & ((pos >> shift) == (end_incl >> shift))
        bins[hit] = base + (pos[hit] >> shift)
        done |= hit
    return bins


def _scatter_section(out: np.ndarray, dst_off: np.ndarray,
                     lens: np.ndarray, blob: np.ndarray):
    """out[dst_off[i] : dst_off[i]+lens[i]] = blob[src_off[i]:...] for all i
    (blob is the records' section data concatenated in record order).  Native
    fast path: a memcpy per row (pt_copy_rows); the fancy-index below is the
    numpy oracle/fallback."""
    total = int(lens.sum())
    if total == 0:
        return
    from ..native import copy_rows_native

    src_off = np.concatenate(([0], np.cumsum(lens, dtype=np.int64)[:-1]))
    if copy_rows_native(blob[:total], src_off, dst_off, lens, out):
        return
    lens32 = lens.astype(np.int32)
    start = (np.repeat(dst_off.astype(np.int64), lens32)
             - np.repeat(src_off, lens32))
    idx = start.astype(np.int64) + np.arange(total, dtype=np.int64)
    out[idx] = blob[:total]


def encode_bam_columnar(pos, flag, mapq, mtid, mpos, tlen, ref_span,
                        qname_blob: bytes, qname_off: np.ndarray,
                        cig_stream: np.ndarray, cig_off: np.ndarray,
                        seq_blob: np.ndarray, qual_blob: np.ndarray,
                        seq_off: np.ndarray) -> bytes:
    """Fully vectorized BAM record stream from columnar inputs (records in
    final order).  qname_blob contains NUL-terminated names back to back;
    cig_stream is (len<<4|op) u32s; seq_blob ASCII bases (oriented);
    qual_blob raw phred bytes; seq_off/qname_off/cig_off are n+1 offset
    arrays.  Byte-identical to encode_bam_record per record (cross-checked
    by tests/test_bam_batch.py)."""
    n = len(pos)
    pos = np.asarray(pos, np.int64)
    lqn = np.diff(qname_off).astype(np.int64)
    ncig = np.diff(cig_off).astype(np.int64)
    lseq = np.diff(seq_off).astype(np.int64)
    nib_len = (lseq + 1) // 2
    blen = 32 + lqn + 4 * ncig + nib_len + lseq
    rec_len = blen + 4
    rec_off = np.concatenate(([0], np.cumsum(rec_len)))
    total = int(rec_off[-1])
    end = pos + np.maximum(np.asarray(ref_span, np.int64), 1) - 1
    head = np.empty(n, dtype=_BAM_HEAD_DT)
    head["blen"] = blen
    head["tid"] = 0
    head["pos"] = pos
    head["lqn"] = lqn
    head["mapq"] = mapq
    head["bin"] = _reg2bin_vec(pos, end)
    head["ncig"] = ncig
    head["flag"] = flag
    head["lseq"] = lseq
    head["mtid"] = mtid
    head["mpos"] = mpos
    head["tlen"] = tlen
    out = np.empty(total, np.uint8)
    hb = head.view(np.uint8).reshape(n, 36)
    hidx = (rec_off[:-1][:, None] + np.arange(36)[None, :]).ravel()
    out[hidx] = hb.ravel()
    cur = rec_off[:-1] + 36
    _scatter_section(out, cur, lqn,
                     np.frombuffer(qname_blob, np.uint8))
    cur = cur + lqn
    _scatter_section(out, cur, 4 * ncig,
                     np.ascontiguousarray(cig_stream, "<u4").view(np.uint8))
    cur = cur + 4 * ncig
    # nibble packing over the whole oriented seq blob, per record parity
    from ..native import pack_nibbles_native

    if pack_nibbles_native(np.asarray(seq_blob, np.uint8),
                           np.asarray(seq_off, np.int64), _NT16_LUT, out,
                           np.asarray(cur, np.int64)):
        pass  # packed straight into the record stream
    else:
        codes = _NT16_LUT[seq_blob]
        nib_off = np.concatenate(([0], np.cumsum(nib_len)))
        total_nib = int(nib_off[-1])
        rec_of = np.repeat(np.arange(n), nib_len)
        local = np.arange(total_nib) - np.repeat(nib_off[:-1], nib_len)
        i0 = seq_off[:-1][rec_of] + 2 * local
        i1 = i0 + 1
        pad = i1 >= seq_off[:-1][rec_of] + lseq[rec_of]
        hi4 = codes[i0]
        lo4 = np.where(pad, 0, codes[np.minimum(i1, max(len(codes) - 1, 0))])
        nibbles = ((hi4 << 4) | lo4).astype(np.uint8)
        _scatter_section(out, cur, nib_len, nibbles)
    cur = cur + nib_len
    _scatter_section(out, cur, lseq, qual_blob)
    return out.tobytes()
