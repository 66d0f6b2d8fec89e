"""Reference `.idx` compatibility reader (VERDICT item 7 / SURVEY §7 step 3).

Reads an index file written by the reference binary's
`IndexBuilder::writeIndex` (src/index_single_mode.cpp:1593-1636): a 32-byte
uncompressed parameter header ("PMI1" magic, version, k/s/t/l, hpc/open/
uncompressed flags) followed by either the raw Cap'n Proto flat message or
independent 64MB ZSTD frames of it.  The payload is the LiteIndex struct
(src/index_lite.capnp:36-70) — decoded with the repo's schema-less capnp
walker into the same IndexArrays our own builder produces, so a
reference-built index can drive placement directly and, more importantly,
cross-validate our builder row-for-row (tools/validate_ref_idx.py).

Capnp field -> slot map for LiteIndex (field numbers from the schema;
pointer index = declaration order among pointer fields):
  data:  k u16@0, s u16@2, t u16@4, l u16@6, open bit@64, hpc bit@65,
         formatVersion u16@10
  ptrs:  0 liteTree, 1 seedChangeHashes, 2 seedChangeParentCounts,
         3 seedChangeChildCounts, 4 nodeChangeOffsets, 5..8 mgsr fields,
         9 perNodeChanges, 10 substitutionMatrix
"""

from __future__ import annotations

import struct

import numpy as np

from ..index.builder import IndexArrays, IndexParams
from .capnp import CapnpMessage

IDX_MAGIC = 0x31494D50  # "PMI1" little-endian
IDX_HEADER_VERSION = 1
IDX_HEADER_SIZE = 32


def read_idx_header(path: str) -> dict:
    """The 32-byte uncompressed parameter header (encodeIndexHeader)."""
    with open(path, "rb") as fh:
        h = fh.read(IDX_HEADER_SIZE)
    if len(h) < IDX_HEADER_SIZE:
        raise ValueError(f"{path}: truncated index header")
    magic, ver, k, s, t, l = struct.unpack_from("<6I", h, 0)
    if magic != IDX_MAGIC or ver != IDX_HEADER_VERSION:
        raise ValueError(f"{path}: not a reference .idx (magic/version)")
    return dict(k=k, s=s, t=t, l=l, hpc=h[24] != 0, open=h[25] != 0,
                uncompressed=h[26] != 0)


def _payload(path: str, uncompressed: bool) -> bytes:
    with open(path, "rb") as fh:
        fh.seek(IDX_HEADER_SIZE)
        blob = fh.read()
    if uncompressed:
        return blob
    import zstandard

    # concatenated independent frames: decompress them in sequence
    out = []
    off = 0
    dctx = zstandard.ZstdDecompressor()
    while off < len(blob):
        # one decompressobj per frame: it stops at frame end and reports
        # the remainder via unused_data
        dobj = dctx.decompressobj()
        chunk = dobj.decompress(blob[off:])
        out.append(chunk)
        consumed = len(blob) - off - len(dobj.unused_data)
        if consumed <= 0:
            raise ValueError("zstd frame did not advance")
        off += consumed
    return b"".join(out)


def _concat_ragged(lst, dtype):
    """List(List(T)) (the 500M-row segmenting of index_lite.capnp:45-48)
    concatenated into one array."""
    parts = []
    for i in range(len(lst)):
        inner = lst.ptr(i)
        parts.append(inner.as_numpy(dtype) if inner is not None
                     else np.empty(0, dtype))
    return (np.concatenate(parts) if parts else np.empty(0, dtype))


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

    def f64_list(self, at, values):
        n = len(values)
        tgt = self.alloc(n)
        bits = np.asarray(values, "<f8").view("<u8")
        for i in range(n):
            self.words[tgt + i] = int(bits[i])
        self.put_list_ptr(at, tgt, 5, n)

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


def write_ref_index(path: str, idx: IndexArrays, compressed: bool = False,
                    zstd_level: int = 3, segment_rows: int = 500_000_000):
    """Write IndexArrays in the REFERENCE's on-disk .idx format (PMI1 header
    + LiteIndex capnp payload, raw or multi-frame ZSTD) so a reference-
    binary user can consume an index built here.  read_ref_index is the
    round-trip check; formatVersion = 4 (panmap_utils.hpp:27)."""
    p = idx.params
    e = _CapnpEncoder()
    root = e.alloc(2 + 11)
    e.put_struct_ptr(0, root, 2, 11)
    d = bytearray(16)
    struct.pack_into("<HHHH", d, 0, p.k, p.s, p.t, p.l)
    d[8] = (1 if p.open else 0) | ((1 if p.hpc else 0) << 1)
    struct.pack_into("<H", d, 10, 4)  # formatVersion
    e.words[root] = struct.unpack_from("<Q", d, 0)[0]
    e.words[root + 1] = struct.unpack_from("<Q", d, 8)[0]
    P = root + 2

    lt = e.alloc(2)
    e.put_struct_ptr(P + 0, lt, 0, 2)
    n_nodes = len(idx.node_ids)
    el0 = e.composite_list(lt + 0, n_nodes, 1, 1)
    for i in range(n_nodes):
        base = el0 + i * 2
        e.words[base] = int(idx.parent_index[i]) \
            | ((1 if idx.identical_to_parent[i] else 0) << 32)
        e.text(base + 1, idx.node_ids[i])
    nb = len(idx.block_ranges)
    el1 = e.composite_list(lt + 1, nb, 1, 0)
    for i in range(nb):
        e.words[el1 + i] = int(idx.block_ranges[i, 0]) \
            | (int(idx.block_ranges[i, 1]) << 32)

    def ragged(pi, values, esize, bytes_per):
        n = len(values)
        nseg = max((n + segment_rows - 1) // segment_rows, 1)
        outer = e.alloc(nseg)
        e.put_list_ptr(P + pi, outer, 6, nseg)
        for si in range(nseg):
            e.prim_list(outer + si,
                        values[si * segment_rows : (si + 1) * segment_rows],
                        esize, bytes_per)

    ragged(1, idx.seed_hashes, 5, 8)
    ragged(2, idx.parent_counts, 3, 2)
    ragged(3, idx.child_counts, 3, 2)
    e.prim_list(P + 4, idx.node_offsets, 5, 8)
    e.f64_list(P + 10, np.asarray(idx.substitution_matrix,
                                  np.float64).reshape(-1)[:16])

    hdr = bytearray(IDX_HEADER_SIZE)
    struct.pack_into("<6I", hdr, 0, IDX_MAGIC, IDX_HEADER_VERSION,
                     p.k, p.s, p.t, p.l)
    hdr[24] = 1 if p.hpc else 0
    hdr[25] = 1 if p.open else 0
    hdr[26] = 0 if compressed else 1
    msg = e.message()
    with open(path, "wb") as fh:
        fh.write(bytes(hdr))
        if compressed:
            import zstandard

            cctx = zstandard.ZstdCompressor(level=zstd_level)
            FRAME = 64 * 1024 * 1024
            for off in range(0, len(msg), FRAME):
                fh.write(cctx.compress(msg[off : off + FRAME]))
        else:
            fh.write(msg)


def read_ref_index(path: str) -> IndexArrays:
    """Decode a reference-built .idx into IndexArrays."""
    hdr = read_idx_header(path)
    msg = CapnpMessage(_payload(path, hdr["uncompressed"]))
    root = msg.root()

    k = root.u16(0)
    s = root.u16(2)
    t = root.u16(4)
    l = root.u16(6)
    open_ = root.bool_(64)
    hpc = root.bool_(65)
    fmt = root.u16(10)
    if fmt not in (0, 4):
        raise ValueError(f"{path}: unsupported formatVersion {fmt}")

    tree = root.ptr(0)
    nodes = tree.ptr(0) if tree is not None else None
    node_ids = []
    parent_index = []
    identical = []
    if nodes is not None:
        for nd in nodes.structs():
            node_ids.append(nd.text(0) or "")
            parent_index.append(nd.u32(0))
            identical.append(nd.bool_(32))
    brs = tree.ptr(1) if tree is not None else None
    if brs is not None and len(brs):
        block_ranges = np.stack(
            [np.array([b.u32(0), b.u32(4)], np.uint32)
             for b in brs.structs()])
    else:
        block_ranges = np.zeros((0, 2), np.uint32)

    def ragged(pi, dtype):
        lst = root.ptr(pi)
        return (_concat_ragged(lst, dtype) if lst is not None
                else np.empty(0, dtype))

    hashes = ragged(1, "<u8")
    pcounts = ragged(2, "<i2")
    ccounts = ragged(3, "<i2")
    offs_l = root.ptr(4)
    offsets = (offs_l.as_numpy("<u8") if offs_l is not None
               else np.zeros(1, np.uint64))
    sub_l = root.ptr(10)
    sub = (sub_l.as_numpy("<f8") if sub_l is not None else np.zeros(16))

    return IndexArrays(
        params=IndexParams(k=int(k), s=int(s), t=int(t), l=int(l),
                           open=bool(open_), hpc=bool(hpc)),
        node_ids=node_ids,
        parent_index=np.asarray(parent_index, np.uint32),
        identical_to_parent=np.asarray(identical, bool),
        block_ranges=block_ranges,
        seed_hashes=np.ascontiguousarray(hashes),
        parent_counts=np.ascontiguousarray(pcounts),
        child_counts=np.ascontiguousarray(ccounts),
        node_offsets=np.ascontiguousarray(offsets),
        substitution_matrix=np.asarray(sub, np.float64),
    )
