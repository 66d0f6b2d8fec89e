"""Minimal schema-less Cap'n Proto wire-format reader.

The reference stores both its inputs (.panman files, written by TurakhiaLab/panman)
and its indexes (.idx/.midx, schema src/index_lite.capnp) as Cap'n
Proto messages.  pycapnp is not available in this environment, and our own index
format is a flat numpy container, so all we need is a small, fast *reader* for the
standard (unpacked) stream framing: segment table + struct/list/far pointers.

Wire format reference: https://capnproto.org/encoding.html
  - message = u32 segcount-1, u32 sizes[segcount], pad to 8B, then segments
  - struct ptr : tag=0, signed 30-bit word offset, u16 data words, u16 ptr words
  - list ptr   : tag=1, signed 30-bit word offset, 3-bit elem size, 29-bit count
  - far ptr    : tag=2, landing pad offset, segment id
  - capability : tag=3 (not used by panman/panmap)

Numeric list contents are returned as numpy views over the message buffer
(zero-copy), which is what the index loader wants.
"""

from __future__ import annotations

import numpy as np

# list element size codes
_ELEM_BITS = {0: 0, 1: 1, 2: 8, 3: 16, 4: 32, 5: 64, 6: 64, 7: None}  # 6=ptr, 7=composite


class CapnpMessage:
    """Holds the raw segments of one message and resolves pointers."""

    __slots__ = ("segments", "buf")

    def __init__(self, data: bytes | memoryview):
        buf = memoryview(data)
        nseg = int(np.frombuffer(buf[:4], dtype="<u4")[0]) + 1
        sizes = np.frombuffer(buf[4 : 4 + 4 * nseg], dtype="<u4")
        hdr = 4 + 4 * nseg
        hdr = (hdr + 7) & ~7  # pad to 8 bytes
        self.segments: list[memoryview] = []
        off = hdr
        for sz in sizes:
            nbytes = int(sz) * 8
            self.segments.append(buf[off : off + nbytes])
            off += nbytes
        self.buf = buf

    def root(self) -> "StructReader":
        ptr = _read_ptr(self, 0, 0)
        assert isinstance(ptr, StructReader), "root must be a struct"
        return ptr


def _word(seg: memoryview, woff: int) -> int:
    return int.from_bytes(seg[woff * 8 : woff * 8 + 8], "little")


def _read_ptr(msg: CapnpMessage, seg_id: int, woff: int):
    """Decode the pointer at (seg_id, woff). Returns StructReader/ListReader/None."""
    w = _word(msg.segments[seg_id], woff)
    if w == 0:
        return None
    kind = w & 3
    if kind == 2:  # far pointer
        landing_two = (w >> 2) & 1
        pad_off = (w >> 3) & 0x1FFFFFFF
        target_seg = (w >> 32) & 0xFFFFFFFF
        if not landing_two:
            return _read_ptr(msg, target_seg, pad_off)
        # two-word landing pad: first word is a far ptr to the object start,
        # second is the tag word describing it.
        far = _word(msg.segments[target_seg], pad_off)
        tag = _word(msg.segments[target_seg], pad_off + 1)
        obj_seg = (far >> 32) & 0xFFFFFFFF
        obj_off = (far >> 3) & 0x1FFFFFFF
        return _decode_tag(msg, obj_seg, obj_off, tag)
    # intra-segment pointer: offset is relative to the word after the pointer
    off = w >> 2
    off &= 0x3FFFFFFF
    if off & 0x20000000:  # sign-extend 30-bit
        off -= 0x40000000
    target = woff + 1 + off
    return _decode_tag(msg, seg_id, target, w, at_target=True)


def _decode_tag(msg: CapnpMessage, seg_id: int, target: int, w: int, at_target: bool = True):
    kind = w & 3
    if kind == 0:
        data_words = (w >> 32) & 0xFFFF
        ptr_words = (w >> 48) & 0xFFFF
        return StructReader(msg, seg_id, target, data_words, ptr_words)
    if kind == 1:
        esize = (w >> 32) & 7
        count = (w >> 35) & 0x1FFFFFFF
        return ListReader(msg, seg_id, target, esize, count)
    raise ValueError(f"unexpected pointer kind {kind}")


class StructReader:
    __slots__ = ("msg", "seg", "woff", "data_words", "ptr_words")

    def __init__(self, msg, seg, woff, data_words, ptr_words):
        self.msg = msg
        self.seg = seg
        self.woff = woff
        self.data_words = data_words
        self.ptr_words = ptr_words

    # --- data section accessors (byte offsets within data section) ---
    def _data(self) -> memoryview:
        s = self.msg.segments[self.seg]
        return s[self.woff * 8 : (self.woff + self.data_words) * 8]

    def _scalar(self, byte_off: int, dtype: str, default: int = 0):
        nbytes = np.dtype(dtype).itemsize
        d = self._data()
        if byte_off + nbytes > len(d):
            return default  # field absent in this (older) message version
        return np.frombuffer(d[byte_off : byte_off + nbytes], dtype=dtype)[0]

    def u8(self, o):
        return int(self._scalar(o, "<u1"))

    def u16(self, o):
        return int(self._scalar(o, "<u2"))

    def u32(self, o):
        return int(self._scalar(o, "<u4"))

    def u64(self, o):
        return int(self._scalar(o, "<u8"))

    def i8(self, o):
        return int(self._scalar(o, "<i1"))

    def i16(self, o):
        return int(self._scalar(o, "<i2"))

    def i32(self, o):
        return int(self._scalar(o, "<i4"))

    def i64(self, o):
        return int(self._scalar(o, "<i8"))

    def f32(self, o):
        return float(self._scalar(o, "<f4", 0.0))

    def f64(self, o):
        return float(self._scalar(o, "<f8", 0.0))

    def bool_(self, bit_index: int) -> bool:
        byte = bit_index // 8
        bit = bit_index % 8
        return bool(self.u8(byte) >> bit & 1)

    # --- pointer section ---
    def ptr(self, i: int):
        if i >= self.ptr_words:
            return None
        return _read_ptr(self.msg, self.seg, self.woff + self.data_words + i)

    def text(self, i: int) -> str | None:
        p = self.ptr(i)
        if p is None:
            return None
        assert isinstance(p, ListReader) and p.esize == 2
        raw = p.raw_bytes()
        # capnp Text is NUL-terminated
        return bytes(raw[:-1]).decode("utf-8") if len(raw) else ""

    def shape(self) -> str:
        return f"struct(data={self.data_words}w, ptrs={self.ptr_words})"


class ListReader:
    __slots__ = ("msg", "seg", "woff", "esize", "count", "_tag_dw", "_tag_pw")

    def __init__(self, msg, seg, woff, esize, count):
        self.msg = msg
        self.seg = seg
        self.woff = woff
        self.esize = esize
        self.count = count
        self._tag_dw = self._tag_pw = 0
        if esize == 7:  # composite: count holds total words; tag word precedes elems
            tag = _word(msg.segments[seg], woff)
            self.count = (tag >> 2) & 0x3FFFFFFF
            self._tag_dw = (tag >> 32) & 0xFFFF
            self._tag_pw = (tag >> 48) & 0xFFFF

    def __len__(self):
        return self.count

    def raw_bytes(self) -> memoryview:
        bits = _ELEM_BITS[self.esize]
        if bits is None:
            raise ValueError("raw_bytes on composite list")
        nbytes = (self.count * bits + 7) // 8
        s = self.msg.segments[self.seg]
        return s[self.woff * 8 : self.woff * 8 + nbytes]

    def as_numpy(self, dtype: str) -> np.ndarray:
        """Zero-copy numpy view of a primitive list."""
        bits = _ELEM_BITS[self.esize]
        want = np.dtype(dtype).itemsize * 8
        if bits != want:
            raise ValueError(f"list elem is {bits} bits, asked for {want}")
        return np.frombuffer(self.raw_bytes(), dtype=dtype, count=self.count)

    def as_bools(self) -> np.ndarray:
        assert self.esize == 1
        nbytes = (self.count + 7) // 8
        s = self.msg.segments[self.seg]
        packed = np.frombuffer(s[self.woff * 8 : self.woff * 8 + nbytes], dtype="<u1")
        return np.unpackbits(packed, bitorder="little")[: self.count].astype(bool)

    def data_region(self):
        """Composite list: (memoryview of all element words, count, stride
        words).  Element e's data section starts at byte e*stride*8; its
        pointer section follows at e*stride*8 + tag_dw*8.  Enables vectorized
        decoding of fixed-layout struct lists."""
        assert self.esize == 7, "data_region on non-composite list"
        stride = self._tag_dw + self._tag_pw
        s = self.msg.segments[self.seg]
        start = (self.woff + 1) * 8
        return s[start : start + self.count * stride * 8], self.count, stride

    def struct(self, i: int) -> StructReader:
        if self.esize == 7:
            stride = self._tag_dw + self._tag_pw
            off = self.woff + 1 + i * stride
            return StructReader(self.msg, self.seg, off, self._tag_dw, self._tag_pw)
        if self.esize == 6:  # list of pointers treated via ptr()
            raise ValueError("use ptr() for pointer lists")
        raise ValueError("not a struct list")

    def ptr(self, i: int):
        assert self.esize == 6
        return _read_ptr(self.msg, self.seg, self.woff + i)

    def structs(self):
        for i in range(self.count):
            yield self.struct(i)

    def shape(self) -> str:
        if self.esize == 7:
            return f"list<struct(data={self._tag_dw}w, ptrs={self._tag_pw})>[{self.count}]"
        return f"list<esize={self.esize}>[{self.count}]"


def describe(obj, depth=0, max_depth=3, max_items=3, lines=None):
    """Dump the shape of a message tree for schema reverse-engineering."""
    if lines is None:
        lines = []
    pad = "  " * depth
    if obj is None:
        lines.append(pad + "null")
        return lines
    if isinstance(obj, StructReader):
        data = bytes(obj._data())
        lines.append(pad + obj.shape() + " data=" + data[:32].hex())
        if depth < max_depth:
            for i in range(obj.ptr_words):
                p = obj.ptr(i)
                lines.append(pad + f"ptr[{i}]:")
                describe(p, depth + 1, max_depth, max_items, lines)
    elif isinstance(obj, ListReader):
        lines.append(pad + obj.shape())
        if obj.esize == 2:
            raw = bytes(obj.raw_bytes())
            lines.append(pad + f"  text? {raw[:60]!r}")
        elif obj.esize == 7 and depth < max_depth:
            for i in range(min(obj.count, max_items)):
                describe(obj.struct(i), depth + 1, max_depth, max_items, lines)
        elif obj.esize == 6 and depth < max_depth:
            for i in range(min(obj.count, max_items)):
                describe(obj.ptr(i), depth + 1, max_depth, max_items, lines)
        elif obj.esize in (3, 4, 5) and obj.count:
            dt = {3: "<u2", 4: "<u4", 5: "<u8"}[obj.esize]
            arr = obj.as_numpy(dt)
            lines.append(pad + f"  vals={arr[:8].tolist()}")
    return lines
