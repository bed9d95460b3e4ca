"""Native Arrow IPC wire format — no pyarrow on the wire.

Implements the encapsulated-message format from scratch against the
flatbuffers runtime (hand-built tables; no generated code):

  message   = 0xFFFFFFFF continuation + int32 metadata_len
              + Message flatbuffer (padded to 8) + aligned body
              (reference: cpp/src/arrow/ipc/message.h:238-260)
  stream    = Schema msg, DictionaryBatch msgs, RecordBatch msgs, EOS
  file      = "ARROW1\\0\\0" + stream + Footer flatbuffer
              + int32 footer_len + "ARROW1"
              (reference: cpp/src/arrow/ipc/writer.cc:128,216 /
               reader.cc:138,525 ArrayLoader)

The writer flattens engine columns into the columnar buffer layout
(validity bitmaps LSB-packed, bools bit-packed, 8-byte buffer
alignment); the reader reconstructs columns from zero-copy numpy views
over the body. Supported: all fixed-width primitives, temporals,
decimal128/256, utf8/large_utf8 + binary (written as plain var-binary
from the engine's dictionary form; read either plain or
dictionary-encoded), and the nested family — list / large_list /
fixed_size_list / struct / map / sparse+dense union — via recursive
pre-order field/node/buffer traversal (reference ArrayLoader,
ipc/reader.cc:138-520).

Compressed bodies (RecordBatch.compression, Message.fbs BodyCompression)
are supported per the spec's buffer framing: each buffer is an int64
uncompressed-length prefix (-1 = stored raw) + codec frame. ZSTD rides
the `zstandard` module; LZ4_FRAME rides the native codec
(native/src/lz4.cpp) and raises only when the native library is
unavailable.

Byte-level interop is tested both directions against pyarrow.ipc.
"""

from __future__ import annotations

import io as _io
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import dtypes as dt
from ..column import (Column, Dictionary, ListColumn, StructColumn,
                      UnionColumn)
from ..errors import Invalid
from ..table import RecordBatch

COMP_LZ4, COMP_ZSTD = 0, 1


def _builder(size: int):
    """A flatbuffers Builder. The package is imported on first write:
    reading IPC and the rest of the engine do not need it."""
    import flatbuffers

    return flatbuffers.Builder(size)


def _codec(comp_id: int):
    if comp_id == COMP_ZSTD:
        import zstandard

        return (lambda b: zstandard.ZstdCompressor().compress(b),
                lambda b, n: zstandard.ZstdDecompressor().decompress(
                    b, max_output_size=n))
    if comp_id == COMP_LZ4:
        from ..native import (lz4_frame_compress, lz4_frame_decompress,
                              native_available)

        if not native_available():
            raise Invalid("ipc_native: LZ4_FRAME codec needs the native "
                          "library — write with compression='zstd'")
        return lz4_frame_compress, lz4_frame_decompress
    raise Invalid(f"ipc_native: unknown compression codec {comp_id}")

__all__ = ["write_stream", "read_stream", "write_file", "read_file",
           "serialize_batch", "deserialize_batch"]

CONTINUATION = 0xFFFFFFFF
MAGIC = b"ARROW1"
ALIGN = 8

# ---- flatbuffer union/member indices (from format/*.fbs declarations) ----
TYPE_NULL, TYPE_INT, TYPE_FP, TYPE_BINARY, TYPE_UTF8, TYPE_BOOL, \
    TYPE_DECIMAL, TYPE_DATE, TYPE_TIME, TYPE_TIMESTAMP, TYPE_INTERVAL, \
    TYPE_LIST, TYPE_STRUCT, TYPE_UNION, TYPE_FSB, TYPE_FSL, TYPE_MAP, \
    TYPE_DURATION, TYPE_LARGEBIN, TYPE_LARGEUTF8, TYPE_LARGELIST = \
    range(1, 22)

HDR_SCHEMA, HDR_DICTBATCH, HDR_RECORDBATCH = 1, 2, 3
TIME_UNITS = ["s", "ms", "us", "ns"]
V5 = 4  # MetadataVersion.V5


# ====================================================================
# minimal flatbuffer table reader (vtable navigation, no generated code)
# ====================================================================

class _T:
    """A positioned flatbuffer table. Slot s = vtable entry 4 + 2*s."""

    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos

    def _field(self, slot: int) -> int:
        """Byte offset of field (0 if absent)."""
        vtab = self.pos - self._i32(self.pos)
        vsize = self._u16(vtab)
        fo = 4 + 2 * slot
        if fo >= vsize:
            return 0
        off = self._u16(vtab + fo)
        return self.pos + off if off else 0

    def _i32(self, p):
        return struct.unpack_from("<i", self.buf, p)[0]

    def _u16(self, p):
        return struct.unpack_from("<H", self.buf, p)[0]

    def i8(self, slot, default=0):
        p = self._field(slot)
        return struct.unpack_from("<b", self.buf, p)[0] if p else default

    def u8(self, slot, default=0):
        p = self._field(slot)
        return struct.unpack_from("<B", self.buf, p)[0] if p else default

    def i16(self, slot, default=0):
        p = self._field(slot)
        return struct.unpack_from("<h", self.buf, p)[0] if p else default

    def i32(self, slot, default=0):
        p = self._field(slot)
        return self._i32(p) if p else default

    def i64(self, slot, default=0):
        p = self._field(slot)
        return struct.unpack_from("<q", self.buf, p)[0] if p else default

    def bool_(self, slot, default=False):
        p = self._field(slot)
        return bool(self.buf[p]) if p else default

    def string(self, slot) -> Optional[str]:
        p = self._field(slot)
        if not p:
            return None
        p += self._i32(p)
        n = self._i32(p)
        return self.buf[p + 4: p + 4 + n].decode("utf8")

    def table(self, slot) -> Optional["_T"]:
        p = self._field(slot)
        if not p:
            return None
        return _T(self.buf, p + self._i32(p))

    def vector(self, slot) -> Tuple[int, int]:
        """(element-0 position, length); (0, 0) if absent."""
        p = self._field(slot)
        if not p:
            return 0, 0
        p += self._i32(p)
        return p + 4, self._i32(p)

    def vtable_at(self, pos) -> "_T":
        return _T(self.buf, pos + self._i32(pos))


def _root(buf: bytes) -> _T:
    return _T(buf, struct.unpack_from("<i", buf, 0)[0])


# ====================================================================
# schema: engine <-> flatbuffer
# ====================================================================

def _build_type(b: flatbuffers.Builder, t: dt.DataType) -> Tuple[int, int]:
    """Returns (union_type_index, table_offset)."""
    k = t.kind
    if k == "null":
        b.StartObject(0)
        return TYPE_NULL, b.EndObject()
    if t.is_integer:
        width = t.byte_width * 8
        b.StartObject(2)
        b.PrependInt32Slot(0, width, 0)
        b.PrependBoolSlot(1, t.is_signed_integer, False)
        return TYPE_INT, b.EndObject()
    if k in ("float16", "float32", "float64"):
        prec = {"float16": 0, "float32": 1, "float64": 2}[k]
        b.StartObject(1)
        b.PrependInt16Slot(0, prec, 0)
        return TYPE_FP, b.EndObject()
    if k == "bool":
        b.StartObject(0)
        return TYPE_BOOL, b.EndObject()
    if k in ("string", "large_string", "binary", "large_binary"):
        b.StartObject(0)
        idx = {"string": TYPE_UTF8, "large_string": TYPE_LARGEUTF8,
               "binary": TYPE_BINARY, "large_binary": TYPE_LARGEBIN}[k]
        return idx, b.EndObject()
    if k in ("decimal128", "decimal256"):
        b.StartObject(3)
        b.PrependInt32Slot(0, t.precision, 0)
        b.PrependInt32Slot(1, t.scale, 0)
        b.PrependInt32Slot(2, 128 if k == "decimal128" else 256, 128)
        return TYPE_DECIMAL, b.EndObject()
    if k in ("date32", "date64"):
        b.StartObject(1)
        b.PrependInt16Slot(0, 0 if k == "date32" else 1, 1)
        return TYPE_DATE, b.EndObject()
    if k in ("time32", "time64"):
        b.StartObject(2)
        b.PrependInt16Slot(0, TIME_UNITS.index(t.unit), 1)
        b.PrependInt32Slot(1, 32 if k == "time32" else 64, 32)
        return TYPE_TIME, b.EndObject()
    if k == "timestamp":
        tz_off = b.CreateString(t.tz) if t.tz else None
        b.StartObject(2)
        b.PrependInt16Slot(0, TIME_UNITS.index(t.unit), 0)
        if tz_off is not None:
            b.PrependUOffsetTRelativeSlot(1, tz_off, 0)
        return TYPE_TIMESTAMP, b.EndObject()
    if k == "duration":
        b.StartObject(1)
        b.PrependInt16Slot(0, TIME_UNITS.index(t.unit), 1)
        return TYPE_DURATION, b.EndObject()
    if k in ("list", "large_list"):
        b.StartObject(0)
        return (TYPE_LIST if k == "list" else TYPE_LARGELIST), b.EndObject()
    if k == "fixed_size_list":
        b.StartObject(1)
        b.PrependInt32Slot(0, t.list_size, 0)
        return TYPE_FSL, b.EndObject()
    if k == "struct":
        b.StartObject(0)
        return TYPE_STRUCT, b.EndObject()
    if k == "map":
        b.StartObject(1)
        b.PrependBoolSlot(0, False, False)  # keysSorted
        return TYPE_MAP, b.EndObject()
    if k in ("sparse_union", "dense_union"):
        codes = list(t.type_codes)
        b.StartVector(4, len(codes), 4)
        for c in reversed(codes):
            b.PrependInt32(c)
        cvec = b.EndVector()
        b.StartObject(2)
        b.PrependInt16Slot(0, 0 if k == "sparse_union" else 1, 0)
        b.PrependUOffsetTRelativeSlot(1, cvec, 0)
        return TYPE_UNION, b.EndObject()
    raise Invalid(f"ipc_native: unsupported type {t}")


def _child_fields(t: dt.DataType, in_map: bool = False):
    """Child (name, type, nullable, in_map) tuples in wire layout order.
    Map entries structs and their keys are non-nullable per the spec."""
    if t.kind == "map":
        return [("entries", dt.struct(t.fields), False, True)]
    if t.kind == "struct" and in_map:
        (kn, kt), (vn, vt) = t.fields
        return [("key", kt, False, False), ("value", vt, True, False)]
    if t.is_nested:
        return [(n, ct, True, False) for n, ct in t.fields]
    return []


def _build_field(b: flatbuffers.Builder, name: str, t: dt.DataType,
                 nullable: bool, dict_id: Optional[int],
                 in_map: bool = False) -> int:
    name_off = b.CreateString(name)
    kids = [_build_field(b, cn, ct, cnull, None, in_map=cmap)
            for cn, ct, cnull, cmap in _child_fields(t, in_map)]
    kids_off = None
    if kids:
        b.StartVector(4, len(kids), 4)
        for k in reversed(kids):
            b.PrependUOffsetTRelative(k)
        kids_off = b.EndVector()
    tidx, toff = _build_type(b, t)
    dict_off = None
    if dict_id is not None:
        # DictionaryEncoding: id(0), indexType(1), isOrdered(2), kind(3)
        it_off = _int_table(b, 32, True)  # built before StartObject
        b.StartObject(4)
        b.PrependUOffsetTRelativeSlot(1, it_off, 0)
        b.PrependInt64Slot(0, dict_id, 0)
        dict_off = b.EndObject()
    # Field: name(0) nullable(1) type_type(2) type(3) dictionary(4)
    #        children(5) custom_metadata(6)
    b.StartObject(7)
    b.PrependUOffsetTRelativeSlot(0, name_off, 0)
    b.PrependBoolSlot(1, nullable, False)
    b.PrependUint8Slot(2, tidx, 0)
    b.PrependUOffsetTRelativeSlot(3, toff, 0)
    if dict_off is not None:
        b.PrependUOffsetTRelativeSlot(4, dict_off, 0)
    if kids_off is not None:
        b.PrependUOffsetTRelativeSlot(5, kids_off, 0)
    return b.EndObject()


def _int_table(b: flatbuffers.Builder, width: int, signed: bool) -> int:
    b.StartObject(2)
    b.PrependInt32Slot(0, width, 0)
    b.PrependBoolSlot(1, signed, False)
    return b.EndObject()


def _build_kv_vector(b: flatbuffers.Builder, metadata) -> Optional[int]:
    """[KeyValue] vector from an order-preserving tuple of byte pairs."""
    if not metadata:
        return None
    kvs = []
    for k, v in metadata:
        ko = b.CreateString(k if isinstance(k, str) else bytes(k))
        vo = b.CreateString(v if isinstance(v, str) else bytes(v))
        b.StartObject(2)
        b.PrependUOffsetTRelativeSlot(0, ko, 0)
        b.PrependUOffsetTRelativeSlot(1, vo, 0)
        kvs.append(b.EndObject())
    b.StartVector(4, len(kvs), 4)
    for kv in reversed(kvs):
        b.PrependUOffsetTRelative(kv)
    return b.EndVector()


def _build_schema(b: flatbuffers.Builder, batch: RecordBatch,
                  dict_ids: Dict[str, int]) -> int:
    meta_off = _build_kv_vector(
        b, getattr(batch.schema, "metadata", None))
    fields = []
    for name in batch.names:
        c = batch.column(name)
        t = c.dtype
        if isinstance(c, Column) and t.is_dictionary:
            fields.append(_build_field(b, name, t.value_type, True,
                                       dict_ids[name]))
        else:
            fields.append(_build_field(b, name, t, True, None))
    b.StartVector(4, len(fields), 4)
    for f in reversed(fields):
        b.PrependUOffsetTRelative(f)
    fvec = b.EndVector()
    # Schema: endianness(0) fields(1) custom_metadata(2) features(3)
    b.StartObject(4)
    b.PrependInt16Slot(0, 0, 0)  # little-endian
    b.PrependUOffsetTRelativeSlot(1, fvec, 0)
    if meta_off is not None:
        b.PrependUOffsetTRelativeSlot(2, meta_off, 0)
    return b.EndObject()


def _finish_message(b: flatbuffers.Builder, header_type: int,
                    header_off: int, body_len: int) -> bytes:
    # Message: version(0) header_type(1) header(2) bodyLength(3) meta(4)
    b.StartObject(5)
    b.PrependInt16Slot(0, V5, 0)
    b.PrependUint8Slot(1, header_type, 0)
    b.PrependUOffsetTRelativeSlot(2, header_off, 0)
    b.PrependInt64Slot(3, body_len, 0)
    b.Finish(b.EndObject())
    return bytes(b.Output())


def _pad(n: int, align: int = ALIGN) -> int:
    return (-n) % align


# ====================================================================
# column <-> buffers
# ====================================================================

def _validity_buffer(col) -> Tuple[Optional[bytes], int]:
    if col.validity is None:
        return None, 0
    mask = np.asarray(col.validity)
    nulls = int((~mask).sum())
    if nulls == 0:
        return None, 0
    return np.packbits(mask, bitorder="little").tobytes(), nulls


def _as_u8(arr: np.ndarray) -> np.ndarray:
    """Zero-copy byte view of a contiguous array (len == nbytes)."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _column_buffers(col: Column) -> Tuple[List[bytes], int, int]:
    """-> (buffers, length, null_count). Buffer 0 = validity ('' when
    all-valid), then the type's data buffers."""
    vbuf, nulls = _validity_buffer(col)
    bufs = [vbuf or b""]
    t = col.dtype
    if t.kind == "bool":
        bufs.append(np.packbits(np.asarray(col.data),
                                bitorder="little").tobytes())
    elif t.kind in ("decimal128", "decimal256"):
        n = col.length
        nl = 2 if t.kind == "decimal128" else 4
        words = np.empty((n, nl), dtype="<u8")
        words[:, 0] = np.ascontiguousarray(
            np.asarray(col.data)).view(np.uint64)
        h = np.ascontiguousarray(np.asarray(col.data2)).view(np.uint64)
        if nl == 2:
            words[:, 1] = h
        else:
            words[:, 1:] = h.reshape(n, 3)
        bufs.append(_as_u8(words))
    elif t.is_binary and not t.is_dictionary:
        # engine strings are dict codes + host values: materialize plain
        # var-binary (offsets + data) so the wire type matches the
        # logical type. Byte assembly is a vectorized gather out of the
        # unique-value pool (O(bytes) numpy, no per-row python).
        codes = np.asarray(col.data).astype(np.int64)
        values = col.dictionary.values
        enc = [v.encode("utf8") if isinstance(v, str) else bytes(v)
               for v in values]
        lens = np.array([len(e) for e in enc], dtype=np.int64)
        u_starts = np.zeros(len(enc) + 1, dtype=np.int64)
        np.cumsum(lens, out=u_starts[1:])
        row_lens = lens[codes]
        if col.validity is not None:
            row_lens = np.where(np.asarray(col.validity), row_lens, 0)
        odt = np.int64 if t.kind.startswith("large") else np.int32
        offsets = np.zeros(col.length + 1, dtype=odt)
        np.cumsum(row_lens, out=offsets[1:])
        total = int(offsets[-1])
        pool = np.frombuffer(b"".join(enc), np.uint8)
        if total:
            # native per-row memcpy gather (native/src/ragged.cpp) —
            # ~3x over the numpy padded-matrix extract on IPC shapes
            from ..native import ragged_gather

            rv = (None if col.validity is None
                  else np.asarray(col.validity))
            got = ragged_gather(codes, u_starts, pool, rv, total,
                                large=odt is np.int64)
            if got is not None:
                bufs.append(_as_u8(got[0]))
                bufs.append(got[1])
                return bufs, col.length, nulls
        bufs.append(_as_u8(offsets))
        if not total:
            bufs.append(b"")
        else:
            maxlen = int(lens.max())
            if maxlen * col.length <= 4 * total + (1 << 20):
                # padded-matrix gather: [U, maxlen] unique bytes ->
                # [n, maxlen] row gather -> boolean extract of the
                # ragged payload (aux traffic ~= payload, not 24x)
                iota = np.arange(maxlen)
                umat = np.zeros((len(enc), maxlen), np.uint8)
                umat[iota < lens[:, None]] = pool
                rowmat = umat[codes]
                bufs.append(rowmat[iota < row_lens[:, None]])
            else:
                rows = np.repeat(np.arange(col.length), row_lens)
                within = np.arange(total, dtype=np.int64) - np.repeat(
                    offsets[:-1].astype(np.int64), row_lens)
                bufs.append(pool[u_starts[codes][rows] + within])
    else:
        bufs.append(_as_u8(np.asarray(col.data)))
    return bufs, col.length, nulls


def _flatten_array(col, nodes: List[Tuple[int, int]], bufs: List[bytes]):
    """Pre-order (node, buffer) flattening of one array, nested included
    (reference writer: ipc/writer.cc:216 RecordBatchSerializer visits)."""
    if isinstance(col, ListColumn):
        k = col.dtype.kind
        vbuf, nulls = _validity_buffer(col)
        nodes.append((col.length, nulls))
        bufs.append(vbuf or b"")
        offs = np.asarray(col.offsets)
        if k in ("list", "map"):
            bufs.append(offs.astype(np.int32).tobytes())
        elif k == "large_list":
            bufs.append(offs.astype(np.int64).tobytes())
        elif k == "fixed_size_list":
            ksz = col.dtype.list_size
            if not np.array_equal(offs, np.arange(len(offs)) * ksz):
                raise Invalid("ipc_native: non-affine fixed_size_list "
                              "offsets (sliced view) — pyarrow adapter")
        else:
            raise Invalid(f"ipc_native: unexpected list kind {k}")
        child = col.values
        if k == "map" and isinstance(child, RecordBatch):
            # engine maps hold entries as a {key, value} RecordBatch:
            # serialize as the wire's struct<key, value> entries array
            nodes.append((child.num_rows, 0))
            bufs.append(b"")
            for cc in child.columns:
                _flatten_array(cc, nodes, bufs)
            return
        _flatten_array(child, nodes, bufs)
        return
    if isinstance(col, StructColumn):
        vbuf, nulls = _validity_buffer(col)
        nodes.append((col.length, nulls))
        bufs.append(vbuf or b"")
        for c in col.children:
            _flatten_array(c, nodes, bufs)
        return
    if isinstance(col, UnionColumn):
        nodes.append((col.length, 0))  # unions carry no top validity
        bufs.append(np.asarray(col.type_ids).astype(np.int8).tobytes())
        if col.dtype.kind == "dense_union":
            bufs.append(np.asarray(col.offsets).astype(np.int32).tobytes())
        for c in col.children:
            _flatten_array(c, nodes, bufs)
        return
    if col.dtype.is_dictionary:
        raise Invalid("ipc_native: nested dictionary columns route "
                      "through serialize_batch's top-level handling")
    cb, length, nulls = _column_buffers(col)
    nodes.append((length, nulls))
    bufs.extend(cb)


def _body_chunks(all_bufs: List[bytes], compression=None):
    """Aligned body as a CHUNK LIST (no concatenation — the writers
    stream chunks straight to the sink, one copy total). Returns
    (chunks, Buffer structs, body_len). With compression, each buffer
    gets the spec's int64 uncompressed-length prefix (-1 = stored raw
    when not smaller)."""
    chunks, descs = [], []
    off = 0
    comp = _codec(compression)[0] if compression is not None else None
    for buf in all_bufs:
        if isinstance(buf, np.ndarray):
            buf = memoryview(buf)
        if comp is not None and len(buf):
            c = comp(bytes(buf))
            if len(c) < len(buf):
                buf = struct.pack("<q", len(buf)) + c
            else:
                buf = struct.pack("<q", -1) + bytes(buf)
        n = len(buf)
        descs.append((off, n))
        if n:
            chunks.append(buf)
        pad = _pad(n)
        if pad:
            chunks.append(b"\0" * pad)
        off += n + pad
    return chunks, descs, off


def _body_from_buffers(all_bufs: List[bytes], compression=None):
    chunks, descs, _ = _body_chunks(all_bufs, compression)
    return b"".join(bytes(c) if isinstance(c, memoryview) else c
                    for c in chunks), descs


def _build_recordbatch_header(b: flatbuffers.Builder, length: int,
                              nodes: List[Tuple[int, int]],
                              buffers: List[Tuple[int, int]],
                              compression=None) -> int:
    comp_off = None
    if compression is not None:
        # BodyCompression: codec(0) int8, method(1) int8 (0 = BUFFER)
        b.StartObject(2)
        b.PrependInt8Slot(0, compression, 0)
        comp_off = b.EndObject()
    # struct vectors are built inline, in reverse
    b.StartVector(16, len(buffers), 8)
    for off, ln in reversed(buffers):
        b.PrependInt64(ln)
        b.PrependInt64(off)
    bvec = b.EndVector()
    b.StartVector(16, len(nodes), 8)
    for ln, nc in reversed(nodes):
        b.PrependInt64(nc)
        b.PrependInt64(ln)
    nvec = b.EndVector()
    # RecordBatch: length(0) nodes(1) buffers(2) compression(3)
    b.StartObject(4)
    b.PrependInt64Slot(0, length, 0)
    b.PrependUOffsetTRelativeSlot(1, nvec, 0)
    b.PrependUOffsetTRelativeSlot(2, bvec, 0)
    if comp_off is not None:
        b.PrependUOffsetTRelativeSlot(3, comp_off, 0)
    return b.EndObject()


def _comp_id(compression) -> Optional[int]:
    if compression is None:
        return None
    return {"zstd": COMP_ZSTD, "lz4": COMP_LZ4}.get(
        compression, compression if isinstance(compression, int) else -1)


def serialize_batch_parts(batch: RecordBatch, compression=None):
    """-> (metadata flatbuffer, body chunk list, body_len) for one
    RecordBatch message; the writers stream chunks without a body
    concatenation."""
    cid = _comp_id(compression)
    nodes, all_bufs = [], []
    for name in batch.names:
        c = batch.column(name)
        if isinstance(c, Column) and c.dtype.is_dictionary:
            # indices only; dictionary travels as a DictionaryBatch
            vbuf, nulls = _validity_buffer(c)
            nodes.append((c.length, nulls))
            all_bufs.append(vbuf or b"")
            all_bufs.append(np.ascontiguousarray(np.asarray(c.data)))
        else:
            _flatten_array(c, nodes, all_bufs)
    chunks, descs, blen = _body_chunks(all_bufs, cid)
    b = _builder(1024)
    hdr = _build_recordbatch_header(b, batch.num_rows, nodes, descs, cid)
    meta = _finish_message(b, HDR_RECORDBATCH, hdr, blen)
    return meta, chunks, blen


def serialize_batch(batch: RecordBatch,
                    compression=None) -> Tuple[bytes, bytes]:
    """-> (metadata flatbuffer, body) for one RecordBatch message."""
    meta, chunks, _ = serialize_batch_parts(batch, compression)
    return meta, b"".join(bytes(c) if isinstance(c, memoryview) else c
                          for c in chunks)


def _serialize_dictionary(dict_id: int, values: np.ndarray
                          ) -> Tuple[bytes, bytes]:
    """Dictionary payload as a one-column utf8 batch."""
    enc = [v.encode("utf8") if isinstance(v, str) else bytes(v)
           for v in values]
    offsets = np.zeros(len(enc) + 1, dtype=np.int32)
    np.cumsum([len(e) for e in enc], out=offsets[1:])
    data = b"".join(enc)
    body, descs = _body_from_buffers([b"", offsets.tobytes(), data])
    b = _builder(256)
    rb = _build_recordbatch_header(b, len(enc), [(len(enc), 0)], descs)
    # DictionaryBatch: id(0) data(1) isDelta(2)
    b.StartObject(3)
    b.PrependInt64Slot(0, dict_id, 0)
    b.PrependUOffsetTRelativeSlot(1, rb, 0)
    hdr = b.EndObject()
    meta = _finish_message(b, HDR_DICTBATCH, hdr, len(body))
    return meta, body


def _write_encapsulated(sink, meta: bytes, body=b"") -> int:
    """Write one encapsulated message as parts (no full-copy join);
    `body` may be bytes or a chunk list. Returns total bytes written."""
    mlen = len(meta)
    pad = _pad(4 + 4 + mlen)
    sink.write(struct.pack("<II", CONTINUATION, mlen + pad))
    sink.write(meta)
    if pad:
        sink.write(b"\0" * pad)
    blen = 0
    for part in (body if isinstance(body, list) else [body]):
        if len(part):
            sink.write(part)
            blen += len(part)
    return 8 + mlen + pad + blen


def _encapsulate(meta: bytes, body: bytes) -> bytes:
    mlen = len(meta)
    pad = _pad(4 + 4 + mlen)  # total prefix+meta must land on 8
    out = struct.pack("<II", CONTINUATION, mlen + pad)
    return out + meta + b"\0" * pad + body


# ====================================================================
# writer API
# ====================================================================

def _dict_columns(batch: RecordBatch) -> Dict[str, int]:
    ids = {}
    for name in batch.names:
        c = batch.column(name)
        if isinstance(c, Column) and c.dtype.is_dictionary:
            ids[name] = len(ids)
    return ids


def write_stream(sink, batch_or_batches, compression=None,
                 schema_batch=None) -> None:
    """Write engine batches as a native Arrow IPC stream. With zero
    batches, `schema_batch` supplies the schema for a schema-only
    stream (writer.cc: schema message + EOS, no batch messages)."""
    batches = (batch_or_batches if isinstance(batch_or_batches, (list,
               tuple)) else [batch_or_batches])
    first = batches[0] if batches else schema_batch
    if first is None:
        raise Invalid("write_stream: no batches and no schema")
    dict_ids = _dict_columns(first)
    b = _builder(1024)
    schema_off = _build_schema(b, first, dict_ids)
    _write_encapsulated(sink, _finish_message(b, HDR_SCHEMA, schema_off, 0))
    for name, did in dict_ids.items():
        meta, body = _serialize_dictionary(
            did, first.column(name).dictionary.values)
        _write_encapsulated(sink, meta, body)
    for batch in batches:
        meta, chunks, _ = serialize_batch_parts(batch,
                                                compression=compression)
        _write_encapsulated(sink, meta, chunks)
    sink.write(struct.pack("<II", CONTINUATION, 0))  # EOS


def write_file(sink, batch_or_batches, compression=None,
               schema_batch=None) -> None:
    """Arrow IPC *file* format: magic + stream + Footer."""
    batches = (batch_or_batches if isinstance(batch_or_batches, (list,
               tuple)) else [batch_or_batches])
    first = batches[0] if batches else schema_batch
    if first is None:
        raise Invalid("write_file: no batches and no schema")
    dict_ids = _dict_columns(first)
    sink.write(MAGIC + b"\0\0")
    dict_blocks, batch_blocks = [], []

    def emit(meta, body):
        off = sink.tell()
        blen = sum(len(c) for c in body) if isinstance(body, list) \
            else len(body)
        total = _write_encapsulated(sink, meta, body)
        return (off, total - blen, blen)

    b = _builder(1024)
    schema_off = _build_schema(b, first, dict_ids)
    schema_meta = _finish_message(b, HDR_SCHEMA, schema_off, 0)
    emit(schema_meta, b"")
    for name, did in dict_ids.items():
        meta, body = _serialize_dictionary(
            did, first.column(name).dictionary.values)
        dict_blocks.append(emit(meta, body))
    for batch in batches:
        meta, chunks, _ = serialize_batch_parts(batch,
                                                compression=compression)
        batch_blocks.append(emit(meta, chunks))
    sink.write(struct.pack("<II", CONTINUATION, 0))

    fb = _builder(1024)
    fschema = _build_schema(fb, first, dict_ids)

    def blocks_vec(blocks):
        fb.StartVector(24, len(blocks), 8)
        for off, mlen, blen in reversed(blocks):
            fb.PrependInt64(blen)
            fb.Pad(4)
            fb.PrependInt32(mlen)
            fb.PrependInt64(off)
        return fb.EndVector()

    bvec = blocks_vec(batch_blocks)
    dvec = blocks_vec(dict_blocks)
    # Footer: version(0) schema(1) dictionaries(2) recordBatches(3)
    fb.StartObject(5)
    fb.PrependInt16Slot(0, V5, 0)
    fb.PrependUOffsetTRelativeSlot(1, fschema, 0)
    fb.PrependUOffsetTRelativeSlot(2, dvec, 0)
    fb.PrependUOffsetTRelativeSlot(3, bvec, 0)
    fb.Finish(fb.EndObject())
    footer = bytes(fb.Output())
    sink.write(footer)
    sink.write(struct.pack("<i", len(footer)))
    sink.write(MAGIC)


# ====================================================================
# reader
# ====================================================================

def _type_from_fb(ttype: int, tt: Optional[_T],
                  children: Optional[List["_FieldInfo"]] = None
                  ) -> dt.DataType:
    children = children or []
    if ttype == TYPE_LIST:
        return dt.list_(children[0].dtype)
    if ttype == TYPE_LARGELIST:
        return dt.large_list(children[0].dtype)
    if ttype == TYPE_FSL:
        return dt.fixed_size_list(children[0].dtype, tt.i32(0))
    if ttype == TYPE_STRUCT:
        return dt.struct(tuple((c.name, c.dtype) for c in children))
    if ttype == TYPE_MAP:
        entries = children[0]
        kv = entries.children
        return dt.map_(kv[0].dtype, kv[1].dtype)
    if ttype == TYPE_UNION:
        mode = tt.i16(0, 0)
        cpos, cn = tt.vector(1)
        codes = tuple(struct.unpack_from("<i", tt.buf, cpos + 4 * i)[0]
                      for i in range(cn)) or None
        fields = tuple((c.name, c.dtype) for c in children)
        mk = dt.sparse_union if mode == 0 else dt.dense_union
        return mk(fields, codes)
    if ttype == TYPE_NULL:
        return dt.null
    if ttype == TYPE_INT:
        width, signed = tt.i32(0), tt.bool_(1)
        return dt.DataType(("int" if signed else "uint") + str(width))
    if ttype == TYPE_FP:
        return [dt.float16, dt.float32, dt.float64][tt.i16(0)]
    if ttype == TYPE_BOOL:
        return dt.bool_
    if ttype == TYPE_UTF8:
        return dt.string
    if ttype == TYPE_LARGEUTF8:
        return dt.large_string
    if ttype == TYPE_BINARY:
        return dt.binary
    if ttype == TYPE_LARGEBIN:
        return dt.DataType("large_binary")
    if ttype == TYPE_DECIMAL:
        width = tt.i32(2, 128)
        mk = dt.decimal128 if width == 128 else dt.decimal256
        return mk(tt.i32(0), tt.i32(1))
    if ttype == TYPE_DATE:
        return dt.date32 if tt.i16(0, 1) == 0 else dt.date64
    if ttype == TYPE_TIME:
        unit = TIME_UNITS[tt.i16(0, 1)]
        return dt.time32(unit) if tt.i32(1, 32) == 32 else dt.time64(unit)
    if ttype == TYPE_TIMESTAMP:
        return dt.timestamp(TIME_UNITS[tt.i16(0)], tt.string(1))
    if ttype == TYPE_DURATION:
        return dt.duration(TIME_UNITS[tt.i16(0, 1)])
    raise Invalid(f"ipc_native reader: unsupported Type index {ttype}")


class _FieldInfo:
    def __init__(self, name, dtype, dict_id, index_type, children=()):
        self.name, self.dtype = name, dtype
        self.dict_id, self.index_type = dict_id, index_type
        self.children = list(children)


def _read_kv_vector(s: _T, slot: int):
    pos, n = s.vector(slot)
    if not n:
        return None
    out = []
    for i in range(n):
        kv = s.vtable_at(pos + 4 * i)
        k, v = kv.string(0), kv.string(1)
        out.append((k.encode("utf8"), (v or "").encode("utf8")))
    return tuple(out)


def _field_from_fb(f: _T) -> _FieldInfo:
    name = f.string(0)
    ttype = f.u8(2)
    tt = f.table(3)
    cpos, cn = f.vector(5)
    children = [_field_from_fb(f.vtable_at(cpos + 4 * i))
                for i in range(cn)]
    dtype = _type_from_fb(ttype, tt, children)
    denc = f.table(4)
    dict_id = index_type = None
    if denc is not None:
        dict_id = denc.i64(0)
        it = denc.table(1)
        if it is not None:
            width, signed = it.i32(0, 32), it.bool_(1, True)
            index_type = dt.DataType(
                ("int" if signed else "uint") + str(width))
        else:
            index_type = dt.int32
    return _FieldInfo(name, dtype, dict_id, index_type, children)


def _schema_from_fb(s: _T) -> List[_FieldInfo]:
    pos, n = s.vector(1)
    return [_field_from_fb(s.vtable_at(pos + 4 * i)) for i in range(n)]


def _read_message(src) -> Optional[Tuple[_T, int, bytes]]:
    """-> (Message table, header_type, body) or None at EOS/EOF."""
    head = src.read(4)
    if len(head) < 4:
        return None
    (w,) = struct.unpack("<I", head)
    if w == CONTINUATION:
        ln = struct.unpack("<i", src.read(4))[0]
    else:
        ln = struct.unpack("<i", head)[0]
    if ln == 0:
        return None
    meta = src.read(ln)
    msg = _root(meta)
    # Message: version(0) header_type(1) header(2) bodyLength(3)
    htype = msg.u8(1)
    body_len = msg.i64(3)
    body = src.read(body_len) if body_len else b""
    return msg, htype, body


def _load_column(fi: _FieldInfo, length: int, null_count: int,
                 bufs: List[np.ndarray], dictionaries) -> Column:
    import jax.numpy as jnp

    validity = None
    vraw = bufs[0]
    if null_count > 0 and len(vraw):
        validity = jnp.asarray(np.unpackbits(
            vraw, bitorder="little", count=length).astype(bool))
    t = fi.dtype
    if fi.dict_id is not None:
        codes = bufs[1][: length * fi.index_type.byte_width].view(
            np.dtype(fi.index_type.physical_dtype())).astype(np.int32)
        values = dictionaries[fi.dict_id]
        return Column(jnp.asarray(codes), t, validity=validity,
                      dictionary=Dictionary(np.asarray(values, object)))
    if t.kind == "bool":
        data = np.unpackbits(bufs[1], bitorder="little",
                             count=length).astype(bool)
        return Column(jnp.asarray(data), t, validity=validity)
    if t.kind in ("decimal128", "decimal256"):
        nl = 2 if t.kind == "decimal128" else 4
        words = bufs[1][: length * nl * 8].view("<u8").reshape(length, nl)
        lo = words[:, 0].astype(np.uint64).view(np.int64)
        if nl == 2:
            hi = words[:, 1].astype(np.uint64).view(np.int64)
        else:
            hi = words[:, 1:].astype(np.uint64).view(np.int64).copy()
        return Column(jnp.asarray(lo), t, validity=validity,
                      data2=jnp.asarray(hi))
    if t.is_binary:
        odt = np.int64 if t.kind.startswith("large") else np.int32
        osize = np.dtype(odt).itemsize
        if len(bufs[1]) < (length + 1) * osize:
            raise Invalid("ipc_native: truncated var-binary offsets")
        offsets = bufs[1][: (length + 1) * osize].view(odt)
        data = np.ascontiguousarray(bufs[2])
        if length and (int(offsets[0]) < 0
                       or bool(np.any(np.diff(offsets) < 0))
                       or int(offsets[-1]) > data.size):
            raise Invalid("ipc_native: corrupt var-binary offsets")
        from ..native import MemoTable, native_available

        if native_available() and length:
            # C++ memo-table bulk encode (first-appearance code order)
            memo = MemoTable(max(64, length // 4))
            codes = memo.encode_array(data,
                                      offsets.astype(np.int64))
            raw = memo.values()
            uniq = np.asarray(
                [b.decode("utf8") for b in raw] if t.is_string else raw,
                dtype=object)
        else:
            vals = []
            for i in range(length):
                b = bytes(data[offsets[i]: offsets[i + 1]])
                vals.append(b.decode("utf8") if t.is_string else b)
            uniq, codes = (np.unique(np.asarray(vals, dtype=object),
                                     return_inverse=True)
                           if length else (np.asarray([""], object),
                                           np.zeros(0, np.int64)))
        return Column(jnp.asarray(np.asarray(codes).astype(np.int32)), t,
                      validity=validity, dictionary=Dictionary(uniq))
    # fixed-width
    npdt = np.dtype(t.physical_dtype())
    data = bufs[1][: length * npdt.itemsize].view(npdt)
    bits = None
    if t.kind == "float64":
        bits = jnp.asarray(data.view(np.int64))
    return Column(jnp.asarray(data), t, validity=validity, bits=bits)


class _BodyCursor:
    """Sequential node/buffer consumer over a RecordBatch body, with
    per-buffer decompression when BodyCompression is set."""

    def __init__(self, rb: _T, body: bytes):
        npos, nn = rb.vector(1)
        bpos, nb = rb.vector(2)
        self.nodes = [
            (struct.unpack_from("<q", rb.buf, npos + 16 * i)[0],
             struct.unpack_from("<q", rb.buf, npos + 16 * i + 8)[0])
            for i in range(nn)]
        self.buffers = [
            (struct.unpack_from("<q", rb.buf, bpos + 16 * i)[0],
             struct.unpack_from("<q", rb.buf, bpos + 16 * i + 8)[0])
            for i in range(nb)]
        self.raw = np.frombuffer(body, np.uint8)
        comp = rb.table(3)
        self.decomp = (None if comp is None
                       else _codec(comp.i8(0, 0))[1])
        self.ni = self.bi = 0

    def node(self) -> Tuple[int, int]:
        n = self.nodes[self.ni]
        self.ni += 1
        return n

    def buf(self) -> np.ndarray:
        off, sz = self.buffers[self.bi]
        self.bi += 1
        view = self.raw[off: off + sz]
        if self.decomp is None or sz == 0:
            return view
        (ulen,) = struct.unpack_from("<q", view.tobytes(), 0)
        payload = view[8:].tobytes()
        if ulen == -1:
            return np.frombuffer(payload, np.uint8)
        return np.frombuffer(self.decomp(payload, ulen), np.uint8)


def _validity_from(vraw, length, null_count):
    import jax.numpy as jnp

    if null_count > 0 and len(vraw):
        return jnp.asarray(np.unpackbits(
            vraw, bitorder="little", count=length).astype(bool))
    return None


def _load_array(fi: _FieldInfo, cur: _BodyCursor, dictionaries):
    """Recursive pre-order array loader (reference ArrayLoader,
    ipc/reader.cc:138)."""
    import jax.numpy as jnp

    t = fi.dtype
    k = t.kind
    if k in ("list", "large_list", "map"):
        length, nulls = cur.node()
        validity = _validity_from(cur.buf(), length, nulls)
        odt = np.int64 if k == "large_list" else np.int32
        osize = np.dtype(odt).itemsize
        offsets = cur.buf()[: (length + 1) * osize].view(odt)
        child = _load_array(fi.children[0], cur, dictionaries)
        if k == "map":
            # engine maps hold entries as a {key, value} RecordBatch
            # (interop.py map ingest)
            child = RecordBatch(tuple(child.children), child.names)
        return ListColumn(jnp.asarray(offsets.astype(np.int64)), child, t,
                          validity=validity)
    if k == "fixed_size_list":
        length, nulls = cur.node()
        validity = _validity_from(cur.buf(), length, nulls)
        offsets = jnp.asarray(
            np.arange(length + 1, dtype=np.int64) * t.list_size)
        child = _load_array(fi.children[0], cur, dictionaries)
        return ListColumn(offsets, child, t, validity=validity)
    if k == "struct":
        length, nulls = cur.node()
        validity = _validity_from(cur.buf(), length, nulls)
        children = [_load_array(c, cur, dictionaries) for c in fi.children]
        return StructColumn(children, tuple(c.name for c in fi.children),
                            t, validity=validity)
    if k in ("sparse_union", "dense_union"):
        length, _ = cur.node()
        type_ids = jnp.asarray(
            cur.buf()[:length].view(np.int8).astype(np.int8))
        offsets = None
        if k == "dense_union":
            offsets = jnp.asarray(
                cur.buf()[: length * 4].view(np.int32))
        children = [_load_array(c, cur, dictionaries) for c in fi.children]
        return UnionColumn(type_ids, children, t, offsets=offsets)
    # flat
    length, nulls = cur.node()
    nbuf = _nbuffers(fi)
    bufs = [cur.buf() for _ in range(nbuf)]
    return _load_column(fi, length, nulls, bufs, dictionaries)


def deserialize_batch(msg: _T, body: bytes, fields: List[_FieldInfo],
                      dictionaries) -> RecordBatch:
    rb = msg.table(2)
    cur = _BodyCursor(rb, body)
    cols = [_load_array(fi, cur, dictionaries) for fi in fields]
    return RecordBatch(tuple(cols), tuple(f.name for f in fields))


def _nbuffers(fi: _FieldInfo) -> int:
    if fi.dict_id is not None:
        return 2
    t = fi.dtype
    if t.is_binary:
        return 3
    if t.kind == "null":
        return 1
    return 2


def _read_dictionary(msg: _T, body: bytes):
    db = msg.table(2)
    dict_id = db.i64(0)
    rb = db.table(1)
    length = rb.i64(0)
    cur = _BodyCursor(rb, body)
    cur.buf()  # validity (dictionaries are written all-valid)
    offsets = cur.buf()[: (length + 1) * 4].view(np.int32)
    data = cur.buf()
    vals = [bytes(data[offsets[i]: offsets[i + 1]]).decode("utf8")
            for i in range(length)]
    return dict_id, np.array(vals, dtype=object)


def read_stream(src) -> List[RecordBatch]:
    """Read a native or pyarrow-written IPC stream into engine batches."""
    if isinstance(src, (bytes, bytearray)):
        src = _io.BytesIO(src)
    first = _read_message(src)
    if first is None:
        raise Invalid("ipc_native: empty stream")
    msg, htype, _ = first
    if htype != HDR_SCHEMA:
        raise Invalid("ipc_native: stream must start with a Schema message")
    schema_t = msg.table(2)
    fields = _schema_from_fb(schema_t)
    meta = _read_kv_vector(schema_t, 2)
    dictionaries = {}
    batches = []
    while True:
        item = _read_message(src)
        if item is None:
            break
        msg, htype, body = item
        if htype == HDR_DICTBATCH:
            did, vals = _read_dictionary(msg, body)
            dictionaries[did] = vals
        elif htype == HDR_RECORDBATCH:
            batches.append(deserialize_batch(msg, body, fields,
                                             dictionaries))
        else:
            raise Invalid(f"ipc_native: unexpected message type {htype}")
    if not batches:
        # schema-only stream: surface the schema as one zero-row batch
        batches = [_empty_batch(fields)]
    if meta:
        batches = [b.replace_schema_metadata(dict(meta)) for b in batches]
    return batches


def _empty_batch(fields: List["_FieldInfo"]) -> RecordBatch:
    from ..column import nulls

    cols = tuple(nulls(0, fi.dtype).with_validity(None) for fi in fields)
    return RecordBatch(cols, tuple(f.name for f in fields))


def read_file(src) -> List[RecordBatch]:
    """Read the IPC *file* format via the Footer (seekable random access,
    reference ipc/reader.h:102)."""
    if isinstance(src, (bytes, bytearray)):
        src = _io.BytesIO(src)
    src.seek(0, 2)
    end = src.tell()
    src.seek(0)
    if src.read(6) != MAGIC:
        raise Invalid("ipc_native: bad file magic")
    src.seek(end - 10)
    (flen,) = struct.unpack("<i", src.read(4))
    if src.read(6) != MAGIC:
        raise Invalid("ipc_native: bad trailing magic")
    src.seek(end - 10 - flen)
    footer = _root(src.read(flen))
    schema_t = footer.table(1)
    fields = _schema_from_fb(schema_t)
    meta = _read_kv_vector(schema_t, 2)
    dictionaries = {}

    def read_block(pos_off):
        src.seek(pos_off)
        return _read_message(src)

    dpos, nd = footer.vector(2)
    for i in range(nd):
        off = struct.unpack_from("<q", footer.buf, dpos + 24 * i)[0]
        msg, htype, body = read_block(off)
        did, vals = _read_dictionary(msg, body)
        dictionaries[did] = vals
    bpos, nbk = footer.vector(3)
    batches = []
    for i in range(nbk):
        off = struct.unpack_from("<q", footer.buf, bpos + 24 * i)[0]
        msg, htype, body = read_block(off)
        batches.append(deserialize_batch(msg, body, fields, dictionaries))
    if not batches:
        batches = [_empty_batch(fields)]
    if meta:
        batches = [b.replace_schema_metadata(dict(meta)) for b in batches]
    return batches
