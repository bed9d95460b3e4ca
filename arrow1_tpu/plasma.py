"""Shared-memory object store: zero-copy table handoff between processes.

Reference: cpp/src/plasma/ (13.4 kLoC: store daemon + client over unix
sockets + fd passing, plasma/client.h:46, store.h:56). Redesigned
daemon-less (see native/src/shm_store.cpp): the store is a named POSIX
shm segment any process can open; tables are stored as Arrow IPC stream
bytes and read back zero-copy (pyarrow reads straight out of the mapped
buffer).

Role in the device pipeline (SURVEY.md §2 parallelism table): host-RAM
staging between ingest processes and the device-feeding process.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from typing import List, Optional, Union

import numpy as np

from .errors import Invalid
from .native import load_library
from .table import RecordBatch, Table

__all__ = ["ObjectID", "PlasmaStore", "connect"]

ID_LEN = 20


class ObjectID:
    """20-byte object identifier (reference: plasma/common.h UniqueID<20>)."""

    __slots__ = ("binary",)

    def __init__(self, binary: bytes):
        if len(binary) != ID_LEN:
            raise Invalid(f"ObjectID must be {ID_LEN} bytes")
        self.binary = binary

    @classmethod
    def from_random(cls) -> "ObjectID":
        return cls(os.urandom(ID_LEN))

    @classmethod
    def of(cls, name: Union[str, bytes]) -> "ObjectID":
        if isinstance(name, str):
            name = name.encode()
        return cls(hashlib.sha1(name).digest())

    def __eq__(self, other):
        return isinstance(other, ObjectID) and other.binary == self.binary

    def __hash__(self):
        return hash(self.binary)

    def __repr__(self):
        return f"ObjectID({self.binary.hex()[:12]}…)"


class PlasmaStore:
    """Create or attach to a named shared-memory store."""

    def __init__(self, name: str = "/a1t-plasma",
                 capacity: int = 1 << 30, max_objects: int = 4096,
                 create: bool = True):
        self._lib = load_library()
        if self._lib is None:
            raise Invalid("native library unavailable — build native/ first")
        self.name = name
        enc = name.encode()
        handle = self._lib.a1t_store_open(enc)
        if not handle and create:
            handle = self._lib.a1t_store_create(enc, capacity, max_objects)
        if not handle:
            raise Invalid(f"cannot open or create store {name!r}")
        self._handle = handle

    # ---- raw bytes API ----
    def put_bytes(self, oid: ObjectID, data: bytes) -> None:
        ptr = self._lib.a1t_create(self._handle, oid.binary, len(data))
        if not ptr:
            raise Invalid("store full or object exists")
        ctypes.memmove(ptr, data, len(data))
        self._lib.a1t_seal(self._handle, oid.binary)

    def get_buffer(self, oid: ObjectID) -> memoryview:
        """Zero-copy view into the shared segment (pins the object —
        callers release() when done, as with plasma's Release)."""
        size = ctypes.c_uint64()
        ptr = self._lib.a1t_get(self._handle, oid.binary, ctypes.byref(size))
        if not ptr:
            raise KeyError(oid)
        return memoryview((ctypes.c_char * size.value).from_address(ptr)) \
            .cast("B")

    def release(self, oid: ObjectID) -> None:
        self._lib.a1t_release(self._handle, oid.binary)

    def delete(self, oid: ObjectID) -> None:
        self._lib.a1t_delete(self._handle, oid.binary)

    def contains(self, oid: ObjectID) -> bool:
        return bool(self._lib.a1t_contains(self._handle, oid.binary))

    def list(self) -> List[ObjectID]:
        buf = np.zeros(4096 * ID_LEN, dtype=np.uint8)
        n = self._lib.a1t_list(self._handle,
                               buf.ctypes.data_as(ctypes.c_void_p), 4096)
        return [ObjectID(bytes(buf[i * ID_LEN:(i + 1) * ID_LEN]))
                for i in range(n)]

    @property
    def bytes_used(self) -> int:
        return int(self._lib.a1t_store_bytes_used(self._handle))

    @property
    def evictions(self) -> int:
        return int(self._lib.a1t_store_evictions(self._handle))

    # ---- table API (IPC-stream serialization) ----
    def put(self, data: Union[RecordBatch, Table],
            oid: Optional[ObjectID] = None) -> ObjectID:
        import pyarrow as pa

        from .interop import record_batch_to_arrow

        oid = oid or ObjectID.from_random()
        batches = data.batches if isinstance(data, Table) else [data]
        sink = pa.BufferOutputStream()
        pa_batches = [record_batch_to_arrow(b) for b in batches]
        with pa.ipc.new_stream(sink, pa_batches[0].schema) as w:
            for b in pa_batches:
                w.write_batch(b)
        self.put_bytes(oid, sink.getvalue().to_pybytes())
        return oid

    def get(self, oid: ObjectID) -> Table:
        import pyarrow as pa

        from .interop import record_batch_from_arrow

        buf = self.get_buffer(oid)
        try:
            reader = pa.ipc.open_stream(pa.py_buffer(buf))
            batches = [record_batch_from_arrow(b) for b in reader]
        finally:
            self.release(oid)
        return Table(batches)

    def close(self):
        if self._handle:
            self._lib.a1t_store_close(self._handle)
            self._handle = None

    def destroy(self):
        name = self.name.encode()
        self.close()
        self._lib.a1t_store_destroy(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect(name: str = "/a1t-plasma", **kwargs) -> PlasmaStore:
    """reference: plasma::PlasmaClient::Connect."""
    return PlasmaStore(name, **kwargs)
