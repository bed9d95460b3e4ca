"""Flight RPC: network data plane for engine tables.

Reference: cpp/src/arrow/flight/ — gRPC service (format/Flight.proto:33:
Handshake/ListFlights/GetFlightInfo/DoGet/DoPut/DoExchange/DoAction) with
zero-copy IPC payload serialization (serialization_internal.cc:192).

Position in the device design (SURVEY.md §2 "Distributed exchange"): Flight
is the *host-level / DCN* data plane — cross-host ingest and egress of
tables. On-slice exchange never touches it (that's the compiled
all_to_all in parallel/shuffle.py). The gRPC transport + IPC framing come
from pyarrow.flight (the same C++ stack the reference ships); this module
adapts engine tables and adds a ready-to-run table server.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterator, Optional, Union

from .errors import Invalid
from .interop import record_batch_from_arrow, record_batch_to_arrow
from .table import RecordBatch, Table

__all__ = ["FlightTableServer", "FlightClient", "serve_tables",
           "NativeFlightServer", "NativeFlightClient", "NativeTableServer",
           "serve_tables_native"]


_NATIVE_NAMES = ("NativeFlightServer", "NativeFlightClient",
                 "NativeTableServer", "serve_tables_native",
                 "ServerAuthHandler", "BasicAuthHandler",
                 "ServerMiddleware", "ServerMiddlewareFactory",
                 "FlightStreamReader")
_PROTO_NAMES = ("FlightDescriptor", "FlightInfo", "FlightEndpoint",
                "Ticket", "FlightData", "PutResult", "Action", "Result",
                "ActionType", "Criteria", "Empty", "SchemaResult",
                "Location", "HandshakeRequest", "HandshakeResponse")


def __getattr__(name):
    # Native-transport stack (flight_native.py) + wire message types
    # (flight_proto.py) re-exported here so the one `arrow1_tpu.flight`
    # namespace carries both backends (pyarrow.flight module shape).
    if name in _NATIVE_NAMES:
        from . import flight_native

        return getattr(flight_native, name)
    if name in _PROTO_NAMES:
        from . import flight_proto

        return getattr(flight_proto, name)
    if name == "FlightServerBase":
        from . import flight_native

        return flight_native.NativeFlightServer
    raise AttributeError(name)


# ---- pyarrow.flight parity tail: error family + small client/server
# plumbing types (reference: python/pyarrow/flight.py / _flight.pyx) ----

class FlightError(Exception):
    """Base Flight RPC error (carries extra server info bytes)."""

    def __init__(self, message="", extra_info=b""):
        super().__init__(message)
        self.extra_info = extra_info


class FlightInternalError(FlightError):
    pass


class FlightTimedOutError(FlightError):
    pass


class FlightCancelledError(FlightError):
    pass


class FlightServerError(FlightError):
    pass


class FlightUnauthenticatedError(FlightError):
    pass


class FlightUnauthorizedError(FlightError):
    pass


class FlightUnavailableError(FlightError):
    pass


class FlightWriteSizeExceededError(FlightError):
    def __init__(self, message="", limit=0, actual=0):
        super().__init__(message)
        self.limit = limit
        self.actual = actual


class FlightMethod:
    """RPC method ids (reference: flight/types.h FlightMethod)."""
    INVALID = 0
    HANDSHAKE = 1
    LIST_FLIGHTS = 2
    GET_FLIGHT_INFO = 3
    GET_SCHEMA = 4
    DO_GET = 5
    DO_PUT = 6
    DO_ACTION = 7
    LIST_ACTIONS = 8
    DO_EXCHANGE = 9


class DescriptorType:
    """FlightDescriptor kinds (reference: Flight.proto)."""
    UNKNOWN = 0
    PATH = 1
    CMD = 2


class CallInfo:
    __slots__ = ("method",)

    def __init__(self, method):
        self.method = method


class CertKeyPair:
    __slots__ = ("cert", "key")

    def __init__(self, cert, key):
        self.cert = cert
        self.key = key


class BasicAuth:
    __slots__ = ("username", "password")

    def __init__(self, username=None, password=None):
        self.username = username
        self.password = password

    def serialize(self) -> bytes:
        import json as _json

        u = self.username
        p = self.password
        return _json.dumps({
            "username": u.decode() if isinstance(u, bytes) else u,
            "password": p.decode() if isinstance(p, bytes) else p,
        }).encode()

    @classmethod
    def deserialize(cls, data) -> "BasicAuth":
        import json as _json

        d = _json.loads(bytes(data).decode())
        return cls(d.get("username"), d.get("password"))


class FlightCallOptions:
    """Per-call options (timeout, headers) — reference
    FlightCallOptions."""

    __slots__ = ("timeout", "headers", "write_options", "read_options")

    def __init__(self, timeout=None, write_options=None,
                 read_options=None, headers=None):
        self.timeout = timeout
        self.headers = list(headers or [])
        self.write_options = write_options
        self.read_options = read_options


class ClientAuthHandler:
    """Client side of the auth handshake."""

    def authenticate(self, outgoing, incoming):
        raise NotImplementedError

    def get_token(self):
        raise NotImplementedError


class ClientMiddlewareFactory:
    def start_call(self, info):
        return None


class ClientMiddleware:
    def sending_headers(self):
        return {}

    def received_headers(self, headers):
        pass

    def call_completed(self, exception):
        pass


class ServerCallContext:
    """Per-call server context (peer identity + middleware)."""

    __slots__ = ("_peer", "_identity", "_middleware")

    def __init__(self, peer="", identity=b"", middleware=None):
        self._peer = peer
        self._identity = identity
        self._middleware = middleware or {}

    def peer(self):
        return self._peer

    def peer_identity(self):
        return self._identity

    def get_middleware(self, key):
        return self._middleware.get(key)


class FlightDataStream:
    """Base for server-side DoGet payload streams."""


class RecordBatchStream(FlightDataStream):
    """Stream over a Table/RecordBatchReader
    (reference: RecordBatchStream)."""

    def __init__(self, data_source, options=None):
        self.data_source = data_source

    def batches(self):
        src = self.data_source
        if hasattr(src, "batches"):
            return list(src.batches)
        return list(src)


class GeneratorStream(FlightDataStream):
    """Stream from a generator of batches/tables
    (reference: GeneratorStream)."""

    def __init__(self, schema, generator, options=None):
        self.schema = schema
        self.generator = generator

    def batches(self):
        out = []
        for item in self.generator:
            out.extend(item.batches if hasattr(item, "batches")
                       else [item])
        return out


class FlightStreamChunk:
    """(data, app_metadata) pair from a stream read."""

    __slots__ = ("data", "app_metadata")

    def __init__(self, data, app_metadata=None):
        self.data = data
        self.app_metadata = app_metadata


class MetadataRecordBatchReader:
    """Reader mixin exposing read_all/read_chunk over batches."""

    def __init__(self, batches):
        self._batches = list(batches)
        self._pos = 0

    @property
    def schema(self):
        return self._batches[0].schema if self._batches else None

    def read_all(self) -> Table:
        return Table(list(self._batches))

    def read_chunk(self) -> FlightStreamChunk:
        if self._pos >= len(self._batches):
            raise StopIteration
        chunk = FlightStreamChunk(self._batches[self._pos])
        self._pos += 1
        return chunk

    def __iter__(self):
        return iter(FlightStreamChunk(b) for b in self._batches)


class MetadataRecordBatchWriter:
    """Writer mixin buffering batches + app metadata."""

    def __init__(self):
        self._batches = []

    def begin(self, schema, options=None):
        pass

    def write_batch(self, batch):
        self._batches.append(batch)

    def write_table(self, table):
        self._batches.extend(table.batches)

    def write_with_metadata(self, batch, app_metadata):
        self._batches.append(batch)

    def close(self):
        pass


class FlightStreamWriter(MetadataRecordBatchWriter):
    def done_writing(self):
        pass


class FlightMetadataReader:
    def __init__(self, messages=()):
        self._messages = list(messages)

    def read(self):
        return self._messages.pop(0) if self._messages else None


class FlightMetadataWriter:
    def __init__(self, sink=None):
        self._sink = sink if sink is not None else []

    def write(self, message):
        self._sink.append(message)


class FlightTableServer:
    """A Flight server exposing named engine tables
    (reference: flight/server.h:161 FlightServerBase + test_util.cc
    FlightTestServer shape).

    - DoGet(ticket=name)     -> stream the table
    - DoPut(descriptor=name) -> receive and store a table
    - ListFlights            -> enumerate tables
    - DoAction("drop", name) -> remove
    """

    def __init__(self, location: str = "grpc://0.0.0.0:0"):
        import pyarrow.flight as fl

        outer = self

        class _Server(fl.FlightServerBase):
            def __init__(self):
                super().__init__(location)
                self.tables: Dict[str, object] = {}
                self._lock = threading.Lock()

            def do_get(self, context, ticket):
                name = ticket.ticket.decode()
                with self._lock:
                    tbl = self.tables.get(name)
                if tbl is None:
                    raise fl.FlightServerError(f"no table {name!r}")
                return fl.RecordBatchStream(tbl)

            def do_put(self, context, descriptor, reader, writer):
                name = descriptor.path[0].decode()
                tbl = reader.read_all()
                with self._lock:
                    self.tables[name] = tbl

            def list_flights(self, context, criteria):
                with self._lock:
                    items = list(self.tables.items())
                for name, tbl in items:
                    desc = fl.FlightDescriptor.for_path(name)
                    yield fl.FlightInfo(
                        tbl.schema, desc,
                        [fl.FlightEndpoint(name, [self._loc()])],
                        tbl.num_rows, -1)

            def do_action(self, context, action):
                if action.type == "drop":
                    with self._lock:
                        self.tables.pop(action.body.to_pybytes().decode(),
                                        None)
                    return []
                raise fl.FlightServerError(f"unknown action {action.type!r}")

            def do_exchange(self, context, descriptor, reader, writer):
                """Bidirectional stream (reference: Flight.proto DoExchange):
                echoes batches back after applying the registered exchange
                transform, if any (set via server.set_exchange_fn)."""
                transform = getattr(self, "_exchange_fn", None)
                started = False
                for chunk in reader:
                    batch = chunk.data
                    if transform is not None:
                        from .interop import (record_batch_from_arrow,
                                              record_batch_to_arrow)

                        batch = record_batch_to_arrow(
                            transform(record_batch_from_arrow(batch)))
                    if not started:
                        writer.begin(batch.schema)
                        started = True
                    writer.write_batch(batch)

            def _loc(self):
                return f"grpc://localhost:{self.port}"

        self._server = _Server()
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def location(self) -> str:
        return f"grpc://localhost:{self.port}"

    def set_exchange_fn(self, fn):
        """Server-side transform applied to DoExchange batches
        (RecordBatch -> RecordBatch) — e.g. a compiled pipeline."""
        self._server._exchange_fn = fn

    def add_table(self, name: str, data: Union[RecordBatch, Table]):
        import pyarrow as pa

        batches = data.batches if isinstance(data, Table) else [data]
        tbl = pa.Table.from_batches([record_batch_to_arrow(b)
                                     for b in batches])
        with self._server._lock:
            self._server.tables[name] = tbl

    def serve_background(self):
        self._thread = threading.Thread(target=self._server.serve,
                                        daemon=True)
        self._thread.start()
        return self

    def shutdown(self):
        self._server.shutdown()

    def __enter__(self):
        return self.serve_background()

    def __exit__(self, *exc):
        self.shutdown()


class FlightClient:
    """reference: flight/client.h:168."""

    def __init__(self, location: str):
        import pyarrow.flight as fl

        self._client = fl.connect(location)

    def get(self, name: str) -> Table:
        """DoGet -> engine Table (reference: client.cc:1153)."""
        import pyarrow.flight as fl

        reader = self._client.do_get(fl.Ticket(name.encode()))
        batches = [record_batch_from_arrow(chunk.data)
                   for chunk in reader]
        if not batches:
            raise Invalid(f"table {name!r} streamed no batches")
        return Table(batches)

    def put(self, name: str, data: Union[RecordBatch, Table]):
        """DoPut."""
        import pyarrow as pa
        import pyarrow.flight as fl

        batches = data.batches if isinstance(data, Table) else [data]
        pa_batches = [record_batch_to_arrow(b) for b in batches]
        desc = fl.FlightDescriptor.for_path(name)
        writer, _ = self._client.do_put(desc, pa_batches[0].schema)
        for b in pa_batches:
            writer.write_batch(b)
        writer.close()

    def list(self):
        return [info.descriptor.path[0].decode()
                for info in self._client.list_flights()]

    def exchange(self, name: str, data: Union[RecordBatch, Table]) -> Table:
        """DoExchange: stream batches to the server, read back the
        (possibly transformed) stream."""
        import pyarrow.flight as fl

        batches = data.batches if isinstance(data, Table) else [data]
        pa_batches = [record_batch_to_arrow(b) for b in batches]
        desc = fl.FlightDescriptor.for_path(name)
        writer, reader = self._client.do_exchange(desc)
        out = []
        with writer:
            writer.begin(pa_batches[0].schema)
            for b in pa_batches:
                writer.write_batch(b)
            writer.done_writing()
            for chunk in reader:
                out.append(record_batch_from_arrow(chunk.data))
        if not out:
            raise Invalid("exchange returned no batches")
        return Table(out)

    def drop(self, name: str):
        import pyarrow.flight as fl

        list(self._client.do_action(fl.Action("drop", name.encode())))


def serve_tables(tables: Dict[str, Union[RecordBatch, Table]],
                 location: str = "grpc://0.0.0.0:0") -> FlightTableServer:
    """Convenience: spin up a background server with the given tables."""
    server = FlightTableServer(location)
    for name, tbl in tables.items():
        server.add_table(name, tbl)
    return server.serve_background()


class TracingServerMiddlewareFactory:
    """OpenTelemetry propagation shim (reference:
    TracingServerMiddlewareFactory); spans are not collected here."""

    def start_call(self, info, headers):
        return None


def connect(location, **kwargs):
    """pyarrow.flight.connect shape -> native client."""
    from .flight_native import NativeFlightClient

    return NativeFlightClient(location, **kwargs)
