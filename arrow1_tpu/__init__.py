"""arrow1_tpu — a vectorized columnar query-execution engine in JAX.

Brand-new design with the capabilities of Apache Arrow's C++ compute layer
(reference: cpp/src/arrow/compute), built on JAX/XLA: columns are
fixed-width device arrays with bool validity masks, strings are
dictionary-encoded at ingest, kernels are jitted XLA graphs, and
distribution is `shard_map` + collectives over a `jax.sharding.Mesh`
instead of RPC. It runs on NVIDIA GPUs (and on the CPU for tests).

Layer map (mirrors SURVEY.md §1):
  dtypes/column/table      <- Arrow type system + ArrayData/RecordBatch/Table
  ops/* + registry          <- compute kernel registry (compute/registry.cc)
  expr                      <- compute/exec/expression.{h,cc}
  query                     <- the fluent entry point (a1t.query)
  exec/*                    <- ExecPlan/ExecNode skeleton, compiled and
                               streaming drivers
  parallel/*                <- Flight-as-shuffle -> mesh collectives
  io/*                      <- IPC/CSV/Parquet host ingest
  kernels/*                 <- hash-table, radix-key and scan kernels
"""

import jax

# int64/float64 columns are first-class in the reference engine; enable
# 64-bit mode globally (parity with pyarrow demands exact 64-bit
# semantics).
jax.config.update("jax_enable_x64", True)

from . import dtypes  # noqa: E402
from .dtypes import (  # noqa: E402,F401
    DataType, Field, Schema, schema,
    null, bool_, int8, int16, int32, int64,
    uint8, uint16, uint32, uint64,
    float16, float32, float64,
    string, large_string, binary,
    date32, date64, timestamp, time32, time64, duration,
    decimal128, list_, fixed_size_list, struct, dictionary,
)
from .column import Column, Dictionary, column, nulls  # noqa: E402,F401
from .table import RecordBatch, Table, record_batch, table, concat_batches  # noqa: E402,F401
from .config import ExecContext, default_context  # noqa: E402,F401
from .datum import Datum, Scalar, scalar  # noqa: E402,F401
from .registry import call_function, function_registry, list_functions  # noqa: E402,F401
from . import compute  # noqa: E402,F401
from .datum import as_datum  # noqa: E402,F401
from .ops.groupby import group_by  # noqa: E402,F401
from .ops.join import join  # noqa: E402,F401
from .expr import Expression, call, field, literal  # noqa: E402,F401
from .table import ChunkedColumn, concat_columns  # noqa: E402,F401
from .column import (ListColumn, StructColumn,  # noqa: E402,F401
                     UnionColumn, fixed_size_list_column)
from .validate import validate_batch, validate_column  # noqa: E402,F401

# pyarrow-shaped top-level conveniences
from .dtypes import map_  # noqa: E402,F401
from .dtypes import (  # noqa: E402,F401
    decimal256, large_binary, large_list, month_interval,
    day_time_interval, month_day_nano_interval, sparse_union, dense_union,
    from_numpy_dtype, extension,
)
array = column          # pyarrow.array -> Column
concat_arrays = concat_columns
Array = Column          # pyarrow class-name aliases
ChunkedArray = ChunkedColumn

# pyarrow type-constructor aliases
utf8 = string
large_utf8 = large_string


def union(fields, mode: str = "sparse", type_codes=None):
    """pyarrow.union shape: mode selects sparse/dense."""
    ctor = sparse_union if mode == "sparse" else dense_union
    return ctor(fields, type_codes)


_TYPE_ALIASES = None


def type_for_alias(name: str) -> DataType:
    """pyarrow.type_for_alias: string alias -> DataType
    (reference: type.cc kTypeAliases)."""
    global _TYPE_ALIASES
    if _TYPE_ALIASES is None:
        _TYPE_ALIASES = {
            "null": null, "bool": bool_, "boolean": bool_,
            "i1": int8, "int8": int8, "i2": int16, "int16": int16,
            "i4": int32, "int32": int32, "i8": int64, "int64": int64,
            "u1": uint8, "uint8": uint8, "u2": uint16, "uint16": uint16,
            "u4": uint32, "uint32": uint32, "u8": uint64, "uint64": uint64,
            "f2": float16, "halffloat": float16, "float16": float16,
            "f4": float32, "float": float32, "float32": float32,
            "f8": float64, "double": float64, "float64": float64,
            "string": string, "str": string, "utf8": string,
            "binary": binary, "large_string": large_string,
            "large_str": large_string, "large_utf8": large_string,
            "large_binary": large_binary,
            "date32": date32, "date32[day]": date32,
            "date64": date64, "date64[ms]": date64,
            "time32[s]": time32("s"), "time32[ms]": time32("ms"),
            "time64[us]": time64("us"), "time64[ns]": time64("ns"),
            "timestamp[s]": timestamp("s"), "timestamp[ms]": timestamp("ms"),
            "timestamp[us]": timestamp("us"), "timestamp[ns]": timestamp("ns"),
            "duration[s]": duration("s"), "duration[ms]": duration("ms"),
            "duration[us]": duration("us"), "duration[ns]": duration("ns"),
            "month_day_nano_interval": month_day_nano_interval(),
        }
    try:
        return _TYPE_ALIASES[name]
    except KeyError:
        raise ValueError(f"No type alias for {name!r}")


def infer_type(values, mask=None, from_pandas: bool = False) -> DataType:
    """pyarrow.infer_type shape: python sequence -> DataType (host-side
    ingest helper; rides pyarrow's inference like the rest of ingest)."""
    import pyarrow as pa

    return dtypes.from_arrow(pa.infer_type(values, mask=mask,
                                           from_pandas=from_pandas))


def repeat(value, size: int) -> Column:
    """pyarrow.repeat: one value, size rows."""
    from .datum import Scalar as _S

    if isinstance(value, _S):
        value = value.as_py()
    return column([value] * size)


NA = Scalar(None, dtypes.null, is_valid=False)  # pyarrow.NA


def chunked_array(chunks):
    """pyarrow.chunked_array shape: list of array-likes -> ChunkedColumn."""
    return ChunkedColumn([column(c) for c in chunks])


def concat_tables(tables):
    """pyarrow.concat_tables shape: same-schema Tables -> one Table."""
    from .table import Table

    out = []
    for t in tables:
        out.extend(t.batches)
    return Table(out)


def unify_schemas(schemas):
    """First-wins field unification (reference: UnifySchemas type.cc)."""
    from . import dtypes as _dt

    fields = {}
    for s in schemas:
        for f in s.fields:
            if f.name not in fields:
                fields[f.name] = f
            elif fields[f.name].type != f.type:
                raise ValueError(
                    f"unify_schemas: conflicting types for {f.name!r}: "
                    f"{fields[f.name].type!r} vs {f.type!r}")
    return _dt.Schema(tuple(fields.values()))


def total_allocated_bytes() -> int:
    """Live device-memory estimate (reference: default_memory_pool()
    ->bytes_allocated); backed by PJRT's per-device stats."""
    from .runtime import device_memory_stats

    stats = device_memory_stats()
    return sum(int(s.get("bytes_in_use", 0)) for s in stats.values())         if isinstance(stats, dict) else 0


# ---- error hierarchy aliases (reference: pyarrow.lib Arrow* errors) ----
from . import errors  # noqa: E402
from .errors import A1TError as ArrowException  # noqa: E402,F401
from .errors import Invalid as ArrowInvalid  # noqa: E402,F401
from .errors import IndexError_ as ArrowIndexError  # noqa: E402,F401
from .errors import KeyError_ as ArrowKeyError  # noqa: E402,F401
from .errors import (  # noqa: E402,F401
    NotImplementedError_ as ArrowNotImplementedError,
)
ArrowTypeError = ArrowInvalid
ArrowIOError = ArrowException
ArrowMemoryError = ArrowException
ArrowCapacityError = ArrowException
ArrowSerializationError = ArrowInvalid

# ---- buffers / streams (reference: pyarrow buffer + io surface) ----
from .io.streams import (  # noqa: E402,F401
    Buffer, BufferOutputStream, BufferReader, BufferedInputStream,
    BufferedOutputStream, MemoryMappedFile, OSFile, allocate_buffer,
    create_memory_map, foreign_buffer, input_stream, memory_map,
    output_stream, py_buffer,
)
from .io.compression import (  # noqa: E402,F401
    Codec, CompressedInputStream, CompressedOutputStream, compress,
    decompress,
)

# ---- memory pools (PJRT owns device memory; these are the host-side
# observability analogues, reference: pyarrow memory_pool surface) ----
from .memory import (  # noqa: E402,F401
    LoggingMemoryPool, MemoryPool, ProxyMemoryPool, default_memory_pool,
    set_memory_pool,
)


def system_memory_pool() -> MemoryPool:
    return default_memory_pool()


def logging_memory_pool(parent=None) -> LoggingMemoryPool:
    return LoggingMemoryPool(parent or default_memory_pool())


def proxy_memory_pool(parent=None) -> ProxyMemoryPool:
    return ProxyMemoryPool(parent or default_memory_pool())


def jemalloc_memory_pool() -> MemoryPool:
    raise ArrowNotImplementedError(
        "jemalloc is not used here: device memory is managed by PJRT, "
        "host staging by the CPython allocator")


def mimalloc_memory_pool() -> MemoryPool:
    raise ArrowNotImplementedError(
        "mimalloc is not used here: device memory is managed by PJRT, "
        "host staging by the CPython allocator")


def jemalloc_set_decay_ms(ms: int) -> None:
    raise ArrowNotImplementedError("jemalloc is not used here")


def supported_memory_backends():
    return ["system"]


_BASE_POOL = [None]  # pool before logging was enabled


def log_memory_allocations(enable: bool = True) -> None:
    from . import memory as _m

    cur = default_memory_pool()
    if enable:
        if not isinstance(cur, LoggingMemoryPool):
            _BASE_POOL[0] = cur
            _m.set_memory_pool(LoggingMemoryPool(cur))
    elif isinstance(cur, LoggingMemoryPool):
        _m.set_memory_pool(_BASE_POOL[0] or MemoryPool())


# ---- thread counts (reference: pyarrow cpu_count surface) ----
from .thread_pool import cpu_count  # noqa: E402,F401
from .thread_pool import (  # noqa: E402
    cpu_thread_pool as _cpu_pool,
    set_cpu_thread_pool_capacity as _set_cpu_cap,
)

_io_thread_count = [8]


def set_cpu_count(n: int) -> None:
    _set_cpu_cap(int(n))


def io_thread_count() -> int:
    return _io_thread_count[0]


def set_io_thread_count(n: int) -> None:
    _io_thread_count[0] = int(n)


# ---- runtime/build info ----
from .runtime import build_info, runtime_info  # noqa: E402,F401


def show_versions() -> None:
    import sys as _s

    import jax as _j
    import numpy as _np

    print(f"arrow1_tpu : {__version__}")
    print(f"jax        : {_j.__version__}")
    print(f"numpy      : {_np.__version__}")
    print(f"python     : {_s.version.split()[0]}")


show_info = show_versions


# ---- extension type registry (reference: pyarrow extension surface;
# ingest unwraps to storage per vector_selection.cc:1178 semantics) ----
def register_extension_type(ext_type) -> None:
    """Register a pyarrow ExtensionType for ingest/export round-trips."""
    import pyarrow as pa

    from . import interop as _i

    pa.register_extension_type(ext_type)
    _i._EXT_TYPES[ext_type.extension_name] = ext_type


def unregister_extension_type(type_name: str) -> None:
    import pyarrow as pa

    from . import interop as _i

    pa.unregister_extension_type(type_name)
    _i._EXT_TYPES.pop(type_name, None)


# subpackages/modules re-exported for discoverability (imported lazily by
# users as arrow1_tpu.io / .dataset / .flight / ... to avoid pulling heavy
# deps at import)
from . import io  # noqa: E402,F401
from . import dataset  # noqa: E402,F401
from . import acero  # noqa: E402,F401
from . import fs  # noqa: E402,F401
from . import gandiva  # noqa: E402,F401
from . import tensor  # noqa: E402,F401
from . import cancel  # noqa: E402,F401
from . import runtime  # noqa: E402,F401
from . import cdata  # noqa: E402,F401
from . import builders  # noqa: E402,F401
from . import memory  # noqa: E402,F401
from . import profiler  # noqa: E402,F401
from . import thread_pool  # noqa: E402,F401
from . import types  # noqa: E402,F401
from .query import Query, query  # noqa: E402,F401

# pyarrow-named io facades (import arrow1_tpu.parquet as pq, ...)
from . import parquet  # noqa: E402,F401
from . import csv  # noqa: E402,F401
from . import json  # noqa: E402,F401
from . import ipc  # noqa: E402,F401
from . import feather  # noqa: E402,F401
from . import orc  # noqa: E402,F401
from .ipc import deserialize_pandas, serialize_pandas  # noqa: E402,F401

__version__ = "0.1.0"
