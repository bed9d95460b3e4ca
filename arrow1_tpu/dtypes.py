"""Logical type system for the device-native columnar engine.

Re-designs the reference type system (reference: cpp/src/arrow/type.h:113,
type_fwd.h:270 — 35+ logical types) for device execution:

- Every on-device column is a *fixed-width* physical array. Variable-width
  logical types (string/binary) are dictionary-encoded at ingest (host side)
  and carried on device as int32 codes; the dictionary values stay on the
  host (cf. SURVEY.md §7 "Hard parts": variable-width data on fixed-shape
  hardware).
- Validity bitmaps (reference: LSB-packed, docs/source/format/Columnar.rst)
  become unpacked bool mask arrays — the natural data-parallel
  representation (packed bitmaps would need unpack work on every touch).
- Temporal types are int64/int32 with a unit tag, matching the reference's
  physical storage (cpp/src/arrow/type.h TimestampType etc.).

Types are frozen, hashable dataclasses so they can serve as static (aux)
pytree metadata under `jax.jit`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

__all__ = [
    "DataType",
    "null",
    "bool_",
    "int8",
    "int16",
    "int32",
    "int64",
    "uint8",
    "uint16",
    "uint32",
    "uint64",
    "float16",
    "float32",
    "float64",
    "string",
    "large_string",
    "binary",
    "date32",
    "date64",
    "timestamp",
    "time32",
    "time64",
    "duration",
    "decimal128",
    "list_",
    "fixed_size_list",
    "struct",
    "map_",
    "sparse_union",
    "dense_union",
    "dictionary",
    "Field",
    "Schema",
    "from_arrow",
    "to_arrow",
]


# Physical storage kinds. Every logical type maps to exactly one.
_PHYS = {
    "null": None,
    "bool": jnp.bool_,
    "int8": jnp.int8,
    "int16": jnp.int16,
    "int32": jnp.int32,
    "int64": jnp.int64,
    "uint8": jnp.uint8,
    "uint16": jnp.uint16,
    "uint32": jnp.uint32,
    "uint64": jnp.uint64,
    "float16": jnp.float16,
    "float32": jnp.float32,
    "float64": jnp.float64,
    "bfloat16": jnp.bfloat16,
}


@dataclasses.dataclass(frozen=True)
class DataType:
    """A logical column type (reference: cpp/src/arrow/type.h:113).

    ``kind`` is the logical family; ``unit``/``precision``/``scale``/
    ``fields`` parameterize temporal, decimal, and nested types. Equality
    and hashing are structural, so DataType instances can be jit static
    arguments.
    """

    kind: str
    # temporal unit: "s" | "ms" | "us" | "ns"; or timezone for timestamp
    unit: Optional[str] = None
    tz: Optional[str] = None
    precision: int = 0
    scale: int = 0
    # nested types: tuple of (name, DataType); list types: single child
    fields: Tuple = ()
    # fixed_size_list width
    list_size: int = 0
    # dictionary value type (for explicit dictionary type)
    value_type: Optional["DataType"] = None
    index_type: Optional["DataType"] = None
    # union child type codes (parallel to ``fields``)
    type_codes: Tuple = ()

    # ---- classification predicates (reference: type_traits.h) ----
    @property
    def is_null(self) -> bool:
        return self.kind == "null"

    @property
    def is_boolean(self) -> bool:
        return self.kind == "bool"

    @property
    def is_integer(self) -> bool:
        return self.kind in (
            "int8", "int16", "int32", "int64",
            "uint8", "uint16", "uint32", "uint64",
        )

    @property
    def is_signed_integer(self) -> bool:
        return self.kind in ("int8", "int16", "int32", "int64")

    @property
    def is_unsigned_integer(self) -> bool:
        return self.kind in ("uint8", "uint16", "uint32", "uint64")

    @property
    def is_floating(self) -> bool:
        return self.kind in ("float16", "float32", "float64", "bfloat16")

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_floating

    @property
    def is_temporal(self) -> bool:
        return self.kind in (
            "date32", "date64", "timestamp", "time32", "time64", "duration",
        )

    @property
    def is_string(self) -> bool:
        return self.kind in ("string", "large_string")

    @property
    def is_binary(self) -> bool:
        return self.kind in ("binary", "large_binary", "string", "large_string")

    @property
    def is_decimal(self) -> bool:
        return self.kind in ("decimal128", "decimal256")

    @property
    def is_interval(self) -> bool:
        """month/day_time/month_day_nano intervals (type.h:113 enum
        INTERVAL_MONTHS/DAY_TIME + the 5.0-era month_day_nano)."""
        return self.kind in ("month_interval", "day_time_interval",
                             "month_day_nano_interval")

    @property
    def is_extension(self) -> bool:
        return self.kind == "extension"

    @property
    def is_dictionary(self) -> bool:
        return self.kind == "dictionary"

    @property
    def is_nested(self) -> bool:
        return self.kind in ("list", "large_list", "fixed_size_list",
                             "struct", "map", "sparse_union",
                             "dense_union")

    @property
    def is_primitive(self) -> bool:
        """Stored as one fixed-width device array (+ mask)."""
        return self.kind in _PHYS and self.kind != "null"

    # ---- physical storage ----
    def physical_dtype(self):
        """The jnp dtype of the on-device data array for this logical type.

        Strings/binary are dictionary codes (int32); temporals are their
        integer storage; decimal128 is NOT handled here (two-limb storage,
        see column.py).
        """
        if self.kind in _PHYS:
            return _PHYS[self.kind]
        if self.is_string or self.kind in ("binary", "large_binary"):
            return jnp.int32  # dictionary codes
        if self.kind in ("date32", "time32"):
            return jnp.int32
        if self.kind in ("date64", "time64", "timestamp", "duration"):
            return jnp.int64
        if self.kind == "dictionary":
            return self.index_type.physical_dtype() if self.index_type else jnp.int32
        if self.kind in ("decimal128", "decimal256"):
            return jnp.int64  # low limb; high limb(s) carried in data2
        if self.kind == "month_interval":
            return jnp.int32
        if self.kind in ("day_time_interval", "month_day_nano_interval"):
            # day_time packs (days i32, ms i32) into one i64;
            # month_day_nano packs (months i32, days i32) into data and
            # carries nanoseconds in data2
            return jnp.int64
        if self.kind == "extension":
            return self.value_type.physical_dtype()
        raise TypeError(f"no single physical dtype for {self}")

    @property
    def byte_width(self) -> int:
        return np.dtype(self.physical_dtype()).itemsize

    def __repr__(self) -> str:
        if self.kind == "timestamp":
            return f"timestamp[{self.unit}]" + (f", tz={self.tz}" if self.tz else "")
        if self.kind in ("time32", "time64", "duration"):
            return f"{self.kind}[{self.unit}]"
        if self.kind in ("decimal128", "decimal256"):
            return f"{self.kind}({self.precision}, {self.scale})"
        if self.kind == "extension":
            return f"extension<{self.unit}, storage={self.value_type!r}>"
        if self.kind in ("list", "large_list"):
            return f"{self.kind}<{self.fields[0][1]!r}>"
        if self.kind == "fixed_size_list":
            return f"fixed_size_list<{self.fields[0][1]!r}>[{self.list_size}]"
        if self.kind == "struct":
            inner = ", ".join(f"{n}: {t!r}" for n, t in self.fields)
            return f"struct<{inner}>"
        if self.kind == "dictionary":
            return f"dictionary<{self.value_type!r}, {self.index_type!r}>"
        if self.kind in ("sparse_union", "dense_union"):
            inner = ", ".join(f"{n}: {t!r}={c}" for (n, t), c in
                              zip(self.fields, self.type_codes))
            return f"{self.kind}<{inner}>"
        return self.kind


# ---- canonical instances / factories ----
null = DataType("null")
bool_ = DataType("bool")
int8 = DataType("int8")
int16 = DataType("int16")
int32 = DataType("int32")
int64 = DataType("int64")
uint8 = DataType("uint8")
uint16 = DataType("uint16")
uint32 = DataType("uint32")
uint64 = DataType("uint64")
float16 = DataType("float16")
float32 = DataType("float32")
float64 = DataType("float64")
bfloat16 = DataType("bfloat16")
string = DataType("string")
large_string = DataType("large_string")
binary = DataType("binary")
large_binary = DataType("large_binary")
date32 = DataType("date32")
date64 = DataType("date64")


def timestamp(unit: str = "us", tz: Optional[str] = None) -> DataType:
    assert unit in ("s", "ms", "us", "ns"), unit
    return DataType("timestamp", unit=unit, tz=tz)


def time32(unit: str = "s") -> DataType:
    assert unit in ("s", "ms"), unit
    return DataType("time32", unit=unit)


def time64(unit: str = "us") -> DataType:
    assert unit in ("us", "ns"), unit
    return DataType("time64", unit=unit)


def duration(unit: str = "us") -> DataType:
    assert unit in ("s", "ms", "us", "ns"), unit
    return DataType("duration", unit=unit)


def decimal128(precision: int, scale: int) -> DataType:
    return DataType("decimal128", precision=precision, scale=scale)


def decimal256(precision: int, scale: int) -> DataType:
    """256-bit decimal (util/basic_decimal.h Decimal256): four 64-bit
    limbs — data holds limb0 (lowest), data2 holds [n,3] limbs 1..3."""
    return DataType("decimal256", precision=precision, scale=scale)


def month_interval() -> DataType:
    return DataType("month_interval")


def day_time_interval() -> DataType:
    return DataType("day_time_interval")


def month_day_nano_interval() -> DataType:
    return DataType("month_day_nano_interval")


def extension(name: str, storage: DataType) -> DataType:
    """Extension-type hook (ref: vector_selection.cc:1178 unwraps to
    storage). `unit` carries the extension name; ops operate on the
    storage representation; export re-wraps when the extension is
    registered with pyarrow."""
    return DataType("extension", unit=name, value_type=storage)


def list_(value_type: DataType) -> DataType:
    return DataType("list", fields=(("item", value_type),))


def large_list(value_type: DataType) -> DataType:
    return DataType("large_list", fields=(("item", value_type),))


def fixed_size_list(value_type: DataType, list_size: int) -> DataType:
    return DataType(
        "fixed_size_list", fields=(("item", value_type),), list_size=list_size
    )


def struct(fields) -> DataType:
    return DataType("struct", fields=tuple((n, t) for n, t in fields))


def map_(key_type: DataType, item_type: DataType) -> DataType:
    return DataType("map", fields=(("key", key_type), ("value", item_type)))


def sparse_union(fields, type_codes=None) -> DataType:
    fields = tuple((n, t) for n, t in fields)
    codes = tuple(type_codes) if type_codes else tuple(range(len(fields)))
    return DataType("sparse_union", fields=fields, type_codes=codes)


def dense_union(fields, type_codes=None) -> DataType:
    fields = tuple((n, t) for n, t in fields)
    codes = tuple(type_codes) if type_codes else tuple(range(len(fields)))
    return DataType("dense_union", fields=fields, type_codes=codes)


def dictionary(index_type: DataType, value_type: DataType) -> DataType:
    return DataType("dictionary", index_type=index_type, value_type=value_type)


def from_numpy_dtype(dt) -> DataType:
    dt = np.dtype(dt)
    mapping = {
        "b": {1: bool_},
        "i": {1: int8, 2: int16, 4: int32, 8: int64},
        "u": {1: uint8, 2: uint16, 4: uint32, 8: uint64},
        "f": {2: float16, 4: float32, 8: float64},
    }
    if dt.kind == "b":
        return bool_
    try:
        return mapping[dt.kind][dt.itemsize]
    except KeyError:
        raise TypeError(f"unsupported numpy dtype {dt}")


@dataclasses.dataclass(frozen=True)
class Field:
    """A named, typed, nullable slot in a Schema (reference: type.h Field)."""

    name: str
    type: DataType
    nullable: bool = True

    def __repr__(self):
        return f"Field({self.name!r}: {self.type!r}{'' if self.nullable else ', non-null'})"


@dataclasses.dataclass(frozen=True)
class Schema:
    """An ordered collection of Fields (reference: type.h Schema).

    ``metadata`` is the schema-level key/value store (tuple-of-pairs so
    the dataclass stays frozen/hashable); bytes keys/values like arrow.
    """

    fields: Tuple[Field, ...]
    metadata: Optional[Tuple[Tuple[bytes, bytes], ...]] = None

    def metadata_dict(self):
        return dict(self.metadata) if self.metadata else None

    def with_metadata(self, metadata) -> "Schema":
        # Arrow schema metadata is order-preserving (Schema.fbs custom
        # metadata is a list, not a map) — keep insertion order.
        items = tuple(
            (k.encode() if isinstance(k, str) else k,
             v.encode() if isinstance(v, str) else v)
            for k, v in dict(metadata).items())
        return Schema(self.fields, items)

    def remove_metadata(self) -> "Schema":
        return Schema(self.fields, None)

    @property
    def names(self):
        return tuple(f.name for f in self.fields)

    @property
    def types(self):
        return tuple(f.type for f in self.fields)

    def field(self, name: str) -> Field:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(name)

    # ---- pyarrow.Schema method parity (python/pyarrow/types.pxi) ----
    def get_field_index(self, name: str) -> int:
        try:
            return self.index_of(name)
        except KeyError:
            return -1

    def get_all_field_indices(self, name: str):
        return [i for i, f in enumerate(self.fields) if f.name == name]

    def field_by_name(self, name: str) -> Optional[Field]:
        try:
            return self.field(name)
        except KeyError:
            return None

    def equals(self, other, check_metadata: bool = False) -> bool:
        if self.fields != tuple(other.fields):
            return False
        return not check_metadata or self.metadata == other.metadata

    def append(self, field: Field) -> "Schema":
        return Schema(self.fields + (field,), self.metadata)

    def insert(self, i: int, field: Field) -> "Schema":
        return Schema(self.fields[:i] + (field,) + self.fields[i:],
                      self.metadata)

    def remove(self, i: int) -> "Schema":
        return Schema(self.fields[:i] + self.fields[i + 1:], self.metadata)

    def set(self, i: int, field: Field) -> "Schema":
        return Schema(self.fields[:i] + (field,) + self.fields[i + 1:],
                      self.metadata)

    def add_metadata(self, metadata) -> "Schema":  # deprecated pa alias
        return self.with_metadata(metadata)

    @property
    def pandas_metadata(self):
        md = self.metadata_dict()
        if md and b"pandas" in md:
            import json as _json

            return _json.loads(md[b"pandas"].decode())
        return None

    def empty_table(self):
        from .table import RecordBatch, Table

        from .column import Column, nulls

        cols = tuple(nulls(0, f.type).with_validity(None)
                     for f in self.fields)
        return Table([RecordBatch(cols, self.names)])

    def to_string(self) -> str:
        return repr(self)

    def serialize(self) -> bytes:
        """Schema as IPC stream bytes (an empty-table stream)."""
        import io as _io

        from .io import ipc_native

        buf = _io.BytesIO()
        ipc_native.write_stream(buf, list(self.empty_table().batches))
        return buf.getvalue()

    def __len__(self):
        return len(self.fields)

    def __repr__(self):
        inner = "\n  ".join(repr(f) for f in self.fields)
        return f"Schema(\n  {inner}\n)"


def schema(fields) -> Schema:
    out = []
    for f in fields:
        if isinstance(f, Field):
            out.append(f)
        else:
            name, typ = f[0], f[1]
            nullable = f[2] if len(f) > 2 else True
            out.append(Field(name, typ, nullable))
    return Schema(tuple(out))


# ---- pyarrow bridge (host boundary only) ----

def from_arrow(pa_type) -> DataType:
    """Map a pyarrow DataType to ours. Used only at the host ingest boundary."""
    import pyarrow as pa

    if pa.types.is_null(pa_type):
        return null
    if pa.types.is_boolean(pa_type):
        return bool_
    for k in ("int8", "int16", "int32", "int64",
              "uint8", "uint16", "uint32", "uint64"):
        if pa_type == getattr(pa, k)():
            return DataType(k)
    if pa.types.is_float16(pa_type):
        return float16
    if pa.types.is_float32(pa_type):
        return float32
    if pa.types.is_float64(pa_type):
        return float64
    if pa.types.is_string(pa_type):
        return string
    if pa.types.is_large_string(pa_type):
        return large_string
    if pa.types.is_binary(pa_type):
        return binary
    if pa.types.is_date32(pa_type):
        return date32
    if pa.types.is_date64(pa_type):
        return date64
    if pa.types.is_timestamp(pa_type):
        return timestamp(pa_type.unit, pa_type.tz)
    if pa.types.is_time32(pa_type):
        return time32(pa_type.unit)
    if pa.types.is_time64(pa_type):
        return time64(pa_type.unit)
    if pa.types.is_duration(pa_type):
        return duration(pa_type.unit)
    if pa.types.is_decimal128(pa_type):
        return decimal128(pa_type.precision, pa_type.scale)
    if pa.types.is_decimal256(pa_type):
        return decimal256(pa_type.precision, pa_type.scale)
    if pa_type == pa.month_day_nano_interval():
        return month_day_nano_interval()
    if str(pa_type) == "month_interval":  # C++-only in pyarrow 25
        return month_interval()
    if str(pa_type) == "day_time_interval":
        return day_time_interval()
    if isinstance(pa_type, pa.ExtensionType):
        return extension(pa_type.extension_name,
                         from_arrow(pa_type.storage_type))
    if pa.types.is_dictionary(pa_type):
        return dictionary(from_arrow(pa_type.index_type), from_arrow(pa_type.value_type))
    if pa.types.is_list(pa_type):
        return list_(from_arrow(pa_type.value_type))
    if pa.types.is_large_list(pa_type):
        return large_list(from_arrow(pa_type.value_type))
    if pa.types.is_fixed_size_list(pa_type):
        return fixed_size_list(from_arrow(pa_type.value_type), pa_type.list_size)
    if pa.types.is_struct(pa_type):
        return struct((f.name, from_arrow(f.type)) for f in pa_type)
    if pa.types.is_map(pa_type):
        return map_(from_arrow(pa_type.key_type), from_arrow(pa_type.item_type))
    if pa.types.is_union(pa_type):
        fields = [(f.name, from_arrow(f.type)) for f in pa_type]
        mk = sparse_union if pa_type.mode == "sparse" else dense_union
        return mk(fields, list(pa_type.type_codes))
    raise TypeError(f"unsupported arrow type {pa_type}")


def to_arrow(dt: DataType):
    import pyarrow as pa

    simple = {
        "null": pa.null(), "bool": pa.bool_(),
        "int8": pa.int8(), "int16": pa.int16(),
        "int32": pa.int32(), "int64": pa.int64(),
        "uint8": pa.uint8(), "uint16": pa.uint16(),
        "uint32": pa.uint32(), "uint64": pa.uint64(),
        "float16": pa.float16(), "float32": pa.float32(),
        "float64": pa.float64(),
        "string": pa.string(), "large_string": pa.large_string(),
        "binary": pa.binary(), "large_binary": pa.large_binary(),
        "date32": pa.date32(), "date64": pa.date64(),
    }
    if dt.kind in simple:
        return simple[dt.kind]
    if dt.kind == "timestamp":
        return pa.timestamp(dt.unit, dt.tz)
    if dt.kind == "time32":
        return pa.time32(dt.unit)
    if dt.kind == "time64":
        return pa.time64(dt.unit)
    if dt.kind == "duration":
        return pa.duration(dt.unit)
    if dt.kind == "decimal128":
        return pa.decimal128(dt.precision, dt.scale)
    if dt.kind == "decimal256":
        return pa.decimal256(dt.precision, dt.scale)
    if dt.kind == "month_day_nano_interval":
        return pa.month_day_nano_interval()
    if dt.kind in ("month_interval", "day_time_interval"):
        # pyarrow 25 exposes no Python constructor for these (the
        # reference's Python binding can't build them either — they are
        # the "pyarrow-broken interval outputs" of the 5 unregistered
        # functions); engine-native only.
        raise TypeError(f"pyarrow exposes no Python {dt.kind} type")
    if dt.kind == "dictionary":
        return pa.dictionary(to_arrow(dt.index_type), to_arrow(dt.value_type))
    if dt.kind == "list":
        return pa.list_(to_arrow(dt.fields[0][1]))
    if dt.kind == "large_list":
        return pa.large_list(to_arrow(dt.fields[0][1]))
    if dt.kind == "fixed_size_list":
        return pa.list_(to_arrow(dt.fields[0][1]), dt.list_size)
    if dt.kind == "struct":
        return pa.struct([pa.field(n, to_arrow(t)) for n, t in dt.fields])
    if dt.kind == "map":
        return pa.map_(to_arrow(dt.fields[0][1]), to_arrow(dt.fields[1][1]))
    if dt.kind in ("sparse_union", "dense_union"):
        mode = "sparse" if dt.kind == "sparse_union" else "dense"
        return pa.union([pa.field(n, to_arrow(t)) for n, t in dt.fields],
                        mode=mode, type_codes=list(dt.type_codes))
    raise TypeError(f"cannot convert {dt} to arrow")
