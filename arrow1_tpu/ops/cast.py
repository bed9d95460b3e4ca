"""Cast kernels.

Reference: cpp/src/arrow/compute/cast.h:83 (cast meta-function +
CastOptions safety toggles, cast.h:44) and the scalar_cast_*.cc kernel
families. Safety checks (int narrowing, float truncation, time truncation)
are on-device flag reductions raised at the eager boundary, like the
checked arithmetic kernels.

String<->numeric casts run on the *dictionary values* host-side (a few
unique strings) and gather on device — the dictionary-encode-at-ingest
design means a cast never touches per-row bytes on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..column import Column, Dictionary
from ..datum import Scalar
from ..errors import Invalid
from ..registry import register_function
from .common import result_column, unpack

__all__ = ["CastOptions", "cast", "temporal_to_common"]


@dataclasses.dataclass
class CastOptions:
    """Reference: cast.h:44."""

    target_type: Optional[dt.DataType] = None
    allow_int_overflow: bool = False
    allow_time_truncate: bool = False
    allow_time_overflow: bool = False
    allow_decimal_truncate: bool = False
    allow_float_truncate: bool = False
    allow_invalid_utf8: bool = False

    @classmethod
    def safe(cls, target_type=None):
        return cls(target_type=target_type)

    @classmethod
    def unsafe(cls, target_type=None):
        return cls(target_type=target_type, allow_int_overflow=True,
                   allow_time_truncate=True, allow_time_overflow=True,
                   allow_decimal_truncate=True, allow_float_truncate=True,
                   allow_invalid_utf8=True)


_UNIT_NS = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}


def _temporal_unit_ns(t: dt.DataType) -> int:
    if t.kind == "date32":
        return 86_400 * _UNIT_NS["s"]
    if t.kind == "date64":
        return _UNIT_NS["ms"]
    return _UNIT_NS[t.unit]


def temporal_to_common(a, b):
    """Storage ints of two temporal args rescaled to the finer unit."""
    na, nb = _temporal_unit_ns(a.dtype), _temporal_unit_ns(b.dtype)
    from .common import value_of

    x = value_of(a).astype(jnp.int64)
    y = value_of(b).astype(jnp.int64)
    if na > nb:
        x = x * (na // nb)
    elif nb > na:
        y = y * (nb // na)
    return x, y


def _raise_if(flag, message, validity):
    if validity is False:
        return
    if validity is not None:
        flag = flag & validity
    if bool(jnp.any(flag)):
        raise Invalid(message)


def _cast_numeric(x, src: dt.DataType, dst: dt.DataType, options: CastOptions,
                  validity):
    tgt = dst.physical_dtype()
    if src.is_boolean:
        return x.astype(tgt)
    if dst.is_boolean:
        return x != 0
    if src.is_integer and dst.is_integer:
        if not options.allow_int_overflow:
            info = np.iinfo(np.dtype(tgt))
            lo, hi = int(info.min), int(info.max)
            sinfo = np.iinfo(np.dtype(src.physical_dtype()))
            if int(sinfo.min) < lo or int(sinfo.max) > hi:
                bad = (x.astype(jnp.int64) < lo) | (
                    x.astype(jnp.uint64) > np.uint64(hi)
                    if src.kind == "uint64"
                    else x.astype(jnp.int64) > hi)
                _raise_if(bad, f"integer value out of bounds casting {src} -> {dst}",
                          validity)
        return x.astype(tgt)
    if src.is_floating and dst.is_integer:
        if not options.allow_float_truncate:
            _raise_if(jnp.floor(x) != x, "float value was truncated converting to"
                      f" {dst}", validity)
        if not options.allow_int_overflow:
            info = np.iinfo(np.dtype(tgt))
            bad = (x < float(info.min)) | (x > float(info.max)) | jnp.isnan(x)
            _raise_if(bad, f"float out of bounds casting to {dst}", validity)
        return x.astype(tgt)
    if src.is_integer and dst.is_floating:
        return x.astype(tgt)
    if src.is_floating and dst.is_floating:
        if (not options.allow_float_truncate
                and np.dtype(tgt).itemsize < np.dtype(x.dtype).itemsize):
            y = x.astype(tgt)
            _raise_if((y.astype(x.dtype) != x) & ~jnp.isnan(x),
                      f"float truncation casting {src} -> {dst}", validity)
            return y
        return x.astype(tgt)
    raise Invalid(f"unsupported numeric cast {src} -> {dst}")


def cast(value, target_type: dt.DataType, safe: bool = True,
         options: Optional[CastOptions] = None):
    """Eager cast entry (reference: compute::Cast cast.cc)."""
    if options is None:
        options = CastOptions.safe(target_type) if safe else CastOptions.unsafe(
            target_type)
    from ..datum import as_datum

    return _cast_exec([as_datum(value)], options, None)


def _cast_exec(args, options: CastOptions, ctx):
    (a,) = args
    dst = options.target_type
    assert dst is not None, "cast requires target_type"
    src = a.dtype
    if src == dst:
        return a
    (x,), validities, n = unpack(args)
    validity = validities[0] if isinstance(a, Column) else (
        None if a.is_valid else False)

    # explicit dictionary type: decode by gathering values through codes
    # (reference: cast from dictionary unpacks, scalar_cast_nested.cc)
    if src.is_dictionary:
        d = a.dictionary
        vt = src.value_type
        if dst.is_binary:
            return result_column(a.data, dst, validity, n, dictionary=d)
        vals = np.asarray(d.values)
        lut = jnp.asarray(vals.astype(np.dtype(vt.physical_dtype())))
        decoded = lut[jnp.clip(x, 0, max(len(d) - 1, 0))] if len(d) \
            else jnp.zeros_like(x, vt.physical_dtype())
        if vt == dst:
            return result_column(decoded, dst, validity, n)
        inner_validity = validity if not (validity is None or
                                          validity is False) else None
        inner = Column(decoded, vt, validity=inner_validity)
        return _cast_exec([inner], options, ctx)

    # dictionary-string source: parse the unique values host-side with
    # the native parsers (reference util/value_parsing.h via
    # scalar_cast_string.cc), gather on device. Bad values raise only if
    # a LIVE row references them (strptime pattern).
    if src.is_binary:
        d = a.dictionary if isinstance(a, Column) else a.dictionary
        assert d is not None
        if dst.is_binary:
            return a.with_data(a.data, dst) if isinstance(a, Column) else a
        parsed, ok, err = _parse_string_uniques(d.values, dst)
        codes = jnp.clip(x, 0, max(len(d) - 1, 0))
        if not all(ok):
            okl = jnp.asarray(np.asarray(ok))
            bad = ~okl[codes]
            _raise_if(bad, err, validity)
        if dst.is_decimal:
            lo = jnp.asarray(parsed[0])[codes] if len(d) else \
                jnp.zeros_like(x, jnp.int64)
            hi = jnp.asarray(parsed[1])[codes] if len(d) else (
                jnp.zeros_like(x, jnp.int64)
                if dst.kind == "decimal128"
                else jnp.zeros((n, 3), jnp.int64))
            return Column(lo, dst,
                          validity=None if (validity is None or validity
                                    is False) else validity, data2=hi)
        lut = jnp.asarray(parsed)
        data = lut[codes] if len(d) else jnp.zeros_like(
            x, dst.physical_dtype())
        return result_column(data, dst, validity, n)

    if dst.is_binary:
        # numeric -> string: native formatting on the unique values
        # (reference util/formatting.h via scalar_cast_string.cc);
        # output is dictionary form, one int32 code gather on device.
        from ..column import Dictionary

        strs, codes = _format_to_strings(a, x, src)
        out = Column(jnp.asarray(codes.astype(np.int32)), dst,
                     validity=None if (validity is None or
                                       validity is False) else validity,
                     dictionary=Dictionary(strs))
        return out

    if src.is_decimal:
        from .decimal import decimal_cast, decimal_to_float

        if dst.is_floating:
            f = decimal_to_float(a)
            if dst != dt.float64:
                return result_column(f.data.astype(dst.physical_dtype()),
                                     dst, validity, n)
            return f
        if dst.is_decimal or dst.is_integer:
            out = decimal_cast(a, dst,
                               bool(options.allow_decimal_truncate))
            if validity is not None and validity is not False and \
                    out.validity is None:
                out = Column(out.data, out.dtype, validity=validity,
                             data2=out.data2)
            return out
        raise Invalid(f"unsupported decimal cast {src} -> {dst}")
    if dst.is_decimal and (src.is_integer or src.is_floating):
        from .decimal import cast_to_decimal

        return cast_to_decimal(a, dst)

    if src.is_temporal or dst.is_temporal:
        return _cast_temporal(a, x, src, dst, options, validity, n)

    if src.is_null:
        data = jnp.zeros(n or 1, dst.physical_dtype())
        return result_column(data if n is not None else data[0], dst, False, n)

    r = _cast_numeric(x, src, dst, options, validity)
    return result_column(r, dst, validity, n)


def _cast_temporal(a, x, src, dst, options, validity, n):
    if src.is_numeric and dst.is_temporal:
        return result_column(x.astype(dst.physical_dtype()), dst, validity, n)
    if src.is_temporal and dst.is_numeric:
        return result_column(_cast_numeric(x, dt.int64, dst, options, validity),
                             dst, validity, n)
    if src.is_temporal and dst.is_temporal:
        ns_src, ns_dst = _temporal_unit_ns(src), _temporal_unit_ns(dst)
        v = x.astype(jnp.int64)
        if ns_src >= ns_dst:
            r = v * (ns_src // ns_dst)
        else:
            f = ns_dst // ns_src
            if not options.allow_time_truncate:
                _raise_if(v % f != 0, f"casting {src} -> {dst} would lose data",
                          validity)
            # truncation rounds toward negative infinity (arrow divides)
            r = jnp.floor_divide(v, f)
        return result_column(r.astype(dst.physical_dtype()), dst, validity, n)
    raise Invalid(f"unsupported temporal cast {src} -> {dst}")


register_function("cast", "scalar", 1, CastOptions)(_cast_exec)


def _parse_string_uniques(values, dst: dt.DataType):
    """Parse dictionary values host-side with the native parsers
    (ops/formatting.py; reference util/value_parsing.h). Returns
    (lut | (lo, hi) for decimals, ok flags, first error message); bad
    values only raise if a live row references them."""
    from . import formatting as F

    vals = [v.decode() if isinstance(v, (bytes, np.bytes_)) else str(v)
            for v in values]
    ok = [True] * len(vals)
    err = [""]

    def attempt(fn, i, default):
        try:
            return fn()
        except (Invalid, ValueError) as e:
            ok[i] = False
            if not err[0]:
                err[0] = str(e)
            return default

    kind = dst.kind
    if dst.is_decimal:
        ints = [attempt(lambda v=v: F.parse_decimal(
            v, dst.precision, dst.scale), i, 0)
            for i, v in enumerate(vals)]
        lo = np.array([v & (2**64 - 1) for v in ints], np.uint64
                      ).view(np.int64)
        if kind == "decimal128":
            hi = np.array([(v >> 64) for v in ints], np.int64)
        else:
            hi = np.array([[(v >> 64) & (2**64 - 1),
                            (v >> 128) & (2**64 - 1),
                            v >> 192] for v in ints] or
                          np.zeros((0, 3)), np.int64)
        return (lo, hi), ok, err[0]
    if dst.is_integer:
        lut = np.array([attempt(lambda v=v: F.parse_int(v, kind), i, 0)
                        for i, v in enumerate(vals)],
                       dst.physical_dtype())
    elif dst.is_floating:
        lut = np.array([attempt(lambda v=v: F.parse_float(v), i, 0.0)
                        for i, v in enumerate(vals)],
                       dst.physical_dtype())
    elif dst.is_boolean:
        lut = np.array([attempt(lambda v=v: F.parse_bool(v), i, False)
                        for i, v in enumerate(vals)], bool)
    elif dst.is_temporal:
        lut = np.array([attempt(lambda v=v: _parse_iso(v, dst), i, 0)
                        for i, v in enumerate(vals)],
                       dst.physical_dtype())
    else:
        raise Invalid(f"unsupported cast string -> {dst}")
    return lut, ok, err[0]


def _parse_iso(s: str, dst: dt.DataType) -> int:
    """ISO 8601 -> unit ticks (reference value_parsing.h
    ParseTimestampISO8601)."""
    import datetime as _dt

    if dst.kind == "date32":
        return _dt.date.fromisoformat(s).toordinal() - 719163
    if dst.kind == "date64":
        return (_dt.date.fromisoformat(s).toordinal() - 719163) * 86400000
    if dst.kind in ("time32", "time64"):
        t = _dt.time.fromisoformat(s)
        ns = ((t.hour * 3600 + t.minute * 60 + t.second) * 10**9
              + t.microsecond * 1000)
        per = _UNIT_NS[dst.unit]
        if ns % per:
            raise Invalid(f"time value {s!r} loses precision at "
                          f"{dst.unit}")
        return ns // per
    if dst.kind == "timestamp":
        if dst.tz:
            raise Invalid("cast string -> tz-aware timestamp is not "
                          "supported; cast to naive then assume_timezone")
        body, _, frac = s.replace("T", " ").partition(".")
        if " " in body.strip():
            d = _dt.datetime.fromisoformat(body.strip())
        else:
            dd = _dt.date.fromisoformat(body.strip())
            d = _dt.datetime(dd.year, dd.month, dd.day)
        secs = int(d.replace(tzinfo=_dt.timezone.utc).timestamp())
        ns = int((frac + "0" * 9)[:9]) if frac else 0
        per = _UNIT_NS[dst.unit]
        total_ns = secs * 10**9 + ns
        if total_ns % per:
            raise Invalid(f"timestamp {s!r} loses precision at "
                          f"{dst.unit}")
        return total_ns // per
    raise Invalid(f"unsupported cast string -> {dst}")


_TIME_DIGITS = {"s": 0, "ms": 3, "us": 6, "ns": 9}


def _format_to_strings(a, x, src: dt.DataType):
    """Format unique values host-side (ops/formatting.py; reference
    util/formatting.h) -> (object array of strings, int codes)."""
    from . import formatting as F

    host = np.asarray(x)
    if src.is_boolean:
        return (np.asarray(["false", "true"], object),
                host.astype(np.int64))
    if src.is_integer:
        uniq, codes = np.unique(host, return_inverse=True)
        return (np.asarray([str(int(v)) for v in uniq], object), codes)
    if src.is_floating:
        f32 = src.kind == "float32"
        bits = np.ascontiguousarray(host).view(
            np.int32 if f32 else np.int64)
        uniqb, codes = np.unique(bits, return_inverse=True)
        fl = uniqb.view(np.float32 if f32 else np.float64)
        return (np.asarray([F.format_float(v, f32) for v in fl],
                           object), codes)
    if src.is_decimal:
        lo = np.ascontiguousarray(host).view(np.uint64).astype(object)
        d2 = np.asarray(a.data2) if getattr(a, "data2", None) is not None \
            else np.zeros((len(lo), 0), np.int64)
        if src.kind == "decimal128":
            hi = d2.reshape(-1).astype(object)
            ints = (hi << 64) + lo
        else:
            limbs = d2.reshape(len(lo), -1)
            ints = lo.copy()
            for j in range(limbs.shape[1]):
                limb = (limbs[:, j].astype(object)
                        if j == limbs.shape[1] - 1 else
                        limbs[:, j].view(np.uint64).astype(object))
                ints = ints + (limb << (64 * (j + 1)))
        uniq, codes = np.unique(ints, return_inverse=True)
        return (np.asarray([F.format_decimal(int(v), src.scale)
                            for v in uniq], object), codes)
    if src.is_temporal:
        uniq, codes = np.unique(host, return_inverse=True)
        kind = src.kind
        if kind == "duration":
            return (np.asarray([str(int(v)) for v in uniq], object),
                    codes)
        if kind in ("date32", "date64"):
            days = (uniq if kind == "date32"
                    else uniq // 86400000)
            return (np.asarray([F.format_temporal(int(v), 0, 0, "date")
                                for v in days], object), codes)
        unit = src.unit
        digits = _TIME_DIGITS[unit]
        per = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}[unit]
        if kind in ("time32", "time64"):
            out = []
            for v in uniq:
                secs, rem = divmod(int(v), per)
                out.append(F.format_temporal(secs, rem, digits, "time"))
            return np.asarray(out, object), codes
        if kind == "timestamp":
            offs = np.zeros(len(uniq), np.int64)
            suffix = [""] * len(uniq)
            if src.tz:
                from ..utils.tzif import load_tz

                tz = load_tz(src.tz)
                secs_arr = np.floor_divide(uniq.astype(np.int64), per)
                idx = (np.searchsorted(tz.trans, secs_arr, side="right")
                       if len(tz.trans) else np.zeros(len(uniq), int))
                offs = tz.utoff[idx] if len(tz.trans) else \
                    np.full(len(uniq), int(tz.utoff[0]))
                for i, o in enumerate(offs):
                    sign = "+" if o >= 0 else "-"
                    hh, mm = divmod(abs(int(o)) // 60, 60)
                    suffix[i] = f"{sign}{hh:02d}{mm:02d}"
            out = []
            for i, v in enumerate(uniq):
                secs, rem = divmod(int(v) + int(offs[i]) * per, per)
                out.append(F.format_temporal(secs, rem, digits, "ts")
                           + suffix[i])
            return np.asarray(out, object), codes
    raise Invalid(f"unsupported cast {src} -> string")
