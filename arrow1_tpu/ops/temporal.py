"""Temporal kernels: strptime, strftime, component extraction, rounding.

Reference: cpp/src/arrow/compute/kernels/scalar_cast_temporal.cc
(strptime via vendored datetime) and the temporal component kernels.

Device design: strptime/strftime are string<->time conversions -> run once
per unique dictionary value on the host (like ops/strings.py). Component
extraction (year/month/day/...) is pure int64 arithmetic on epoch values
-> device math using Howard Hinnant's civil-from-days algorithm (the same
algorithm the reference vendors in arrow/vendored/datetime).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..column import Column, Dictionary
from ..errors import Invalid
from ..registry import register_function
from ..table import RecordBatch

__all__ = ["StrptimeOptions", "StrftimeOptions"]


@dataclasses.dataclass
class StrptimeOptions:
    """Reference: api_scalar.h StrptimeOptions (format + TimeUnit)."""

    format: str = "%Y-%m-%dT%H:%M:%S"
    unit: str = "us"
    error_is_null: bool = False


@dataclasses.dataclass
class StrftimeOptions:
    format: str = "%Y-%m-%dT%H:%M:%S"


_UNIT_PER_S = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}


def _strptime_exec(args, options: StrptimeOptions, ctx):
    from datetime import datetime, timezone

    (col,) = args
    if not col.dtype.is_binary:
        raise Invalid("strptime expects strings")
    options = options or StrptimeOptions()
    mult = _UNIT_PER_S[options.unit]
    vals = col.dictionary.values.tolist()
    parsed = np.zeros(max(len(vals), 1), dtype=np.int64)
    ok = np.zeros(max(len(vals), 1), dtype=bool)
    for i, v in enumerate(vals):
        try:
            ts = datetime.strptime(v, options.format).replace(
                tzinfo=timezone.utc).timestamp()
            parsed[i] = round(ts * mult)
            ok[i] = True
        except (ValueError, TypeError):
            if not options.error_is_null:
                raise Invalid(f"strptime: cannot parse {v!r} with "
                              f"{options.format!r}") from None
    lut = jnp.asarray(parsed)
    okl = jnp.asarray(ok)
    codes = jnp.clip(col.data, 0, max(len(vals) - 1, 0))
    data = lut[codes]
    validity = okl[codes] if not bool(np.all(ok)) else None
    if col.validity is not None:
        validity = col.validity if validity is None else (validity & col.validity)
    return Column(data, dt.timestamp(options.unit), validity=validity)


register_function("strptime", "scalar", 1, StrptimeOptions)(_strptime_exec)


def _strftime_exec(args, options: StrftimeOptions, ctx):
    """%S carries the unit-width fraction (ms->.%03d, us->.%06d,
    ns->.%09d) like the reference's date-lib formatter — pa parity:
    strftime(us ts) default ends '...:30.000000'."""
    from datetime import datetime, timezone

    (col,) = args
    if not col.dtype.is_temporal:
        raise Invalid("strftime expects a temporal column")
    options = options or StrftimeOptions()
    unit = col.dtype.unit or ("ms" if col.dtype.kind == "date64" else "s")
    per_s = 1 if col.dtype.kind == "date32" else _UNIT_PER_S[unit]
    digits = {1: 0, 10**3: 3, 10**6: 6, 10**9: 9}[per_s]
    raw = np.asarray(col.data, dtype=np.int64)
    if col.dtype.kind == "date32":
        raw = raw * 86400
    # format on host; unique-ify via the values themselves
    uniq, codes = np.unique(raw, return_inverse=True)
    out = []
    for v in uniq:
        v = int(v)
        secs, rem = divmod(v, per_s)  # floor div: rem in [0, per_s)
        fmt = options.format
        if digits and "%S" in fmt:
            fmt = fmt.replace("%S", "%S." + format(rem, f"0{digits}d"))
        out.append(datetime.fromtimestamp(secs, tz=timezone.utc)
                   .strftime(fmt))
    formatted = np.asarray(out, dtype=object)
    return Column(jnp.asarray(codes.astype(np.int32)), dt.string,
                  validity=col.validity, dictionary=Dictionary(formatted))


register_function("strftime", "scalar", 1, StrftimeOptions)(_strftime_exec)


def _civil_from_days(days):
    """days since 1970-01-01 -> (year, month, day); Hinnant's algorithm
    (reference vendors it at arrow/vendored/datetime/date.h) — pure int
    vector math, runs as elementwise device code."""
    z = days + 719468
    era = jnp.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = jnp.where(mp < 10, mp + 3, mp - 9)
    y = jnp.where(m <= 2, y + 1, y)
    return y, m, d


def _epoch_days_and_subsec(col: Column):
    t = col.dtype
    x = col.data.astype(jnp.int64)
    if t.kind == "date32":
        return x, jnp.zeros_like(x)
    if t.kind == "date64":
        per_day = 86400 * 1000
    else:
        per_day = 86400 * _UNIT_PER_S[t.unit]
    days = jnp.floor_divide(x, per_day)
    rem = x - days * per_day
    return days, rem


def _component(name, fn, out_type=dt.int64):
    def exec_fn(args, options, ctx):
        (col,) = args
        if not col.dtype.is_temporal:
            raise Invalid(f"{name}: expects a temporal column")
        days, rem = _epoch_days_and_subsec(col)
        y, m, d = _civil_from_days(days)
        unit = col.dtype.unit or "ms" if col.dtype.kind == "date64" else \
            (col.dtype.unit or "s")
        per_s = _UNIT_PER_S.get(unit, 1) if col.dtype.kind not in (
            "date32",) else 1
        if col.dtype.kind == "date64":
            per_s = 1000
        out = fn(y, m, d, days, rem, per_s)
        return Column(out.astype(out_type.physical_dtype()), out_type,
                      validity=col.validity)

    return exec_fn


register_function("year", "scalar", 1)(
    _component("year", lambda y, m, d, days, rem, ps: y))
register_function("month", "scalar", 1)(
    _component("month", lambda y, m, d, days, rem, ps: m))
register_function("day", "scalar", 1)(
    _component("day", lambda y, m, d, days, rem, ps: d))
@dataclasses.dataclass
class DayOfWeekOptions:
    """Reference: api_scalar.h DayOfWeekOptions (count_from_zero,
    week_start 1=Monday..7=Sunday)."""
    count_from_zero: bool = True
    week_start: int = 1


def _day_of_week_exec(args, options: DayOfWeekOptions, ctx):
    options = options or DayOfWeekOptions()
    if not 1 <= options.week_start <= 7:
        raise Invalid(f"week_start must be 1..7, got {options.week_start}")
    offset = options.week_start - 1
    bias = 0 if options.count_from_zero else 1

    def fn(y, m, d, days, rem, ps):
        return (days + 3 - offset) % 7 + bias  # (days+3)%7 == 0 -> Monday

    return _component("day_of_week", fn)(args, None, ctx)


register_function("day_of_week", "scalar", 1, DayOfWeekOptions)(
    _day_of_week_exec)
register_function("day_of_year", "scalar", 1)(
    _component("day_of_year", lambda y, m, d, days, rem, ps:
               days - _days_from_civil(y, 1, 1) + 1))
register_function("hour", "scalar", 1)(
    _component("hour", lambda y, m, d, days, rem, ps: rem // (3600 * ps)))
register_function("minute", "scalar", 1)(
    _component("minute",
               lambda y, m, d, days, rem, ps: (rem // (60 * ps)) % 60))
register_function("second", "scalar", 1)(
    _component("second", lambda y, m, d, days, rem, ps: (rem // ps) % 60))
register_function("millisecond", "scalar", 1)(
    _component("millisecond", lambda y, m, d, days, rem, ps:
               (rem * 1000 // ps) % 1000))
register_function("microsecond", "scalar", 1)(
    _component("microsecond", lambda y, m, d, days, rem, ps:
               (rem * 1000000 // ps) % 1000))


def _days_from_civil(y, m, d):
    """Inverse of _civil_from_days (Hinnant days_from_civil)."""
    y = y - (m <= 2)
    era = jnp.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = jnp.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


# ---- calendar components round 2 (reference: scalar_temporal_unary.cc:
# Quarter/IsLeapYear/ISOYear/ISOWeek/USWeek/ISOCalendar/YearMonthDay/
# Nanosecond/Subsecond) ----

register_function("quarter", "scalar", 1)(
    _component("quarter", lambda y, m, d, days, rem, ps: (m - 1) // 3 + 1))
register_function("is_leap_year", "scalar", 1)(
    _component("is_leap_year", lambda y, m, d, days, rem, ps:
               (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0)),
               out_type=dt.bool_))
register_function("nanosecond", "scalar", 1)(
    _component("nanosecond", lambda y, m, d, days, rem, ps:
               (rem * (10**9 // ps)) % 1000))


def _subsecond_exec(args, options, ctx):
    (col,) = args
    if not col.dtype.is_temporal:
        raise Invalid("subsecond: expects a temporal column")
    days, rem = _epoch_days_and_subsec(col)
    t = col.dtype
    ps = 1000 if t.kind == "date64" else \
        (1 if t.kind == "date32" else _UNIT_PER_S[t.unit])
    out = (rem % ps).astype(jnp.float64) / ps
    return Column(out, dt.float64, validity=col.validity)


register_function("subsecond", "scalar", 1)(_subsecond_exec)


def _week_parts(days, week_starts_monday=True):
    """(pivot_year, week_number) — the week is numbered by its pivot day
    (Thursday for Monday-start weeks, Wednesday for Sunday-start), the
    ISO 8601 construction generalized (reference:
    scalar_temporal_unary.cc Week)."""
    if week_starts_monday:
        dow = (days + 3) % 7          # 0 = Monday
    else:
        dow = (days + 4) % 7          # 0 = Sunday
    pivot = days + (3 - dow)
    py, _, _ = _civil_from_days(pivot)
    jan1 = _days_from_civil(py, jnp.ones_like(py), jnp.ones_like(py))
    week = (pivot - jan1) // 7 + 1
    return py, week


def _iso_week_exec(args, options, ctx):
    (col,) = args
    days, _ = _epoch_days_and_subsec(col)
    _, w = _week_parts(days, True)
    return Column(w.astype(jnp.int64), dt.int64, validity=col.validity)


def _iso_year_exec(args, options, ctx):
    (col,) = args
    days, _ = _epoch_days_and_subsec(col)
    y, _ = _week_parts(days, True)
    return Column(y.astype(jnp.int64), dt.int64, validity=col.validity)


def _us_week_exec(args, options, ctx):
    (col,) = args
    days, _ = _epoch_days_and_subsec(col)
    _, w = _week_parts(days, False)
    return Column(w.astype(jnp.int64), dt.int64, validity=col.validity)


def _us_year_exec(args, options, ctx):
    (col,) = args
    days, _ = _epoch_days_and_subsec(col)
    y, _ = _week_parts(days, False)
    return Column(y.astype(jnp.int64), dt.int64, validity=col.validity)


register_function("iso_week", "scalar", 1)(_iso_week_exec)
register_function("iso_year", "scalar", 1)(_iso_year_exec)
register_function("us_week", "scalar", 1)(_us_week_exec)
register_function("us_year", "scalar", 1)(_us_year_exec)


@dataclasses.dataclass
class WeekOptions:
    week_starts_monday: bool = True
    count_from_zero: bool = False
    first_week_is_fully_in_year: bool = False


def _week_exec(args, options: WeekOptions, ctx):
    (col,) = args
    options = options or WeekOptions()
    if options.first_week_is_fully_in_year:
        raise Invalid("week: first_week_is_fully_in_year not supported")
    days, _ = _epoch_days_and_subsec(col)
    _, w = _week_parts(days, options.week_starts_monday)
    if options.count_from_zero:
        w = w - 1
    return Column(w.astype(jnp.int64), dt.int64, validity=col.validity)


register_function("week", "scalar", 1, WeekOptions)(_week_exec)


def _iso_calendar_exec(args, options, ctx):
    """Struct {iso_year, iso_week, iso_day_of_week(1=Mon..7)} — structs
    are RecordBatches in this engine."""
    (col,) = args
    days, _ = _epoch_days_and_subsec(col)
    y, w = _week_parts(days, True)
    dow = (days + 3) % 7 + 1
    mk = lambda x: Column(x.astype(jnp.int64), dt.int64,
                          validity=col.validity)
    return RecordBatch((mk(y), mk(w), mk(dow)),
                       ("iso_year", "iso_week", "iso_day_of_week"))


register_function("iso_calendar", "scalar", 1)(_iso_calendar_exec)


def _year_month_day_exec(args, options, ctx):
    (col,) = args
    days, _ = _epoch_days_and_subsec(col)
    y, m, d = _civil_from_days(days)
    mk = lambda x: Column(x.astype(jnp.int64), dt.int64,
                          validity=col.validity)
    return RecordBatch((mk(y), mk(m), mk(d)), ("year", "month", "day"))


register_function("year_month_day", "scalar", 1)(_year_month_day_exec)


# ---- temporal difference family (reference: scalar_temporal_binary.cc
# — counts *calendar boundaries crossed*, not elapsed durations) ----

def _to_unit_count(col: Column, per_s_target: int):
    """floor(timestamp / target_unit) as int64."""
    t = col.dtype
    x = col.data.astype(jnp.int64)
    if t.kind == "date32":
        return x * (86400 * per_s_target) if per_s_target else x
    ps = 1000 if t.kind == "date64" else _UNIT_PER_S[t.unit]
    # value in source units -> floor-divide into target units
    # count = floor(x * per_s_target / ps) done without overflow:
    if per_s_target >= ps:
        return x * (per_s_target // ps)
    return jnp.floor_divide(x, ps // per_s_target)


def _between(name, fn):
    def exec_fn(args, options, ctx):
        a, b = args
        for c in (a, b):
            if not c.dtype.is_temporal:
                raise Invalid(f"{name}: expects temporal columns")
        out = fn(a, b)
        validity = None
        if a.validity is not None or b.validity is not None:
            validity = a.mask() & b.mask()
        return Column(out.astype(jnp.int64), dt.int64, validity=validity)

    return exec_fn


def _days_of(col):
    days, _ = _epoch_days_and_subsec(col)
    return days


def _years_between(a, b):
    ya, _, _ = _civil_from_days(_days_of(a))
    yb, _, _ = _civil_from_days(_days_of(b))
    return yb - ya


def _quarters_between(a, b):
    ya, ma, _ = _civil_from_days(_days_of(a))
    yb, mb, _ = _civil_from_days(_days_of(b))
    return (yb * 4 + (mb - 1) // 3) - (ya * 4 + (ma - 1) // 3)


def _weeks_between(a, b, week_start=1):
    da, db = _days_of(a), _days_of(b)
    # week_start-day boundary crossings (1=Monday..7=Sunday)
    off = week_start - 1
    return (db - (db + 3 - off) % 7) // 7 - (da - (da + 3 - off) % 7) // 7


def _unit_between(per_s):
    def fn(a, b):
        return _to_unit_count(b, per_s) - _to_unit_count(a, per_s)
    return fn


register_function("years_between", "scalar", 2)(
    _between("years_between", _years_between))
register_function("quarters_between", "scalar", 2)(
    _between("quarters_between", _quarters_between))
def _weeks_between_exec(args, options: DayOfWeekOptions, ctx):
    ws = options.week_start if options is not None else 1
    if not 1 <= ws <= 7:
        raise Invalid(f"week_start must be 1..7, got {ws}")
    return _between("weeks_between",
                    lambda a, b: _weeks_between(a, b, ws))(args, None, ctx)


register_function("weeks_between", "scalar", 2, DayOfWeekOptions)(
    _weeks_between_exec)
register_function("days_between", "scalar", 2)(
    _between("days_between", lambda a, b: _days_of(b) - _days_of(a)))
for _n, _ps in [("hours_between", None), ("minutes_between", None),
                ("seconds_between", 1), ("milliseconds_between", 10**3),
                ("microseconds_between", 10**6),
                ("nanoseconds_between", 10**9)]:
    if _n == "hours_between":
        fn = _between(_n, lambda a, b: _to_unit_count(b, 1) // 3600
                      - _to_unit_count(a, 1) // 3600)
    elif _n == "minutes_between":
        fn = _between(_n, lambda a, b: _to_unit_count(b, 1) // 60
                      - _to_unit_count(a, 1) // 60)
    else:
        fn = _between(_n, _unit_between(_ps))
    register_function(_n, "scalar", 2)(fn)


# ---- temporal rounding (reference: scalar_temporal_unary.cc
# CeilTemporal/FloorTemporal/RoundTemporal) ----

@dataclasses.dataclass
class RoundTemporalOptions:
    multiple: int = 1
    unit: str = "day"
    week_starts_monday: bool = True
    ceil_is_strictly_greater: bool = False
    calendar_based_origin: bool = False


_ROUND_UNIT_S = {"nanosecond": None, "microsecond": None,
                 "millisecond": None, "second": 1, "minute": 60,
                 "hour": 3600, "day": 86400, "week": 604800}


def _round_temporal(mode):
    def exec_fn(args, options: RoundTemporalOptions, ctx):
        (col,) = args
        options = options or RoundTemporalOptions()
        t = col.dtype
        if not t.is_temporal:
            raise Invalid("temporal rounding expects a temporal column")
        ps = 1000 if t.kind == "date64" else \
            (1 if t.kind == "date32" else _UNIT_PER_S[t.unit])
        unit = options.unit
        if unit in ("month", "quarter", "year"):
            days, rem = _epoch_days_and_subsec(col)
            y, m, d = _civil_from_days(days)
            if unit == "year":
                key = y
                lo_days = _days_from_civil(y, jnp.ones_like(y),
                                           jnp.ones_like(y))
                hi_days = _days_from_civil(y + options.multiple,
                                           jnp.ones_like(y),
                                           jnp.ones_like(y))
            else:
                step = 3 if unit == "quarter" else 1
                step = step * options.multiple
                mz = ((m - 1) // step) * step
                lo_days = _days_from_civil(y, mz + 1, jnp.ones_like(y))
                m_hi = mz + step
                y_hi = y + m_hi // 12
                m_hi = m_hi % 12
                hi_days = _days_from_civil(y_hi, m_hi + 1,
                                           jnp.ones_like(y))
            if t.kind == "date32":
                lo, hi = lo_days, hi_days
                x = col.data.astype(jnp.int64)
            else:
                per_day = 86400 * ps
                lo, hi = lo_days * per_day, hi_days * per_day
                x = col.data.astype(jnp.int64)
            if mode == "floor":
                out = lo
            elif mode == "ceil":
                # the reference bumps calendar units even exactly on the
                # boundary (scalar_temporal_unary.cc CeilTemporal)
                out = hi
            else:
                out = jnp.where((x - lo) <= (hi - x), lo, hi)
            return Column(out.astype(col.data.dtype), t,
                          validity=col.validity)
        if unit not in _ROUND_UNIT_S and unit not in (
                "nanosecond", "microsecond", "millisecond"):
            raise Invalid(f"temporal rounding: bad unit {unit!r}")
        if unit == "week":
            # weeks are day-aligned to Monday (or Sunday)
            anchor = 3 if options.week_starts_monday else 4
            per_day = 86400 * ps if t.kind != "date32" else 1
            step = 7 * options.multiple * per_day
            off = anchor * per_day
            x = col.data.astype(jnp.int64) + off
        else:
            sub = {"nanosecond": 10**9, "microsecond": 10**6,
                   "millisecond": 10**3}
            if unit in sub:
                num, den = ps, sub[unit]
                if num <= den:
                    step_f = options.multiple * num // den
                    step = jnp.maximum(step_f, 1)
                else:
                    step = options.multiple * (num // den)
            else:
                secs = _ROUND_UNIT_S[unit]
                step = options.multiple * (secs * ps if t.kind != "date32"
                                           else max(secs // 86400, 1))
            off = 0
            x = col.data.astype(jnp.int64)
        lo = jnp.floor_divide(x, step) * step
        at_lo = x == lo
        if mode == "floor":
            out = lo
        elif mode == "ceil":
            out = jnp.where(at_lo & ~jnp.bool_(
                options.ceil_is_strictly_greater), lo, lo + step)
            out = jnp.where(at_lo & jnp.bool_(
                options.ceil_is_strictly_greater), lo + step, out)
        else:
            hi = lo + step
            out = jnp.where((x - lo) <= (hi - x), lo, hi)
        out = out - (off if unit == "week" else 0)
        return Column(out.astype(col.data.dtype), t, validity=col.validity)

    return exec_fn


register_function("floor_temporal", "scalar", 1, RoundTemporalOptions)(
    _round_temporal("floor"))
register_function("ceil_temporal", "scalar", 1, RoundTemporalOptions)(
    _round_temporal("ceil"))
register_function("round_temporal", "scalar", 1, RoundTemporalOptions)(
    _round_temporal("round"))


# ---- timezone-aware ops (reference: scalar_temporal_unary.cc with the
# vendored datetime tz library). Native design: the tzdb's TZif file is
# parsed once on the host into three small arrays (utils/tzif.py); the
# per-row work is a searchsorted over ~300 transitions + a gather, both
# on device — the reference's per-row tz-lookup loop becomes two
# vectorized ops. ----

@dataclasses.dataclass
class AssumeTimezoneOptions:
    timezone: str = "UTC"
    ambiguous: str = "raise"
    nonexistent: str = "raise"


def _tz_offsets_for(col: Column):
    """Per-row UTC offset (seconds) + dst flag for a tz-aware column."""
    from ..utils.tzif import load_tz

    t = col.dtype
    if t.kind != "timestamp" or not t.tz:
        raise Invalid("timezone op requires a tz-aware timestamp column")
    tz = load_tz(t.tz)
    ps = _UNIT_PER_S[t.unit]
    secs = jnp.floor_divide(col.data.astype(jnp.int64), ps)
    if len(tz.trans) == 0:
        off = jnp.full(col.data.shape, int(tz.utoff[0]), jnp.int64)
        dst = jnp.full(col.data.shape, bool(tz.isdst[0]), jnp.bool_)
        return off, dst, ps
    idx = jnp.searchsorted(jnp.asarray(tz.trans), secs, side="right")
    off = jnp.asarray(tz.utoff)[idx]
    dst = jnp.asarray(tz.isdst)[idx]
    return off, dst, ps


@register_function("local_timestamp", "scalar", 1)
def local_timestamp_exec(args, options, ctx):
    """UTC instants -> naive local wall time (scalar_temporal_unary.cc
    LocalTimestamp). Naive input is already wall time (UTC assumption,
    pyarrow parity): identity."""
    (col,) = args
    if col.dtype.kind == "timestamp" and not col.dtype.tz:
        return col
    off, _, ps = _tz_offsets_for(col)
    out = col.data.astype(jnp.int64) + off * ps
    return Column(out, dt.timestamp(col.dtype.unit),
                  validity=col.validity)


@register_function("is_dst", "scalar", 1)
def is_dst_exec(args, options, ctx):
    """(scalar_temporal_unary.cc IsDaylightSavings)"""
    (col,) = args
    _, dst, _ = _tz_offsets_for(col)
    return Column(dst, dt.bool_, validity=col.validity)


@register_function("assume_timezone", "scalar", 1, AssumeTimezoneOptions)
def assume_timezone_exec(args, options, ctx):
    """Naive local wall time -> UTC instants in `timezone`
    (scalar_temporal_unary.cc AssumeTimezone).

    Each period p of the zone is valid for local wall clocks in
    [trans[p-1] + utoff[p], trans[p] + utoff[p]). A wall time can fall
    in two periods (DST fall-back: `ambiguous`) or none (spring-forward
    gap: `nonexistent`); both are resolved per the options, with
    'raise' checked by one any() reduction.
    """
    from ..utils.tzif import load_tz, local_candidates

    (col,) = args
    t = col.dtype
    if t.kind != "timestamp":
        raise Invalid("assume_timezone requires a timestamp column")
    if t.tz:
        raise Invalid(f"assume_timezone: input already has tz {t.tz!r}")
    o = options or AssumeTimezoneOptions()
    tz = load_tz(o.timezone)
    ps = _UNIT_PER_S[t.unit]
    data = col.data.astype(jnp.int64)
    out_t = dt.timestamp(t.unit, o.timezone)
    if len(tz.trans) == 0:
        return Column(data - int(tz.utoff[0]) * ps, out_t,
                      validity=col.validity)
    local_sec = jnp.floor_divide(data, ps)
    ws, we = local_candidates(tz)
    ws_j, we_j = jnp.asarray(ws), jnp.asarray(we)
    utoff = jnp.asarray(tz.utoff)
    # p_hi: the latest period whose local window has started
    p_hi = jnp.clip(jnp.searchsorted(ws_j, local_sec, side="right") - 1,
                    0, len(tz.utoff) - 1)
    p_lo = jnp.maximum(p_hi - 1, 0)
    in_hi = local_sec < we_j[p_hi]
    in_lo = (local_sec >= ws_j[p_lo]) & (local_sec < we_j[p_lo]) \
        & (p_lo != p_hi)
    mask = col.mask() if col.validity is not None \
        else jnp.ones(data.shape, jnp.bool_)
    ambiguous = in_hi & in_lo & mask
    nonexistent = ~in_hi & ~in_lo & mask
    if o.ambiguous == "raise" and bool(jnp.any(ambiguous)):
        raise Invalid("assume_timezone: ambiguous local time "
                      f"in {o.timezone}")
    if o.nonexistent == "raise" and bool(jnp.any(nonexistent)):
        raise Invalid("assume_timezone: nonexistent local time "
                      f"in {o.timezone}")
    # pick the period: ambiguous -> earliest = earlier period (p_lo);
    # latest = p_hi. nonexistent -> 'earliest' pins to the instant just
    # before the gap (end of p_lo), 'latest' to the gap's end (start of
    # p_hi) — the reference's NonexistentHandling semantics.
    use_lo = in_lo & (~in_hi | jnp.bool_(o.ambiguous == "earliest"))
    period = jnp.where(use_lo, p_lo, p_hi)
    utc = (local_sec - utoff[period]) * ps + \
        jnp.where(ps > 1, data - local_sec * ps, 0)
    # a spring-forward gap after period p_hi maps both of its wall
    # edges to the same UTC instant: trans[p_hi] (= we[p_hi]-utoff[p_hi]
    # = ws[p_hi+1]-utoff[p_hi+1]); 'earliest' is the last representable
    # tick before it, 'latest' the transition itself
    tr = jnp.asarray(tz.trans)[jnp.clip(p_hi, 0, len(tz.trans) - 1)]
    pin = tr * ps - 1 if o.nonexistent == "earliest" else tr * ps
    utc = jnp.where(nonexistent, pin, utc)
    return Column(utc, out_t, validity=col.validity)


# ---- interval_between family (reference: scalar_temporal_binary.cc
# MonthIntervalBetween / DayTimeIntervalBetween /
# MonthDayNanoIntervalBetween; month_day_nano is the only one pyarrow's
# python layer can represent, and is differentially tested against it) ----

def _calendar_between(a: Column, b: Column):
    """-> (months, days-after-month-shift, nano remainder) per the
    reference's calendar semantics: months = raw (year, month) diff;
    days = end - (start + months) with the shifted day-of-month clamped
    to the target month's length; nanos = sub-day time difference."""
    da, ra = _epoch_days_and_subsec(a)
    db, rb = _epoch_days_and_subsec(b)
    ya, ma, dda = _civil_from_days(da)
    yb, mb, _ = _civil_from_days(db)
    months = (yb - ya) * 12 + (mb - ma)
    tot = ya * 12 + (ma - 1) + months
    y2 = jnp.floor_divide(tot, 12)
    m2 = tot - y2 * 12 + 1
    # start-day beyond the target month's length EXTRAPOLATES into the
    # next month (reference AddMonths: 2020-02-29 + 12mo -> 2021-03-01;
    # Hinnant days_from_civil is linear in d, so no clamp needed)
    shifted = _days_from_civil(y2, m2, dda)
    days = db - shifted
    # nano remainder: time-of-day(b) - time-of-day(a), in each input's
    # native sub-day resolution normalized to nanoseconds
    def nanos(col, rem):
        t = col.dtype
        if t.kind == "date32":
            return jnp.zeros_like(rem)
        per_day = (86400 * 1000 if t.kind == "date64"
                   else 86400 * _UNIT_PER_S[t.unit])
        return rem * (86400 * 10**9 // per_day)

    nano = nanos(b, rb) - nanos(a, ra)
    return months, days, nano


def _interval_between(name, kind):
    def exec_fn(args, options, ctx):
        a, b = args
        for c in (a, b):
            if not c.dtype.is_temporal:
                raise Invalid(f"{name}: expects temporal columns")
        months, days, nano = _calendar_between(a, b)
        validity = None
        if a.validity is not None or b.validity is not None:
            validity = a.mask() & b.mask()
        if kind == "month":
            return Column(months.astype(jnp.int32), dt.month_interval(),
                          validity=validity)
        if kind == "day_time":
            # plain day diff + millisecond remainder (no month shift),
            # packed (days i32 << 32 | ms u32) into one int64
            da, _ = _epoch_days_and_subsec(a)
            db, _ = _epoch_days_and_subsec(b)
            ms = nano // 1_000_000
            packed = (((db - da).astype(jnp.int64) << 32)
                      | (ms.astype(jnp.int64) & 0xFFFFFFFF))
            return Column(packed, dt.day_time_interval(),
                          validity=validity)
        # month_day_nano: (months i32 | days i32) packed in data,
        # nanoseconds in data2 (matches interop.py ingest layout)
        packed = ((months.astype(jnp.int64) << 32)
                  | (days.astype(jnp.int64) & 0xFFFFFFFF))
        return Column(packed, dt.month_day_nano_interval(),
                      validity=validity, data2=nano.astype(jnp.int64))

    return exec_fn


register_function("month_interval_between", "scalar", 2)(
    _interval_between("month_interval_between", "month"))
register_function("day_time_interval_between", "scalar", 2)(
    _interval_between("day_time_interval_between", "day_time"))
register_function("month_day_nano_interval_between", "scalar", 2)(
    _interval_between("month_day_nano_interval_between", "mdn"))
