"""TZif (RFC 8536) timezone database parser + vectorized tz math.

The reference implements timezone kernels over a vendored tz library
(cpp/src/arrow/compute/kernels/scalar_temporal_unary.cc with
cpp/src/arrow/vendored/datetime/). This module plays that role
natively for the device: the system tzdb's binary TZif files are parsed once on
the host into three small arrays (transition instants, utc offsets,
dst flags), and the per-row work — offset lookup at 10M+ rows — is a
single `searchsorted` + gather that runs on device.

Covers TZif v1/v2/v3 bodies and the POSIX-TZ footer rule (M-form and
Julian day rules), which is expanded into explicit transitions through
2100 so instants past the last recorded transition (the usual case for
current data) still resolve correctly.
"""

from __future__ import annotations

import os
import struct
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

from ..errors import Invalid

_SEARCH_DIRS = ("/usr/share/zoneinfo", "/usr/lib/zoneinfo",
                "/etc/zoneinfo")


class TZ:
    """One zone: `trans[i]` is the UTC instant (seconds) at which period
    i+1 begins; period 0 precedes all transitions. `utoff[p]` / `isdst[p]`
    describe period p (len == len(trans) + 1)."""

    __slots__ = ("name", "trans", "utoff", "isdst")

    def __init__(self, name: str, trans: np.ndarray, utoff: np.ndarray,
                 isdst: np.ndarray):
        self.name = name
        self.trans = trans
        self.utoff = utoff
        self.isdst = isdst


def _tzif_path(name: str) -> str:
    if "/" in name and (name.startswith("/") or ".." in name):
        raise Invalid(f"bad timezone name {name!r}")
    for d in _SEARCH_DIRS:
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    # Python's tzdata wheel as a fallback (no system tzdb)
    try:
        import importlib.resources as ir

        pkg = "tzdata.zoneinfo." + ".".join(name.split("/")[:-1])
        fname = name.split("/")[-1]
        ref = ir.files(pkg.rstrip(".")) / fname
        if ref.is_file():
            return str(ref)
    except Exception:
        pass
    raise Invalid(f"timezone {name!r} not found in tzdb")


def _read_body(data: bytes, pos: int, longfmt: bool):
    (isutcnt, isstdcnt, leapcnt, timecnt, typecnt, charcnt
     ) = struct.unpack_from(">6I", data, pos + 20)
    pos += 44
    tw = 8 if longfmt else 4
    fmt = ">%d%s" % (timecnt, "q" if longfmt else "i")
    trans = np.array(struct.unpack_from(fmt, data, pos), np.int64)
    pos += timecnt * tw
    idx = np.frombuffer(data, np.uint8, timecnt, pos).astype(np.int64)
    pos += timecnt
    utoff = np.empty(typecnt, np.int64)
    isdst = np.empty(typecnt, bool)
    for t in range(typecnt):
        o, d, _ = struct.unpack_from(">iBB", data, pos + 6 * t)
        utoff[t] = o
        isdst[t] = bool(d)
    pos += 6 * typecnt + charcnt + leapcnt * (tw + 4)
    pos += isstdcnt + isutcnt
    return pos, trans, idx, utoff, isdst


_DAYS_IN_MONTH = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _is_leap(y: int) -> bool:
    return y % 4 == 0 and (y % 100 != 0 or y % 400 == 0)


def _days_from_epoch(y: int, m: int, d: int) -> int:
    """Civil date -> days since 1970-01-01 (Howard Hinnant's algorithm,
    the same one the reference's vendored datetime uses)."""
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _weekday(days: int) -> int:
    """0 = Sunday for days-since-epoch (1970-01-01 was a Thursday)."""
    return (days + 4) % 7


def _posix_offset(s: str, i: int) -> Tuple[int, int]:
    """Parse [+-]hh[:mm[:ss]] at s[i:]; returns (seconds, new i).
    POSIX sign convention: positive = west of Greenwich."""
    sign = 1
    if i < len(s) and s[i] in "+-":
        sign = -1 if s[i] == "-" else 1
        i += 1
    parts = [0, 0, 0]
    for k in range(3):
        j = i
        while j < len(s) and s[j].isdigit():
            j += 1
        if j == i:
            break
        parts[k] = int(s[i:j])
        i = j
        if i < len(s) and s[i] == ":":
            i += 1
        else:
            break
    return sign * (parts[0] * 3600 + parts[1] * 60 + parts[2]), i


def _posix_name(s: str, i: int) -> int:
    """Skip a zone designation: alphabetic or <...> quoted."""
    if i < len(s) and s[i] == "<":
        return s.index(">", i) + 1
    while i < len(s) and (s[i].isalpha()):
        i += 1
    return i


class _Rule:
    __slots__ = ("kind", "n", "m", "w", "d", "time")

    def __init__(self, kind, n=0, m=0, w=0, d=0, time=7200):
        self.kind = kind  # "M" | "J" | "D"
        self.n, self.m, self.w, self.d, self.time = n, m, w, d, time

    def day_of_year(self, year: int) -> int:
        """Days from Jan 1 of `year` (0-based) of this rule's date."""
        if self.kind == "J":  # Jn: 1..365, Feb 29 never counted
            n = self.n
            doy = n - 1
            if _is_leap(year) and n > 59:
                doy += 1
            return doy
        if self.kind == "D":  # n: 0..365 incl leap day
            return self.n
        # Mm.w.d — the d-th weekday of week w in month m (w=5: last)
        first = _days_from_epoch(year, self.m, 1)
        wd_first = _weekday(first)
        day1 = (self.d - wd_first) % 7 + 1  # first `d` weekday (1-based)
        day = day1 + 7 * (self.w - 1)
        dim = _DAYS_IN_MONTH[self.m - 1] + (
            1 if self.m == 2 and _is_leap(year) else 0)
        while day > dim:
            day -= 7
        return first + day - 1 - _days_from_epoch(year, 1, 1)


def _parse_rule(s: str, i: int) -> Tuple[_Rule, int]:
    if s[i] == "M":
        j = i + 1
        nums = []
        while True:
            k = j
            while k < len(s) and s[k].isdigit():
                k += 1
            nums.append(int(s[j:k]))
            if k < len(s) and s[k] == "." and len(nums) < 3:
                j = k + 1
                continue
            i = k
            break
        r = _Rule("M", m=nums[0], w=nums[1], d=nums[2])
    elif s[i] == "J":
        j = i + 1
        k = j
        while k < len(s) and s[k].isdigit():
            k += 1
        r = _Rule("J", n=int(s[j:k]))
        i = k
    else:
        k = i
        while k < len(s) and s[k].isdigit():
            k += 1
        r = _Rule("D", n=int(s[i:k]))
        i = k
    if i < len(s) and s[i] == "/":
        t, i = _posix_offset(s, i + 1)
        r.time = t
    return r, i


def _expand_footer(tzstr: str, start_year: int, end_year: int
                   ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                       np.ndarray]]:
    """POSIX TZ footer -> (trans, utoff_after, isdst_after) arrays for
    [start_year, end_year]. Returns None for rules we can't expand."""
    s = tzstr.strip()
    if not s or s.startswith(":"):
        return None
    try:
        i = _posix_name(s, 0)
        std_off, i = _posix_offset(s, i)
        std = -std_off  # POSIX west-positive -> utoff
        if i >= len(s):
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, bool))  # constant offset, no dst
        j = _posix_name(s, i)
        if j > i and j < len(s) and s[j] == ",":
            dst_off, _ = std_off - 3600, j
            i = j
        elif j > i:
            dst_off, i = _posix_offset(s, j)
        else:
            return None
        if i >= len(s) or s[i] != ",":
            return None
        dst = -dst_off if isinstance(dst_off, int) else std + 3600
        start_r, i = _parse_rule(s, i + 1)
        if i >= len(s) or s[i] != ",":
            return None
        end_r, i = _parse_rule(s, i + 1)
    except (ValueError, IndexError):
        return None
    trans: List[int] = []
    offs: List[int] = []
    dsts: List[bool] = []
    for y in range(start_year, end_year + 1):
        jan1 = _days_from_epoch(y, 1, 1) * 86400
        t_on = jan1 + start_r.day_of_year(y) * 86400 + start_r.time - std
        t_off = jan1 + end_r.day_of_year(y) * 86400 + end_r.time - dst
        if t_on <= t_off:
            trans += [t_on, t_off]
            offs += [dst, std]
            dsts += [True, False]
        else:  # southern hemisphere: dst spans new year
            trans += [t_off, t_on]
            offs += [std, dst]
            dsts += [False, True]
    return (np.array(trans, np.int64), np.array(offs, np.int64),
            np.array(dsts, bool))


@lru_cache(maxsize=None)
def load_tz(name: str) -> TZ:
    if name in ("UTC", "utc", "Etc/UTC", "GMT"):
        return TZ(name, np.zeros(0, np.int64), np.zeros(1, np.int64),
                  np.zeros(1, bool))
    with open(_tzif_path(name), "rb") as f:
        data = f.read()
    if data[:4] != b"TZif":
        raise Invalid(f"{name}: not a TZif file")
    version = data[4:5]
    pos, trans, idx, utoff_t, isdst_t = _read_body(data, 0, False)
    footer = ""
    if version >= b"2":
        # v2+: parse the 64-bit body that follows, then the footer
        pos, trans, idx, utoff_t, isdst_t = _read_body(data, pos, True)
        nl1 = data.index(b"\n", pos)
        nl2 = data.index(b"\n", nl1 + 1)
        footer = data[nl1 + 1: nl2].decode()
    # period arrays: period 0 = before first transition. Use the first
    # non-dst type (CPython zoneinfo's convention), else type 0.
    if len(utoff_t) == 0:
        raise Invalid(f"{name}: no time types")
    std0 = int(np.flatnonzero(~isdst_t)[0]) if (~isdst_t).any() else 0
    utoff = np.concatenate([[utoff_t[std0]], utoff_t[idx]])
    isdst = np.concatenate([[isdst_t[std0]], isdst_t[idx]])
    if footer:
        last_year = 1970
        if len(trans):
            last_year = 1970 + int(trans[-1]) // (365 * 86400)
        exp = _expand_footer(footer, last_year, 2100)
        if exp is not None and len(exp[0]):
            ft, fo, fd = exp
            keep = ft > (trans[-1] if len(trans) else -2**62)
            # drop expanded transitions that don't change the state
            trans = np.concatenate([trans, ft[keep]])
            utoff = np.concatenate([utoff, fo[keep]])
            isdst = np.concatenate([isdst, fd[keep]])
    return TZ(name, trans, utoff, isdst)


# ---------------------------------------------------------------------
# vectorized per-row math (device-friendly: searchsorted + gather)
# ---------------------------------------------------------------------

def utc_period_index(tz: TZ, utc_sec):
    """Period index per row for UTC instants (numpy or jnp array)."""
    if len(tz.trans) == 0:
        return np.zeros(np.shape(utc_sec), np.int64) \
            if isinstance(utc_sec, np.ndarray) else 0
    xp = np
    try:
        import jax.numpy as jnp

        if not isinstance(utc_sec, np.ndarray):
            xp = jnp
    except Exception:
        pass
    return xp.searchsorted(xp.asarray(tz.trans), utc_sec, side="right")


def local_candidates(tz: TZ):
    """Wall-clock start instants per period: ws[p] = start of period p
    in its own local time. Period p covers local [ws[p], we[p])."""
    if len(tz.trans) == 0:
        return None
    ws = np.concatenate([[np.int64(-2**62)], tz.trans + tz.utoff[1:]])
    we = np.concatenate([tz.trans + tz.utoff[:-1], [np.int64(2**62)]])
    return ws, we
