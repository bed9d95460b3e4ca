"""Elementwise math kernels: ln/log2/log10/log1p/exp/sqrt + trig +
floor/ceil/trunc/round.

Reference: the scalar_arithmetic.cc math additions of the 5.0 cycle
(ln/log2/log10/log1p landed in ARROW-12747 within this snapshot's era)
plus the rounding family. All are trivial elementwise maps with
NullHandling::INTERSECTION; integers promote to float64 like the
reference's generated float kernels.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..registry import register_function
from .common import intersect_validity, result_column, unpack

__all__ = ["RoundOptions"]


@dataclasses.dataclass
class RoundOptions:
    ndigits: int = 0
    round_mode: str = "half_to_even"


def _defloat(args):
    """Decimal args route through the exact scaled float conversion —
    the reference casts decimals to double for the float-domain kernels
    (acos(decimal) -> double in pa)."""
    out = []
    for a in args:
        t = getattr(a, "dtype", None)
        if t is not None and getattr(t, "is_decimal", False):
            if isinstance(a, Column):
                from .decimal import decimal_to_float

                a = decimal_to_float(a)
            else:
                from ..datum import Scalar as _S

                a = _S(float(a.as_py()) if a.is_valid else 0.0,
                       dt.float64, is_valid=a.is_valid)
        out.append(a)
    return out


def _float_unary(name, fn, int_to_float=True):
    def exec_fn(args, options, ctx):
        args = _defloat(args)
        (a,) = args
        t = a.dtype
        if not t.is_numeric:
            raise Invalid(f"{name}: expects numeric")
        out_t = t if t.is_floating else (dt.float64 if int_to_float else t)
        (x,), validities, n = unpack(args, out_t)
        return result_column(fn(x), out_t, intersect_validity(validities, n),
                             n)

    return exec_fn


for _name, _fn in [
    ("ln", jnp.log), ("log2", jnp.log2), ("log10", jnp.log10),
    ("log1p", jnp.log1p), ("exp", jnp.exp), ("expm1", jnp.expm1),
    ("sqrt", jnp.sqrt),
    ("sin", jnp.sin), ("cos", jnp.cos), ("tan", jnp.tan),
    ("asin", jnp.arcsin), ("acos", jnp.arccos), ("atan", jnp.arctan),
]:
    register_function(_name, "scalar", 1)(_float_unary(_name, _fn))


def _float_out(args):
    ts = [a.dtype for a in args]
    return dt.float32 if all(t.kind == "float32" for t in ts) else dt.float64


def _atan2_exec(args, options, ctx):
    args = _defloat(args)
    (y, x) = args
    out_t = _float_out(args)
    (yv, xv), validities, n = unpack(args, out_t)
    return result_column(jnp.arctan2(yv, xv), out_t,
                         intersect_validity(validities, n), n)


register_function("atan2", "scalar", 2)(_atan2_exec)


def _int_preserving(name, fn):
    """floor/ceil/trunc: identity on integers, float op on floats,
    exact directed round on decimals
    (reference: the rounding kernels return the input type)."""
    dec_mode = {"floor": "down", "ceil": "up", "trunc": "towards_zero"}

    def exec_fn(args, options, ctx):
        (a,) = args
        t = a.dtype
        if getattr(t, "is_decimal", False):
            from .decimal import decimal_round

            return decimal_round(a, 0, dec_mode[name])
        if not t.is_numeric:
            raise Invalid(f"{name}: expects numeric")
        (x,), validities, n = unpack(args)
        r = fn(x) if t.is_floating else x
        return result_column(r, t, intersect_validity(validities, n), n)

    return exec_fn


register_function("floor", "scalar", 1)(_int_preserving("floor", jnp.floor))
register_function("ceil", "scalar", 1)(_int_preserving("ceil", jnp.ceil))
register_function("trunc", "scalar", 1)(_int_preserving("trunc", jnp.trunc))


def _apply_round_mode(xs, mode):
    """Integral rounding of xs under one of the reference's 10 RoundModes
    (scalar_round.cc RoundMode enum)."""
    fl = jnp.floor(xs)
    tie = (xs - fl) == 0.5
    if mode == "half_to_even":
        return jnp.round(xs)  # banker's rounding, arrow default
    if mode == "half_to_odd":
        odd = jnp.where((fl % 2) != 0, fl, fl + 1)
        return jnp.where(tie, odd, jnp.round(xs))
    if mode == "down":
        return fl
    if mode == "up":
        return jnp.ceil(xs)
    if mode == "towards_zero":
        return jnp.trunc(xs)
    if mode == "towards_infinity":
        return jnp.where(xs >= 0, jnp.ceil(xs), fl)
    if mode in ("half_away_from_zero", "half_towards_infinity"):
        return jnp.trunc(xs + jnp.where(xs >= 0, 0.5, -0.5))
    if mode == "half_towards_zero":
        return jnp.where(xs >= 0, jnp.ceil(xs - 0.5), jnp.floor(xs + 0.5))
    if mode == "half_up":
        return fl + jnp.where((xs - fl) >= 0.5, 1.0, 0.0)
    if mode == "half_down":
        return jnp.ceil(xs) - jnp.where((jnp.ceil(xs) - xs) >= 0.5, 1.0, 0.0)
    raise Invalid(f"round: unsupported mode {mode!r}")


def _round_int(x, d, mode):
    """Exact integer rounding to a power-of-ten boundary (ndigits < 0
    rows; others unchanged). Pure int64 arithmetic — no float detour, so
    values beyond 2^53 stay exact (reference: scalar_round.cc integer
    kernels). d may be per-row."""
    d = jnp.broadcast_to(jnp.asarray(d, jnp.int64), x.shape)
    k = jnp.clip(-d, 0, 18)
    s = jnp.power(jnp.int64(10), k)          # 10^18 fits int64
    xi = x.astype(jnp.int64)
    q = jnp.floor_divide(xi, s)
    r = xi - q * s                            # 0 <= r < s
    half = s // 2                             # s = 10^k, k>=1 -> even
    neg = xi < 0
    if mode == "down":
        add = jnp.zeros_like(q)
    elif mode == "up":
        add = (r > 0).astype(jnp.int64)
    elif mode == "towards_zero":
        add = (neg & (r > 0)).astype(jnp.int64)
    elif mode == "towards_infinity":
        add = (~neg & (r > 0)).astype(jnp.int64)
    elif mode == "half_to_even":
        add = ((r > half) | ((r == half) & (q % 2 != 0))).astype(jnp.int64)
    elif mode == "half_to_odd":
        add = ((r > half) | ((r == half) & (q % 2 == 0))).astype(jnp.int64)
    elif mode in ("half_away_from_zero", "half_towards_infinity"):
        add = jnp.where(neg, r > half, r >= half).astype(jnp.int64)
    elif mode == "half_towards_zero":
        add = jnp.where(neg, r >= half, r > half).astype(jnp.int64)
    elif mode == "half_up":
        add = (r >= half).astype(jnp.int64)
    elif mode == "half_down":
        add = (r > half).astype(jnp.int64)
    else:
        raise Invalid(f"round: unsupported mode {mode!r}")
    out = (q + add) * s
    return jnp.where(d < 0, out, xi).astype(x.dtype)


def _round_exec(args, options: RoundOptions, ctx):
    (a,) = args
    options = options or RoundOptions()
    t = a.dtype
    if getattr(t, "is_decimal", False):
        from .decimal import decimal_round

        return decimal_round(a, options.ndigits, options.round_mode)
    if not t.is_numeric:
        raise Invalid("round: expects numeric")
    (x,), validities, n = unpack(args)
    if not t.is_floating:
        r = _round_int(x, options.ndigits, options.round_mode) \
            if options.ndigits < 0 else x
        return result_column(r, t, intersect_validity(validities, n), n)
    scale = 10.0 ** options.ndigits
    r = _apply_round_mode(x * scale, options.round_mode)
    return result_column(r / scale, t, intersect_validity(validities, n), n)


register_function("round", "scalar", 1, RoundOptions)(_round_exec)


for _name, _fn in [
    ("sinh", jnp.sinh), ("cosh", jnp.cosh), ("tanh", jnp.tanh),
    ("asinh", jnp.arcsinh), ("acosh", jnp.arccosh), ("atanh", jnp.arctanh),
]:
    register_function(_name, "scalar", 1)(_float_unary(_name, _fn))


# ---- checked variants (reference: generated "<fn>_checked" kernels —
# identical math, but a domain violation raises instead of producing
# inf/nan) ----

def _checked_unary(name, fn, bad_domain, msg):
    def exec_fn(args, options, ctx):
        args = _defloat(args)
        (a,) = args
        t = a.dtype
        if not t.is_numeric:
            raise Invalid(f"{name}: expects numeric")
        out_t = t if t.is_floating else dt.float64
        (x,), validities, n = unpack(args, out_t)
        validity = intersect_validity(validities, n)
        bad = bad_domain(x)
        if validity is not None:
            bad = bad & validity
        if bool(jnp.any(bad)):
            raise Invalid(f"{name}: {msg}")
        return result_column(fn(x), out_t, validity, n)

    return exec_fn


for _name, _fn, _bad, _msg in [
    ("ln_checked", jnp.log, lambda x: x <= 0, "logarithm of non-positive"),
    ("log2_checked", jnp.log2, lambda x: x <= 0,
     "logarithm of non-positive"),
    ("log10_checked", jnp.log10, lambda x: x <= 0,
     "logarithm of non-positive"),
    ("log1p_checked", jnp.log1p, lambda x: x <= -1,
     "logarithm of non-positive"),
    ("sqrt_checked", jnp.sqrt, lambda x: x < 0, "square root of negative"),
    ("asin_checked", jnp.arcsin, lambda x: jnp.abs(x) > 1,
     "domain error"),
    ("acos_checked", jnp.arccos, lambda x: jnp.abs(x) > 1,
     "domain error"),
    ("acosh_checked", jnp.arccosh, lambda x: x < 1, "domain error"),
    ("atanh_checked", jnp.arctanh, lambda x: jnp.abs(x) >= 1,
     "domain error"),
    ("sin_checked", jnp.sin, lambda x: jnp.zeros_like(x, jnp.bool_), ""),
    ("cos_checked", jnp.cos, lambda x: jnp.zeros_like(x, jnp.bool_), ""),
    ("tan_checked", jnp.tan, lambda x: jnp.zeros_like(x, jnp.bool_), ""),
]:
    register_function(_name, "scalar", 1)(
        _checked_unary(_name, _fn, _bad, _msg))


def _logb_exec(checked):
    def exec_fn(args, options, ctx):
        (xv, bv), validities, n = unpack(_defloat(args), dt.float64)
        validity = intersect_validity(validities, n)
        if checked:
            bad = (xv <= 0) | (bv <= 0)
            if validity is not None:
                bad = bad & validity
            if bool(jnp.any(bad)):
                raise Invalid("logb: logarithm of non-positive")
        return result_column(jnp.log(xv) / jnp.log(bv), dt.float64,
                             validity, n)

    return exec_fn


register_function("logb", "scalar", 2)(_logb_exec(False))
register_function("logb_checked", "scalar", 2)(_logb_exec(True))


def _hypot_exec(args, options, ctx):
    args = _defloat(args)
    out_t = _float_out(args)
    (xv, yv), validities, n = unpack(args, out_t)
    return result_column(jnp.hypot(xv, yv), out_t,
                         intersect_validity(validities, n), n)


register_function("hypot", "scalar", 2)(_hypot_exec)


@dataclasses.dataclass
class RoundToMultipleOptions:
    multiple: float = 1.0
    round_mode: str = "half_to_even"


def _round_to_multiple_exec(args, options: RoundToMultipleOptions, ctx):
    """Reference: RoundToMultiple scalar_round.cc — round to the nearest
    integer multiple of ``multiple``."""
    (a,) = args
    options = options or RoundToMultipleOptions()
    if getattr(a.dtype, "is_decimal", False):
        from .decimal import decimal_round_to_multiple

        return decimal_round_to_multiple(a, options)
    t = a.dtype
    if not t.is_numeric:
        raise Invalid("round_to_multiple: expects numeric")
    (x,), validities, n = unpack(args)
    if not t.is_floating:
        x = x.astype(jnp.float64)
    m = float(options.multiple)
    if m <= 0:
        raise Invalid("round_to_multiple: multiple must be positive")
    xs = x / m
    r = _apply_round_mode(xs, options.round_mode)
    out = r * m
    out_t = t if t.is_floating else t
    if not t.is_floating:
        out = out.astype(t.physical_dtype())
    return result_column(out, out_t, intersect_validity(validities, n), n)


register_function("round_to_multiple", "scalar", 1, RoundToMultipleOptions)(
    _round_to_multiple_exec)


@dataclasses.dataclass
class RoundBinaryOptions:
    """Reference: api_scalar.h RoundBinaryOptions (round_mode only;
    ndigits comes from the second argument)."""
    round_mode: str = "half_to_even"


def _round_binary_exec(args, options: RoundBinaryOptions, ctx):
    """round(x, ndigits-per-row) (reference: round_binary scalar_round.cc)."""
    a, nd = args
    options = options or RoundBinaryOptions()
    t = a.dtype
    if not t.is_numeric:
        raise Invalid("round_binary: expects numeric")
    (x, d), validities, n = unpack([a, nd])
    validity = intersect_validity(validities, n)
    if not t.is_floating:
        r = _round_int(x, d, options.round_mode)
        return result_column(r, t, validity, n)
    scale = jnp.power(10.0, d.astype(jnp.float64))
    r = _apply_round_mode(x * scale, options.round_mode) / scale
    return result_column(r, t, validity, n)


register_function("round_binary", "scalar", 2, RoundBinaryOptions)(
    _round_binary_exec)
