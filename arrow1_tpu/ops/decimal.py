"""Decimal128 arithmetic: two-limb int64 math on device.

Reference: cpp/src/arrow/util/basic_decimal.{h,cc} — BasicDecimal128 as
(high int64, low uint64) with carry-propagating add/sub and lexicographic
compare. The device storage is the same two limbs as separate arrays
(column.py: data = low limb, data2 = high limb), so the kernels are plain
vector ops: no __int128, no per-element loops.

Scale semantics (reference: decimal arithmetic promotion in
compute/kernels/scalar_arithmetic.cc for decimals): add/subtract require
rescale to the max scale; result precision grows by 1 (capped at 38).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid

__all__ = ["decimal_add", "decimal_subtract", "decimal_negate",
           "decimal_multiply", "decimal_divide",
           "decimal_compare", "decimal_to_float"]

_U64 = jnp.uint64
_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)  # np: no backend init at import


def _limbs(col: Column):
    return col.data.astype(jnp.uint64), col.data2.astype(jnp.int64)


def _any256(*cols: Column) -> bool:
    return any(c.dtype.kind == "decimal256" for c in cols)


def _rescale(lo, hi, by: int):
    """Multiply (hi:lo) by 10**by (by >= 0, small). Schoolbook per power
    of ten: x*10 = x*8 + x*2 (shifts + adds with carry)."""
    for _ in range(by):
        lo8 = lo << _U64(3)
        hi8 = (hi << jnp.int64(3)) | (lo >> _U64(61)).astype(jnp.int64)
        lo2 = lo << _U64(1)
        hi2 = (hi << jnp.int64(1)) | (lo >> _U64(63)).astype(jnp.int64)
        lo = lo8 + lo2
        carry = (lo < lo8).astype(jnp.int64)
        hi = hi8 + hi2 + carry
    return lo, hi


def _common_scale(a: Column, b: Column):
    sa, sb = a.dtype.scale, b.dtype.scale
    s = max(sa, sb)
    alo, ahi = _limbs(a)
    blo, bhi = _limbs(b)
    if sa < s:
        alo, ahi = _rescale(alo, ahi, s - sa)
    if sb < s:
        blo, bhi = _rescale(blo, bhi, s - sb)
    # reference promotion for add/sub: whole digits from the wider side,
    # fractional digits from the finer side, +1 carry digit
    prec = min(max(a.dtype.precision - sa, b.dtype.precision - sb)
               + s + 1, 38)
    return alo, ahi, blo, bhi, dt.decimal128(prec, s)


def _validity(a: Column, b: Column):
    if a.validity is None:
        return b.validity
    if b.validity is None:
        return a.validity
    return a.validity & b.validity


def decimal_add(a: Column, b: Column) -> Column:
    if _any256(a, b):
        from .decimal256 import dec256_add

        return dec256_add(a, b)
    alo, ahi, blo, bhi, out_t = _common_scale(a, b)
    lo = alo + blo
    carry = (lo < alo).astype(jnp.int64)
    hi = ahi + bhi + carry
    return Column(lo.astype(jnp.int64), out_t, validity=_validity(a, b),
                  data2=hi)


def decimal_subtract(a: Column, b: Column) -> Column:
    if _any256(a, b):
        from .decimal256 import dec256_subtract

        return dec256_subtract(a, b)
    alo, ahi, blo, bhi, out_t = _common_scale(a, b)
    lo = alo - blo
    borrow = (alo < blo).astype(jnp.int64)
    hi = ahi - bhi - borrow
    return Column(lo.astype(jnp.int64), out_t, validity=_validity(a, b),
                  data2=hi)


def decimal_negate(a: Column) -> Column:
    if _any256(a):
        from .decimal256 import dec256_negate

        return dec256_negate(a)
    lo, hi = _limbs(a)
    nlo = (~lo) + _U64(1)
    nhi = (~hi) + (nlo == _U64(0)).astype(jnp.int64)
    return Column(nlo.astype(jnp.int64), a.dtype, validity=a.validity,
                  data2=nhi)


def decimal_compare(a: Column, b: Column, op: str):
    if _any256(a, b):
        from .decimal256 import dec256_compare

        return dec256_compare(a, b, op)
    alo, ahi, blo, bhi, _ = _common_scale(a, b)
    hi_lt = ahi < bhi
    hi_eq = ahi == bhi
    lt = hi_lt | (hi_eq & (alo < blo))
    eq = hi_eq & (alo == blo)
    table = {
        "equal": eq, "not_equal": ~eq,
        "less": lt, "less_equal": lt | eq,
        "greater": ~(lt | eq), "greater_equal": ~lt,
    }
    if op not in table:
        raise Invalid(f"decimal compare: bad op {op}")
    return Column(table[op], dt.bool_, validity=_validity(a, b))


def decimal_to_float(a: Column) -> Column:
    if _any256(a):
        from .decimal256 import dec256_to_float

        return dec256_to_float(a)
    lo, hi = _limbs(a)
    # convert via sign+magnitude: hi*2^64 + lo in float catastrophically
    # cancels for small negative values (hi = -1, lo ~ 2^64)
    neg = hi < 0
    nlo = (~lo) + _U64(1)
    nhi = (~hi) + (nlo == _U64(0)).astype(jnp.int64)
    ulo = jnp.where(neg, nlo, lo)
    uhi = jnp.where(neg, nhi, hi)
    mag = uhi.astype(jnp.float64) * 18446744073709551616.0 + \
        ulo.astype(jnp.float64)
    val = jnp.where(neg, -mag, mag)
    return Column(val / (10.0 ** a.dtype.scale), dt.float64,
                  validity=a.validity)


# ---- multiply / divide (reference: util/basic_decimal.cc Multiply /
# Divide + compute promotion rules: multiply -> (p1+p2+1, s1+s2);
# divide -> (p1+p2+1, max(4, s1+p2-s2+1)), quotient truncated toward 0) ----

def _mul64(a, b):
    """u64 x u64 -> (hi, lo) full 128-bit product via 32-bit halves."""
    m32 = _U64(0xFFFFFFFF)
    a0, a1 = a & m32, a >> _U64(32)
    b0, b1 = b & m32, b >> _U64(32)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + (ll >> _U64(32)) + (hl & m32)  # cannot overflow u64
    lo = (mid << _U64(32)) | (ll & m32)
    hi = hh + (mid >> _U64(32)) + (hl >> _U64(32))
    return hi, lo


def _mul128(alo, ahi, blo, bhi):
    """(hi:lo) x (hi:lo) mod 2^128; two's complement makes signed exact."""
    hi, lo = _mul64(alo, blo)
    hi = hi + alo * bhi.astype(_U64) + ahi.astype(_U64) * blo
    return lo, hi.astype(jnp.int64)


def decimal_multiply(a: Column, b: Column) -> Column:
    if _any256(a, b):
        from .decimal256 import dec256_multiply

        return dec256_multiply(a, b)
    out_t = dt.decimal128(min(a.dtype.precision + b.dtype.precision + 1, 38),
                          a.dtype.scale + b.dtype.scale)
    alo, ahi = _limbs(a)
    blo, bhi = _limbs(b)
    lo, hi = _mul128(alo, ahi, blo, bhi)
    return Column(lo.astype(jnp.int64), out_t, validity=_validity(a, b),
                  data2=hi)


def _abs128(lo, hi):
    """(u64 lo, i64 hi) -> unsigned magnitude + neg flag."""
    neg = hi < 0
    nlo = (~lo) + _U64(1)
    nhi = (~hi) + (nlo == _U64(0)).astype(jnp.int64)
    return (jnp.where(neg, nlo, lo),
            jnp.where(neg, nhi, hi).astype(_U64), neg)


def _neg128_if(lo, hi, neg):
    nlo = (~lo) + _U64(1)
    nhi = ((~hi).astype(jnp.int64)
           + (nlo == _U64(0)).astype(jnp.int64))
    return (jnp.where(neg, nlo, lo).astype(jnp.int64),
            jnp.where(neg, nhi, hi.astype(jnp.int64)))


_RESCALE_LIMIT = (2 ** 127 - 1) // 10  # |x| above this would overflow on x*10


def _rescale_checked(lo, hi, by: int):
    """Unsigned (hi:lo) * 10**by with overflow detection (reference:
    basic_decimal.cc Rescale -> kRescaleDataLoss/overflow)."""
    lim_hi = _U64(_RESCALE_LIMIT >> 64)
    lim_lo = _U64(_RESCALE_LIMIT & 0xFFFFFFFFFFFFFFFF)
    for _ in range(by):
        over = (hi > lim_hi) | ((hi == lim_hi) & (lo > lim_lo))
        if bool(jnp.any(over)):
            raise Invalid("Rescale overflow in decimal divide")
        hi8 = (hi << _U64(3)) | (lo >> _U64(61))
        lo8 = lo << _U64(3)
        hi2 = (hi << _U64(1)) | (lo >> _U64(63))
        lo2 = lo << _U64(1)
        lo = lo8 + lo2
        hi = hi8 + hi2 + (lo < lo8).astype(_U64)
    return lo, hi


def _div128(nlo, nhi, dlo, dhi):
    """Unsigned 128/128 restoring division -> truncated quotient.

    128 static shift-subtract steps (jax.lax.fori_loop) over the whole
    vector — no data-dependent control flow, so it jits for the device.
    """
    import jax

    zeros = jnp.zeros_like(nlo)

    def body(k, state):
        # k runs 0..127; process numerator bit (127 - k)
        rlo, rhi, qlo, qhi = state
        bitpos = _U64(127) - k.astype(_U64)
        in_hi = bitpos >= _U64(64)
        bit = jnp.where(in_hi, (nhi >> (bitpos - _U64(64))),
                        (nlo >> bitpos)) & _U64(1)
        rhi = (rhi << _U64(1)) | (rlo >> _U64(63))
        rlo = (rlo << _U64(1)) | bit
        ge = (rhi > dhi) | ((rhi == dhi) & (rlo >= dlo))
        slo = rlo - dlo
        shi = rhi - dhi - (rlo < dlo).astype(_U64)
        rlo = jnp.where(ge, slo, rlo)
        rhi = jnp.where(ge, shi, rhi)
        g = ge.astype(_U64)
        qhi = jnp.where(in_hi, qhi | (g << (bitpos - _U64(64))), qhi)
        qlo = jnp.where(in_hi, qlo, qlo | (g << bitpos))
        return rlo, rhi, qlo, qhi

    _, _, qlo, qhi = jax.lax.fori_loop(
        0, 128, body, (zeros, zeros, zeros, zeros))
    return qlo, qhi


def decimal_divide(a: Column, b: Column) -> Column:
    """Truncated-toward-zero decimal quotient at the promoted scale."""
    if _any256(a, b):
        from .decimal256 import dec256_divide

        return dec256_divide(a, b)
    p1, s1 = a.dtype.precision, a.dtype.scale
    p2, s2 = b.dtype.precision, b.dtype.scale
    s_out = max(4, s1 + p2 - s2 + 1)
    out_t = dt.decimal128(min(p1 + p2 + 1, 38), s_out)

    blo, bhi = _limbs(b)
    bzero = (blo == _U64(0)) & (bhi == jnp.int64(0))
    vb = _validity(a, b)
    live_zero = bzero if vb is None else (bzero & vb)
    if bool(jnp.any(live_zero)):
        raise Invalid("Divide by zero")

    alo, ahi = _limbs(a)
    ulo, uhi, aneg = _abs128(alo, ahi)
    vlo, vhi, bneg = _abs128(blo, bhi)
    # numerator scaled so the truncated quotient lands at s_out
    ulo, uhi = _rescale_checked(ulo, uhi, s_out - s1 + s2)
    # avoid an all-lanes 0/0 trap on dead rows: make dead divisors 1
    vlo = jnp.where(bzero, _U64(1), vlo)
    qlo, qhi = _div128(ulo, uhi, vlo, vhi)
    lo, hi = _neg128_if(qlo, qhi, aneg != bneg)
    return Column(lo, out_t, validity=vb, data2=hi)


def decimal_round(a: Column, ndigits: int, mode: str) -> Column:
    """Round to `ndigits` fractional digits, type/scale unchanged
    (reference: scalar_round.cc decimal kernels). Exact 128-bit
    divide/compare/multiply on the two limbs."""
    t = a.dtype
    if t.kind != "decimal128":
        raise Invalid("round: decimal256 is not supported — cast to "
                      "decimal128")
    k = t.scale - ndigits
    if k <= 0:
        return a
    return _round_to_divisor(a, 10 ** k, mode, t)


def decimal_round_to_multiple(a: Column, options) -> Column:
    """Round each value to the nearest integer multiple of
    options.multiple (reference: scalar_round.cc RoundToMultiple decimal
    kernels); result widens one precision digit like the reference."""
    import decimal as _pyd

    t = a.dtype
    if t.kind != "decimal128":
        raise Invalid("round_to_multiple: decimal256 unsupported — cast "
                      "to decimal128")
    m = options.multiple
    M = m if isinstance(m, _pyd.Decimal) else _pyd.Decimal(str(m))
    if M <= 0:
        raise Invalid("round_to_multiple: multiple must be positive")
    scaled = M.scaleb(t.scale)
    if scaled != scaled.to_integral_value():
        raise Invalid("round_to_multiple: multiple must be representable "
                      f"at scale {t.scale}")
    # pa keeps the input type when the multiple fits it
    return _round_to_divisor(a, int(scaled), options.round_mode, t)


def _round_to_divisor(a: Column, d: int, mode: str,
                      out_t: dt.DataType) -> Column:
    """|x| = q*d + r exactly (128-bit); per-mode increment on q; result
    = sign * (q + inc) * d at the output type."""
    lo, hi = _limbs(a)
    ulo, uhi, neg = _abs128(lo, hi)
    M = 0xFFFFFFFFFFFFFFFF
    dlo = jnp.full_like(ulo, jnp.uint64(d & M))
    dhi = jnp.full_like(ulo, jnp.uint64((d >> 64) & M))
    qlo, qhi = _div128(ulo, uhi, dlo, dhi)
    # remainder = u - q*d (fits 128 bits; q*d <= u)
    plo, phi = _mul128(qlo, qhi.astype(jnp.int64), dlo,
                       dhi.astype(jnp.int64))
    plo = plo.astype(_U64)
    phi = phi.astype(_U64)
    rlo = ulo - plo
    borrow = (ulo < plo).astype(_U64)
    rhi = uhi - phi - borrow
    frac = (rlo != 0) | (rhi != 0)
    # compare 2*rem vs d
    t_hi = (rhi << _U64(1)) | (rlo >> _U64(63))
    t_lo = rlo << _U64(1)
    gt = (t_hi > dhi) | ((t_hi == dhi) & (t_lo > dlo))
    eq = (t_hi == dhi) & (t_lo == dlo)
    q_odd = (qlo & _U64(1)) != 0
    # pyarrow RoundMode set (options.pyx): inc = +1 on |q| per mode
    if mode == "half_to_even":
        inc = gt | (eq & q_odd)
    elif mode == "half_to_odd":
        inc = gt | (eq & ~q_odd)
    elif mode in ("half_away_from_zero", "half_towards_infinity"):
        inc = gt | eq
    elif mode == "half_towards_zero":
        inc = gt
    elif mode == "half_up":      # tie toward +inf
        inc = gt | (eq & ~neg)
    elif mode == "half_down":    # tie toward -inf
        inc = gt | (eq & neg)
    elif mode == "towards_zero":
        inc = jnp.zeros_like(frac)
    elif mode == "towards_infinity":
        inc = frac
    elif mode == "up":           # toward +inf
        inc = frac & ~neg
    elif mode == "down":         # toward -inf
        inc = frac & neg
    else:
        raise Invalid(f"round: unsupported mode {mode!r} for decimal")
    ilo = qlo + inc.astype(_U64)
    ihi = qhi + (ilo < qlo).astype(jnp.int64)
    olo, ohi = _mul128(ilo, ihi, dlo, dhi.astype(jnp.int64))
    slo, shi = _neg128_if(olo.astype(_U64), ohi, neg)
    return Column(slo, out_t, validity=a.validity, data2=shi)


def decimal_planes(x, t: dt.DataType, n: int):
    """Column-or-Scalar -> (data, data2) planes broadcast to length n.
    Scalars carry an unscaled python int AT THEIR OWN SCALE — rescale it
    to the target scale (exactness required when scaling down)."""
    if isinstance(x, Column):
        if x.dtype.scale != t.scale:
            return decimal_planes_rescale_col(x, t)
        return x.data, x.data2
    v = int(x.value)
    ds = t.scale - getattr(x.dtype, "scale", t.scale)
    if ds > 0:
        v *= 10 ** ds
    elif ds < 0:
        q, r = divmod(v, 10 ** (-ds))
        if r:
            raise Invalid(f"decimal scalar {x.as_py()} does not fit "
                          f"scale {t.scale}")
        v = q
    M = 0xFFFFFFFFFFFFFFFF
    lo = jnp.full(n, np.uint64(v & M).astype(np.int64), jnp.int64)
    if t.kind == "decimal128":
        hi = jnp.full(n, np.int64(v >> 64), jnp.int64)
    else:
        hi = jnp.stack([jnp.full(n, np.uint64((v >> (64 * (j + 1))) & M)
                        .astype(np.int64), jnp.int64) for j in range(3)],
                       axis=-1)
    return lo, hi


def decimal_planes_rescale_col(x: Column, t: dt.DataType):
    from .cast import CastOptions  # noqa: F401 (doc pointer)

    col = decimal_cast(x, t, allow_truncate=False)
    return col.data, col.data2


def decimal_where(c, l_planes, r_planes, t: dt.DataType):
    """Per-row select across both limb planes."""
    llo, lhi = l_planes
    rlo, rhi = r_planes
    data = jnp.where(c, llo, rlo)
    if t.kind == "decimal128":
        data2 = jnp.where(c, lhi, rhi)
    else:
        data2 = jnp.where(c[:, None], lhi, rhi)
    return data, data2


_INT_DIGITS = {"int8": 3, "int16": 5, "int32": 10, "int64": 19,
               "uint8": 3, "uint16": 5, "uint32": 10, "uint64": 20}


def decimal_cast(a: Column, dst: dt.DataType, allow_truncate: bool
                 ) -> Column:
    """decimal <-> decimal/integer casts (reference:
    scalar_cast_numeric.cc decimal paths + util/decimal Rescale).
    All arithmetic in four u64 limbs (covers both widths)."""
    from .decimal256 import _add_ripple, _mul_small, _neg4, limbs256, pack256

    src = a.dtype

    def abs4(limbs):
        neg = limbs[-1].astype(jnp.int64) < 0
        n4 = _neg4(limbs)
        return [jnp.where(neg, x, y) for x, y in zip(n4, limbs)], neg

    def div_pow10(limbs, k):
        """Unsigned 4-limb divide by 10^k one decimal digit at a time
        (shift-free long division by 10 per digit; exact remainder)."""
        rem_any = jnp.zeros(limbs[0].shape, bool)
        for _ in range(k):
            # divide by 10: process limbs high->low with carry remainder
            carry = jnp.zeros(limbs[0].shape, jnp.uint64)
            out = [None] * 4
            for i in range(3, -1, -1):
                # value = carry * 2^64 + limb; q = value // 10
                # split into halves to stay in u64
                hi32 = (carry << jnp.uint64(32)) | (limbs[i] >> jnp.uint64(32))
                q_hi = hi32 // jnp.uint64(10)
                r_hi = hi32 - q_hi * jnp.uint64(10)
                lo32 = (r_hi << jnp.uint64(32)) | (limbs[i] & jnp.uint64(0xFFFFFFFF))
                q_lo = lo32 // jnp.uint64(10)
                carry = lo32 - q_lo * jnp.uint64(10)
                out[i] = (q_hi << jnp.uint64(32)) | q_lo
            rem_any = rem_any | (carry != 0)
            limbs = out
        return limbs, rem_any

    limbs = limbs256(a)
    mag, neg = abs4(limbs)

    if dst.is_decimal:
        dscale = dst.scale
        if dscale > src.scale:
            for _ in range(dscale - src.scale):
                mag = _mul_small(mag, 10)
        elif dscale < src.scale:
            mag, lost = div_pow10(mag, src.scale - dscale)
            if not allow_truncate and bool(jnp.any(
                    lost & (a.mask() if a.validity is not None
                            else jnp.ones(a.length, bool)))):
                raise Invalid("Rescaling Decimal value would cause "
                              "data loss")
        out = _neg4(mag)
        out = [jnp.where(neg, x, y) for x, y in zip(out, mag)]
        if dst.kind == "decimal128":
            # range check: limbs 2..3 must be sign extension
            sign = (out[1].astype(jnp.int64) >> 63).astype(jnp.uint64)
            bad = (out[2] != sign) | (out[3] != sign)
            if bool(jnp.any(bad & (a.mask() if a.validity is not None
                                   else jnp.ones(a.length, bool)))):
                raise Invalid(f"value out of range for {dst}")
            return Column(out[0].astype(jnp.int64), dst,
                          validity=a.validity,
                          data2=out[1].astype(jnp.int64))
        return pack256(out, dst, a.validity)

    if dst.is_integer:
        mag0, lost = div_pow10(mag, src.scale)
        if not allow_truncate and bool(jnp.any(
                lost & (a.mask() if a.validity is not None
                        else jnp.ones(a.length, bool)))):
            raise Invalid(f"Rescaling Decimal value would cause data "
                          f"loss casting to {dst}")
        out = _neg4(mag0)
        out = [jnp.where(neg, x, y) for x, y in zip(out, mag0)]
        sign = (out[0].astype(jnp.int64) >> 63).astype(jnp.uint64)
        in64 = (out[1] == sign) & (out[2] == sign) & (out[3] == sign)
        v = out[0].astype(jnp.int64)
        info = np.iinfo(np.dtype(dst.physical_dtype()))
        ok = in64 & (v >= info.min) & (v <= info.max)
        live = (a.mask() if a.validity is not None
                else jnp.ones(a.length, bool))
        if bool(jnp.any(~ok & live)):
            raise Invalid(f"decimal value out of range for {dst}")
        return Column(v.astype(dst.physical_dtype()), dst,
                      validity=a.validity)

    raise Invalid(f"unsupported decimal cast {src} -> {dst}")


def cast_to_decimal(a: Column, dst: dt.DataType) -> Column:
    """integer/float -> decimal (reference static precision rule for
    ints; floats round half-even at the target scale)."""
    src = a.dtype
    if src.is_integer:
        need = _INT_DIGITS[src.kind]
        if dst.precision - dst.scale < need:
            raise Invalid(
                f"Precision is not great enough for the result: casting "
                f"{src} -> {dst} needs {need} whole digits")
        v = a.data.astype(jnp.int64)
        if src.kind == "uint64":
            # u64 values >= 2^63 would wrap through int64: unsigned limb0
            lo = a.data.astype(jnp.uint64).astype(jnp.int64)
            hi = jnp.zeros_like(lo)
        else:
            lo = v
            hi = v >> 63
        col = Column(lo, dt.decimal128(38, 0), validity=a.validity,
                     data2=hi)
        return decimal_cast(col, dst, allow_truncate=False)
    if src.is_floating:
        x = a.data.astype(jnp.float64)
        live = a.mask() if a.validity is not None else             jnp.ones(a.length, bool)
        scaled = jnp.round(x * (10.0 ** dst.scale))
        bad = (~jnp.isfinite(scaled)) | (jnp.abs(scaled) >= 2.0 ** 63)
        if bool(jnp.any(bad & live)):
            raise Invalid(f"float value not representable as {dst}")
        scaled = jnp.where(live, scaled, 0.0)
        v = scaled.astype(jnp.int64)
        col = Column(v, dt.decimal128(38, dst.scale), validity=a.validity,
                     data2=v >> 63)
        if dst.kind == "decimal128" and dst.scale == col.dtype.scale:
            return Column(col.data, dst, validity=a.validity,
                          data2=col.data2)
        return decimal_cast(col, dst, allow_truncate=True)
    raise Invalid(f"unsupported cast {src} -> {dst}")
