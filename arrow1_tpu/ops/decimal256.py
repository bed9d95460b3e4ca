"""Decimal256 arithmetic: four-limb int64 math on device.

Reference: cpp/src/arrow/util/basic_decimal.{h,cc} BasicDecimal256 (four
little-endian 64-bit limbs, top limb signed) and the decimal promotion
rules in compute/kernels/scalar_arithmetic.cc (precision cap 76).

Storage (interop.py): data = limb0 (int64 bit view), data2 = [n, 3]
int64 = limbs 1..3. All kernels below are straight-line vector ops or a
static 256-step fori_loop (divide) — no data-dependent control flow, so
everything jits for the device.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid

__all__ = ["dec256_add", "dec256_subtract", "dec256_negate",
           "dec256_multiply", "dec256_divide", "dec256_compare",
           "dec256_to_float", "limbs256", "pack256"]

_U64 = jnp.uint64
_NLIMB = 4


def limbs256(col: Column) -> List[jnp.ndarray]:
    """Column -> [limb0..limb3] as u64 vectors. decimal128 inputs are
    sign-extended (mixed-width promotion)."""
    if col.dtype.kind == "decimal256":
        l0 = col.data.astype(_U64)
        rest = [col.data2[:, j].astype(_U64) for j in range(3)]
        return [l0] + rest
    if col.dtype.kind == "decimal128":
        l0 = col.data.astype(_U64)
        l1 = col.data2.astype(_U64)
        sign = (col.data2 >> jnp.int64(63)).astype(_U64)  # 0 or ~0
        return [l0, l1, sign, sign]
    raise Invalid(f"limbs256: not a decimal column ({col.dtype})")


def pack256(limbs: List[jnp.ndarray], dtype: dt.DataType,
            validity) -> Column:
    data = limbs[0].astype(jnp.int64)
    data2 = jnp.stack([l.astype(jnp.int64) for l in limbs[1:]], axis=-1)
    return Column(data, dtype, validity=validity, data2=data2)


def _add_ripple(limbs: List[jnp.ndarray], k: int, v) -> None:
    """limbs += v * 2^(64k), carry rippling upward (in place)."""
    carry = v
    for idx in range(k, _NLIMB):
        s = limbs[idx] + carry
        nxt = (s < carry).astype(_U64)
        limbs[idx] = s
        carry = nxt


def _add4(a, b):
    out = []
    carry = jnp.zeros_like(a[0])
    for i in range(_NLIMB):
        s1 = a[i] + b[i]
        c1 = (s1 < a[i]).astype(_U64)
        s2 = s1 + carry
        c2 = (s2 < carry).astype(_U64)
        out.append(s2)
        carry = c1 | c2  # at most one of the two adds carries
    return out


def _neg4(a):
    out = [~x for x in a]
    _add_ripple(out, 0, jnp.ones_like(a[0]))
    return out


def _sub4(a, b):
    return _add4(a, _neg4(b))


def _is_neg(a) -> jnp.ndarray:
    return a[-1].astype(jnp.int64) < 0


def _abs4(a):
    neg = _is_neg(a)
    n = _neg4(a)
    return [jnp.where(neg, ni, ai) for ni, ai in zip(n, a)], neg


def _neg4_if(a, neg):
    n = _neg4(a)
    return [jnp.where(neg, ni, ai) for ni, ai in zip(n, a)]


def _cmp4(a, b):
    """-> (lt, eq) treating limbs as signed 256-bit values."""
    lt = a[-1].astype(jnp.int64) < b[-1].astype(jnp.int64)
    eq = a[-1] == b[-1]
    for i in range(_NLIMB - 2, -1, -1):
        lt = lt | (eq & (a[i] < b[i]))
        eq = eq & (a[i] == b[i])
    return lt, eq


def _mul64(a, b):
    """u64 x u64 -> (hi, lo) via 32-bit halves (decimal.py:_mul64)."""
    m32 = _U64(0xFFFFFFFF)
    a0, a1 = a & m32, a >> _U64(32)
    b0, b1 = b & m32, b >> _U64(32)
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    hh = a1 * b1
    mid = lh + (ll >> _U64(32)) + (hl & m32)
    lo = (mid << _U64(32)) | (ll & m32)
    hi = hh + (mid >> _U64(32)) + (hl >> _U64(32))
    return hi, lo


def _mul4(a, b):
    """(a * b) mod 2^256; two's complement makes signed exact."""
    out = [jnp.zeros_like(a[0]) for _ in range(_NLIMB)]
    for i in range(_NLIMB):
        for j in range(_NLIMB - i):
            hi, lo = _mul64(a[i], b[j])
            _add_ripple(out, i + j, lo)
            if i + j + 1 < _NLIMB:
                _add_ripple(out, i + j + 1, hi)
    return out


def _mul_small(a, k: int):
    """a * k for small non-negative python int k (fits u32)."""
    out = [jnp.zeros_like(a[0]) for _ in range(_NLIMB)]
    kk = _U64(k)
    for i in range(_NLIMB):
        hi, lo = _mul64(a[i], kk)
        _add_ripple(out, i, lo)
        if i + 1 < _NLIMB:
            _add_ripple(out, i + 1, hi)
    return out


def _rescale4(a, by: int):
    """a * 10**by, one x10 step at a time (by >= 0, small)."""
    for _ in range(by):
        a = _mul_small(a, 10)
    return a


_MAX256 = (1 << 255) - 1
_RESCALE_LIMIT = _MAX256 // 10


def _gt_const(a, const: int):
    """Unsigned a > const (python int)."""
    gt = jnp.zeros_like(a[0], dtype=bool)
    eq = jnp.ones_like(a[0], dtype=bool)
    for i in range(_NLIMB - 1, -1, -1):
        c = _U64((const >> (64 * i)) & 0xFFFFFFFFFFFFFFFF)
        gt = gt | (eq & (a[i] > c))
        eq = eq & (a[i] == c)
    return gt


def _rescale4_checked(a, by: int):
    for _ in range(by):
        if bool(jnp.any(_gt_const(a, _RESCALE_LIMIT))):
            raise Invalid("Rescale overflow in decimal256 divide")
        a = _mul_small(a, 10)
    return a


def _div4(n, d):
    """Unsigned 256/256 restoring division -> truncated quotient.
    256 static shift-subtract steps (fori_loop) over the vector."""
    zeros = [jnp.zeros_like(n[0]) for _ in range(_NLIMB)]

    def body(k, state):
        r = list(state[:_NLIMB])
        q = list(state[_NLIMB:])
        bitpos = (255 - k).astype(_U64)
        limb = bitpos // _U64(64)
        off = bitpos % _U64(64)
        bit = jnp.zeros_like(n[0])
        for i in range(_NLIMB):
            bit = jnp.where(limb == i, (n[i] >> off) & _U64(1), bit)
        # r = (r << 1) | bit
        for i in range(_NLIMB - 1, 0, -1):
            r[i] = (r[i] << _U64(1)) | (r[i - 1] >> _U64(63))
        r[0] = (r[0] << _U64(1)) | bit
        # compare r >= d (unsigned)
        lt = jnp.zeros_like(bit, dtype=bool)
        eq = jnp.ones_like(bit, dtype=bool)
        for i in range(_NLIMB - 1, -1, -1):
            lt = lt | (eq & (r[i] < d[i]))
            eq = eq & (r[i] == d[i])
        ge = ~lt
        # s = r - d
        borrow = jnp.zeros_like(bit)
        s = []
        for i in range(_NLIMB):
            t1 = r[i] - d[i]
            b1 = (r[i] < d[i]).astype(_U64)
            t2 = t1 - borrow
            b2 = (t1 < borrow).astype(_U64)
            s.append(t2)
            borrow = b1 | b2
        r = [jnp.where(ge, si, ri) for si, ri in zip(s, r)]
        g = ge.astype(_U64)
        for i in range(_NLIMB):
            q[i] = jnp.where(limb == i, q[i] | (g << off), q[i])
        return tuple(r) + tuple(q)

    state = jax.lax.fori_loop(
        0, 256, body, tuple(zeros) + tuple(zeros))
    return list(state[_NLIMB:])


# ---- public kernels (promotion rules mirror decimal.py, cap 76) ----

def _common_scale(a: Column, b: Column):
    sa, sb = a.dtype.scale, b.dtype.scale
    s = max(sa, sb)
    al = limbs256(a)
    bl = limbs256(b)
    if sa < s:
        al = _rescale4(al, s - sa)
    if sb < s:
        bl = _rescale4(bl, s - sb)
    prec = min(max(a.dtype.precision - sa, b.dtype.precision - sb)
               + s + 1, 76)
    return al, bl, dt.decimal256(prec, s)


def _validity(a: Column, b: Column):
    if a.validity is None:
        return b.validity
    if b.validity is None:
        return a.validity
    return a.validity & b.validity


def dec256_add(a: Column, b: Column) -> Column:
    al, bl, out_t = _common_scale(a, b)
    return pack256(_add4(al, bl), out_t, _validity(a, b))


def dec256_subtract(a: Column, b: Column) -> Column:
    al, bl, out_t = _common_scale(a, b)
    return pack256(_sub4(al, bl), out_t, _validity(a, b))


def dec256_negate(a: Column) -> Column:
    return pack256(_neg4(limbs256(a)), a.dtype, a.validity)


def dec256_compare(a: Column, b: Column, op: str) -> Column:
    al, bl, _ = _common_scale(a, b)
    lt, eq = _cmp4(al, bl)
    table = {
        "equal": eq, "not_equal": ~eq,
        "less": lt, "less_equal": lt | eq,
        "greater": ~(lt | eq), "greater_equal": ~lt,
    }
    if op not in table:
        raise Invalid(f"decimal256 compare: bad op {op}")
    return Column(table[op], dt.bool_, validity=_validity(a, b))


def dec256_multiply(a: Column, b: Column) -> Column:
    out_t = dt.decimal256(
        min(a.dtype.precision + b.dtype.precision + 1, 76),
        a.dtype.scale + b.dtype.scale)
    prod = _mul4(limbs256(a), limbs256(b))
    return pack256(prod, out_t, _validity(a, b))


def dec256_divide(a: Column, b: Column) -> Column:
    """Truncated-toward-zero quotient at the promoted scale
    (reference divide promotion: (p1+p2+1, max(4, s1+p2-s2+1)))."""
    p1, s1 = a.dtype.precision, a.dtype.scale
    p2, s2 = b.dtype.precision, b.dtype.scale
    s_out = max(4, s1 + p2 - s2 + 1)
    out_t = dt.decimal256(min(p1 + p2 + 1, 76), s_out)

    bl = limbs256(b)
    bzero = bl[0] == _U64(0)
    for l in bl[1:]:
        bzero = bzero & (l == _U64(0))
    vb = _validity(a, b)
    live_zero = bzero if vb is None else (bzero & vb)
    if bool(jnp.any(live_zero)):
        raise Invalid("Divide by zero")

    al = limbs256(a)
    ua, aneg = _abs4(al)
    ub, bneg = _abs4(bl)
    ua = _rescale4_checked(ua, s_out - s1 + s2)
    # dead rows: make divisor 1 to avoid an all-lanes 0/0 style stall
    ub[0] = jnp.where(bzero, _U64(1), ub[0])
    q = _div4(ua, ub)
    q = _neg4_if(q, aneg != bneg)
    return pack256(q, out_t, vb)


def dec256_to_float(a: Column) -> Column:
    ua, neg = _abs4(limbs256(a))
    mag = jnp.zeros(ua[0].shape, dtype=jnp.float64)
    for i in range(_NLIMB - 1, -1, -1):
        mag = mag * 18446744073709551616.0 + ua[i].astype(jnp.float64)
    val = jnp.where(neg, -mag, mag)
    return Column(val / (10.0 ** a.dtype.scale), dt.float64,
                  validity=a.validity)
