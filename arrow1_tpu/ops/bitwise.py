"""Bitwise kernels: bit_wise_and/or/xor/not + shift_left/right (+checked).

Reference: compute/kernels/scalar_arithmetic.cc bitwise section. Integer
elementwise maps. Shift semantics match the reference: an out-of-range shift
amount (< 0 or >= bit width) leaves the operand unchanged in the
unchecked variant and raises in the checked one.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..errors import Invalid
from ..registry import register_function
from .common import common_type, intersect_validity, result_column, unpack


def _bitwise_binary(name, fn):
    def exec_fn(args, options, ctx):
        out_t = common_type(args)
        if not out_t.is_integer:
            raise Invalid(f"{name}: expects integers")
        (x, y), validities, n = unpack(args, out_t)
        return result_column(fn(x, y), out_t,
                             intersect_validity(validities, n), n)

    return exec_fn


register_function("bit_wise_and", "scalar", 2)(
    _bitwise_binary("bit_wise_and", jnp.bitwise_and))
register_function("bit_wise_or", "scalar", 2)(
    _bitwise_binary("bit_wise_or", jnp.bitwise_or))
register_function("bit_wise_xor", "scalar", 2)(
    _bitwise_binary("bit_wise_xor", jnp.bitwise_xor))


def _bit_wise_not_exec(args, options, ctx):
    (a,) = args
    if not a.dtype.is_integer:
        raise Invalid("bit_wise_not: expects integers")
    (x,), validities, n = unpack(args)
    return result_column(jnp.bitwise_not(x), a.dtype,
                         intersect_validity(validities, n), n)


register_function("bit_wise_not", "scalar", 1)(_bit_wise_not_exec)


def _shift(name, left: bool, checked: bool):
    def exec_fn(args, options, ctx):
        out_t = common_type(args)
        if not out_t.is_integer:
            raise Invalid(f"{name}: expects integers")
        (x, y), validities, n = unpack(args, out_t)
        validity = intersect_validity(validities, n)
        # numeric_limits<T>::digits — value bits only (sign bit excluded)
        bits = out_t.byte_width * 8 - (1 if out_t.is_signed_integer else 0)
        oob = (y < 0) | (y >= bits)
        live_oob = oob if validity is None else (oob & validity)
        if checked and bool(jnp.any(live_oob)):
            raise Invalid(f"{name}: shift amount must be >= 0 and less "
                          f"than precision of type")
        ys = jnp.where(oob, 0, y)
        r = jnp.where(oob, x,
                      (x << ys) if left else (x >> ys))
        return result_column(r, out_t, validity, n)

    return exec_fn


register_function("shift_left", "scalar", 2)(
    _shift("shift_left", True, False))
register_function("shift_left_checked", "scalar", 2)(
    _shift("shift_left_checked", True, True))
register_function("shift_right", "scalar", 2)(
    _shift("shift_right", False, False))
register_function("shift_right_checked", "scalar", 2)(
    _shift("shift_right_checked", False, True))
