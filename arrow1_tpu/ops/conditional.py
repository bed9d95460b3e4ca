"""Conditional/selection kernels: case_when, choose, replace_with_mask,
inverse_permutation.

Reference: compute/kernels/scalar_if_else.cc (CaseWhen/Choose) +
vector_replace.cc (ReplaceWithMask) + vector_swizzle.cc
(InversePermutation). All lane-parallel selects/gathers — the device form of
branching.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from ..kernels.blockscan import cumsum_blocked, scan_blocked

from .. import dtypes as dt
from .common import collapse_validity
from ..column import Column
from ..errors import IndexError_, Invalid
from ..registry import register_function
from ..table import RecordBatch


def _as_len(col, n):
    """Broadcast a length-1 Column or a Scalar to n rows."""
    from ..datum import Scalar

    if isinstance(col, Scalar):
        t = col.dtype
        if getattr(t, "is_decimal", False):
            from .decimal import decimal_planes

            lo, hi = decimal_planes(col, t, n)
            validity = None if col.is_valid else jnp.zeros(n, jnp.bool_)
            return Column(lo, t, validity=validity, data2=hi)
        if t.is_binary:
            from ..column import Dictionary
            import numpy as np

            v = (col.dictionary.values[int(col.value)]
                 if col.dictionary is not None else col.value)
            validity = None if col.is_valid else jnp.zeros(n, jnp.bool_)
            return Column(jnp.zeros(n, jnp.int32), t, validity=validity,
                          dictionary=Dictionary(np.array([v],
                                                         dtype=object)))
        validity = None if col.is_valid else jnp.zeros(n, jnp.bool_)
        return Column(jnp.full(n, col.value, t.physical_dtype()), t,
                      validity=validity)
    if isinstance(col, Column) and col.length == 1 and n != 1:
        data = jnp.broadcast_to(col.data, (n,))
        validity = None if col.validity is None else \
            jnp.broadcast_to(col.validity, (n,))
        data2 = None
        if col.data2 is not None:
            shape = ((n,) if col.data2.ndim == 1
                     else (n,) + col.data2.shape[1:])
            data2 = jnp.broadcast_to(col.data2, shape)
        return Column(data, col.dtype, validity=validity,
                      dictionary=col.dictionary, data2=data2)
    return col


def _unify_if_binary(cols):
    """Remap dict codes onto one merged dictionary when they differ."""
    if not cols or not getattr(cols[0].dtype, "is_binary", False):
        return cols
    dicts = [c.dictionary for c in cols]
    if all(d is dicts[0] for d in dicts):
        return cols
    from .dictionary import unify_dictionaries

    merged, d = unify_dictionaries(cols)
    pos = 0
    out = []
    for c in cols:
        out.append(Column(merged[pos:pos + c.length], c.dtype,
                          validity=c.validity, dictionary=d))
        pos += c.length
    return out


def _case_when_exec(args, options, ctx):
    """case_when(cond_struct, *cases): row takes the first case whose
    condition field is true; the trailing extra case (if len(cases) ==
    nconds+1) is the else; otherwise null."""
    cond = args[0]
    if not isinstance(cond, RecordBatch):
        raise Invalid("case_when: first argument must be a struct of bools")
    cases = list(args[1:])
    nconds = len(cond.columns)
    if len(cases) not in (nconds, nconds + 1):
        raise Invalid("case_when: need one case per condition "
                      "(+ optional else)")
    n = cond.num_rows
    cases = [_as_len(c, n) for c in cases]
    has_else = len(cases) == nconds + 1
    out_dtype = cases[0].dtype
    cases = _unify_if_binary(cases)
    is_dec = getattr(out_dtype, "is_decimal", False)
    if has_else:
        out = cases[-1].data
        out2 = cases[-1].data2 if is_dec else None
        out_valid = cases[-1].mask()
    else:
        out = jnp.zeros_like(cases[0].data)
        out2 = jnp.zeros_like(cases[0].data2) if is_dec else None
        out_valid = jnp.zeros(n, jnp.bool_)
    for j in reversed(range(nconds)):
        cj = cond.columns[j]
        fire = cj.data & cj.mask()
        out = jnp.where(fire, cases[j].data, out)
        if is_dec:
            f2 = fire if out2.ndim == 1 else fire[:, None]
            out2 = jnp.where(f2, cases[j].data2, out2)
        out_valid = jnp.where(fire, cases[j].mask(), out_valid)
    return Column(out, out_dtype,
                  validity=collapse_validity(out_valid),
                  dictionary=cases[0].dictionary, data2=out2)


register_function("case_when", "scalar", -1)(_case_when_exec)


def _choose_exec(args, options, ctx):
    """choose(indices, *values): per-row select among the value columns."""
    idx = args[0]
    vals = list(args[1:])
    if not vals:
        raise Invalid("choose: need at least one value")
    n = idx.length
    vals = _unify_if_binary([_as_len(v, n) for v in vals])
    stacked = jnp.stack([v.data for v in vals])          # [k, n]
    vmask = jnp.stack([v.mask() for v in vals])
    i = jnp.clip(idx.data.astype(jnp.int32), 0, len(vals) - 1)
    rows = jnp.arange(n)
    out = stacked[i, rows]
    out_valid = vmask[i, rows] & idx.mask()
    data2 = None
    if vals[0].data2 is not None:
        d2 = jnp.stack([v.data2 for v in vals])
        data2 = d2[i, rows] if d2.ndim == 2 else d2[i, rows, :]
    return Column(out, vals[0].dtype,
                  validity=collapse_validity(out_valid),
                  dictionary=vals[0].dictionary, data2=data2)


register_function("choose", "scalar", -1)(_choose_exec)


def _replace_with_mask_exec(args, options, ctx):
    """Rows where mask is true take successive replacement values;
    a null mask slot nulls the row (reference: vector_replace.cc)."""
    a, mask, repl = args
    a, repl = _unify_if_binary([a, repl])
    fire = mask.data & mask.mask()
    ri = jnp.clip(cumsum_blocked(fire) - 1, 0, max(repl.length - 1, 0))
    out = jnp.where(fire, repl.data[ri], a.data)
    out_valid = jnp.where(fire, repl.mask()[ri], a.mask()) & mask.mask()
    data2 = None
    if a.data2 is not None:
        data2 = jnp.where(fire, repl.data2[ri], a.data2)
    return Column(out, a.dtype,
                  validity=collapse_validity(out_valid),
                  dictionary=a.dictionary, data2=data2)


register_function("replace_with_mask", "scalar", 3)(_replace_with_mask_exec)


@dataclasses.dataclass
class InversePermutationOptions:
    """Reference: api_vector.h InversePermutationOptions."""
    max_index: object = None
    output_type: object = None


def _inverse_permutation_exec(args, options: InversePermutationOptions,
                              ctx):
    """out[input[i]] = i, last occurrence wins, null inputs claim no slot,
    unclaimed slots are null (reference: vector_swizzle.cc
    InversePermutation). Scatter-free: stable sort by value, then
    searchsorted locates each output slot's run — the run's last element
    is the winning index."""
    (a,) = args
    options = options or InversePermutationOptions()
    if not a.dtype.is_integer:
        raise Invalid("inverse_permutation: expects integer indices")
    n = a.length
    m = n if options.max_index is None else int(options.max_index) + 1
    vals = a.data.astype(jnp.int64)
    valid = a.mask()
    if bool(jnp.any(valid & ((vals < 0) | (vals >= m)))):
        raise IndexError_("inverse_permutation: index out of bounds "
                          f"(valid range [0, {m}))")
    key = vals if a.validity is None else \
        jnp.where(a.validity, vals, jnp.int64(m))  # nulls sort past the end
    perm = jnp.argsort(key, stable=True)
    sk = key[perm]
    slots = jnp.arange(m, dtype=jnp.int64)
    left = jnp.searchsorted(sk, slots, side="left")
    right = jnp.searchsorted(sk, slots, side="right")
    hit = right > left
    idx = perm[jnp.clip(right - 1, 0, max(n - 1, 0))] if n else \
        jnp.zeros(m, jnp.int64)
    out_t = options.output_type
    out_t = a.dtype if out_t is None else (
        out_t if isinstance(out_t, dt.DataType) else dt.from_arrow(out_t))
    out = jnp.where(hit, idx, 0).astype(out_t.physical_dtype())
    return Column(out, out_t,
                  validity=None if bool(jnp.all(hit)) else hit)


register_function("inverse_permutation", "vector", 1,
                  InversePermutationOptions)(_inverse_permutation_exec)
