"""Exact f32 contractions against one-hot matrices via 3-term bfloat16
splitting.

A DEFAULT-precision f32 ``dot_general`` may multiply at reduced
precision on an accelerator (TF32 on NVIDIA tensor cores, bf16 passes on
other matrix units), which would turn an exact one-hot gather or scatter
into a rounded one (~1e-3 relative error on O(1) data).  The portable
exact spelling splits the f32 data operand into three terms of at most 8
significant bits each (top/middle/bottom mantissa slices; each residual
is exact in f32) and accumulates three products:

    x = hi + mid + lo  (exactly),  x @ G = hi@G + mid@G + lo@G.

Each term is exact in bf16, TF32 and f32, and {0, +-1} one-hots are exact
in all three, so every product is exact and the result is exact to f32
rounding of the accumulation.  The slices are cut with bit masks, not by
a round trip through bf16: XLA's GPU compiler may drop an f32 -> bf16 ->
f32 round trip as excess precision, which folds the split back into the
plain f32 dot (measured on an H100: windowed vs gather drifted 4.7e-2
after 60 bunny frames).  Cost: three products per contraction (or one,
with ``stack_axis``).

Used by ``solvers/general``'s windowed backends.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _top8(x):
    """``x`` cut to its 8 leading significant bits (sign and exponent
    kept): an f32 value that bf16 and TF32 both hold exactly."""
    bits = lax.bitcast_convert_type(x, jnp.uint32)
    return lax.bitcast_convert_type(bits & jnp.uint32(0xFFFF0000),
                                    jnp.float32)


def split3(x):
    """Split f32 ``x`` into three bf16 terms whose (f32) sum is ``x``.
    Each subtraction is exact in f32: 24 significant bits = 8 + 8 + 8."""
    hi = _top8(x)
    r1 = x - hi
    mid = _top8(r1)
    lo = r1 - mid
    return (hi.astype(jnp.bfloat16), mid.astype(jnp.bfloat16),
            lo.astype(jnp.bfloat16))


def dot_oh(lhs, rhs, dimension_numbers, *, split="lhs", parts=None,
           stack_axis=None):
    """``lax.dot_general`` of f32 data against a one-hot matrix, exact at
    any matmul precision.

    ``split`` names the f32 DATA operand ("lhs"/"rhs"); the other operand
    is the one-hot (bf16 or f32 {0, +-1} — exact either way, a reduced-
    precision multiply of a {0, +-1} one-hot is lossless).  ``parts``
    optionally supplies a
    precomputed split of the data operand so one ``split3`` can be shared
    across several dots (the 4-endpoint bending gathers): either the
    3-tuple, or — with ``stack_axis`` — the already-concatenated array.

    ``stack_axis`` names a FREE (non-contracted, non-batch) axis of the
    data operand along which the three bf16 parts are concatenated so the
    whole compensation rides ONE dot; the matching output axis is
    slice-summed afterwards.  Without ``stack_axis`` the fallback is
    three accumulated dots.
    Both spellings sum hi+mid+lo in the same order — bitwise identical
    results."""
    data = lhs if split == "lhs" else rhs
    if stack_axis is not None:
        if parts is None:
            parts = split3(data)
        stacked = (parts if not isinstance(parts, tuple)
                   else jnp.concatenate(parts, axis=stack_axis))
        (c_l, c_r), (b_l, b_r) = dimension_numbers
        if split == "lhs":
            free = [a for a in range(lhs.ndim)
                    if a not in c_l and a not in b_l]
            out_axis = len(b_l) + free.index(stack_axis)
            out = lax.dot_general(stacked, rhs, dimension_numbers,
                                  preferred_element_type=jnp.float32)
        else:
            lfree = [a for a in range(lhs.ndim)
                     if a not in c_l and a not in b_l]
            rfree = [a for a in range(rhs.ndim)
                     if a not in c_r and a not in b_r]
            out_axis = len(b_l) + len(lfree) + rfree.index(stack_axis)
            out = lax.dot_general(lhs, stacked, dimension_numbers,
                                  preferred_element_type=jnp.float32)
        size = data.shape[stack_axis]
        acc = None
        for i in range(3):
            t = lax.slice_in_dim(out, i * size, (i + 1) * size,
                                 axis=out_axis)
            acc = t if acc is None else acc + t
        return acc
    if parts is None:
        parts = split3(data)
    acc = None
    for p in parts:
        a, b = (p, rhs) if split == "lhs" else (lhs, p)
        t = lax.dot_general(a, b, dimension_numbers,
                            preferred_element_type=jnp.float32)
        acc = t if acc is None else acc + t
    return acc
