"""Portable exact-rounding float32 primitives for XLA backends.

XLA lowers f32 division to reciprocal-based approximations on the CPU and
the GPU (measured on an H100: ~30% of random quotients are 1 ulp off IEEE).
The reference implementation (Rust on x86, `divss`) is correctly rounded,
and ADDER event timestamps are produced by `u32(dt + time * prop)` where
`prop = (2^d - integration) / intensity` — a 1-ulp error there shifts event
timestamps by one tick and breaks bit-parity.

`exact_div` recovers the correctly rounded quotient from the hardware
approximation with two Dekker double-float residual-correction steps:
pure f32 mul/add, no f64, no FMA requirement. Residual window after two
steps is ~2^-69 relative, i.e. misrounding probability ~2^-45 per division.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_f32 = jnp.float32
_SPLIT = 4097.0  # 2^12 + 1, Veltkamp split constant (exact in f32)

# Anti-FMA-contraction fence. Neither optimization_barrier nor a bitcast
# round-trip survives to LLVM: XLA erases both before instruction
# selection, and LLVM then contracts an fmul feeding an fadd/fsub into an
# FMA (on the CPU for single-use products; NVPTX fuses readily) — flipping
# the last ulp on rounding near-ties and breaking bit-parity with the
# (separately rounded) reference. The robust fence is `min(x, F32_MAX)`:
# XLA cannot fold it (it differs at +inf, and +inf only occurs in lanes the
# kernel masks out anyway), so the product is consumed by a min, never
# directly by the add — no contraction pattern exists. chip_smoke.py holds
# the GPU's event streams byte-identical to the CPU's on every run.
_F32_MAX = float(jnp.finfo(jnp.float32).max)


def barrier(x):
    return jax.lax.optimization_barrier(x)


def product_fence(x):
    """Fence for a rounded f32 product about to feed an add/sub (see module
    note above): min(x, F32_MAX) breaks the fmul->fadd adjacency so LLVM
    cannot contract it into an FMA. Only +inf changes (to F32_MAX), and the
    callers' inf lanes are masked out. Not for values where +inf must be
    preserved (use barrier there)."""
    return barrier(jnp.minimum(x, _f32(_F32_MAX)))


def _two_product(x, y):
    """Dekker product: (p, e) with p + e == x*y exactly (f32)."""
    p = (x * y).astype(_f32)
    cx = (_SPLIT * x).astype(_f32)
    xh = (cx - (cx - x)).astype(_f32)
    xl = (x - xh).astype(_f32)
    cy = (_SPLIT * y).astype(_f32)
    yh = (cy - (cy - y)).astype(_f32)
    yl = (y - yh).astype(_f32)
    e = (((xh * yh - p) + xh * yl + xl * yh) + xl * yl).astype(_f32)
    return p, e


def _refine(q, a, b):
    """One residual-correction step: q + (a - q*b)/b."""
    p, e = _two_product(q, b)
    r = ((a - p) - e).astype(_f32)  # a - q*b, exact to ~ulp(r)
    return (q + r / b).astype(_f32)


def _exponent(x):
    bits = jax.lax.bitcast_convert_type(x, jnp.int32)
    return ((bits >> 23) & 0xFF) - 127


def _pow2(e):
    """2^e as f32 for e in [-126, 127]."""
    return jax.lax.bitcast_convert_type((e + 127) << 23, _f32)


def exact_div_uint24(a, b):
    """Correctly-rounded f32 a/b on the FramePerfect framed domain:
    INTEGER-valued f32 a in [0, 2^24) and integer b in [1, 2^12).

    Equal to exact_div there, at roughly half the ops: operands cannot
    overflow the Veltkamp split, so no exponent normalization; and b needs
    no split (a 12-bit mantissa half times b < 2^12 is exact), so each
    residual costs one one-sided split instead of a full Dekker product.
    Out-of-domain inputs (b == 0 etc.) fall back to the hardware result,
    mirroring exact_div's masked-lane contract."""
    a = a.astype(_f32)
    b = b.astype(_f32)
    q0 = barrier((a / b).astype(_f32))

    def residual(q):
        # r = a - q*b exactly: split q into 12+12 mantissa bits; both
        # halves times b (< 2^12) are exact f32 products
        c = (_SPLIT * q).astype(_f32)
        qh = (c - (c - q)).astype(_f32)
        ql = (q - qh).astype(_f32)
        p = (q * b).astype(_f32)
        e = ((qh * b - p) + ql * b).astype(_f32)
        return ((a - p) - e).astype(_f32)

    # one residual-correction step makes q faithful (< 1 ulp) even if the
    # hardware approximation was a couple of ulps off
    q1 = (q0 + residual(q0) / b).astype(_f32)
    r1 = residual(q1)
    qbits = jax.lax.bitcast_convert_type(q1, jnp.int32)
    step = jnp.where(r1 > 0, 1, -1).astype(jnp.int32)
    qn = jax.lax.bitcast_convert_type(qbits + step, _f32)
    rn = residual(qn)
    take_n = jnp.abs(rn) < jnp.abs(r1)
    tie = jnp.abs(rn) == jnp.abs(r1)
    n_even = (qbits + step) & 1 == 0
    q = jnp.where(r1 == 0, q1, jnp.where(take_n | (tie & n_even), qn, q1))

    ok = jnp.isfinite(q0) & (a >= 0) & (b >= 1)
    return jnp.where(ok, q, q0)


def exact_div(a, b):
    """Correctly-rounded f32 a/b (within ~2^-45 misround probability).

    Inputs are exponent-normalized to [1, 2) so the Veltkamp splits cannot
    overflow even for 2^127-scale operands (D_SHIFT values). Division by
    zero / non-normal cases fall back to the hardware result (the ADDER
    kernel masks those lanes separately).
    """
    a = a.astype(_f32)
    b = b.astype(_f32)
    q0 = barrier((a / b).astype(_f32))

    sign_bits = (
        jax.lax.bitcast_convert_type(a, jnp.int32)
        ^ jax.lax.bitcast_convert_type(b, jnp.int32)
    ) & jnp.int32(-0x80000000)
    a = jnp.abs(a)
    b = jnp.abs(b)
    ea = _exponent(a)
    eb = _exponent(b)
    ma = (a * _pow2(-ea)).astype(_f32)  # in [1, 2)
    mb = (b * _pow2(-eb)).astype(_f32)
    qm = barrier((ma / mb).astype(_f32))
    qm = _refine(qm, ma, mb)  # now faithful (< 1 ulp)

    # round-to-nearest correction: compare residuals of qm and its neighbor
    # in the direction of the residual; exact at ties (both residuals are
    # representable b*ulp/2 multiples there), round-to-even on equality.
    p1, e1 = _two_product(qm, mb)
    r1 = ((ma - p1) - e1).astype(_f32)
    qbits = jax.lax.bitcast_convert_type(qm, jnp.int32)
    step = jnp.where(r1 > 0, 1, -1).astype(jnp.int32)
    qn = jax.lax.bitcast_convert_type(qbits + step, _f32)
    p2, e2 = _two_product(qn, mb)
    r2 = ((ma - p2) - e2).astype(_f32)
    take_n = jnp.abs(r2) < jnp.abs(r1)
    tie = jnp.abs(r2) == jnp.abs(r1)
    n_even = (qbits + step) & 1 == 0
    qm = jnp.where(take_n | (tie & n_even), qn, qm)
    qm = jnp.where(r1 == 0, jax.lax.bitcast_convert_type(qbits, _f32), qm)

    e = ea - eb
    q = (qm * _pow2(jnp.clip(e, -126, 127))).astype(_f32)
    q = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(q, jnp.int32) | sign_bits, _f32
    )

    ok = (
        jnp.isfinite(q0)
        & (a > 0)
        & (b > 0)
        & (e >= -125)
        & (e <= 126)
        & (ea >= -126)
        & (eb >= -126)
    )
    return jnp.where(ok, q, q0)
