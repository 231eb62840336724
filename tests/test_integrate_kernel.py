"""Differential tests: dense JAX kernel vs scalar oracle, bit-exact.

Random intensity walks over many pixels and intervals, across all mode
combinations, must produce byte-identical event streams to the oracle
(which is itself pinned to the reference's unit tests).
"""

import numpy as np
import pytest

import jax

from adder_jax.core.types import Coord, Mode, PixelMultiMode, TimeMode
from adder_jax.ops import integrate as K
from adder_jax.transcoder import pixel_oracle as O


def run_oracle(frames, params: K.TranscodeParams, c_thresh0, init_frame=None):
    """frames: (T, N) uint8. Returns per-(interval, pixel) event list."""
    T, N = frames.shape
    pixels = []
    for i in range(N):
        px = O.PixelArena(1.0, Coord(i % 65535, i // 65535, None))
        px.set_time_mode(TimeMode(params.time_mode))
        px.c_thresh = c_thresh0
        if init_frame is not None:
            fv = int(init_frame[i])
            px.arena[0].d = (
                O.get_d_from_intensity(float(fv)) if fv > 0 else 128
            )
            px.base_val = fv
        pixels.append(px)
    out = []
    for t in range(T):
        for i in range(N):
            buf = []
            O.integrate_for_px(
                pixels[i],
                int(frames[t, i]),
                float(frames[t, i]),
                float(params.ref_time),
                buf,
                Mode(params.mode),
                PixelMultiMode(params.multi_mode),
                params.delta_t_max,
                params.ref_time,
                params.c_thresh_max,
                params.c_increase_velocity,
            )
            for e in buf:
                out.append((t, i, e.d, e.t))
    return out


def run_kernel(frames, params: K.TranscodeParams, c_thresh0, init_frame=None, pack=4):
    T, N = frames.shape
    state = K.init_state(N, c_thresh=c_thresh0)
    if init_frame is not None:
        state = K.set_initial_d(state, jax.numpy.asarray(init_frame))
    fn = K.make_transcode_chunk(params, event_cap=T * N * K.K_SLOTS, pack=pack)
    fr = jax.numpy.asarray(frames, jax.numpy.uint8)
    run0 = jax.numpy.zeros((N,), jax.numpy.uint8)
    (
        state, pixd, t, t16, t_base, t16_ok, total, per_int, runnings, pack_max
    ) = fn(state, fr, jax.numpy.float32(params.ref_time), run0)
    if pack < K.K_SLOTS and int(pack_max) > pack:
        return run_kernel(frames, params, c_thresh0, init_frame, pack=K.K_SLOTS)
    total = int(total)
    assert int(state.overflow) == 0
    pixd = np.asarray(pixd)[:total]
    if bool(t16_ok):
        t = np.asarray(t16)[:total].astype(np.uint32) + np.uint32(int(t_base))
    else:
        t = np.asarray(t)[:total]
    pix = (pixd >> 8).astype(np.int64)
    d = (pixd & 0xFF).astype(np.uint8)
    per_int = np.asarray(per_int)
    out = []
    k = 0
    for ti in range(T):
        for _ in range(per_int[ti]):
            out.append((ti, int(pix[k]), int(d[k]) & 0xFF, int(t[k])))
            k += 1
    return out


# Normal-mode tails are slow-tier (compile-heavy; full matrix via
# `pytest tests/` — see pytest.ini); Collapse pins stay fast
CASES = [
    pytest.param(
        dict(mode=Mode.FramePerfect, multi=PixelMultiMode.Normal,
             tm=TimeMode.AbsoluteT),
        marks=pytest.mark.slow,
    ),
    dict(mode=Mode.FramePerfect, multi=PixelMultiMode.Collapse, tm=TimeMode.AbsoluteT),
    dict(mode=Mode.FramePerfect, multi=PixelMultiMode.Collapse, tm=TimeMode.DeltaT),
    pytest.param(
        dict(mode=Mode.Continuous, multi=PixelMultiMode.Normal,
             tm=TimeMode.AbsoluteT),
        marks=pytest.mark.slow,
    ),
    dict(mode=Mode.Continuous, multi=PixelMultiMode.Collapse, tm=TimeMode.AbsoluteT),
    pytest.param(
        dict(mode=Mode.Continuous, multi=PixelMultiMode.Normal,
             tm=TimeMode.DeltaT),
        marks=pytest.mark.slow,
    ),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{Mode(c['mode']).name}-{PixelMultiMode(c['multi']).name}-{TimeMode(c['tm']).name}")
@pytest.mark.parametrize("crf_like", [(0, 10, 0), (7, 2, 10)], ids=["lossless", "lossy"])
def test_kernel_matches_oracle(case, crf_like):
    c_max, c_vel, c0 = crf_like
    params = K.TranscodeParams(
        mode=int(case["mode"]),
        multi_mode=int(case["multi"]),
        time_mode=int(case["tm"]),
        ref_time=255,
        delta_t_max=255 * 8,
        c_thresh_max=c_max,
        c_increase_velocity=max(c_vel, 1),
    )
    rng = np.random.default_rng(hash((case["mode"], case["multi"], case["tm"], c_max)) % 2**32)
    N, T = 64, 40
    # random walk intensities with occasional jumps + flat and zero pixels
    frames = np.zeros((T, N), dtype=np.uint8)
    cur = rng.integers(0, 256, N)
    for t in range(T):
        step = rng.integers(-6, 7, N)
        jump = rng.random(N) < 0.05
        cur = np.where(jump, rng.integers(0, 256, N), np.clip(cur + step, 0, 255))
        frames[t] = cur
    frames[:, 0] = 128  # constant pixel
    frames[:, 1] = 0  # dark pixel
    frames[:, 2] = 255  # saturated pixel

    init = frames[0]
    got = run_kernel(frames, params, c0, init_frame=init)
    want = run_oracle(frames, params, c0, init_frame=init)
    assert len(got) == len(want), (len(got), len(want))
    mism = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert not mism, (mism[:5], [got[i] for i in mism[:3]], [want[i] for i in mism[:3]])


def test_exact_div_uint24_matches_exact_div():
    """The FramePerfect integer-domain divider must be correctly rounded
    (== exact_div == f64-rounded-to-f32) over its whole contract domain:
    integer a in [0, 2^24), integer b in [1, 2^12)."""
    import jax.numpy as jnp

    from adder_jax.ops import numerics

    rng = np.random.default_rng(21)
    a = rng.integers(0, 1 << 24, 200_000).astype(np.float32)
    b = rng.integers(1, 1 << 12, 200_000).astype(np.float32)
    # adversarial band: small quotients and near-tie magnitudes
    a[:4096] = np.repeat(np.arange(1, 65), 64).astype(np.float32)
    b[:4096] = np.tile(np.arange(1, 65), 64).astype(np.float32)
    got = np.asarray(numerics.exact_div_uint24(jnp.asarray(a), jnp.asarray(b)))
    ref = np.asarray(numerics.exact_div(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    # and both equal the f64 quotient rounded to f32
    f64 = (a.astype(np.float64) / b.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(ref.view(np.uint32), f64.view(np.uint32))
