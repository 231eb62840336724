"""Differential tests for the batched DVS device path (ops/dvs_batch.py).

The batched path must reproduce the scalar-oracle Prophesee pipeline's
per-pixel event streams bit-for-bit (the reference's own determinism
contract for serial DVS processing, prophesee.rs:116-297).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from adder_jax.codec.encoder import EncoderOptions, EncoderType
from adder_jax.core.types import (
    Mode,
    PixelMultiMode,
    SourceCamera,
    TimeMode,
)
from adder_jax.ops import dvs_batch as B
from adder_jax.ops import integrate as K


def test_masked_interval_restores_unmasked_pixels():
    """Pixels outside the mask keep their state bit-for-bit, and emit no
    slots; pixels inside the mask evolve exactly like a dense interval
    over only those pixels."""
    rng = np.random.default_rng(5)
    n = 64
    p = K.TranscodeParams(
        mode=int(Mode.Continuous),
        multi_mode=int(PixelMultiMode.Collapse),
        ref_time=20,
        delta_t_max=40,
        c_thresh_max=10,
        c_increase_velocity=1,
    )
    state = K.init_state(n)
    # evolve everything a few steps so the state is non-trivial
    for step in range(3):
        inten = rng.integers(0, 256, n).astype(np.float32)
        state, *_ = K.integrate_interval(
            state, jnp.asarray(inten), jnp.asarray(inten.astype(np.int32)),
            jnp.full((n,), 20.0, jnp.float32), p,
        )
    mask = rng.random(n) < 0.5
    inten = rng.integers(0, 256, n).astype(np.float32)
    tvec = np.full(n, 20.0, np.float32)
    st2, sd, stt, sm, _ = B.masked_interval(
        state, jnp.asarray(inten), jnp.asarray(inten.astype(np.int32)),
        jnp.asarray(tvec), jnp.asarray(mask), p,
    )
    # unmasked pixels: identical state, no slots
    for a, b in zip(state, st2):
        a, b = np.asarray(a), np.asarray(b)
        if a.ndim == 0:
            continue
        cols = ~mask
        np.testing.assert_array_equal(a[..., cols], b[..., cols])
    assert not np.asarray(sm)[:, ~mask].any()

    # masked pixels: same as a dense interval over the submatrix
    sub_idx = np.flatnonzero(mask)
    sub_state = K.PixelState(*[
        jnp.asarray(np.asarray(a)[..., sub_idx]) if np.asarray(a).ndim else a
        for a in state
    ])
    st3, sd3, stt3, sm3, _ = K.integrate_interval(
        sub_state, jnp.asarray(inten[sub_idx]),
        jnp.asarray(inten[sub_idx].astype(np.int32)),
        jnp.asarray(tvec[sub_idx]), p,
    )
    for a, b in zip(st3, st2):
        a, b = np.asarray(a), np.asarray(b)
        if a.ndim == 0:
            continue
        np.testing.assert_array_equal(a, b[..., sub_idx])
    np.testing.assert_array_equal(np.asarray(sm3), np.asarray(sm)[:, sub_idx])
    np.testing.assert_array_equal(
        np.asarray(sd3)[np.asarray(sm3)],
        np.asarray(sd)[:, sub_idx][np.asarray(sm3)],
    )
    np.testing.assert_array_equal(
        np.asarray(stt3)[np.asarray(sm3)],
        np.asarray(stt)[:, sub_idx][np.asarray(sm3)],
    )


def _make_raw(path, w, h, events):
    with open(path, "wb") as f:
        f.write(b"% Height " + str(h).encode() + b"\n")
        f.write(b"% Width " + str(w).encode() + b"\n")
        f.write(bytes([0, 8]))
        rec = np.zeros((len(events), 2), dtype="<u4")
        for i, (t, x, y, p) in enumerate(events):
            rec[i, 0] = t
            rec[i, 1] = (p << 28) | (y << 14) | x
        f.write(rec.tobytes())


def _run(path, batched, multi_mode):
    from adder_jax.transcoder.prophesee import Prophesee

    src = Prophesee(20, str(path), batched=batched)
    out = open(str(path) + (".b" if batched else ".o"), "wb")
    src.write_out(
        SourceCamera.Dvs, TimeMode.AbsoluteT, multi_mode, None,
        EncoderType.Raw, EncoderOptions.default(src.plane), out,
    )
    streams = {}
    while True:
        try:
            arr = src.consume()
        except EOFError:
            break
        for x, y, d, t in zip(arr.x, arr.y, arr.d, arr.t):
            streams.setdefault((int(x), int(y)), []).append((int(d), int(t)))
    src.end_write_stream().close()
    return streams


@pytest.mark.parametrize(
    "multi_mode",
    [
        PixelMultiMode.Collapse,
        pytest.param(PixelMultiMode.Normal, marks=pytest.mark.slow),
    ],
)
def test_batched_matches_oracle(tmp_path, multi_mode):
    w, h = 14, 10
    rng = np.random.default_rng(3)
    events = []
    t = 10
    for _ in range(300):
        t += int(rng.integers(1, 1500))
        events.append(
            (t, int(rng.integers(0, w)), int(rng.integers(0, h)),
             int(rng.integers(0, 2)))
        )
    raw = tmp_path / "diff.raw"
    _make_raw(raw, w, h, events)

    oracle = _run(raw, batched=False, multi_mode=multi_mode)
    batched = _run(raw, batched=True, multi_mode=multi_mode)

    assert set(oracle) == set(batched)
    for key in sorted(oracle):
        assert oracle[key] == batched[key], (
            key, oracle[key][:6], batched[key][:6]
        )


@pytest.mark.parametrize(
    "mode_name",
    ["RawDavis", pytest.param("RawDvs", marks=pytest.mark.slow)],
)
def test_davis_batched_matches_oracle(mode_name):
    """Davis batched path (davis_event_interval + dense frame/gap calls)
    must reproduce the oracle's per-pixel event streams exactly."""
    from adder_jax.transcoder.davis import (
        ArrayDavisProvider,
        Davis,
        DavisPacket,
        DvsEvent,
        TranscoderMode,
    )
    from adder_jax.core.types import PlaneSize

    mode = TranscoderMode[mode_name]
    H, W = 12, 14
    plane = PlaneSize(W, H, 1)
    rng = np.random.default_rng(9)

    def frame():
        return rng.integers(40, 200, (H, W)).astype(np.uint8)

    def burst(t0, t1, n):
        evs = [
            DvsEvent(t=int(t), x=int(rng.integers(0, W)),
                     y=int(rng.integers(0, H)), on=bool(rng.integers(0, 2)))
            for t in sorted(rng.integers(t0, t1, n))
        ]
        return evs

    packets = [
        DavisPacket(frame(), 1000, 3000, burst(10, 900, 60)),
        DavisPacket(frame(), 6000, 8000, burst(3100, 5900, 80)),
        DavisPacket(None, 0, 0, burst(8100, 12000, 70)),
        DavisPacket(frame(), 15000, 17000, burst(12100, 14900, 50)),
    ]

    def run(batched):
        src = Davis(ArrayDavisProvider(packets, plane), ref_time=255,
                    mode=mode, batched=batched)
        streams = {}
        while True:
            try:
                arr = src.consume()
            except EOFError:
                break
            for x, y, d, t in zip(arr.x, arr.y, arr.d, arr.t):
                streams.setdefault((int(x), int(y)), []).append(
                    (int(d), int(t))
                )
        return streams

    oracle = run(False)
    batched = run(True)
    assert set(oracle) == set(batched)
    for key in sorted(oracle):
        assert oracle[key] == batched[key], (
            key, oracle[key][:6], batched[key][:6]
        )


def test_davis_framed_mode_batched():
    """Framed transcoder mode (APS frames only) through the batched path
    matches the oracle too (exercises _integrate_frame_batched alone)."""
    from adder_jax.transcoder.davis import (
        ArrayDavisProvider,
        Davis,
        DavisPacket,
        TranscoderMode,
    )
    from adder_jax.core.types import PlaneSize

    H, W = 10, 12
    plane = PlaneSize(W, H, 1)
    rng = np.random.default_rng(4)
    packets = [
        DavisPacket(rng.integers(20, 230, (H, W)).astype(np.uint8),
                    1000 + 5000 * i, 3000 + 5000 * i, [])
        for i in range(4)
    ]

    def run(batched):
        src = Davis(ArrayDavisProvider(packets, plane), ref_time=255,
                    mode=TranscoderMode.Framed, batched=batched)
        streams = {}
        while True:
            try:
                arr = src.consume()
            except EOFError:
                break
            for x, y, d, t in zip(arr.x, arr.y, arr.d, arr.t):
                streams.setdefault((int(x), int(y)), []).append(
                    (int(d), int(t))
                )
        return streams

    oracle = run(False)
    batched = run(True)
    assert oracle == batched and len(oracle) > 0

def test_compact_plan_matches_dense_and_scatter():
    """The compact planner mutates identical chain state to the dense
    planner (one shared math path), and the dense per-lane planes the scan
    engine consumes carry exactly the compact rows: each row lands at its
    (lane, pixel) with its gap and tick fields, and nothing else is set."""
    from adder_jax.ops import dvs_batch as B

    w, h = 14, 10
    n = w * h
    rng = np.random.default_rng(23)
    n_ev = 260
    ts = np.sort(rng.integers(5, 4000, n_ev)).astype(np.uint32)
    xs = rng.integers(0, w, n_ev).astype(np.uint16)
    ys = rng.integers(0, h, n_ev).astype(np.uint16)
    ps = rng.integers(0, 2, n_ev).astype(np.uint8)
    lt1 = np.full(n, 2, np.uint32)
    ln1 = np.full(n, np.log1p(128.0 / 255.0), np.float64)
    lt2, ln2 = lt1.copy(), ln1.copy()

    compact = B.plan_dvs_batch_compact(
        ts, xs, ys, ps, w, n, lt1, ln1, 0.02, 20
    )
    lanes = B.plan_dvs_batch(ts, xs, ys, ps, w, n, lt2, ln2, 0.02, 20)
    np.testing.assert_array_equal(lt1, lt2)
    np.testing.assert_array_equal(ln1, ln2)
    L = len(lanes)
    assert compact.n_lanes == L and L >= 2

    gi, gf, gt, gm, ti, tf, tt, tm = B.stack_lanes(lanes, L)
    want = {k: np.zeros((L, n), a.dtype) for k, a in
            zip("gi gf gt gm ti tf tt tm".split(), (gi, gf, gt, gm, ti, tf, tt, tm))}
    c = compact
    g, k = c.gap_on, c.tick_on
    want["gm"][c.lane[g], c.pix[g]] = True
    want["gf"][c.lane[g], c.pix[g]] = c.gap_fv[g]
    want["gi"][c.lane[g], c.pix[g]] = c.gap_int[g]
    want["gt"][c.lane[g], c.pix[g]] = c.gap_time[g]
    want["tm"][c.lane[k], c.pix[k]] = True
    want["tf"][c.lane[k], c.pix[k]] = c.tick_fv[k]
    want["ti"][c.lane[k], c.pix[k]] = c.tick_int[k]
    want["tt"][c.lane[k], c.pix[k]] = c.tick_time[k]
    for name, got in zip("gi gf gt gm ti tf tt tm".split(),
                         (gi, gf, gt, gm, ti, tf, tt, tm)):
        np.testing.assert_array_equal(got, want[name], err_msg=name)


def test_davis_compact_plan_matches_dense_and_scatter():
    """DAVIS twin of test_compact_plan_matches_dense_and_scatter."""
    from adder_jax.ops import dvs_batch as B

    w, h = 14, 10
    n = w * h
    rng = np.random.default_rng(31)
    n_ev = 240
    ts = np.sort(rng.integers(100, 9000, n_ev)).astype(np.int64)
    xs = rng.integers(0, w, n_ev).astype(np.uint16)
    ys = rng.integers(0, h, n_ev).astype(np.uint16)
    ons = rng.integers(0, 2, n_ev).astype(bool)
    lt1 = np.zeros(n, np.int64)
    ln1 = np.full(n, np.log1p(0.5), np.float64)
    lt2, ln2 = lt1.copy(), ln1.copy()

    compact = B.plan_davis_events_compact(
        ts, xs, ys, ons, w, n, lt1, ln1, 0.15, 255, 1.5
    )
    lanes = B.plan_davis_events(
        ts, xs, ys, ons, w, n, lt2, ln2, 0.15, 255, 1.5
    )
    np.testing.assert_array_equal(lt1, lt2)
    np.testing.assert_array_equal(ln1, ln2)
    # empty (all-inactive) lanes stay as zero rows on both paths
    L = len(lanes)
    assert compact.n_lanes == L and L >= 2

    fi_d, dt_d, fv_d, f8_d, m_d = B.stack_davis_lanes(lanes, L)
    c = compact
    for got, vals in ((fi_d, c.first_int), (dt_d, c.dt_ticks),
                      (fv_d, c.fval), (f8_d, c.fv8), (m_d, c.active)):
        want = np.zeros_like(got)
        want[c.lane, c.pix] = vals
        np.testing.assert_array_equal(got, want)


def test_native_dvs_planner_matches_numpy():
    """The C++ chain walk (ops/native/dvs_plan.cpp) must reproduce the
    numpy reference planner BIT-exactly: every compact-plan field, the
    lane-major row order, and the mutated last_t/last_ln chain state —
    across the drop rule (t < last_t), tick-only events (t == lt+1),
    gap+tick events, and both mid-clamp branches."""
    from adder_jax.ops import dvs_batch as B
    from adder_jax.ops.native_dvs_plan import plan_dvs_native

    w, h = 23, 17
    n = w * h
    rng = np.random.default_rng(41)
    n_ev = 3000
    ts = np.sort(rng.integers(0, 2500, n_ev)).astype(np.uint32)
    xs = rng.integers(0, w, n_ev).astype(np.uint16)
    ys = rng.integers(0, h, n_ev).astype(np.uint16)
    ps = rng.integers(0, 2, n_ev).astype(np.uint8)
    lt1 = rng.integers(0, 900, n).astype(np.uint32)  # some events drop
    # extreme ln values exercise the mid clamp on both branches
    ln1 = rng.uniform(-1.0, 1.2, n)
    ln1[rng.random(n) < 0.05] = 5.0
    lt2, ln2 = lt1.copy(), ln1.copy()

    theta = 0.3  # big step: frequent clamp crossings
    got = plan_dvs_native(ts, xs, ys, ps, w, lt1, ln1, theta, 20)
    if got is None:
        pytest.skip("native planner unavailable (no g++)")
    want = B.plan_dvs_batch_compact_np(
        ts, xs, ys, ps, w, n, lt2, ln2, theta, 20
    )
    for name, g, e in zip(want._fields, got, want):
        np.testing.assert_array_equal(g, e, err_msg=f"field {name}")
        assert g.dtype == e.dtype, (name, g.dtype, e.dtype)
    np.testing.assert_array_equal(lt1, lt2)
    np.testing.assert_array_equal(ln1, ln2)

    # empty batch
    e0 = plan_dvs_native(
        np.zeros(0, np.uint32), np.zeros(0, np.uint16),
        np.zeros(0, np.uint16), np.zeros(0, np.uint8), w, lt1, ln1,
        theta, 20,
    )
    assert e0 is not None and len(e0.pix) == 0


def test_native_davis_planner_matches_numpy():
    """DAVIS twin: the multiplicative ln step, the dt_us==t /
    negative-dt drop rule, unconditional last_t update, and both
    clamp_u8 branches, bit-exact vs the numpy reference."""
    from adder_jax.ops import dvs_batch as B
    from adder_jax.ops.native_dvs_plan import plan_davis_native

    w, h = 19, 13
    n = w * h
    rng = np.random.default_rng(43)
    n_ev = 2500
    ts = np.sort(rng.integers(1, 30000, n_ev)).astype(np.int64)
    xs = rng.integers(0, w, n_ev).astype(np.uint16)
    ys = rng.integers(0, h, n_ev).astype(np.uint16)
    ons = rng.integers(0, 2, n_ev).astype(bool)
    lt1 = np.zeros(n, np.int64)
    lt1[rng.random(n) < 0.3] = 50_000  # negative-dt drops
    # zeros keep dt_us == t (the uninitialized-pixel skip)
    ln1 = rng.uniform(0.01, 1.4, n)
    ln1[rng.random(n) < 0.05] = 2.5  # high-side clamp
    ln1[rng.random(n) < 0.05] = 1e-9  # low-side clamp via shrink
    lt2, ln2 = lt1.copy(), ln1.copy()

    got = plan_davis_native(
        ts, xs, ys, ons, w, lt1, ln1, 0.6, 255, 1.5
    )
    if got is None:
        pytest.skip("native planner unavailable (no g++)")
    want = B.plan_davis_events_compact_np(
        ts, xs, ys, ons, w, n, lt2, ln2, 0.6, 255, 1.5
    )
    for name, g, e in zip(want._fields, got, want):
        np.testing.assert_array_equal(g, e, err_msg=f"field {name}")
        assert g.dtype == e.dtype, (name, g.dtype, e.dtype)
    np.testing.assert_array_equal(lt1, lt2)
    np.testing.assert_array_equal(ln1, ln2)


def test_packed_carriers_roundtrip_and_masked_parity():
    """The single-upload masked-call forms — the (4, N) i32 array and the
    in-graph constant bootstrap — must produce identical states and events
    to the unpacked masked-interval dispatch."""
    import jax
    import jax.numpy as jnp

    from adder_jax.ops import dvs_batch as B
    from adder_jax.ops import integrate as I
    from adder_jax.core.types import Mode, TimeMode

    n = 23 * 11
    # masked-interval: unpacked vs packed vs const, identical state+events
    p = I.TranscodeParams(
        mode=int(Mode.Continuous), time_mode=int(TimeMode.AbsoluteT),
        ref_time=20, delta_t_max=40, c_thresh_max=10,
        c_increase_velocity=1,
    )
    st0 = I.init_state(n, depth=8)
    take = 1 << (n - 1).bit_length()
    inten = np.full(n, 128.0 * 20, np.float32)
    fv = np.full(n, 128, np.int32)
    tme = np.full(n, 20.0, np.float32)
    mask = np.ones(n, bool)

    f_u = B.make_masked_interval_compact(p, take)
    st_u, pix_u, t_u, n_u = f_u(
        st0, jnp.asarray(inten), jnp.asarray(fv), jnp.asarray(tme),
        jnp.asarray(mask),
    )
    pk = np.zeros((4, n), np.int32)
    pk[0] = inten.view(np.int32)
    pk[1] = fv
    pk[2] = tme.view(np.int32)
    pk[3] = mask
    f_p = B.make_masked_interval_compact_packed(p, take)
    st_p, pix_p, t_p, n_p = f_p(st0, jnp.asarray(pk))
    f_c = B.make_masked_interval_const(p, take, n, n, 128.0 * 20, 128, 20.0)
    st_c, [(pix_c, t_c, n_c)] = f_c(st0)
    assert int(n_u) == int(n_p) == int(n_c)
    k = int(n_u)
    np.testing.assert_array_equal(np.asarray(pix_u)[:k], np.asarray(pix_p)[:k])
    np.testing.assert_array_equal(np.asarray(pix_u)[:k], np.asarray(pix_c)[:k])
    np.testing.assert_array_equal(np.asarray(t_u)[:k], np.asarray(t_p)[:k])
    np.testing.assert_array_equal(np.asarray(t_u)[:k], np.asarray(t_c)[:k])
    for a, b in zip(jax.tree.leaves(st_u), jax.tree.leaves(st_p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(st_u), jax.tree.leaves(st_c)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_masked_interval_const_reps_and_void():
    """One reps=2 const masked call == two chained reps=1 calls (state and
    per-rep events), and the compact=False (void) variant chains the same
    state while skipping compaction entirely."""
    import jax

    n = 64
    p = K.TranscodeParams(
        mode=int(Mode.Continuous), time_mode=int(TimeMode.AbsoluteT),
        ref_time=20, delta_t_max=40, c_thresh_max=10,
        c_increase_velocity=1,
    )
    st0 = K.init_state(n, depth=8)
    take = 1 << (n - 1).bit_length()
    f1 = B.make_masked_interval_const(p, take, n, n, 128.0 * 20, 128, 20.0)
    st_a, [(pix_a, t_a, n_a)] = f1(st0)
    st_b, [(pix_b, t_b, n_b)] = f1(st_a)

    f2 = B.make_masked_interval_const(
        p, take, n, n, 128.0 * 20, 128, 20.0, reps=2
    )
    st_r, [(pix_1, t_1, n_1), (pix_2, t_2, n_2)] = f2(st0)
    assert int(n_1) == int(n_a) and int(n_2) == int(n_b)
    k1, k2 = int(n_a), int(n_b)
    np.testing.assert_array_equal(np.asarray(pix_1)[:k1], np.asarray(pix_a)[:k1])
    np.testing.assert_array_equal(np.asarray(t_1)[:k1], np.asarray(t_a)[:k1])
    np.testing.assert_array_equal(np.asarray(pix_2)[:k2], np.asarray(pix_b)[:k2])
    np.testing.assert_array_equal(np.asarray(t_2)[:k2], np.asarray(t_b)[:k2])
    for a, b in zip(jax.tree.leaves(st_r), jax.tree.leaves(st_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    f_void = B.make_masked_interval_const(
        p, take, n, n, 128.0 * 20, 128, 20.0, reps=2, compact=False
    )
    st_v, rep_outs = f_void(st0)
    assert all(int(nv) == 0 and pv.shape == (0,) for pv, _, nv in rep_outs)
    for a, b in zip(jax.tree.leaves(st_v), jax.tree.leaves(st_b)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # packed variant: compact=False chains the same state too
    inten = np.full(n, 128.0 * 20, np.float32)
    pk = np.zeros((4, n), np.int32)
    pk[0] = inten.view(np.int32)
    pk[1] = 128
    pk[2] = np.full(n, 20.0, np.float32).view(np.int32)
    pk[3] = 1
    fp = B.make_masked_interval_compact_packed(p, take, compact=False)
    st_pv, pix_pv, _, n_pv = fp(st0, jnp.asarray(pk))
    assert int(n_pv) == 0 and pix_pv.shape == (0,)
    for a, b in zip(jax.tree.leaves(st_pv), jax.tree.leaves(st_a)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
