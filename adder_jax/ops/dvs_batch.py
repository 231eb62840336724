"""Batched device path for sparse DVS-style sources (SURVEY P5).

The reference processes DVS/Prophesee events serially, one pixel at a time
(ref: adder-codec-rs/src/transcoder/source/prophesee.rs:116-297). This
module keeps those exact per-event semantics but runs the integration on
the dense device kernel:

- DVS events are bucketed host-side into per-pixel *lanes* (lane k = the
  k-th event a pixel sees within the batch, preserving the stream's
  per-pixel time order).
- The sequential log-intensity chain (gap integrate -> +-theta step ->
  one-tick integrate) is replayed lane by lane: host numpy updates the
  (float64) ln state exactly as the scalar loop does, and each lane issues
  two *masked* dense interval calls on the device - one for the held-
  intensity gap, one for the new-intensity source tick.
- `masked_interval` wraps `ops.integrate._interval_core` with a per-pixel
  mask: untouched pixels keep their state bit-for-bit (full snapshot
  select), so sparse batches never perturb idle pixels.

Per-pixel event streams are bit-identical to the scalar-oracle path (see
tests/test_dvs_batch.py); cross-pixel order is normalized by sort, the
same determinism contract the framed path uses.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import integrate as I

_f32 = jnp.float32
_i32 = jnp.int32

_MID_LN = float(np.log1p(128.0 / 255.0))


def masked_interval(
    state: I.PixelState,
    intensity: jax.Array,  # (N,) f32
    frame_val: jax.Array,  # (N,) i32
    time: jax.Array,  # (N,) f32 per-pixel ticks spanned
    mask: jax.Array,  # (N,) bool - pixels that integrate this call
    p: I.TranscodeParams,
):
    """One dense interval where only `mask` pixels integrate.

    `_interval_core` treats `time` elementwise (it only ever broadcasts
    it), so a per-pixel time vector drops straight in; masked-off pixels
    are restored from a snapshot afterwards, which also undoes any
    spurious pop/c_thresh movement their garbage inputs caused.
    """
    old = I._S.unstack(state)
    s = I._S.unstack(state)
    slots, running = I._interval_core(
        s, intensity, frame_val, time, p, ovf_mask=mask
    )

    m = mask
    for k in range(len(s.nd)):
        s.nd[k] = jnp.where(m, s.nd[k], old.nd[k])
        s.ni[k] = jnp.where(m, s.ni[k], old.ni[k])
        s.ndt[k] = jnp.where(m, s.ndt[k], old.ndt[k])
        s.bd[k] = jnp.where(m, s.bd[k], old.bd[k])
        s.bdt[k] = jnp.where(m, s.bdt[k], old.bdt[k])
    s.length = jnp.where(m, s.length, old.length)
    s.base_val = jnp.where(m, s.base_val, old.base_val)
    s.c_thresh = jnp.where(m, s.c_thresh, old.c_thresh)
    s.cic = jnp.where(m, s.cic, old.cic)
    s.lft = jnp.where(m, s.lft, old.lft)
    s.running_t = jnp.where(m, s.running_t, old.running_t)
    s.need_pop = jnp.where(m, s.need_pop, old.need_pop)
    s.dtm_reached = jnp.where(m, s.dtm_reached, old.dtm_reached)
    s.popped_dtm = jnp.where(m, s.popped_dtm, old.popped_dtm)
    # masked pixels can't overflow: resting nodes hold integ < 2^d, so a
    # zero-intensity zero-time step never fires their DEPTH-th node
    slot_d = jnp.stack([x[0] for x in slots]).astype(_i32)
    slot_t = jnp.stack([x[1] for x in slots]).astype(jnp.uint32)
    slot_m = jnp.stack([x[2] for x in slots]) & m
    rval, rhas = running
    return s.restack(), slot_d, slot_t, slot_m, (rval, rhas & m)


@functools.lru_cache(maxsize=32)
def make_masked_interval(p: I.TranscodeParams):
    return jax.jit(lambda st, i, fv, t, m: masked_interval(st, i, fv, t, m, p))


@functools.lru_cache(maxsize=32)
def make_masked_interval_compact(p: I.TranscodeParams, take: int):
    """masked_interval + in-graph event compaction: returns (state,
    pixd (take,) u32 wire-packed, t (take,) u32, n_ev). The caller fetches
    only the [0, n_ev) prefix instead of the dense (K, N) slot arrays.
    n_ev > take signals overflow (rerun with a doubled take from the
    pre-call state). Event order is (pixel, slot) — identical to
    slots_to_events."""

    def f(st, i, fv, t, m):
        st2, sd, stt, sm, _ = masked_interval(st, i, fv, t, m, p)
        pixd, tt, n = I._compact_interval(sd, stt, sm, take)
        return st2, pixd, tt, n

    return jax.jit(f)


@functools.lru_cache(maxsize=32)
def make_masked_interval_compact_packed(
    p: I.TranscodeParams, take: int, compact: bool = True
):
    """make_masked_interval_compact fed by ONE (4, N) i32 array
    [bits(intensity), fv, bits(time), mask] instead of four: one upload
    per masked call. f32 fields travel as i32 bit patterns (host
    `.view(np.int32)`) and are bitcast back in-graph.

    compact=False drops the event compaction (a take-sized top_k over the
    (K, N) slot keys) for void-output callers that only chain state."""

    def f(st, packed):
        bf = lambda r: jax.lax.bitcast_convert_type(packed[r], _f32)
        st2, sd, stt, sm, _ = masked_interval(
            st, bf(0), packed[1], bf(2), packed[3] != 0, p
        )
        if not compact:
            z = jnp.zeros((0,), jnp.uint32)
            return st2, z, z, jnp.int32(0)
        pixd, tt, n = I._compact_interval(sd, stt, sm, take)
        return st2, pixd, tt, n

    return jax.jit(f)


@functools.lru_cache(maxsize=32)
def make_masked_interval_const(
    p: I.TranscodeParams, take: int, n: int, n_real: int,
    intensity: float, fv: int, time: float,
    reps: int = 1, compact: bool = True,
):
    """All-real-pixels masked interval with CONSTANT arguments
    materialized in-graph — zero host->device transfers. This is the
    bootstrap shape (ref: prophesee.rs:150-162 — every pixel integrates
    the mid-gray 128 for one ref tick before the event stream starts).
    `n` is the padded state length; only pixels < n_real integrate.

    reps chains that constant sub-step in ONE jit (the bootstrap runs it
    twice; separate dispatches paid graph + dispatch overhead per rep).
    Returns (state, [per-rep (pixd, tt, n_ev)]). compact=False as in
    make_masked_interval_compact_packed."""

    def f(st):
        outs = []
        for _ in range(reps):
            st, sd, stt, sm, _ = masked_interval(
                st,
                jnp.full((n,), jnp.float32(intensity)),
                jnp.full((n,), jnp.int32(fv)),
                jnp.full((n,), jnp.float32(time)),
                jnp.arange(n, dtype=_i32) < jnp.int32(n_real),
                p,
            )
            if compact:
                outs.append(I._compact_interval(sd, stt, sm, take))
            else:
                z = jnp.zeros((0,), jnp.uint32)
                outs.append((z, z, jnp.int32(0)))
        return st, outs

    return jax.jit(f)


def _mid_clamp_vec(val: np.ndarray, ln: np.ndarray):
    """Vectorized utils.cv.mid_clamp_u8 (ref: transcoder/mod.rs clamp)."""
    bad = (val < 0.0) | (val > 255.0)
    return np.where(bad, 128.0, val), np.where(bad, _MID_LN, ln)


class DvsLane(NamedTuple):
    """Dense per-lane device inputs for one DVS event per pixel (two masked
    interval sub-steps: the held-intensity gap, then the source tick)."""

    gap_mask: np.ndarray  # (N,) bool
    gap_fv: np.ndarray  # (N,) i32
    gap_intensity: np.ndarray  # (N,) f32
    gap_time: np.ndarray  # (N,) f32
    tick_mask: np.ndarray
    tick_fv: np.ndarray
    tick_intensity: np.ndarray
    tick_time: np.ndarray


class DvsCompact(NamedTuple):
    """Compact (per-active-event) DVS lane plan: one row per source event
    that survives the out-of-order drop AND does device work (gap and/or
    tick sub-step), in lane-major order. plan_dvs_batch scatters these
    rows into the dense per-lane planes the scan engine consumes."""

    pix: np.ndarray  # (E,) int32 flat pixel index
    lane: np.ndarray  # (E,) int32 per-pixel occurrence number
    gap_on: np.ndarray  # (E,) bool
    gap_fv: np.ndarray  # (E,) int32
    gap_int: np.ndarray  # (E,) float32
    gap_time: np.ndarray  # (E,) float32
    tick_on: np.ndarray  # (E,) bool
    tick_fv: np.ndarray  # (E,) int32
    tick_int: np.ndarray  # (E,) float32
    tick_time: np.ndarray  # (E,) float32
    # factored gap fields: gap_int == f32(gap_val) * f32(gap_n) exactly,
    # and gap_time == f32(gap_n * ref) exactly
    gap_val: np.ndarray  # (E,) float32 held value (post mid-clamp)
    gap_n: np.ndarray  # (E,) int64 gap tick count (t - last_t - 1)

    @property
    def n_lanes(self) -> int:
        return int(self.lane.max()) + 1 if len(self.lane) else 0


def plan_dvs_batch_compact(
    ts: np.ndarray,
    xs: np.ndarray,
    ys: np.ndarray,
    ps: np.ndarray,
    width: int,
    n: int,
    last_t: np.ndarray,  # (N,) uint32, updated in place
    last_ln: np.ndarray,  # (N,) float64, updated in place
    theta: float,
    ref: int,
    val_cache: np.ndarray | None = None,  # (N,) f64 exp(last_ln) memo
) -> DvsCompact:
    """Lane planner for Prophesee DVS batches (ref: prophesee.rs:175-249).
    Dispatches to the native O(E) chain walk (ops/native/dvs_plan.cpp —
    same f64 libm math, bit-identical, suite-pinned) and falls back to the
    numpy reference implementation below. Mutates last_t / last_ln (and
    val_cache when given — see plan_dvs_native)."""
    from .native_dvs_plan import plan_dvs_native

    out = plan_dvs_native(ts, xs, ys, ps, width, last_t, last_ln, theta,
                          ref, val_cache)
    if out is not None:
        return out
    return plan_dvs_batch_compact_np(
        ts, xs, ys, ps, width, n, last_t, last_ln, theta, ref
    )


def plan_dvs_batch_compact_np(
    ts: np.ndarray,
    xs: np.ndarray,
    ys: np.ndarray,
    ps: np.ndarray,
    width: int,
    n: int,
    last_t: np.ndarray,  # (N,) uint32, updated in place
    last_ln: np.ndarray,  # (N,) float64, updated in place
    theta: float,
    ref: int,
) -> DvsCompact:
    """Numpy reference planner: bucket a time-ordered DVS batch into
    per-pixel lanes and replay the sequential ln-chain exactly as the
    scalar loop does (ref: prophesee.rs:175-249). Returns the compact
    plan; mutates last_t / last_ln to the post-batch state. All math is
    f64 host numpy — identical to the reference's serial chain (and to
    the scalar oracle path, which the parity tests pin)."""
    pix = ys.astype(np.int64) * width + xs.astype(np.int64)
    # lane index = per-pixel occurrence number (stream is time-ordered, so
    # per-pixel order is preserved by stable sort)
    order = np.argsort(pix, kind="stable")
    sp = pix[order]
    seg_start = np.ones(len(sp), bool)
    seg_start[1:] = sp[1:] != sp[:-1]
    # occurrence number within segment
    idx = np.arange(len(sp))
    seg_base = np.where(seg_start, idx, 0)
    np.maximum.accumulate(seg_base, out=seg_base)
    lane_sorted = idx - seg_base
    lane = np.empty(len(sp), np.int64)
    lane[order] = lane_sorted

    parts = []
    k_max = int(lane.max()) + 1 if len(lane) else 0
    for k in range(k_max):
        sel = lane == k
        i = pix[sel]
        t = ts[sel].astype(np.int64)
        pol = ps[sel]
        lt = last_t[i].astype(np.int64)
        keep = t >= lt  # ref: prophesee.rs:180 (skip out-of-order)

        gap_on = keep & (t > lt + 1)
        tick_on = keep & (t > lt)

        ln = last_ln[i]
        last_val = (np.exp(ln) - 1.0) * 255.0
        last_val, ln_c = _mid_clamp_vec(last_val, ln)
        gap_n = t - lt - 1

        # the mid-clamp of the held ln happens only on the gap branch
        # (ref: prophesee.rs:203-212 - the reassignment is branch-local)
        base_ln = np.where(gap_on, ln_c, ln)
        new_ln = np.where(keep, base_ln + np.where(pol == 0, -theta, theta), ln)
        new_val = (np.exp(new_ln) - 1.0) * 255.0
        new_val_c, new_ln_c = _mid_clamp_vec(new_val, new_ln)
        # the tick branch re-clamps and stores the clamped ln
        # (ref: prophesee.rs:243-247); without a tick the raw step persists
        ln_after = np.where(tick_on, new_ln_c, new_ln)

        last_ln[i] = np.where(keep, ln_after, last_ln[i])
        last_t[i] = np.where(keep, t, lt).astype(last_t.dtype)

        act = gap_on | tick_on
        # gap intensity is DEFINED as an f32 product (see DvsCompact):
        # identical roundings in the native planner
        lv32 = last_val.astype(np.float32)
        gn32 = gap_n.astype(np.float32)
        parts.append(
            (
                i[act].astype(np.int32),
                np.full(int(act.sum()), k, np.int32),
                gap_on[act],
                last_val[act].astype(np.int64).astype(np.int32),
                (lv32 * gn32)[act],
                (gap_n * ref)[act].astype(np.float32),
                tick_on[act],
                new_val_c[act].astype(np.int64).astype(np.int32),
                new_val_c[act].astype(np.float32),
                np.full(int(act.sum()), float(ref), np.float32),
                lv32[act],
                gap_n[act].astype(np.int64),
            )
        )
    if not parts:
        return DvsCompact(
            np.zeros(0, np.int32), np.zeros(0, np.int32),
            np.zeros(0, bool), np.zeros(0, np.int32),
            np.zeros(0, np.float32), np.zeros(0, np.float32),
            np.zeros(0, bool), np.zeros(0, np.int32),
            np.zeros(0, np.float32), np.zeros(0, np.float32),
            np.zeros(0, np.float32), np.zeros(0, np.int64),
        )
    return DvsCompact(
        *(np.concatenate([p[j] for p in parts]) for j in range(12))
    )


def plan_dvs_batch(
    ts: np.ndarray,
    xs: np.ndarray,
    ys: np.ndarray,
    ps: np.ndarray,
    width: int,
    n: int,
    last_t: np.ndarray,  # (N,) uint32, updated in place
    last_ln: np.ndarray,  # (N,) float64, updated in place
    theta: float,
    ref: int,
) -> list:
    """Dense-lane view of plan_dvs_batch_compact (one shared math path):
    returns a list of DvsLane with (N,) planes, for the XLA scan engine
    and per-lane masked calls. Mutates last_t / last_ln."""
    c = plan_dvs_batch_compact(
        ts, xs, ys, ps, width, n, last_t, last_ln, theta, ref
    )
    lanes = []
    for k in range(c.n_lanes):
        sel = c.lane == k
        i = c.pix[sel].astype(np.int64)
        gap_on, tick_on = c.gap_on[sel], c.tick_on[sel]

        def dense(vals, dtype, sub):
            out = np.zeros(n, dtype)
            out[i[sub]] = vals[sub]
            return out

        lanes.append(
            DvsLane(
                gap_mask=dense(gap_on, bool, gap_on),
                gap_fv=dense(c.gap_fv[sel], np.int32, gap_on),
                gap_intensity=dense(c.gap_int[sel], np.float32, gap_on),
                gap_time=dense(c.gap_time[sel], np.float32, gap_on),
                tick_mask=dense(tick_on, bool, tick_on),
                tick_fv=dense(c.tick_fv[sel], np.int32, tick_on),
                tick_intensity=dense(c.tick_int[sel], np.float32, tick_on),
                tick_time=dense(c.tick_time[sel], np.float32, tick_on),
            )
        )
    return lanes


def slots_to_events(slot_d, slot_t, slot_m, width: int):
    """Flatten one masked-interval's slots to (x, y, d, t) numpy arrays in
    (pixel, slot) order — the per-pixel chronological order."""
    m = np.asarray(slot_m)
    k_idx, pix = np.nonzero(m)  # slot-major; reorder to pixel-major
    order = np.argsort(pix * m.shape[0] + k_idx, kind="stable")
    k_idx, pix = k_idx[order], pix[order]
    d = np.asarray(slot_d)[k_idx, pix].astype(np.uint8)
    t = np.asarray(slot_t)[k_idx, pix]
    return (
        (pix % width).astype(np.uint16),
        (pix // width).astype(np.uint16),
        d,
        t,
    )


# --- scanned batch dispatch --------------------------------------------------


def _masked_substep(state, inten, fv, time, mask, p):
    """masked_interval body reshaped for lax.scan consumption."""
    st, sd, stt, sm, _ = masked_interval(state, inten, fv, time, mask, p)
    return st, sd, stt, sm


@functools.lru_cache(maxsize=32)
def make_dvs_scan_step(p: I.TranscodeParams, take: int):
    """One jitted dispatch per DVS batch: lax.scan over the lane axis, each
    lane running its two masked sub-steps (gap, then source tick) and
    compacting the emitted slots into a bounded event buffer — the same
    compact/merge machinery the framed chunk path uses
    (ops/integrate.py make_transcode_chunk).

    Inputs are (L, N)-stacked DvsLane fields; returns
    (state, buf_pixd (cap,), buf_t (cap,), total) with cap = 2*L*take.
    total > cap or any sub-step exceeding `take` signals overflow (caller
    falls back to the per-lane path)."""

    def step_fn(state, gi, gf, gt, gm, ti, tf, tt, tm):
        L = gi.shape[0]
        cap = 2 * L * take

        def lane_step(carry, xs):
            st, bufs, offset, max_sub = carry
            lgi, lgf, lgt, lgm, lti, ltf, ltt, ltm = xs
            for inten, fv, tme, msk in (
                (lgi, lgf, lgt, lgm),
                (lti, ltf, ltt, ltm),
            ):
                st, sd, stt_, sm = _masked_substep(st, inten, fv, tme, msk, p)
                take_i = min(take, sd.shape[0] * sd.shape[1])
                pixd_i, t_i, n_ev = I._compact_interval(sd, stt_, sm, take_i)
                max_sub = jnp.maximum(max_sub, n_ev)
                bufs, offset = I._merge_prefix(
                    bufs, offset, pixd_i, t_i, jnp.minimum(n_ev, take_i),
                    take_i,
                )
            return (st, bufs, offset, max_sub), None

        bufs0 = (
            jnp.zeros((cap,), jnp.uint32),
            jnp.zeros((cap,), jnp.uint32),
        )
        (state, bufs, total, max_sub), _ = jax.lax.scan(
            lane_step,
            (state, bufs0, jnp.zeros((), _i32), jnp.zeros((), _i32)),
            (gi, gf, gt, gm, ti, tf, tt, tm),
        )
        return state, bufs[0], bufs[1], total, max_sub

    return jax.jit(step_fn)


def stack_lanes(lanes: list, pad_to: int):
    """Stack DvsLane fields to (L, N) arrays, padding with no-op lanes."""
    n = len(lanes[0].gap_mask)
    L = pad_to

    def field(name, dtype):
        out = np.zeros((L, n), dtype)
        for i, lane in enumerate(lanes):
            out[i] = getattr(lane, name)
        return out

    return (
        field("gap_intensity", np.float32),
        field("gap_fv", np.int32),
        field("gap_time", np.float32),
        field("gap_mask", bool),
        field("tick_intensity", np.float32),
        field("tick_fv", np.int32),
        field("tick_time", np.float32),
        field("tick_mask", bool),
    )


def wire_to_events(pixd: np.ndarray, t: np.ndarray, width: int):
    """Decode the (pix<<8|d, t) wire pairs back to (x, y, d, t)."""
    pix = (pixd >> 8).astype(np.int64)
    d = (pixd & 0xFF).astype(np.uint8)
    return (
        (pix % width).astype(np.uint16),
        (pix // width).astype(np.uint16),
        d,
        t.astype(np.uint32),
    )


# --- DAVIS variant (ref: adder-codec-rs/src/transcoder/source/davis.rs) -----


def davis_event_interval(
    state: I.PixelState,
    first_integration: jax.Array,  # (N,) f32
    dt_ticks: jax.Array,  # (N,) f32
    frame_val: jax.Array,  # (N,) f32 - post-ln-step, clamped
    fv8: jax.Array,  # (N,) i32  - int(frame_val) (host-truncated)
    mask: jax.Array,  # (N,) bool
    p: I.TranscodeParams,
):
    """One DAVIS DVS event per masked pixel. The op order differs from the
    standard interval (davis.rs:235-465): [pop_top?, integrate, pop_top?]
    over the held intensity, THEN the contrast stage against the post-step
    log intensity. Composed from the same primitives as _interval_core."""
    old = I._S.unstack(state)
    s = I._S.unstack(state)
    inten = first_integration.astype(_f32)

    d0, t0, m0 = I._pop_top_event(s, inten, s.need_pop, p)
    I._integrate(s, inten, dt_ticks, p, ovf_mask=mask)
    d8, t8, m8 = I._pop_top_event(s, inten, s.need_pop, p)

    fv_f = frame_val.astype(_f32)
    bv, c = s.base_val, s.c_thresh
    changed = mask & (
        (fv8 < jnp.maximum(bv - c, 0)) | (fv8 > jnp.minimum(bv + c, 255))
    )
    pop_slots = I._pop_best_events(s, fv_f, changed, p)
    s.base_val = jnp.where(changed, fv8, s.base_val)
    d7, t7, m7 = I._set_d_for_continuous(s, fv_f, changed, p)

    m = mask
    for k in range(len(s.nd)):
        s.nd[k] = jnp.where(m, s.nd[k], old.nd[k])
        s.ni[k] = jnp.where(m, s.ni[k], old.ni[k])
        s.ndt[k] = jnp.where(m, s.ndt[k], old.ndt[k])
        s.bd[k] = jnp.where(m, s.bd[k], old.bd[k])
        s.bdt[k] = jnp.where(m, s.bdt[k], old.bdt[k])
    s.length = jnp.where(m, s.length, old.length)
    s.base_val = jnp.where(m, s.base_val, old.base_val)
    s.c_thresh = jnp.where(m, s.c_thresh, old.c_thresh)
    s.cic = jnp.where(m, s.cic, old.cic)
    s.lft = jnp.where(m, s.lft, old.lft)
    s.running_t = jnp.where(m, s.running_t, old.running_t)
    s.need_pop = jnp.where(m, s.need_pop, old.need_pop)
    s.dtm_reached = jnp.where(m, s.dtm_reached, old.dtm_reached)
    s.popped_dtm = jnp.where(m, s.popped_dtm, old.popped_dtm)

    # per-pixel chronological slot order for this event
    slots = [(d0, t0, m0), (d8, t8, m8)] + list(pop_slots) + [(d7, t7, m7)]
    slot_d = jnp.stack([x[0] for x in slots]).astype(_i32)
    slot_t = jnp.stack([x[1] for x in slots]).astype(jnp.uint32)
    slot_m = jnp.stack([x[2] for x in slots]) & m
    return s.restack(), slot_d, slot_t, slot_m


@functools.lru_cache(maxsize=32)
def make_davis_event_interval(p: I.TranscodeParams):
    return jax.jit(
        lambda st, fi, dt, fv, f8, m: davis_event_interval(
            st, fi, dt, fv, f8, m, p
        )
    )


def _clamp_u8_vec(val: np.ndarray, ln: np.ndarray):
    """Vectorized utils.cv.clamp_u8."""
    lo = val <= 0.0
    hi = val > 255.0
    v = np.where(lo, 0.0, np.where(hi, 255.0, val))
    l2 = np.where(lo, 0.0, np.where(hi, float(np.log1p(1.0)), ln))
    return v, l2


class DavisLane(NamedTuple):
    mask: np.ndarray  # (N,) bool
    first_integration: np.ndarray  # (N,) f32
    dt_ticks: np.ndarray  # (N,) f32
    frame_val: np.ndarray  # (N,) f32
    fv8: np.ndarray  # (N,) i32


class DavisCompact(NamedTuple):
    """Compact (per-active-event) DAVIS lane plan, lane-major: one device
    sub-step per row (plan_davis_events densifies it per lane)."""

    pix: np.ndarray  # (E,) int32
    lane: np.ndarray  # (E,) int32
    active: np.ndarray  # (E,) bool (True for real rows; padding is False)
    first_int: np.ndarray  # (E,) float32
    dt_ticks: np.ndarray  # (E,) float32
    fval: np.ndarray  # (E,) float32
    fv8: np.ndarray  # (E,) int32

    @property
    def n_lanes(self) -> int:
        return int(self.lane.max()) + 1 if len(self.lane) else 0


def plan_davis_events_compact(
    ts: np.ndarray,  # event times, microseconds
    xs: np.ndarray,
    ys: np.ndarray,
    ons: np.ndarray,  # polarity booleans
    width: int,
    n: int,
    last_t: np.ndarray,  # (N,) int64 microseconds, updated in place
    last_ln: np.ndarray,  # (N,) float64, updated in place
    dvs_c: float,
    ref: int,
    ticks_per_micro: float,
    val_cache: np.ndarray | None = None,  # (N,) f64 exp(last_ln) memo
) -> DavisCompact:
    """Lane planner for DAVIS DVS events (ref: davis.rs:235-465).
    Dispatches to the native O(E) chain walk (ops/native/dvs_plan.cpp,
    bit-identical, suite-pinned) with the numpy reference implementation
    below as fallback. Mutates last_t / last_ln (and val_cache when
    given)."""
    from .native_dvs_plan import plan_davis_native

    out = plan_davis_native(
        ts, xs, ys, ons, width, last_t, last_ln, dvs_c, ref,
        ticks_per_micro, val_cache,
    )
    if out is not None:
        return out
    return plan_davis_events_compact_np(
        ts, xs, ys, ons, width, n, last_t, last_ln, dvs_c, ref,
        ticks_per_micro,
    )


def plan_davis_events_compact_np(
    ts: np.ndarray,  # event times, microseconds
    xs: np.ndarray,
    ys: np.ndarray,
    ons: np.ndarray,  # polarity booleans
    width: int,
    n: int,
    last_t: np.ndarray,  # (N,) int64 microseconds, updated in place
    last_ln: np.ndarray,  # (N,) float64, updated in place
    dvs_c: float,
    ref: int,
    ticks_per_micro: float,
) -> DavisCompact:
    """Numpy reference planner for DAVIS DVS events, replaying
    integrate_dvs_events' sequential ln chain (ref: davis.rs:235-465; the
    ln step is MULTIPLICATIVE: last_ln *= exp(+-c)). Compact: one row per
    event that does device work; all math f64 host numpy (one shared path
    — the dense plan_davis_events is a view over this)."""
    pix = ys.astype(np.int64) * width + xs.astype(np.int64)
    order = np.argsort(pix, kind="stable")
    sp = pix[order]
    seg_start = np.ones(len(sp), bool)
    seg_start[1:] = sp[1:] != sp[:-1]
    idx = np.arange(len(sp))
    seg_base = np.where(seg_start, idx, 0)
    np.maximum.accumulate(seg_base, out=seg_base)
    lane_of = np.empty(len(sp), np.int64)
    lane_of[order] = idx - seg_base

    parts = []
    k_max = int(lane_of.max()) + 1 if len(lane_of) else 0
    for k in range(k_max):
        sel = lane_of == k
        i = pix[sel]
        t = ts[sel].astype(np.int64)
        on = ons[sel].astype(bool)
        lt = last_t[i]
        dt_us = t - lt
        active = ~((dt_us == t) | (dt_us < 0))  # ref: davis.rs:300-305

        ln = last_ln[i]
        last_val = (np.exp(ln) - 1.0) * 255.0
        dt_ticks = dt_us.astype(np.float64) * ticks_per_micro
        first_int = np.maximum(last_val / ref * dt_ticks, 0.0)

        ln2 = ln * np.exp(np.where(on, dvs_c, -dvs_c))
        fval = (np.exp(ln2) - 1.0) * 255.0
        fval, ln2 = _clamp_u8_vec(fval, ln2)

        last_ln[i] = np.where(active, ln2, ln)
        last_t[i] = t  # set on the skip path too (davis.rs:303)

        parts.append(
            (
                i[active].astype(np.int32),
                np.full(int(active.sum()), k, np.int32),
                np.ones(int(active.sum()), bool),
                first_int[active].astype(np.float32),
                dt_ticks[active].astype(np.float32),
                fval[active].astype(np.float32),
                fval[active].astype(np.int64).astype(np.int32),
            )
        )
    if not parts:
        return DavisCompact(
            np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros(0, bool),
            np.zeros(0, np.float32), np.zeros(0, np.float32),
            np.zeros(0, np.float32), np.zeros(0, np.int32),
        )
    return DavisCompact(
        *(np.concatenate([p[j] for p in parts]) for j in range(7))
    )


def plan_davis_events(
    ts: np.ndarray,
    xs: np.ndarray,
    ys: np.ndarray,
    ons: np.ndarray,
    width: int,
    n: int,
    last_t: np.ndarray,
    last_ln: np.ndarray,
    dvs_c: float,
    ref: int,
    ticks_per_micro: float,
) -> list:
    """Dense-lane view of plan_davis_events_compact for the XLA scan
    engine. Mutates last_t / last_ln."""
    c = plan_davis_events_compact(
        ts, xs, ys, ons, width, n, last_t, last_ln, dvs_c, ref,
        ticks_per_micro,
    )
    lanes = []
    for k in range(c.n_lanes):
        sel = c.lane == k
        i = c.pix[sel].astype(np.int64)

        def dense(vals, dtype):
            out = np.zeros(n, dtype)
            out[i] = vals
            return out

        lanes.append(
            DavisLane(
                mask=dense(np.ones(len(i), bool), bool),
                first_integration=dense(c.first_int[sel], np.float32),
                dt_ticks=dense(c.dt_ticks[sel], np.float32),
                frame_val=dense(c.fval[sel], np.float32),
                fv8=dense(c.fv8[sel], np.int32),
            )
        )
    return lanes


@functools.lru_cache(maxsize=32)
def make_davis_scan_step(p: I.TranscodeParams, take: int):
    """All DAVIS event lanes of a packet in one device dispatch (scan over
    the lane axis + per-lane compaction; see make_dvs_scan_step)."""

    def step_fn(state, fi, dt, fv, f8, m):
        L = fi.shape[0]
        cap = L * take

        def lane_step(carry, xs):
            st, bufs, offset, max_sub = carry
            lfi, ldt, lfv, lf8, lm = xs
            st, sd, stt_, sm = davis_event_interval(
                st, lfi, ldt, lfv, lf8, lm, p
            )
            take_i = min(take, sd.shape[0] * sd.shape[1])
            pixd_i, t_i, n_ev = I._compact_interval(sd, stt_, sm, take_i)
            max_sub = jnp.maximum(max_sub, n_ev)
            bufs, offset = I._merge_prefix(
                bufs, offset, pixd_i, t_i, jnp.minimum(n_ev, take_i), take_i
            )
            return (st, bufs, offset, max_sub), None

        bufs0 = (
            jnp.zeros((cap,), jnp.uint32),
            jnp.zeros((cap,), jnp.uint32),
        )
        (state, bufs, total, max_sub), _ = jax.lax.scan(
            lane_step,
            (state, bufs0, jnp.zeros((), _i32), jnp.zeros((), _i32)),
            (fi, dt, fv, f8, m),
        )
        return state, bufs[0], bufs[1], total, max_sub

    return jax.jit(step_fn)


def stack_davis_lanes(lanes: list, pad_to: int):
    """Stack DavisLane fields to (L, N), padding with no-op lanes."""
    n = len(lanes[0].mask)

    def field(name, dtype):
        out = np.zeros((pad_to, n), dtype)
        for i, lane in enumerate(lanes):
            out[i] = getattr(lane, name)
        return out

    return (
        field("first_integration", np.float32),
        field("dt_ticks", np.float32),
        field("frame_val", np.float32),
        field("fv8", np.int32),
        field("mask", bool),
    )
