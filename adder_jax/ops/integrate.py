"""Dense ADDER integration kernel: the whole pixel plane as one state machine.

Dense, data-parallel redesign of the reference's per-pixel arena walk
(ref: adder-codec-rs/src/transcoder/event_pixel_tree.rs:317-479 and
transcoder/source/video.rs:1317-1380 `integrate_for_px`).

Design: the per-pixel recursive arena becomes struct-of-arrays state over the
flattened H*W*C plane. The reference's loop index `idx` increments uniformly
per iteration, so the arena walk unrolls into DEPTH masked elementwise steps
— no per-pixel dynamic control flow in the hot loop. D-table lookups
(D_SHIFT) are replaced by f32 exponent-bit manipulation, exact for powers of
two.

Performance notes:
- Inside one interval the DEPTH node planes are handled as independent (N,)
  vectors (Python lists), not as a stacked (DEPTH, N) array: chained
  dynamic-update-slices on the stacked form made XLA materialize full-state
  copies per update. The stacked PixelState layout survives only at the
  interval boundary (restack = the one mandatory state write).
- All real arithmetic is float32 and division is correctly rounded
  (ops/numerics.py), so events are bit-identical to the scalar oracle
  (adder_jax.transcoder.pixel_oracle) and the Rust-reference semantics.

Per input interval each pixel emits events into K fixed slots:
  slot 0        pop_top_event (pre-integration, dtm/D_MAX overflow)
  slots 1..=D   pop_best_events (contrast change drain, up to DEPTH nodes)
  slot D+1      set_d_for_continuous D_EMPTY filler (Continuous mode only)
  slot D+2      pop_top_event (post-integration)
Flattened (pixel, slot)-major this reproduces the reference's single-thread
event order exactly (per-pixel chronological, raster across pixels — the
reference's own determinism contract, src/bin/adder_simulproc.rs:188).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.types import Mode, PixelMultiMode, TimeMode
from . import numerics
from .numerics import exact_div

DEPTH = 8  # reference SmallVec inline capacity is 6 but can heap-grow
K_SLOTS = DEPTH + 3  # pop_top, DEPTH pop_best nodes, set_d filler, pop_top

F32_EPSILON = float(np.float32(1.1920929e-07))
D_MAX = 127
D_ZERO_INTEGRATION = 128
D_EMPTY = 255

_i32 = jnp.int32
_f32 = jnp.float32
_u32 = jnp.uint32


class PixelState(NamedTuple):
    """Dense transcoder state over N pixels (SoA; node arrays are (DEPTH, N))."""

    node_d: jax.Array  # int32 (DEPTH, N), 0..=128
    node_integ: jax.Array  # f32 (DEPTH, N)
    node_dt: jax.Array  # f32 (DEPTH, N)
    best_d: jax.Array  # int32 (DEPTH, N), -1 = no best event
    best_dt: jax.Array  # f32 (DEPTH, N)
    length: jax.Array  # int32 (N,), 1..=DEPTH
    base_val: jax.Array  # int32 (N,), u8 range
    c_thresh: jax.Array  # int32 (N,)
    c_increase_counter: jax.Array  # int32 (N,)
    last_fired_t: jax.Array  # f32 (N,)
    running_t: jax.Array  # f32 (N,)
    need_pop: jax.Array  # bool (N,)
    dtm_reached: jax.Array  # bool (N,)
    popped_dtm: jax.Array  # bool (N,)
    overflow: jax.Array  # int32 scalar: arena-depth overflow counter


class TranscodeParams(NamedTuple):
    """Per-run integration parameters (Python scalars, baked into the jit)."""

    mode: int = int(Mode.FramePerfect)
    multi_mode: int = int(PixelMultiMode.Collapse)
    time_mode: int = int(TimeMode.AbsoluteT)
    ref_time: int = 255
    delta_t_max: int = 7650
    c_thresh_max: int = 7
    c_increase_velocity: int = 7
    view_mode: int = 0  # FramedViewMode: 0 Intensity, 1 D, 2 DeltaT, 3 SAE


class _S:
    """Unstacked per-interval working state: DEPTH lists of (N,) vectors."""

    __slots__ = (
        "nd", "ni", "ndt", "bd", "bdt", "length", "base_val", "c_thresh",
        "cic", "lft", "running_t", "need_pop", "dtm_reached", "popped_dtm",
        "overflow",
    )

    @classmethod
    def unstack(cls, st: PixelState) -> "_S":
        s = cls()
        depth = st.node_d.shape[0]  # arena depth baked into the state
        s.nd = [st.node_d[i] for i in range(depth)]
        s.ni = [st.node_integ[i] for i in range(depth)]
        s.ndt = [st.node_dt[i] for i in range(depth)]
        s.bd = [st.best_d[i] for i in range(depth)]
        s.bdt = [st.best_dt[i] for i in range(depth)]
        s.length = st.length
        s.base_val = st.base_val
        s.c_thresh = st.c_thresh
        s.cic = st.c_increase_counter
        s.lft = st.last_fired_t
        s.running_t = st.running_t
        s.need_pop = st.need_pop
        s.dtm_reached = st.dtm_reached
        s.popped_dtm = st.popped_dtm
        s.overflow = st.overflow
        return s

    def restack(self) -> PixelState:
        return PixelState(
            node_d=jnp.stack(self.nd),
            node_integ=jnp.stack(self.ni),
            node_dt=jnp.stack(self.ndt),
            best_d=jnp.stack(self.bd),
            best_dt=jnp.stack(self.bdt),
            length=self.length,
            base_val=self.base_val,
            c_thresh=self.c_thresh,
            c_increase_counter=self.cic,
            last_fired_t=self.lft,
            running_t=self.running_t,
            need_pop=self.need_pop,
            dtm_reached=self.dtm_reached,
            popped_dtm=self.popped_dtm,
            overflow=self.overflow,
        )

    def tail_pick(self, arrs, zero):
        """arrs[length-1] per pixel via unrolled selects."""
        out = jnp.full_like(arrs[0], zero)
        for s in range(len(arrs)):
            out = jnp.where(self.length - 1 == s, arrs[s], out)
        return out


def init_state(
    n_pixels: int, c_thresh: int = 10, depth: int = DEPTH
) -> PixelState:
    """Fresh state as in PixelArena::new(1.0, coord) (ref: :69-87) — node d
    = floor(log2(1.0)) = 0, c_thresh 10, c_increase_counter 1.

    `depth` bounds the arena (the reference's SmallVec grows unbounded);
    every kernel derives its unroll from the state's shape, so deeper
    arenas (e.g. DVS gap cascades, ops/dvs_batch.py) just pass a larger
    depth here. Depth overflow is counted in `state.overflow`."""
    z = lambda shape, dt: jnp.zeros(shape, dt)
    return PixelState(
        node_d=z((depth, n_pixels), _i32),
        node_integ=z((depth, n_pixels), _f32),
        node_dt=z((depth, n_pixels), _f32),
        best_d=jnp.full((depth, n_pixels), -1, _i32),
        best_dt=z((depth, n_pixels), _f32),
        length=jnp.ones((n_pixels,), _i32),
        base_val=z((n_pixels,), _i32),
        c_thresh=jnp.full((n_pixels,), c_thresh, _i32),
        c_increase_counter=jnp.ones((n_pixels,), _i32),
        last_fired_t=z((n_pixels,), _f32),
        running_t=z((n_pixels,), _f32),
        need_pop=z((n_pixels,), jnp.bool_),
        dtm_reached=z((n_pixels,), jnp.bool_),
        popped_dtm=z((n_pixels,), jnp.bool_),
        overflow=jnp.zeros((), _i32),
    )


def pad_state_depth(state: PixelState, new_depth: int) -> PixelState:
    """Grow the arena depth of an existing state (zero nodes, best_d = -1).

    Used when resuming a checkpoint taken with shallower arenas (the
    reference's SmallVec inline capacity is 6)."""
    old = state.node_d.shape[0]
    if new_depth <= old:
        return state
    n = state.node_d.shape[1]
    pad = new_depth - old

    def z(dt):
        return jnp.zeros((pad, n), dt)

    return state._replace(
        node_d=jnp.concatenate([state.node_d, z(_i32)]),
        node_integ=jnp.concatenate([state.node_integ, z(_f32)]),
        node_dt=jnp.concatenate([state.node_dt, z(_f32)]),
        best_d=jnp.concatenate(
            [state.best_d, jnp.full((pad, n), -1, _i32)]
        ),
        best_dt=jnp.concatenate([state.best_dt, z(_f32)]),
    )


def set_initial_d(state: PixelState, frame_val: jax.Array) -> PixelState:
    """Seed D and base_val from the first frame (ref: video.rs:780-801)."""
    d0 = _d_from_intensity(frame_val.astype(_f32))
    return state._replace(
        node_d=state.node_d.at[0].set(d0),
        base_val=frame_val.astype(_i32),
    )


# --- f32 exponent-bit helpers (replace D_SHIFT table lookups) ---------------


def _d_from_intensity(x: jax.Array) -> jax.Array:
    """floor(log2(x)) via exponent bits, 128 below 1.0, clamped to D_MAX.

    Matches the reference's trunc-then-leading_zeros (ref: event_pixel_tree.rs
    :482-499): for x >= 1, floor(log2(trunc(x))) == unbiased f32 exponent.
    """
    bits = jax.lax.bitcast_convert_type(x.astype(_f32), _i32)
    e = ((bits >> 23) & 0xFF) - 127
    return jnp.where(x < 1.0, D_ZERO_INTEGRATION, jnp.minimum(e, D_MAX))


def _dshift_f32(d: jax.Array) -> jax.Array:
    """2^d as f32 for d in 0..=127; 0.0 for d >= 128 (table semantics)."""
    pow2 = jax.lax.bitcast_convert_type(
        (jnp.minimum(d, D_MAX) + 127) << 23, _f32
    )
    return jnp.where(d >= 128, _f32(0.0), pow2)


def _fence(x: jax.Array) -> jax.Array:
    return numerics.product_fence(x)


def _as_u32(x: jax.Array) -> jax.Array:
    """Rust `f32 as u32`: truncate toward zero, saturating, NaN -> 0."""
    x = jnp.nan_to_num(x, nan=0.0, posinf=4294967295.0, neginf=0.0)
    x = jnp.clip(x, 0.0, 4294967295.0)
    return x.astype(_u32)


# --- event time conversion (ref: event_pixel_tree.rs:113-137) ---------------


def _emit_abs(lft, dt_f32, p: TranscodeParams):
    """delta_t -> event t + updated last_fired_t. Returns (t_u32, new_lft)."""
    if p.time_mode != int(TimeMode.AbsoluteT):
        return _as_u32(dt_f32), lft
    dtt = (dt_f32 + lft).astype(_f32)
    new_lft = dtt
    if p.mode == int(Mode.FramePerfect):
        lf_u = _as_u32(dtt)
        ref = _u32(p.ref_time)
        rounded = jnp.where(lf_u % ref == 0, lf_u, (lf_u // ref + 1) * ref)
        new_lft = rounded.astype(_f32)
    return _as_u32(dtt), new_lft


def _emit_abs_continuous(lft, dt_f32, p: TranscodeParams):
    """delta_t_to_absolute_t with mode forced Continuous (set_d filler path,
    ref: event_pixel_tree.rs:303)."""
    if p.time_mode != int(TimeMode.AbsoluteT):
        return _as_u32(dt_f32), lft
    dtt = (dt_f32 + lft).astype(_f32)
    return _as_u32(dtt), dtt


# --- pop_top_event (ref: event_pixel_tree.rs:139-210) -----------------------


def _pop_top_event(s: _S, next_i, mask, p: TranscodeParams):
    """Vectorized root pop. Returns (ev_d, ev_t, mask)."""
    n0_d, n0_integ, n0_dt, n0_best = s.nd[0], s.ni[0], s.ndt[0], s.bd[0]
    has_best = n0_best >= 0

    zero_case = ~has_best & (n0_integ == 0.0) & (n0_dt > 0.0)
    synth_case = ~has_best & ~zero_case

    # synthesized best event (frame-perfect near-dtm path, ref: :161-196)
    synth_d = jnp.where(
        n0_integ < 1.0, D_ZERO_INTEGRATION, _d_from_intensity(n0_integ)
    )
    ev_d = jnp.where(
        zero_case, D_ZERO_INTEGRATION, jnp.where(has_best, n0_best, synth_d)
    )
    ev_dt = jnp.where(has_best, s.bdt[0], n0_dt)

    t, new_lft = _emit_abs(s.lft, ev_dt, p)
    if p.time_mode == int(TimeMode.AbsoluteT):  # new_lft == lft otherwise
        s.lft = jnp.where(mask, new_lft, s.lft)

    # arena shift-left for best & synth cases; zero case leaves arena in place
    shift = mask & ~zero_case
    for i in range(len(s.nd) - 1):
        s.nd[i] = jnp.where(shift, s.nd[i + 1], s.nd[i])
        s.ni[i] = jnp.where(shift, s.ni[i + 1], s.ni[i])
        s.ndt[i] = jnp.where(shift, s.ndt[i + 1], s.ndt[i])
        s.bd[i] = jnp.where(shift, s.bd[i + 1], s.bd[i])
        s.bdt[i] = jnp.where(shift, s.bdt[i + 1], s.bdt[i])

    new_d0 = _d_from_intensity(next_i)
    # synth case result: arena[0] = PixelNode(next_i), length = 1
    ms = mask & synth_case
    s.nd[0] = jnp.where(ms, new_d0, s.nd[0])
    s.ni[0] = jnp.where(ms, 0.0, s.ni[0])
    s.ndt[0] = jnp.where(ms, 0.0, s.ndt[0])
    s.bd[0] = jnp.where(ms, -1, s.bd[0])
    # zero case: node0.dt = 0, node0.d = d_from(next_i)
    mz = mask & zero_case
    s.ndt[0] = jnp.where(mz, 0.0, s.ndt[0])
    s.nd[0] = jnp.where(mz, new_d0, s.nd[0])

    s.length = jnp.where(
        ms, 1, jnp.where(mask & has_best, s.length - 1, s.length)
    )
    s.need_pop = s.need_pop & ~mask
    s.popped_dtm = s.popped_dtm | mask
    return ev_d, t, mask


# --- pop_best_events (ref: event_pixel_tree.rs:213-287) ---------------------


def _pop_best_events(s: _S, intensity, mask, p: TranscodeParams):
    """Drain all node best events where `mask`. Returns DEPTH slots in node
    order as [(d, t, emit_mask)]."""
    slots = []
    any_emit = None
    tail_zeroed = jnp.zeros_like(mask)
    for k in range(len(s.nd)):
        node_active = k < s.length
        has_best = s.bd[k] >= 0
        zero_ev = ~has_best & (s.ndt[k] > 0.0) & (s.ni[k] == 0.0)
        emit = mask & node_active & (has_best | zero_ev)
        d_raw = jnp.where(has_best, s.bd[k], D_ZERO_INTEGRATION)
        dt_raw = jnp.where(has_best, s.bdt[k], s.ndt[k])
        t, new_lft = _emit_abs(s.lft, dt_raw, p)
        if p.time_mode == int(TimeMode.AbsoluteT):
            s.lft = jnp.where(emit, new_lft, s.lft)
        slots.append((d_raw, t, emit))
        any_emit = emit if any_emit is None else (any_emit | emit)
        # zero-event mutates node.dt = 0; only the tail's survives the reset
        tail_zeroed = tail_zeroed | (emit & zero_ev & (k == s.length - 1))

    if p.multi_mode == int(PixelMultiMode.Collapse):
        collapse = mask & s.popped_dtm & any_emit
        # first emitted event across slots
        first_d = jnp.zeros_like(slots[0][0])
        first_t = jnp.zeros_like(slots[0][1])
        found = jnp.zeros_like(mask)
        for d_raw, t, emit in slots:
            take = emit & ~found
            first_d = jnp.where(take, d_raw, first_d)
            first_t = jnp.where(take, t, first_t)
            found = found | emit
        # rewrite: [first, (D_EMPTY, running_t)], rest off (ref: :249-265)
        new_slots = []
        for k, (d_raw, t, emit) in enumerate(slots):
            if k == 0:
                new_slots.append(
                    (
                        jnp.where(collapse, first_d, d_raw),
                        jnp.where(collapse, first_t, t),
                        emit | collapse,
                    )
                )
            elif k == 1:
                new_slots.append(
                    (
                        jnp.where(collapse, D_EMPTY, d_raw),
                        jnp.where(collapse, _as_u32(s.running_t), t),
                        emit | collapse,
                    )
                )
            else:
                new_slots.append((d_raw, t, emit & ~collapse))
        slots = new_slots
        s.lft = jnp.where(collapse, s.running_t, s.lft)
    else:
        collapse = jnp.zeros_like(mask)

    # arena reset: normal -> arena[0] = tail node; collapse -> fresh node
    tail_d = s.tail_pick(s.nd, 0)
    tail_integ = s.tail_pick(s.ni, 0.0)
    tail_dt = jnp.where(tail_zeroed, 0.0, s.tail_pick(s.ndt, 0.0))
    # reference tail never carries a best event (debug_assert, ref: :242)

    fresh_d = _d_from_intensity(intensity)
    s.nd[0] = jnp.where(mask, jnp.where(collapse, fresh_d, tail_d), s.nd[0])
    s.ni[0] = jnp.where(mask, jnp.where(collapse, 0.0, tail_integ), s.ni[0])
    s.ndt[0] = jnp.where(mask, jnp.where(collapse, 0.0, tail_dt), s.ndt[0])
    s.bd[0] = jnp.where(mask, -1, s.bd[0])

    s.length = jnp.where(mask, 1, s.length)
    s.need_pop = s.need_pop & ~mask
    s.dtm_reached = s.dtm_reached & ~mask
    s.popped_dtm = s.popped_dtm & ~mask
    return slots


# --- set_d_for_continuous (ref: event_pixel_tree.rs:289-312) ----------------


def _set_d_for_continuous(s: _S, intensity, mask, p: TranscodeParams):
    next_d = _d_from_intensity(intensity)
    fire = mask & (next_d < s.nd[0]) & (s.ndt[0] > 0.0)
    t, new_lft = _emit_abs_continuous(s.lft, s.ndt[0], p)
    if p.time_mode == int(TimeMode.AbsoluteT):
        s.lft = jnp.where(fire, new_lft, s.lft)
    s.ndt[0] = jnp.where(fire, 0.0, s.ndt[0])
    s.ni[0] = jnp.where(fire, 0.0, s.ni[0])
    s.nd[0] = jnp.where(mask, next_d, s.nd[0])
    return jnp.full_like(next_d, D_EMPTY), t, fire


# --- integrate (ref: event_pixel_tree.rs:317-479) ---------------------------


def _integrate(s: _S, intensity, time, p: TranscodeParams, ovf_mask=None):
    """Vectorized PixelArena::integrate over all pixels. `ovf_mask`, when
    given, limits the scalar depth-overflow counter to those pixels (DVS
    masked-interval callers roll back inactive pixels' state but the
    scalar counter cannot be rolled back per-pixel — garbage inputs on
    masked-off pixels must not count)."""
    # tail D re-aim for virgin tail nodes (ref: :332-335)
    tail_virgin = (s.tail_pick(s.ndt, 0.0) == 0.0) & (
        s.tail_pick(s.ni, 0.0) == 0.0
    )
    d_aim = _d_from_intensity(intensity)
    for k in range(len(s.nd)):
        s.nd[k] = jnp.where(
            (s.length - 1 == k) & tail_virgin, d_aim, s.nd[k]
        )

    s.running_t = (s.running_t + time).astype(_f32)

    i_cur = intensity.astype(_f32)
    t_cur = jnp.broadcast_to(jnp.asarray(time, _f32), i_cur.shape)
    active = jnp.ones(i_cur.shape, jnp.bool_)
    collapse_brk = (
        s.popped_dtm
        if p.multi_mode == int(PixelMultiMode.Collapse)
        else jnp.zeros_like(s.popped_dtm)
    )

    depth = len(s.nd)
    frame_perfect = p.mode == int(Mode.FramePerfect)
    if frame_perfect:
        # FramePerfect breaks the walk at the FIRST fire (and discards the
        # remainder), so the correctly-rounded division and the fenced
        # product — the loop's most expensive ops — are needed at most
        # once per pixel. Record the firing node's pre-fire values during
        # the walk and evaluate the event payload once afterwards
        # (bit-identical: the deferred inputs equal the in-loop ones —
        # i_cur and t_cur are still their original values at first fire).
        fire_ks = []
        snap_d = jnp.zeros_like(s.nd[0])
        snap_integ = jnp.zeros_like(s.ni[0])
        snap_dt = jnp.zeros_like(s.ndt[0])
        child_d0 = _d_from_intensity(i_cur)  # i_cur loop-invariant pre-fire

    for k in range(depth):
        d, integ, dt = s.nd[k], s.ni[k], s.ndt[k]

        total = (integ + i_cur).astype(_f32)
        fire = active & (total >= _dshift_f32(d))

        new_d = _d_from_intensity(total)
        if frame_perfect:
            fire_ks.append(fire)
            snap_d = jnp.where(fire, d, snap_d)
            snap_integ = jnp.where(fire, integ, snap_integ)
            snap_dt = jnp.where(fire, dt, snap_dt)
        else:
            # correctly-rounded division (XLA's f32 divide is ~1 ulp off
            # IEEE, which would shift event timestamps; see ops/numerics.py)
            prop = exact_div(
                (_dshift_f32(new_d) - integ).astype(_f32), i_cur
            )
            prop = jnp.where(
                (new_d == D_ZERO_INTEGRATION)
                | (d == D_ZERO_INTEGRATION)
                | (i_cur < F32_EPSILON),
                _f32(1.0),
                prop,
            )
            # barrier: force separate f32 rounding of the products (the
            # reference rounds `time * prop` before adding; XLA would
            # otherwise fuse into an FMA and shift timestamps by 1 tick)
            t_prop = _fence((t_cur * prop).astype(_f32))
            i_prop = _fence((i_cur * prop).astype(_f32))
            fired_best_dt = (dt + t_prop).astype(_f32)

        # D bump for continued integration (ref: :449-461); the reference's
        # max(new_d+1, d_from(total)+1) has equal operands (new_d IS
        # d_from(total)), so the bump is just new_d+1 capped at 128
        bump = new_d < D_MAX
        d_bumped = jnp.minimum(new_d + 1, 128)

        accum = active & ~fire
        grow = (fire & bump) | accum  # disjoint branches, shared condition
        s.nd[k] = jnp.where(fire, jnp.where(bump, d_bumped, new_d), d)
        s.ni[k] = jnp.where(grow, total, integ)
        s.ndt[k] = jnp.where(grow, (dt + t_cur).astype(_f32), dt)
        if not frame_perfect:
            s.bd[k] = jnp.where(fire, new_d, s.bd[k])
            s.bdt[k] = jnp.where(fire, fired_best_dt, s.bdt[k])

            # remainder (ref: :463-473)
            rem_i = (i_cur - i_prop).astype(_f32)
            rem_t = (t_cur - t_prop).astype(_f32)
            neg = rem_i < 0.0
            next_i = jnp.where(neg, 0.0, rem_i).astype(_f32)
            next_t = jnp.where(neg, 0.0, rem_t).astype(_f32)

        # child creation at k+1 (ref: :344-355)
        child_d = child_d0 if frame_perfect else _d_from_intensity(i_cur)
        if k + 1 < depth:
            s.nd[k + 1] = jnp.where(fire, child_d, s.nd[k + 1])
            s.ni[k + 1] = jnp.where(fire, 0.0, s.ni[k + 1])
            s.ndt[k + 1] = jnp.where(fire, 0.0, s.ndt[k + 1])
            s.bd[k + 1] = jnp.where(fire, -1, s.bd[k + 1])
        else:
            fire_c = fire if ovf_mask is None else (fire & ovf_mask)
            s.overflow = s.overflow + jnp.sum(fire_c.astype(_i32))
        s.length = jnp.where(fire, k + 2, s.length)

        # break conditions for the next iteration (idx = k+1)
        brk = collapse_brk
        if frame_perfect:
            # remainder discarded; fired lanes deactivate, so i_cur/t_cur
            # keep their original values for the (masked) remaining steps
            brk = brk | fire
        else:
            i_cur = jnp.where(fire, next_i, i_cur)
            t_cur = jnp.where(fire, next_t, t_cur)
            # continuous: child D override when remaining time > ref_time
            if k + 1 < depth:
                override = fire & ~collapse_brk & (t_cur > _f32(p.ref_time))
                s.nd[k + 1] = jnp.where(
                    override, _d_from_intensity(i_cur), s.nd[k + 1]
                )
            brk = brk | (fire & (i_cur == 0.0))
        brk = brk | ((k + 1) >= s.length)
        active = active & ~brk

    if frame_perfect:
        # deferred event payload for the (single) fired node.
        # FramePerfect is framed-only (ref: framed.rs:66 is its sole
        # producer), so intensities are integer-valued u8 and, when the
        # dtm window bounds accumulated totals under 2^24, the payload
        # division runs on the integer domain where the cheaper
        # exact_div_uint24 is provably correctly rounded.
        int_regime = (
            255.0 * (p.delta_t_max / max(p.ref_time, 1) + 4) < float(1 << 24)
        )
        div = numerics.exact_div_uint24 if int_regime else exact_div
        total_f = (snap_integ + i_cur).astype(_f32)
        new_d_f = _d_from_intensity(total_f)
        prop = div(
            (_dshift_f32(new_d_f) - snap_integ).astype(_f32), i_cur
        )
        prop = jnp.where(
            (new_d_f == D_ZERO_INTEGRATION)
            | (snap_d == D_ZERO_INTEGRATION)
            | (i_cur < F32_EPSILON),
            _f32(1.0),
            prop,
        )
        t_prop = _fence((t_cur * prop).astype(_f32))
        best_dt_f = (snap_dt + t_prop).astype(_f32)
        for k in range(depth):
            s.bd[k] = jnp.where(fire_ks[k], new_d_f, s.bd[k])
            s.bdt[k] = jnp.where(fire_ks[k], best_dt_f, s.bdt[k])

    s.length = jnp.minimum(s.length, depth)  # overflow containment
    s.dtm_reached = s.ndt[0] >= _f32(p.delta_t_max)
    s.need_pop = (s.nd[0] == D_MAX) | (s.dtm_reached & ~s.popped_dtm)

    # adaptive c_thresh (ref: :402-412)
    adapting = s.c_thresh < p.c_thresh_max
    vel_m1 = (p.c_increase_velocity - 1) % 256
    bump_c = adapting & (s.cic >= vel_m1)
    inc = (
        _as_u32(jnp.broadcast_to(jnp.asarray(time, _f32), s.c_thresh.shape))
        // _u32(max(p.ref_time, 1))
    ).astype(_i32) % 256
    s.c_thresh = jnp.where(bump_c, jnp.minimum(s.c_thresh + 1, 255), s.c_thresh)
    s.cic = jnp.where(
        bump_c, 0, jnp.where(adapting, jnp.minimum(s.cic + inc, 255), s.cic)
    )


# --- full interval: integrate_for_px over the plane -------------------------


def integrate_interval(
    state: PixelState,
    intensity: jax.Array,  # (N,) f32
    frame_val: jax.Array,  # (N,) int32 (u8 range)
    time: jax.Array,  # scalar f32 ticks spanned
    p: TranscodeParams,
):
    """One input interval over all pixels (ref: video.rs:1317-1380).

    Returns (state, slot_d (K, N) int32, slot_t (K, N) uint32,
    slot_mask (K, N) bool)."""
    s = _S.unstack(state)
    slots, running = _interval_core(s, intensity, frame_val, time, p)
    slot_d = jnp.stack([x[0] for x in slots]).astype(_i32)
    slot_t = jnp.stack([x[1] for x in slots]).astype(_u32)
    slot_m = jnp.stack([x[2] for x in slots])
    return s.restack(), slot_d, slot_t, slot_m, running


def _interval_core(s: _S, intensity, frame_val, time, p: TranscodeParams,
                   emit_running: bool = True, ovf_mask=None):
    """The interval logic on an unstacked state; shared by the framed chunk
    scan and the DVS masked sub-steps (ops/dvs_batch.py). Mutates `s`; returns
    (K_SLOTS list of (d, t, mask), (running_val, running_has)).
    emit_running=False skips the display-intensity conversion (an
    exact-rounded division per pixel) for pipelines that never read it."""
    intensity = intensity.astype(_f32)

    # 1. pre-integration pop_top
    d0, t0, m0 = _pop_top_event(s, intensity, s.need_pop, p)

    # 2. contrast threshold check (u8 saturating, ref: video.rs:1338-1340)
    bv = s.base_val
    c = s.c_thresh
    changed = (frame_val < jnp.maximum(bv - c, 0)) | (
        frame_val > jnp.minimum(bv + c, 255)
    )
    pop_slots = _pop_best_events(s, intensity, changed, p)
    s.base_val = jnp.where(changed, frame_val.astype(_i32), bv)

    if p.mode == int(Mode.Continuous):
        d7, t7, m7 = _set_d_for_continuous(s, intensity, changed, p)
    else:
        d7 = jnp.zeros_like(d0)
        t7 = jnp.zeros_like(t0)
        m7 = jnp.zeros_like(m0)

    # 3. integrate
    _integrate(s, intensity, time, p, ovf_mask=ovf_mask)

    # 4. post-integration pop_top
    d8, t8, m8 = _pop_top_event(s, intensity, s.need_pop, p)

    slots = [(d0, t0, m0)] + list(pop_slots) + [(d7, t7, m7), (d8, t8, m8)]
    if emit_running:
        running = _running_intensity(s, p)
    else:
        z = jnp.zeros_like(s.base_val)
        running = (z.astype(jnp.uint8), z != 0)
    return slots, running


def _running_intensity(s: _S, p: TranscodeParams):
    """Per-pixel display value from the root's best event
    (ref: video.rs:713-730, scale_intensity.rs:54-109). Pixels without a
    best event keep value 0 (caller keeps the previous frame via the mask)."""
    bd = s.bd[0]
    bdt = s.bdt[0]
    has = bd >= 0
    # all divisions correctly rounded (exact_div): XLA's approximate divide
    # is fusion-dependent, so the same state would otherwise display ±1
    # differently between graphs and backends
    if p.view_mode == 1:  # D
        pdm = float(np.float32(np.log2(255.0 * (p.delta_t_max / max(p.ref_time, 1)))))
        val = exact_div(bd.astype(_f32), jnp.full_like(bdt, pdm)) * 255.0
    elif p.view_mode == 2:  # DeltaT
        val = exact_div(bdt, jnp.full_like(bdt, p.delta_t_max)) * 255.0
    elif p.view_mode == 3:  # SAE
        val = exact_div(
            (s.running_t - s.lft).astype(_f32),
            jnp.full_like(bdt, p.delta_t_max),
        ) * 255.0
    else:  # Intensity: 2^d / dt * ticks-per-frame
        dshift = _dshift_f32(bd)
        dt = jnp.where(bdt == 0.0, _f32(1.0), bdt)
        val = exact_div(dshift, dt) * _f32(p.ref_time)
    val = jnp.clip(val, 0.0, 255.0).astype(_i32)
    return jnp.where(has, val, 0).astype(jnp.uint8), has


# --- chunked transcode with on-device compaction ----------------------------


def per_interval_take(event_cap: int, n_intervals: int) -> int:
    """Per-interval compaction prefix length for a chunk of n_intervals.

    Deliberately 4x tighter than the buffer would allow: the prefix gather
    is a hot cost, typical event rates are well under capacity, and an
    underestimate is caught by the per-interval overflow check (the caller
    re-runs the chunk with a doubled cap)."""
    return max(event_cap // max(n_intervals, 1) // 4, 1)


def _pack_slots(slot_d, slot_t, slot_m, pack: int):
    """Left-pack each pixel's K slots into `pack` lanes (order-preserving,
    pure selects — no gathers). Returns packed (pack, N) arrays plus the
    per-pixel event count; counts > pack mean events were dropped (the
    caller re-runs with the unpacked graph)."""
    K, N = slot_d.shape
    pd = [jnp.zeros((N,), slot_d.dtype) for _ in range(pack)]
    pt = [jnp.zeros((N,), slot_t.dtype) for _ in range(pack)]
    pm = [jnp.zeros((N,), jnp.bool_) for _ in range(pack)]
    cnt = jnp.zeros((N,), _i32)
    for k in range(K):
        mk = slot_m[k]
        for j in range(pack):
            place = mk & (cnt == j)
            pd[j] = jnp.where(place, slot_d[k], pd[j])
            pt[j] = jnp.where(place, slot_t[k], pt[j])
            pm[j] = pm[j] | place
        cnt = cnt + mk.astype(_i32)
    return jnp.stack(pd), jnp.stack(pt), jnp.stack(pm), cnt


def _compact_interval(slot_d, slot_t, slot_m, take):
    """One interval's event compaction via top_k over position keys — no
    full sort, no transposes. Returns
    (pixd (take,) u32 wire-packed, t (take,) u32, n_ev); n_ev > take signals
    overflow (events dropped; the caller re-runs with a larger cap)."""
    K, N = slot_d.shape
    # Keys ARE the (pixel, slot)-major event positions, built natively on the
    # (K, N) layout (ordering comes from key VALUES, not input order).
    # Invalid slots get a sentinel above every real position; top_k of the
    # negated keys yields the `take` smallest positions already in order.
    pix_ids = jax.lax.broadcasted_iota(_i32, (K, N), 1)
    lane_ids = jax.lax.broadcasted_iota(_i32, (K, N), 0)
    key = jnp.where(slot_m, pix_ids * K + lane_ids, (1 << 30)).reshape(-1)
    n_ev = jnp.sum(slot_m.astype(_i32))
    neg_top, _ = jax.lax.top_k(-key, take)
    src = -neg_top  # ascending event positions

    # resolve (pixel, lane) back into the (K, N) layout for the gathers
    flat_idx = (src % K) * N + (src // K)
    d_s = slot_d.reshape(-1)[flat_idx]
    t_s = slot_t.reshape(-1)[flat_idx]
    pix_s = (src // K).astype(_i32)
    # wire-packed event: (pix << 8 | d) in u32 — halves the pix+d transfer
    pixd_s = (pix_s.astype(_u32) << 8) | (d_s.astype(_u32) & 0xFF)
    return pixd_s, t_s, n_ev


def _merge_prefix(bufs, offset, pixd_s, t_s, n_ev, take):
    """Write an interval's compacted prefix into the chunk buffers at the
    running offset (contiguous DUS with masked read-modify-write)."""
    buf_pixd, buf_t = bufs
    valid = jnp.arange(take, dtype=_i32) < n_ev
    old_pixd = jax.lax.dynamic_slice_in_dim(buf_pixd, offset, take)
    old_t = jax.lax.dynamic_slice_in_dim(buf_t, offset, take)
    buf_pixd = jax.lax.dynamic_update_slice_in_dim(
        buf_pixd, jnp.where(valid, pixd_s, old_pixd), offset, 0
    )
    buf_t = jax.lax.dynamic_update_slice_in_dim(
        buf_t, jnp.where(valid, t_s, old_t), offset, 0
    )
    return (buf_pixd, buf_t), offset + n_ev


def _finish_chunk(buf_pixd, buf_t, total, event_cap):
    """16-bit timestamp compression for the host link (shared tail of the
    chunk functions)."""
    ok = jnp.arange(event_cap, dtype=_i32) < total
    t_base = jnp.min(jnp.where(ok, buf_t, jnp.uint32(0xFFFFFFFF)))
    t_base = jnp.where(total > 0, t_base, 0)
    t_max = jnp.max(jnp.where(ok, buf_t, 0))
    t16_ok = (t_max - t_base) < (1 << 16)
    buf_t16 = (buf_t - t_base).astype(jnp.uint16)
    return buf_t16, t_base, t16_ok


@functools.lru_cache(maxsize=64)
def make_transcode_chunk(p: TranscodeParams, event_cap: int, pack: int = 4):
    """Build a jittable function scanning T frames through the integrator,
    compacting events into a bounded (event_cap,) buffer on device.

    Replaces the reference's rayon row-chunk fan-out + serial encoder feed
    (ref: video.rs:651-778): the "chunk" is the whole plane; event order is
    the single-thread order.

    Returned fn: (state, frames (T, N) uint8, time f32, run0 (N,) uint8) ->
    (state, ev_pixd u32 (pix<<8|d), ev_t u32, ev_t16 u16, t_base u32,
    t16_ok bool, total, interval_counts (T,), runnings (T, N) u8).

    Frames ship host->device as 1 byte/pixel; intensity and contrast values
    derive on device (framed sources have intensity == frame value). Events
    come back wire-packed: pix+d fused into one u32, and — when the chunk's
    timestamp span fits 16 bits (t16_ok) — t as u16 offsets from t_base,
    i.e. 6 bytes/event over the host link instead of 9.

    Overflow (events dropped; caller must re-run the chunk from the
    checkpointed state with a larger cap) is signaled by `total` > event_cap
    OR any interval_counts[i] exceeding per_interval_take(event_cap, T)."""

    def chunk_fn(state, frames, time, run0):
        T = frames.shape[0]
        take = per_interval_take(event_cap, T)

        def step(carry, frame_u8):
            st, max_cnt, run, bufs, offset = carry
            intensity = frame_u8.astype(_f32)
            fv = frame_u8.astype(_i32)
            st, sd, stt, sm, (rval, rhas) = integrate_interval(
                st, intensity, fv, time, p
            )
            run = jnp.where(rhas, rval, run)
            if 0 < pack < K_SLOTS:
                # shrink the compaction volume K -> pack lanes per pixel; the
                # rare pixel with > pack events raises max_cnt and the
                # caller re-runs this chunk with the unpacked graph
                sd, stt, sm, cnt = _pack_slots(sd, stt, sm, pack)
                max_cnt = jnp.maximum(max_cnt, jnp.max(cnt))
            take_i = min(take, sd.shape[0] * sd.shape[1])
            pixd_i, t_i, n_ev = _compact_interval(sd, stt, sm, take_i)
            # merge the interval's prefix into the chunk buffer (contiguous
            # dynamic-update-slice at the running offset; in-place in the
            # scan carry)
            bufs, offset = _merge_prefix(
                bufs, offset, pixd_i, t_i, n_ev, take_i
            )
            return (st, max_cnt, run, bufs, offset), (n_ev, run)

        bufs0 = (
            jnp.zeros((event_cap,), _u32),  # pix<<8 | d
            jnp.zeros((event_cap,), _u32),  # t
        )
        (state, max_cnt, _, bufs, total), (per_interval, runnings) = (
            jax.lax.scan(
                step,
                (state, jnp.zeros((), _i32), run0, bufs0, jnp.zeros((), _i32)),
                frames,
            )
        )
        buf_pixd, buf_t = bufs
        buf_t16, t_base, t16_ok = _finish_chunk(
            buf_pixd, buf_t, total, event_cap
        )
        return (
            state, buf_pixd, buf_t, buf_t16, t_base, t16_ok, total,
            per_interval, runnings, max_cnt,
        )

    return jax.jit(chunk_fn)
