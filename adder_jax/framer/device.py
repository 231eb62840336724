"""Device-side framer: the segmented-scan event->frame pipeline as one jit.

The host framer (framer/driver.py) already reformulates the reference's
per-event ingest (ref: adder-codec-rs/src/framer/driver.rs:984-1133) as
segmented scans over a pixel-sorted batch; this module runs the same
formulation on the accelerator:

  sort by pixel (lexsort keeps per-pixel order — the reference's own
  invariant) -> segmented chains (AbsoluteT monotonicity guard, framed
  ref_interval rounding, last-filled-frame cummax) -> span fill into a
  modular (F, N) frame window by bounded scatter passes (span length is
  bounded by delta_t_max / tpf, the reference's own guarantee that a pixel
  cannot stay silent past dtm).

Byte-parity strategy: the device fills each frame cell with the event's
(d, delta_t) PAIR (not the display value); the host converts popped frames
through the same vectorized f64 `get_frame_values` path as the host framer,
so output bytes are identical by construction — no f32-vs-f64 divergence
on device.

Scope: AbsoluteT (codec v2+) and DeltaT streams, all view modes
(Intensity/D/DeltaT/SAE) plus EventCoordless output (the window already
holds the (d, delta-t) pair; coordless just skips value conversion and
packs it into u64 on pop). DeltaT chains are u32 on device (x64 is off
under jit), so streams whose cumulative tick count passes 2^31 raise
OverflowError — reconstruct those on the host framer.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np

from ..core.types import D_EMPTY, EventArray, TimeMode, is_framed
from .driver import FramerBuilder
from .scale_intensity import FramedViewMode, get_frame_values

_SENTINEL_NEG = -(1 << 30)


@functools.lru_cache(maxsize=16)
def _make_batch_step(
    n: int,
    cap: int,
    window: int,
    tpf: int,
    ref_interval: int,
    framed_round: bool,
    max_span: int,
    absolute: bool = True,
    chain_payload: bool = False,
):
    import jax
    import jax.numpy as jnp

    i32 = jnp.int32
    u32 = jnp.uint32

    def seg_scan(vals, seg_start, combine):
        def op(a, b):
            fa, va = a
            fb, vb = b
            return (fa | fb, jnp.where(fb, vb, combine(va, vb)))

        _, v = jax.lax.associative_scan(op, (seg_start, vals))
        return v

    def seg_exclusive(inclusive, seg_start, carry_per_ev):
        prev = jnp.concatenate([inclusive[:1], inclusive[:-1]])
        return jnp.where(seg_start, carry_per_ev, prev)

    def step(
        pix, t, d, valid, base,
        running_ts, last_filled, last_intensity_d, last_intensity_dt,
        win_d, win_dt, win_filled,
    ):
        # sort by pixel, stable in arrival order (per-pixel order contract)
        order = jnp.lexsort((jnp.arange(cap, dtype=i32), pix))
        pix = pix[order]
        t = t[order]
        d = d[order]
        valid = valid[order]
        # invalid (pad) events were given pix == n, sorting to the tail

        seg_start = jnp.ones(cap, dtype=bool)
        seg_start = seg_start.at[1:].set(pix[1:] != pix[:-1])

        gpix = jnp.minimum(pix, n - 1)
        ref = u32(ref_interval)

        rt = t
        if framed_round:
            rt = ((t + ref - u32(1)) // ref) * ref
        if absolute:
            incl_rt = seg_scan(
                jnp.maximum(rt, running_ts[gpix]), seg_start, jnp.maximum
            )
            prev_chain = seg_exclusive(incl_rt, seg_start, running_ts[gpix])
            keep = valid & (t > prev_chain)
            v = t  # pre-rounding running value for the frame index
            dt_for_value = jnp.where(
                t >= prev_chain, t - prev_chain, u32(0)
            )
        else:
            # DeltaT: running_ts accumulates (rounded) deltas; chains fit
            # u32 for bounded streams (overflow checked below)
            incl_sum = seg_scan(
                jnp.where(valid, rt, u32(0)), seg_start, jnp.add
            )
            base_chain = running_ts[gpix] + incl_sum - jnp.where(
                valid, rt, u32(0)
            )
            incl_rt = running_ts[gpix] + incl_sum  # carry update value
            keep = valid
            v = base_chain + t
            # SAE on DeltaT streams displays the chain value itself
            # (host: sae_running_t=v, sae_last_fired_t=0)
            dt_for_value = v if chain_payload else t

        # frame index: (running_ts.saturating_sub(1)) / tpf
        f_idx = (
            (jnp.maximum(v, u32(1)) - u32(1)) // u32(tpf)
        ).astype(i32)

        f_for_chain = jnp.where(keep, f_idx, i32(_SENTINEL_NEG))
        incl_lf = seg_scan(
            jnp.maximum(f_for_chain, last_filled[gpix]), seg_start,
            jnp.maximum,
        )
        prev_lf = seg_exclusive(incl_lf, seg_start, last_filled[gpix])
        fires = keep & (f_idx > prev_lf)

        # fill payload: (d, dt); D_EMPTY repeats the previous payload
        compute = fires & (d != D_EMPTY)
        idx = jnp.arange(cap, dtype=i32)
        src = jnp.where(compute, idx, i32(-1))
        incl_src = seg_scan(src, seg_start, jnp.maximum)
        has_src = incl_src >= 0
        gsrc = jnp.maximum(incl_src, 0)
        fill_d = jnp.where(has_src, d[gsrc], last_intensity_d[gpix])
        fill_dt = jnp.where(
            has_src, dt_for_value[gsrc], last_intensity_dt[gpix]
        )

        # span fill: fired event fills frames (prev_lf, f_idx] with payload
        lo = jnp.maximum(prev_lf + 1, base)
        hi = f_idx
        overflow = jnp.max(jnp.where(fires, hi - base, 0)) >= window

        wd, wdt, wf = win_d, win_dt, win_filled
        for s in range(max_span):
            fr = lo + s
            m = fires & (fr <= hi)
            row = jax.lax.rem(fr, window)
            flat = row * n + jnp.minimum(pix, n - 1)
            flat = jnp.where(m, flat, window * n)  # dummy slot
            taken = wf.reshape(-1).at[flat].get(
                mode="fill", fill_value=True
            )
            write = m & ~taken
            flatw = jnp.where(write, flat, window * n)
            wd = wd.reshape(-1).at[flatw].set(
                fill_d, mode="drop"
            ).reshape(window, n)
            wdt = wdt.reshape(-1).at[flatw].set(
                fill_dt, mode="drop"
            ).reshape(window, n)
            wf = wf.reshape(-1).at[flatw].set(
                True, mode="drop"
            ).reshape(window, n)

        # span overflow detection (hi - lo + 1 can exceed max_span only on
        # corrupt streams; the dtm contract bounds it)
        overflow = overflow | (
            jnp.max(jnp.where(fires, hi - lo, 0)) >= max_span
        )
        if not absolute:
            # DeltaT chains wrap u32 on very long streams -> host framer
            overflow = overflow | (jnp.max(incl_rt) >= u32(1 << 31))

        # carries (value at each segment's last element)
        last_el = jnp.ones(cap, dtype=bool)
        last_el = last_el.at[:-1].set(seg_start[1:])
        seg_pix = jnp.where(last_el & (pix < n), pix, n)
        running_ts = running_ts.at[seg_pix].set(
            jnp.maximum(incl_rt, running_ts[gpix]), mode="drop"
        )
        last_filled = last_filled.at[seg_pix].set(
            jnp.maximum(incl_lf, last_filled[gpix]), mode="drop"
        )
        last_intensity_d = last_intensity_d.at[seg_pix].set(
            fill_d, mode="drop"
        )
        last_intensity_dt = last_intensity_dt.at[seg_pix].set(
            fill_dt, mode="drop"
        )

        counts = jnp.sum(wf, axis=1, dtype=i32)
        return (
            running_ts, last_filled, last_intensity_d, last_intensity_dt,
            wd, wdt, wf, counts, overflow,
        )

    import jax

    def step_packed(
        packed, base,
        running_ts, last_filled, last_intensity_d, last_intensity_dt,
        win_d, win_dt, win_filled,
    ):
        # ONE (4, cap) i32 array [pix, bits(t), d, valid]: one upload per
        # batch instead of four
        return step(
            packed[0],
            jax.lax.bitcast_convert_type(packed[1], u32),
            packed[2],
            packed[3] != 0,
            base,
            running_ts, last_filled, last_intensity_d, last_intensity_dt,
            win_d, win_dt, win_filled,
        )

    return jax.jit(step_packed, donate_argnums=(2, 3, 4, 5, 6, 7, 8))


class DeviceFramer:
    """Accelerated FrameSequence (AbsoluteT and bounded DeltaT streams).

    API subset: ingest_event_array / pop_next_frame / flush_frame_buffer /
    frames_written — enough to drive reconstruction pipelines and the
    decode benchmark. Values are converted on pop via the host
    `get_frame_values` f64 path, so popped frames are byte-identical to
    the host framer's."""

    def __init__(self, b: FramerBuilder, batch_cap: int = 1 << 17,
                 window: Optional[int] = None):
        import jax.numpy as jnp

        self._absolute = (
            b.codec_version >= 2 and b.time_mode == TimeMode.AbsoluteT
        )

        self.b = b
        self.plane = b.plane
        self.n = b.plane.volume()
        self.coordless = b.coordless
        self.out_dtype = (
            np.dtype(np.uint64) if b.coordless else np.dtype(b.out_dtype)
        )
        self.tpf = int(b.tps / b.output_fps) if b.output_fps else b.ref_interval
        self.ref_interval = b.ref_interval
        self.delta_t_max = b.delta_t_max
        self.view_mode = b.view_mode
        self.source = b.source
        self._framed_round = b.codec_version >= 1 and is_framed(
            b.source_camera
        )
        # SAE on DeltaT streams needs the chain value as payload; on
        # AbsoluteT the standard (t - prev_chain) payload IS the SAE diff
        self._sae_chain = (
            self.view_mode == FramedViewMode.SAE
            and not self._absolute
            and not self.coordless
        )
        self.max_span = max(self.delta_t_max // max(self.tpf, 1) + 2, 4)
        self.window = window or max(2 * self.max_span, 64)
        self.batch_cap = batch_cap
        self.frames_written = 0

        n, F = self.n, self.window
        self.running_ts = jnp.zeros(n + 1, jnp.uint32)
        self.last_filled = jnp.full(n + 1, -1, jnp.int32)
        # never-filled pixels must convert to the host framer's
        # zero-initialized last_intensity: d=255 maps to intensity 0 in the
        # Intensity view, while the D view and coordless packing read d
        # directly and need a literal 0 payload (DeltaT/SAE read only dt)
        init_d = (
            255
            if (
                self.view_mode == FramedViewMode.Intensity
                and not self.coordless
            )
            else 0
        )
        self.li_d = jnp.full(n + 1, init_d, jnp.int32)
        self.li_dt = jnp.zeros(n + 1, jnp.uint32)
        self.win_d = jnp.zeros((F, n), jnp.int32)
        self.win_dt = jnp.zeros((F, n), jnp.uint32)
        self.win_filled = jnp.zeros((F, n), bool)
        self._counts = np.zeros(F, np.int64)
        self._force_pop = False

        from .scale_intensity import practical_d_max_for

        self._practical_d_max = practical_d_max_for(
            float(np.iinfo(self.out_dtype).max), self.delta_t_max,
            self.ref_interval,
        )

    def _pix_index(self, events: EventArray) -> np.ndarray:
        from ..core.types import NO_CHANNEL

        c = np.where(events.c == NO_CHANNEL, 0, events.c).astype(np.int64)
        return (
            events.y.astype(np.int64) * self.plane.width
            + events.x.astype(np.int64)
        ) * self.plane.channels + c

    def ingest_event_array(self, events: EventArray) -> bool:
        import jax.numpy as jnp

        step = _make_batch_step(
            self.n, self.batch_cap, self.window, self.tpf,
            self.ref_interval, self._framed_round, self.max_span,
            self._absolute, self._sae_chain,
        )
        i = 0
        m = len(events)
        if m == 0:
            return self.is_frame_0_filled()
        import jax

        from ..utils import tracing

        overflows = []
        counts = None
        while i < m:
            j = min(i + self.batch_cap, m)
            cnt = j - i
            # ONE i32 carrier upload per batch (see step_packed)
            with tracing.stage("device_framer.pack"):
                packed = np.zeros((4, self.batch_cap), np.int32)
                if cnt:
                    packed[0, :cnt] = self._pix_index(events[i:j])
                    packed[0, cnt:] = self.n  # pad events sort to the tail
                    packed[1, :cnt] = (
                        events.t[i:j].astype(np.uint32).view(np.int32)
                    )
                    packed[2, :cnt] = events.d[i:j].astype(np.int32)
                    packed[3, :cnt] = 1
            with tracing.stage("device_framer.dispatch"):
                (
                    self.running_ts, self.last_filled, self.li_d, self.li_dt,
                    self.win_d, self.win_dt, self.win_filled, counts, overflow,
                ) = step(
                    jnp.asarray(packed), jnp.int32(self.frames_written),
                    self.running_ts, self.last_filled, self.li_d, self.li_dt,
                    self.win_d, self.win_dt, self.win_filled,
                )
            overflows.append(overflow)
            i = j
        # ONE deferred d2h round trip for all control outputs: counts are
        # cumulative (each step emits the full window-row fill counts), so
        # only the last batch's matter; dispatches pipeline sync-free
        with tracing.stage("device_framer.sync_fetch"):
            counts_h, *ovfs = jax.device_get((counts, *overflows))
        if any(bool(o) for o in ovfs):
            raise OverflowError(
                "device framer window overflow (increase `window`; the "
                "stream violates the delta_t_max span bound)"
            )
        self._counts = np.array(counts_h)  # writable copy
        return self.is_frame_0_filled()

    def is_frame_0_filled(self) -> bool:
        return int(self._counts[self.frames_written % self.window]) >= self.n

    def _values_for(self, dd: np.ndarray, dtt: np.ndarray) -> np.ndarray:
        if self.coordless:
            # EventCoordless passthrough: (d, delta-t) packed into u64
            # (the device window already holds exactly that pair)
            return (dd.astype(np.uint64) << 32) | dtt.astype(np.uint64)
        if self.view_mode == FramedViewMode.SAE:
            # the stored payload is the SAE diff (see _sae_chain note)
            return get_frame_values(
                dd.astype(np.int64), dtt.astype(np.uint64), self.out_dtype,
                self.source, float(self.ref_interval),
                self._practical_d_max, self.delta_t_max, self.view_mode,
                sae_running_t=dtt.astype(np.uint64),
                sae_last_fired_t=np.zeros(len(dtt), np.uint64),
            )
        return get_frame_values(
            dd.astype(np.int64), dtt.astype(np.uint64), self.out_dtype,
            self.source, float(self.ref_interval), self._practical_d_max,
            self.delta_t_max, self.view_mode,
        )

    def pop_next_frame(self) -> Optional[np.ndarray]:
        """Pop frame 0 if every pixel is filled (None otherwise; a
        preceding flush_frame_buffer() force-pops with back-fill)."""
        if not self._force_pop and not self.is_frame_0_filled():
            return None
        self._force_pop = False
        return self._pop_row()

    def _pop_row(self) -> np.ndarray:
        import jax
        import jax.numpy as jnp

        row = self.frames_written % self.window
        # dynamic row index (a python-int index bakes into the jaxpr and
        # compiles a new executable per row value) + ONE d2h round trip
        idx = jnp.int32(row)
        dd, dtt, filled = jax.device_get(
            (self.win_d[idx], self.win_dt[idx], self.win_filled[idx])
        )
        vals = self._values_for(dd, dtt)
        # unfilled pixels inherit the carry payload (flush semantics use
        # this too; during normal pops every pixel is filled)
        if not filled.all():
            carry_d, carry_dt = jax.device_get(
                (self.li_d[: self.n], self.li_dt[: self.n])
            )
            vals = np.where(filled, vals, self._values_for(carry_d, carry_dt))
        # recycle the row
        self.win_d = self.win_d.at[idx].set(0)
        self.win_dt = self.win_dt.at[idx].set(0)
        self.win_filled = self.win_filled.at[idx].set(False)
        self._counts[row] = 0
        self.frames_written += 1
        return vals.reshape(self.plane.shape).astype(self.out_dtype)

    def pop_ready_frames(self) -> list[np.ndarray]:
        """Pop every consecutive complete frame in ONE device fetch.

        Per-frame pops cost a host<->device round trip each, so the batch
        variant gathers all ready rows at once."""
        import jax.numpy as jnp

        F = self.window
        k = 0
        while k < F - 1 and (
            self._counts[(self.frames_written + k) % F] >= self.n
        ):
            k += 1
        if k == 0:
            return []
        rows = np.array(
            [(self.frames_written + i) % F for i in range(k)], np.int32
        )
        # pow2-pad the row-index shape (a fresh shape per k would compile
        # a new executable per pop; padding rides OOB indices: take clips
        # — host ignores rows [k:] — and the recycle scatter drops them)
        k_pad = 1 << (k - 1).bit_length()
        rows_pad = np.full(k_pad, F, np.int32)
        rows_pad[:k] = rows
        rows_j = jnp.asarray(rows_pad)
        import jax

        from ..utils import tracing

        with tracing.stage("device_framer.pop_d2h"):
            # d values fit u8 (0..255 incl. the 255 init), and dt values
            # are bounded by delta_t_max — casting on device before the
            # fetch cuts the d2h payload 8 -> 5 (or 3) bytes/px
            dtt_dev = jnp.take(self.win_dt, rows_j, axis=0, mode="clip")
            if self.delta_t_max < (1 << 16):
                dtt_dev = dtt_dev.astype(jnp.uint16)
            dd, dtt = jax.device_get(  # ONE d2h round trip
                (
                    jnp.take(self.win_d, rows_j, axis=0, mode="clip").astype(
                        jnp.uint8
                    ),
                    dtt_dev,
                )
            )
        with tracing.stage("device_framer.recycle"):
            self.win_d = self.win_d.at[rows_j].set(0, mode="drop")
            self.win_dt = self.win_dt.at[rows_j].set(0, mode="drop")
            self.win_filled = self.win_filled.at[rows_j].set(
                False, mode="drop"
            )
            self._counts[rows] = 0
        with tracing.stage("device_framer.convert"):
            out = []
            for i in range(k):
                vals = self._values_for(dd[i], dtt[i])
                out.append(
                    vals.reshape(self.plane.shape).astype(self.out_dtype)
                )
        self.frames_written += k
        return out

    def flush_frame_buffer(self) -> bool:
        """Back-fill the current frame from the per-pixel carry and mark it
        poppable (host framer / ref driver.rs:632-677 semantics)."""
        hi = int(np.asarray(self.last_filled[: self.n]).max())
        if hi > self.frames_written:
            self._force_pop = True
            return True
        return self.is_frame_0_filled()

    def drain(self) -> list[np.ndarray]:
        """Batch-pop all complete frames, then a single back-filling flush
        (the simulproc shutdown drive, like the host framer)."""
        out = self.pop_ready_frames()
        if self.flush_frame_buffer() and self._force_pop:
            out.append(self.pop_next_frame())
            out.extend(self.pop_ready_frames())
        return out
