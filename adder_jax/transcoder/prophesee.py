"""Prophesee RAW (EVT2-style) DVS stream -> ADDER source.

ref: adder-codec-rs/src/transcoder/source/prophesee.rs. Integration model:
per-pixel last-log-intensity + last-timestamp state; for each DVS event the
held intensity is integrated over the gap, the log intensity steps by
+-camera_theta, and one source-tick of the new intensity is integrated.

The record decode is one vectorized numpy pass over the whole file. The
per-event integration runs batched on the device by default
(ops/dvs_batch.py: per-pixel event lanes, one scanned dispatch per window);
the scalar pixel oracle (the reference itself is serial here,
chunk_rows=1) remains as `batched=False`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..codec.encoder import EncoderOptions, EncoderType
from ..core.types import (
    Coord,
    Event,
    EventArray,
    Mode,
    PixelMultiMode,
    PlaneSize,
    SourceCamera,
    TimeMode,
)
from ..utils import tracing
from ..utils.cv import mid_clamp_u8
from . import pixel_oracle as O
from .video import SourceError, Video

PROPHESEE_SOURCE_TPS = 1_000_000


def parse_header(f) -> tuple:
    """Parse the %-comment header; returns (bod, ev_type, ev_size, (h, w)).

    ref: prophesee.rs:367-422
    """
    f.seek(0)
    height = width = None
    n_comment = 0
    bod = 0
    while True:
        bod = f.tell()
        line = f.readline()
        if not line or not line.startswith(b"%"):
            break
        words = line.replace(b"\t", b" ").split(b" ")
        if len(words) > 2:
            try:
                if words[1] == b"Height":
                    height = int(words[2].strip())
                elif words[1] == b"Width":
                    width = int(words[2].strip())
            except ValueError:
                pass
        n_comment += 1
    f.seek(bod)
    ev_type, ev_size = 0, 0
    if n_comment > 0:
        buf = f.read(2)
        ev_type, ev_size = buf[0], buf[1]
        if ev_size != 8 or ev_type not in (0, 12):
            raise SourceError("Invalid Prophesee event size")
    bod = f.tell()
    return bod, ev_type, ev_size, (height or 70, width or 100)


def decode_events_np(buf: bytes) -> tuple:
    """Vectorized decode of 8-byte LE records -> (t, x, y, p) arrays.

    ref: prophesee.rs:437-452 (bit layout: x = data & 0x3FF,
    y = (data & 0xFFFC000) >> 14, p = (data >> 28) & 1).
    """
    raw = np.frombuffer(buf, dtype="<u4")
    n = len(raw) // 2
    t = raw[0 : 2 * n : 2]
    data = raw[1 : 2 * n : 2].astype(np.int64)
    x = (data & 0x3FF).astype(np.uint16)
    y = ((data & 0xFFFC000) >> 14).astype(np.uint16)
    p = ((data & 0x10000000) >> 28).astype(np.uint8)
    return t.astype(np.uint32), x, y, p


class Prophesee:
    """Prophesee RAW -> ADDER transcoder (ref: prophesee.rs:25-323).

    Integration runs through the batched dense device kernel by default
    (ops/dvs_batch.py); `batched=False` opts into the scalar per-event
    oracle (reference-shaped, orders of magnitude slower). Per-pixel event
    streams are bit-identical between the two paths
    (tests/test_dvs_batch.py)."""

    def __init__(self, ref_time: int, input_path: str, batched: bool = True,
                 view_fps: int = 60):
        """view_fps: how much of the stream one consume() call processes
        (events until t passes running_t + tps/view_fps). 60 mirrors the
        reference's 1/60 s view interval (prophesee.rs:136-170); offline
        bulk transcodes can lower it (e.g. 1 = one-second batches) to
        amortize device dispatches over far more events — per-pixel event
        streams are identical either way (the lane replay preserves each
        pixel's chain regardless of batch boundaries)."""
        self.reader = open(input_path, "rb")
        _, _, _, (h, w) = parse_header(self.reader)
        plane = PlaneSize(w, h, 1)
        self.plane = plane

        # tps scales the source's 1 MHz clock by ref_time; dtm = 2*ref_time
        # (ref: prophesee.rs:65-76)
        self.video = Video(plane, Mode.Continuous)
        self.video.time_parameters(
            ref_time * PROPHESEE_SOURCE_TPS,
            ref_time,
            ref_time * 2,
            TimeMode.AbsoluteT,
        )

        self.running_t = 0
        self.t_subtract = 0
        self.camera_theta = 0.02
        self.view_fps = max(int(view_fps), 1)
        n = plane.volume()
        self.dvs_last_timestamps = np.full(n, 2, dtype=np.uint32)
        self.dvs_last_ln_val = np.full(n, np.log1p(128.0 / 255.0), dtype=np.float64)
        self.running_intensities = np.full(plane.shape, 128, dtype=np.uint8)

        self.batched = batched
        if batched:
            from ..ops import integrate as ops_integrate

            # DVS gap integrations cascade much deeper than framed intervals
            # (intensity ~ 255 * gap_ticks); 16 levels cover minutes-long
            # gaps, and state.overflow counts any deeper truncation
            self._dev_state = ops_integrate.init_state(n, depth=16)
            self._pixels = []
        else:
            # scalar oracle state per pixel (Continuous mode integration)
            self._pixels = [
                O.PixelArena(1.0, Coord(i % w, i // w, None)) for i in range(n)
            ]
            for px in self._pixels:
                px.set_time_mode(TimeMode.AbsoluteT)

        self._event_buf: Optional[np.ndarray] = None
        self._event_pos = 0
        self._eof = False
        # True = discard events after integration (the reference's no-IO
        # EmptyOutput bench semantics; the Empty encoder gets nothing)
        self.void_events = False

    # -- builder API parity --

    def crf(self, crf: int):
        self.video.update_crf(crf)
        base = self.video.encoder.options.crf.get_parameters().c_thresh_baseline
        if self.batched:
            import jax.numpy as jnp

            self._dev_state = self._dev_state._replace(
                c_thresh=jnp.full_like(self._dev_state.c_thresh, base),
                c_increase_counter=jnp.zeros_like(
                    self._dev_state.c_increase_counter
                ),
            )
        for px in self._pixels:
            px.c_thresh = base
            px.c_increase_counter = 0
        return self

    def write_out(self, source_camera, time_mode, pixel_multi_mode,
                  adu_interval, encoder_type, encoder_options, write,
                  **kwargs):
        self.video.write_out(
            source_camera, time_mode, pixel_multi_mode, adu_interval,
            encoder_type, encoder_options, write, **kwargs,
        )
        return self

    def get_video_ref(self):
        return self.video

    def get_video_mut(self):
        return self.video

    # -- internals --

    def _params(self):
        v = self.video
        crf = v.encoder.options.crf.get_parameters()
        return (
            Mode.Continuous,
            v.pixel_multi_mode,
            v.delta_t_max,
            v.ref_time,
            crf.c_thresh_max,
            max(crf.c_increase_velocity, 1),
        )

    def _integrate_px(self, i, frame_val, intensity, time_spanned, buffer):
        mode, multi, dtm, ref, cmax, cvel = self._params()
        O.integrate_for_px(
            self._pixels[i], frame_val, intensity, time_spanned, buffer,
            mode, multi, dtm, ref, cmax, cvel,
        )

    def _bootstrap(self):
        """Integrate 2 gray (128) frames at t=0 (ref: prophesee.rs:117-133)."""
        events: list = []
        ref = self.video.ref_time
        for _ in range(2):
            for i in range(len(self._pixels)):
                self._integrate_px(i, 128, 128.0, float(ref), events)
        self.running_t = 2
        self.video.encoder.ingest_event_array(EventArray.from_events(events))
        return events

    def _next_dvs_batch(self):
        """DVS events until t passes running_t + 1/60 s (ref: :136-170)."""
        if self._event_buf is None:
            buf = self.reader.read()
            t, x, y, p = decode_events_np(buf)
            t = t - self.t_subtract
            self._event_buf = (t, x, y, p)
            self._event_pos = 0
        t, x, y, p = self._event_buf
        start = self._event_pos
        if start >= len(t):
            self._eof = True
            return None
        view_interval = PROPHESEE_SOURCE_TPS // self.view_fps
        limit = self.running_t + view_interval
        beyond = np.flatnonzero(t[start:] > limit)
        end = start + int(beyond[0]) + 1 if len(beyond) else len(t)
        if not len(beyond):
            self._eof = True
        self._event_pos = end
        sl = slice(start, end)
        if end > start:
            self.running_t = max(self.running_t, int(t[sl].max()))
        return t[sl], x[sl], y[sl], p[sl]

    # -- batched device path (ops/dvs_batch.py, SURVEY P5) --

    def _tp(self):
        from ..ops.integrate import TranscodeParams

        v = self.video
        crf = v.encoder.options.crf.get_parameters()
        return TranscodeParams(
            mode=int(Mode.Continuous),
            multi_mode=int(v.pixel_multi_mode),
            time_mode=int(TimeMode.AbsoluteT),
            ref_time=int(v.ref_time),
            delta_t_max=int(v.delta_t_max),
            c_thresh_max=int(crf.c_thresh_max),
            c_increase_velocity=max(int(crf.c_increase_velocity), 1),
        )

    def _masked_call(self, intensity, fv, time, mask, out: list):
        import jax.numpy as jnp

        from ..ops import dvs_batch as B

        ns = int(self._dev_state.length.shape[0])
        # ONE (4, ns) i32 upload (see make_masked_interval_compact_packed)
        packed = np.zeros((4, ns), np.int32)
        packed[0] = np.asarray(intensity, np.float32).view(np.int32)
        packed[1] = fv
        packed[2] = np.asarray(time, np.float32).view(np.int32)
        packed[3] = mask
        K = int(self._dev_state.node_d.shape[0]) + 3
        take = 1 << (ns - 1).bit_length()  # ~1 event/px; doubles on overflow
        take = self._mask_take = max(take, getattr(self, "_mask_take", 0))
        args = (jnp.asarray(packed),)
        st0 = self._dev_state
        void = getattr(self, "void_events", False)
        while True:
            fn = B.make_masked_interval_compact_packed(
                self._tp(), min(take, K * ns), compact=not void
            )
            st, pixd, tt, n_ev = fn(st0, *args)
            if void:
                # events are discarded; state is what matters — no sync,
                # and the compaction top_k never runs (compact=False)
                self._dev_state = st
                return
            n_i = int(n_ev)
            if n_i <= take or take >= K * ns:
                break
            take = self._mask_take = take * 2
        self._dev_state = st
        n_i = min(n_i, K * ns)
        import jax

        pixd_h, tt_h = jax.device_get((pixd[:n_i], tt[:n_i]))
        out.append(B.wire_to_events(pixd_h, tt_h, self.plane.width))

    @staticmethod
    def _events_from_parts(parts) -> EventArray:
        if not parts:
            z = np.zeros(0, np.uint16)
            return EventArray(z, z.copy(), np.zeros(0, np.uint8),
                              np.zeros(0, np.uint8), np.zeros(0, np.uint32))
        x = np.concatenate([p[0] for p in parts])
        y = np.concatenate([p[1] for p in parts])
        d = np.concatenate([p[2] for p in parts])
        t = np.concatenate([p[3] for p in parts]).astype(np.uint32)
        from ..core.types import NO_CHANNEL

        return EventArray(x, y, np.full(len(x), NO_CHANNEL, np.uint8), d, t)

    def _bootstrap_batched(self) -> EventArray:
        ref = self.video.ref_time
        parts: list = []
        self._masked_call_const(128.0, 128, float(ref), parts, reps=2)
        self.running_t = 2
        arr = self._events_from_parts(parts)
        self.video.encoder.ingest_event_array(arr)
        return arr

    def _masked_call_const(self, intensity: float, fv: int, time: float,
                           out: list, reps: int = 1):
        """_masked_call with constant all-pixel arguments materialized
        in-graph — no host->device transfer at all (the bootstrap shape,
        ref: prophesee.rs:150-162). `reps` chains the sub-step in one jit
        (the bootstrap needs two; separate dispatches paid graph + dispatch
        overhead per rep)."""
        from ..ops import dvs_batch as B

        ns = int(self._dev_state.length.shape[0])
        K = int(self._dev_state.node_d.shape[0]) + 3
        take = 1 << (ns - 1).bit_length()
        take = self._mask_take = max(take, getattr(self, "_mask_take", 0))
        st0 = self._dev_state
        void = getattr(self, "void_events", False)
        while True:
            fn = B.make_masked_interval_const(
                self._tp(), min(take, K * ns), ns, self.plane.volume(),
                intensity, fv, time, reps=reps, compact=not void,
            )
            st, rep_outs = fn(st0)
            if void:
                # state-only chain: no sync, no compaction in-graph
                self._dev_state = st
                return
            ns_i = [int(n_ev) for _, _, n_ev in rep_outs]
            if max(ns_i) <= take or take >= K * ns:
                break
            take = self._mask_take = take * 2
        self._dev_state = st
        import jax

        fetch = []
        for (pixd, tt, _), n_i in zip(rep_outs, ns_i):
            n_i = min(n_i, K * ns)
            fetch.extend((pixd[:n_i], tt[:n_i]))
        flat = jax.device_get(tuple(fetch))  # one batched fetch
        for k in range(0, len(flat), 2):
            out.append(
                B.wire_to_events(flat[k], flat[k + 1], self.plane.width)
            )

    def _consume_batched(self) -> EventArray:
        from ..ops import dvs_batch as B

        if self.running_t == 0:
            self._bootstrap_batched()
        batch = self._next_dvs_batch()
        if batch is None:
            self._end_events_batched()
            raise EOFError("prophesee source exhausted")
        ts, xs, ys, ps = batch
        n = self.plane.volume()
        parts: list = []
        with tracing.stage("dvs.plan", items=len(ts)):
            lanes = B.plan_dvs_batch(
                ts, xs, ys, ps, self.plane.width, n,
                self.dvs_last_timestamps, self.dvs_last_ln_val,
                self.camera_theta, self.video.ref_time,
            )
        if lanes:
            parts = self._run_lanes_scanned(lanes)
        arr = self._events_from_parts(parts)
        with tracing.stage("dvs.encode", items=len(arr)):
            self.video.encoder.ingest_event_array(arr)
        if self._eof:
            self._end_events_batched()
        return arr

    def _run_lanes_scanned(self, lanes) -> list:
        """All lanes in ONE device dispatch (lax.scan over the lane axis);
        falls back to per-lane masked calls if the compaction bound is ever
        exceeded (it cannot be by construction: take >= active_pixels * K)."""
        import jax.numpy as jnp

        from ..ops import dvs_batch as B

        K = int(self._dev_state.node_d.shape[0]) + 3  # slots per sub-step
        max_active = max(
            max(int(lane.gap_mask.sum()), int(lane.tick_mask.sum()))
            for lane in lanes
        )
        if max_active == 0:
            return []
        # sticky-grow the compile shape so steady state reuses ONE executable
        take = 1 << (max(64, max_active * K) - 1).bit_length()
        take = self._scan_take = max(take, getattr(self, "_scan_take", 0))
        L_pad = 1 << (len(lanes) - 1).bit_length()
        L_pad = self._scan_lpad = max(L_pad, getattr(self, "_scan_lpad", 0))
        # each scan-step executable holds hundreds of JIT-code mappings; a
        # long-lived process crossing many sticky shapes must not run into
        # vm.max_map_count (see runtime.bound_jit_mappings)
        from ..runtime import bound_jit_mappings

        bound_jit_mappings()
        fn = B.make_dvs_scan_step(self._tp(), take)
        st0 = self._dev_state
        stacked = [jnp.asarray(a) for a in B.stack_lanes(lanes, L_pad)]
        st, pixd, t, total, max_sub = fn(st0, *stacked)
        import jax

        total_i, max_sub_i = map(int, jax.device_get((total, max_sub)))
        if max_sub_i > take:  # unreachable bound check
            parts: list = []
            for lane in lanes:
                if lane.gap_mask.any():
                    self._masked_call(
                        lane.gap_intensity, lane.gap_fv, lane.gap_time,
                        lane.gap_mask, parts,
                    )
                if lane.tick_mask.any():
                    self._masked_call(
                        lane.tick_intensity, lane.tick_fv, lane.tick_time,
                        lane.tick_mask, parts,
                    )
            return parts
        self._dev_state = st
        pixd_np, t_np = jax.device_get((pixd[:total_i], t[:total_i]))
        return [B.wire_to_events(pixd_np, t_np, self.plane.width)]

    def _end_events_batched(self):
        """Vectorized EOF flush (semantics of _end_events, ref:
        prophesee.rs:325-365). Flushes once (a consume() after EOF would
        otherwise re-ingest the held intensities, ref flushes once too)."""
        if getattr(self, "_end_flushed", False):
            return
        self._end_flushed = True
        n = self.plane.volume()
        ref = self.video.ref_time
        gap = self.running_t - self.dvs_last_timestamps.astype(np.int64)
        mask = gap > 0
        last_val = (np.exp(self.dvs_last_ln_val) - 1.0) * 255.0
        time_spanned = (gap * ref).astype(np.float64)
        intensity = (last_val * time_spanned).astype(np.float32)
        fv = np.clip(last_val, 0.0, 255.0).astype(np.int64).astype(np.int32)
        parts: list = []
        self._masked_call(
            np.where(mask, intensity, 0.0).astype(np.float32),
            np.where(mask, fv, 0),
            np.where(mask, time_spanned, 0.0).astype(np.float32),
            mask,
            parts,
        )
        self.video.encoder.ingest_event_array(self._events_from_parts(parts))

    def consume(self) -> EventArray:
        """One view interval's worth of DVS events (ref: prophesee.rs:116-297)."""
        if self.batched:
            return self._consume_batched()
        if self.running_t == 0:
            self._bootstrap()

        batch = self._next_dvs_batch()
        if batch is None:
            self._end_events()
            raise EOFError("prophesee source exhausted")

        ts, xs, ys, ps = batch
        W = self.plane.width
        ref = self.video.ref_time
        events: list = []
        for k in range(len(ts)):
            t = int(ts[k])
            i = int(ys[k]) * W + int(xs[k])
            last_t = int(self.dvs_last_timestamps[i])
            if t < last_t:
                continue
            last_ln = self.dvs_last_ln_val[i]

            if t > last_t + 1:
                last_val = (np.exp(last_ln) - 1.0) * 255.0
                last_val, last_ln = mid_clamp_u8(last_val, last_ln)
                time_spanned = (t - last_t - 1) * ref
                # f32 product by definition — matches the batched planners
                # and the device-side 8-byte carrier reconstruction
                # (ops/dvs_batch.DvsCompact.gap_val docstring)
                intensity = np.float32(
                    np.float32(last_val) * np.float32(t - last_t - 1)
                )
                self._integrate_px(
                    i, int(last_val), float(intensity), float(time_spanned), events
                )

            new_ln = last_ln - self.camera_theta if ps[k] == 0 else last_ln + self.camera_theta
            self.dvs_last_ln_val[i] = new_ln
            self.dvs_last_timestamps[i] = t

            if t > last_t:
                new_val = (np.exp(new_ln) - 1.0) * 255.0
                new_val, new_ln = mid_clamp_u8(new_val, new_ln)
                self.dvs_last_ln_val[i] = new_ln
                self._integrate_px(i, int(new_val), float(new_val), float(ref), events)

        arr = EventArray.from_events(events)
        self.video.encoder.ingest_event_array(arr)
        if self._eof:
            self._end_events()
        return arr

    def _end_events(self):
        """Flush held intensities at EOF (ref: prophesee.rs:325-365).
        Flushes once, like _end_events_batched."""
        if getattr(self, "_end_flushed", False):
            return
        self._end_flushed = True
        events: list = []
        ref = self.video.ref_time
        for i in range(len(self._pixels)):
            last_ln = self.dvs_last_ln_val[i]
            last_val = (np.exp(last_ln) - 1.0) * 255.0
            gap = self.running_t - int(self.dvs_last_timestamps[i])
            if gap <= 0:
                continue
            time_spanned = gap * ref
            intensity = last_val * time_spanned
            self._integrate_px(
                i, int(max(min(last_val, 255.0), 0.0)), float(intensity),
                float(time_spanned), events,
            )
        self.video.encoder.ingest_event_array(EventArray.from_events(events))

    def end_write_stream(self):
        return self.video.end_write_stream()
