"""DAVIS (APS frames + DVS events) -> ADDER source.

ref: adder-codec-rs/src/transcoder/source/davis.rs. The reference drives the
davis-edi-rs EDI deblur reconstructor on a dedicated thread and integrates
deblurred APS frames plus DVS events in log-intensity space with contrast
dvs_c = 0.15. EDI reconstruction itself is an external component there too;
here a `DavisFrameProvider` supplies (deblurred frame, exposure interval,
dvs events) tuples — from a file-backed reader or synthetic arrays — and the
three reference transcode modes are preserved:

  Framed   - integrate only the (deblurred) APS frames
  RawDavis - integrate APS frames AND the DVS events between them
  RawDvs   - integrate only DVS events

Integration runs batched on the device by default (ops/dvs_batch.py: the
per-event log-space chain is serial per pixel, so events are bucketed into
per-pixel lanes, like the Prophesee path); `batched=False` runs the scalar
pixel oracle.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.types import Coord, EventArray, Mode, PlaneSize, TimeMode
from ..utils.cv import clamp_u8
from . import pixel_oracle as O
from .video import SourceError, Video


class TranscoderMode(enum.IntEnum):
    """ref: davis.rs:39-53"""

    Framed = 0
    RawDavis = 1
    RawDvs = 2


@dataclass
class DvsEvent:
    t: int  # microseconds
    x: int
    y: int
    on: bool


@dataclass
class DvsEvents:
    """Struct-of-arrays DVS event batch: what high-rate providers (the EDI
    reconstructor over real aedat4 recordings) hand to the Davis source.
    Iterates as DvsEvent objects for the scalar-oracle path; the batched
    device path reads the arrays directly (no per-event Python objects)."""

    t: np.ndarray  # int64 microseconds
    x: np.ndarray
    y: np.ndarray
    on: np.ndarray  # bool

    def __len__(self) -> int:
        return len(self.t)

    def __iter__(self):
        for i in range(len(self.t)):
            yield DvsEvent(
                t=int(self.t[i]), x=int(self.x[i]), y=int(self.y[i]),
                on=bool(self.on[i]),
            )


@dataclass
class DavisPacket:
    """One reconstructed interval from the (external) EDI stage."""

    frame: Optional[np.ndarray]  # (H, W) u8 deblurred APS frame
    frame_start_us: int
    frame_end_us: int
    # DVS events since the previous packet: a list of DvsEvent or a
    # DvsEvents struct-of-arrays batch (preferred for high-rate sources)
    events: object


class ArrayDavisProvider:
    """Synthetic/array-backed provider for tests and offline data."""

    def __init__(self, packets: List[DavisPacket], plane: PlaneSize):
        self.packets = packets
        self.plane = plane

    def __iter__(self) -> Iterator[DavisPacket]:
        return iter(self.packets)


class Davis:
    """ref: davis.rs:55-900 (Davis / Integration)."""

    def __init__(
        self,
        provider,
        ref_time: int = 255,
        tps: int = 255_000_000,
        delta_t_max: Optional[int] = None,
        mode: TranscoderMode = TranscoderMode.RawDavis,
        batched: bool = True,
        prefetch: bool = True,
    ):
        if prefetch:
            from .edi import ThreadedProvider

            # P4: run the reconstructor/provider on a dedicated worker
            # thread so host deblur overlaps device integration
            # (ref: davis.rs:626-632). In-memory providers gain nothing
            # but lose nothing; already-threaded ones are left alone.
            if not isinstance(provider, ThreadedProvider):
                provider = ThreadedProvider(provider)
        self.provider = provider
        self.mode = mode
        self.plane = provider.plane
        self.dvs_c = 0.15  # ref: davis.rs:150
        self.video = Video(self.plane, Mode.Continuous)
        self.video.time_parameters(
            tps, ref_time, delta_t_max or ref_time * 30, TimeMode.AbsoluteT
        )
        n = self.plane.volume()
        self.dvs_last_timestamps = np.zeros(n, dtype=np.int64)
        self.dvs_last_ln_val = np.full(n, np.log1p(0.5), dtype=np.float64)
        self.batched = batched
        if batched:
            from ..ops import integrate as ops_integrate

            # deep arenas for gap cascades, as in the Prophesee batched path
            self._dev_state = ops_integrate.init_state(n, depth=16)
            self._pixels = []
        else:
            self._pixels = [
                O.PixelArena(
                    1.0,
                    Coord(i % self.plane.width, i // self.plane.width, None),
                )
                for i in range(n)
            ]
            for px in self._pixels:
                px.set_time_mode(TimeMode.AbsoluteT)
        self._iter = iter(provider)
        self._first_frame = True

    def _oracle_params(self):
        v = self.video
        crf = v.encoder.options.crf.get_parameters()
        return (
            Mode.Continuous, v.pixel_multi_mode, v.delta_t_max, v.ref_time,
            crf.c_thresh_max, max(crf.c_increase_velocity, 1),
        )

    def integrate_dvs_events(
        self, events: List[DvsEvent], buffer: list
    ) -> None:
        """Log-space DVS integration (ref: davis.rs:235-465): integrate the
        held intensity over the gap, then step ln intensity by *exp(+-c)."""
        mode, multi, dtm, ref, cmax, cvel = self._oracle_params()
        ticks_per_micro = self.video.tps / 1e6
        W = self.plane.width
        for e in events:
            i = e.y * W + e.x
            px = self._pixels[i]
            last_ln = self.dvs_last_ln_val[i]
            last_val = (np.exp(last_ln) - 1.0) * 255.0
            delta_t_micro = e.t - self.dvs_last_timestamps[i]
            if delta_t_micro == e.t or delta_t_micro < 0:
                self.dvs_last_timestamps[i] = e.t
                continue
            delta_t_ticks = delta_t_micro * ticks_per_micro
            first_integration = max(last_val / ref * delta_t_ticks, 0.0)

            if px.need_to_pop_top:
                buffer.append(px.pop_top_event(first_integration, mode, ref))
            px.integrate(first_integration, delta_t_ticks, mode, dtm, ref, cmax, cvel, multi)
            if px.need_to_pop_top:
                buffer.append(px.pop_top_event(first_integration, mode, ref))

            # the reference multiplies the ln value by exp(+-c) (davis.rs:365)
            last_ln *= np.exp(self.dvs_c if e.on else -self.dvs_c)
            frame_val = (np.exp(last_ln) - 1.0) * 255.0
            frame_val, last_ln = clamp_u8(frame_val, last_ln)
            self.dvs_last_ln_val[i] = last_ln
            fv8 = int(frame_val)
            if fv8 < max(px.base_val - px.c_thresh, 0) or fv8 > min(
                px.base_val + px.c_thresh, 255
            ):
                px.pop_best_events(buffer, mode, multi, ref, frame_val)
                px.base_val = fv8
                ev = px.set_d_for_continuous(frame_val, ref)
                if ev is not None:
                    buffer.append(ev)
            self.dvs_last_timestamps[i] = e.t

    def integrate_frame_gaps(
        self, start_of_frame_us: int, buffer: list
    ) -> None:
        """Fill per-pixel time up to the APS frame start (ref: davis.rs:466+)."""
        mode, multi, dtm, ref, cmax, cvel = self._oracle_params()
        ticks_per_micro = self.video.tps / 1e6
        for i, px in enumerate(self._pixels):
            gap_us = start_of_frame_us - self.dvs_last_timestamps[i]
            if gap_us <= 0:
                continue
            last_ln = self.dvs_last_ln_val[i]
            last_val = (np.exp(last_ln) - 1.0) * 255.0
            dt_ticks = gap_us * ticks_per_micro
            intensity = max(last_val / ref * dt_ticks, 0.0)
            O.integrate_for_px(
                px, int(max(min(last_val, 255.0), 0.0)), intensity, dt_ticks,
                buffer, mode, multi, dtm, ref, cmax, cvel,
            )
            self.dvs_last_timestamps[i] = start_of_frame_us

    def integrate_frame(self, frame: np.ndarray, exposure_us: int, buffer: list) -> None:
        """Integrate a (deblurred) APS frame like a framed source
        (ref: davis.rs consume, :601-900)."""
        mode, multi, dtm, ref, cmax, cvel = self._oracle_params()
        ticks_per_micro = self.video.tps / 1e6
        dt_ticks = max(exposure_us, 1) * ticks_per_micro
        flat = frame.reshape(-1)
        for i, px in enumerate(self._pixels):
            fv = int(flat[i])
            intensity = fv / ref * dt_ticks
            O.integrate_for_px(
                px, fv, intensity, dt_ticks, buffer, mode, multi, dtm, ref,
                cmax, cvel,
            )
            self.dvs_last_ln_val[i] = np.log1p(fv / 255.0)

    # -- batched device path (ops/dvs_batch.py) --

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

    def _integrate_dvs_events_batched(self, events, parts: list) -> None:
        import jax.numpy as jnp

        from ..ops import dvs_batch as B

        if not len(events):
            return
        if isinstance(events, DvsEvents):
            ts = events.t.astype(np.int64)
            xs = events.x.astype(np.uint16)
            ys = events.y.astype(np.uint16)
            ons = events.on.astype(bool)
        else:
            ts = np.array([e.t for e in events], np.int64)
            xs = np.array([e.x for e in events], np.uint16)
            ys = np.array([e.y for e in events], np.uint16)
            ons = np.array([e.on for e in events], bool)
        lanes = B.plan_davis_events(
            ts, xs, ys, ons, self.plane.width, self.plane.volume(),
            self.dvs_last_timestamps, self.dvs_last_ln_val,
            self.dvs_c, self.video.ref_time, self.video.tps / 1e6,
        )
        lanes = [lane for lane in lanes if lane.mask.any()]
        if not lanes:
            return
        # one scanned dispatch for all lanes; compile shapes sticky-grow
        K = int(self._dev_state.node_d.shape[0]) + 3
        max_active = max(int(lane.mask.sum()) for lane in lanes)
        take = 1 << (max(64, max_active * K) - 1).bit_length()
        take = self._scan_take = max(take, getattr(self, "_scan_take", 0))
        L_pad = 1 << (len(lanes) - 1).bit_length()
        L_pad = self._scan_lpad = max(L_pad, getattr(self, "_scan_lpad", 0))
        fn = B.make_davis_scan_step(self._tp(), take)
        stacked = [jnp.asarray(a) for a in B.stack_davis_lanes(lanes, L_pad)]
        st, pixd, t, total, max_sub = fn(self._dev_state, *stacked)
        import jax

        total_i, max_sub_i = map(int, jax.device_get((total, max_sub)))
        assert max_sub_i <= take  # unreachable: take >= active_pixels * K
        self._dev_state = st
        pixd_h, t_h = jax.device_get((pixd[:total_i], t[:total_i]))
        parts.append(B.wire_to_events(pixd_h, t_h, self.plane.width))

    def _masked_call(self, intensity, fv, time, mask, parts: list) -> None:
        # shares Prophesee's masked call (device compaction; only the event
        # prefix is fetched)
        from .prophesee import Prophesee

        Prophesee._masked_call(self, intensity, fv, time, mask, parts)

    def _integrate_frame_gaps_batched(self, start_of_frame_us, parts) -> None:
        tpm = self.video.tps / 1e6
        ref = self.video.ref_time
        gap_us = start_of_frame_us - self.dvs_last_timestamps
        mask = gap_us > 0
        last_val = (np.exp(self.dvs_last_ln_val) - 1.0) * 255.0
        dt_ticks = gap_us.astype(np.float64) * tpm
        intensity = np.maximum(last_val / ref * dt_ticks, 0.0)
        fv = np.clip(last_val, 0.0, 255.0).astype(np.int64)
        self._masked_call(
            np.where(mask, intensity, 0.0).astype(np.float32),
            np.where(mask, fv, 0).astype(np.int32),
            np.where(mask, dt_ticks, 0.0).astype(np.float32),
            mask, parts,
        )
        self.dvs_last_timestamps[mask] = start_of_frame_us

    def _integrate_frame_batched(self, frame, exposure_us, parts) -> None:
        tpm = self.video.tps / 1e6
        ref = self.video.ref_time
        dt_ticks = max(exposure_us, 1) * tpm
        fv = frame.reshape(-1).astype(np.int64)
        intensity = (fv.astype(np.float64) / ref * dt_ticks).astype(np.float32)
        n = self.plane.volume()
        self._masked_call(
            intensity, fv.astype(np.int32),
            np.full(n, dt_ticks, np.float32), np.ones(n, bool), parts,
        )
        self.dvs_last_ln_val[:] = np.log1p(fv / 255.0)

    def consume(self) -> EventArray:
        packet = next(self._iter, None)
        if packet is None:
            raise EOFError("davis source exhausted")
        buffer: list = []
        parts: list = []
        if self.mode in (TranscoderMode.RawDavis, TranscoderMode.RawDvs):
            if self.batched:
                self._integrate_dvs_events_batched(packet.events, parts)
            else:
                self.integrate_dvs_events(packet.events, buffer)
        if self.mode in (TranscoderMode.Framed, TranscoderMode.RawDavis):
            if packet.frame is not None:
                if self.mode == TranscoderMode.RawDavis:
                    if self.batched:
                        self._integrate_frame_gaps_batched(
                            packet.frame_start_us, parts
                        )
                    else:
                        self.integrate_frame_gaps(
                            packet.frame_start_us, buffer
                        )
                if self.batched:
                    self._integrate_frame_batched(
                        packet.frame,
                        packet.frame_end_us - packet.frame_start_us,
                        parts,
                    )
                else:
                    self.integrate_frame(
                        packet.frame,
                        packet.frame_end_us - packet.frame_start_us,
                        buffer,
                    )
                np.copyto(
                    self.dvs_last_timestamps,
                    np.maximum(self.dvs_last_timestamps, packet.frame_end_us),
                )
        if self.batched:
            from .prophesee import Prophesee

            arr = Prophesee._events_from_parts(parts)
        else:
            arr = EventArray.from_events(buffer)
        self.video.encoder.ingest_event_array(arr)
        return arr

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

    def write_out(self, *args, **kwargs):
        self.video.write_out(*args, **kwargs)
        return self

    def get_video_ref(self):
        return self.video

    def end_write_stream(self):
        return self.video.end_write_stream()
