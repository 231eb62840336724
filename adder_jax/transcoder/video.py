"""Video: the transcoder runtime tying the dense kernel to the encoder.

ref: adder-codec-rs/src/transcoder/source/video.rs (Video<W>, VideoState,
builder methods, integrate_matrix, CRF/ROI quality control).

Data-parallel redesign:
- The reference's rayon row-chunk fan-out (video.rs:677-734) disappears: the
  whole H*W*C plane is one dense kernel invocation; event order equals the
  reference's single-thread order (its own determinism contract).
- Frames are transcoded in device-resident chunks of T intervals via one
  jitted lax.scan (ops.integrate.make_transcode_chunk); events come back as
  one compacted struct-of-arrays block per chunk and are bulk-fed to the
  encoder (no per-event host loop).
- Event-capacity overflow is detected from the returned count; the chunk is
  re-run from the (still-live) pre-chunk state with a doubled cap.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..codec.encoder import (
    Encoder,
    EncoderOptions,
    EncoderType,
    RawOutput,
)
from ..codec.header import CodecMetadata, LATEST_CODEC_VERSION
from ..codec.rate_controller import Crf
from ..core.types import (
    EventArray,
    Mode,
    NO_CHANNEL,
    PixelMultiMode,
    PlaneSize,
    SourceCamera,
    TimeMode,
)
from ..ops import integrate as ops
from ..runtime import device_path
from ..utils import tracing


class SourceError(Exception):
    pass


# Chunks of at most this many pixel-intervals get the exact event capacity
# K_SLOTS * N * T up front; larger ones start at N * T and grow on overflow.
FULL_CAP_MAX_PX = 1 << 20


@functools.lru_cache(maxsize=16)
def _make_feature_lookup(H: int, W: int, C: int, n: int):
    """Jitted batched FAST mask + candidate gather over a chunk's running
    frames (ref predicate: cv.rs:26-212 via utils.cv.fast_mask_jax)."""
    from ..utils.cv import fast_mask_jax

    def f(runnings, cand):
        # cand: ONE (3, pad) i32 array [interval, y, x]
        ii, yy, xx = cand[0], cand[1], cand[2]
        T = runnings.shape[0]
        frames = runnings[:, :n].reshape(T, H, W, C)[..., 0]
        masks = jax.vmap(fast_mask_jax)(frames)
        # bit-pack the per-candidate corner bits (8x less d2h; the pad is
        # a power of two >= 256, so it divides by 8)
        return jnp.packbits(masks[ii, yy, xx])

    return jax.jit(f)


@dataclass
class Roi:
    """Region of interest (ref: video.rs:219-223)."""

    start_x: int
    start_y: int
    end_x: int
    end_y: int


class Video:
    """Shared transcoder engine for all sources (ref: video.rs:322-1301)."""

    def __init__(
        self,
        plane: PlaneSize,
        pixel_tree_mode: Mode,
        chunk_frames: int = 8,
    ):
        self.plane = plane
        self.n = plane.volume()
        self.pixel_tree_mode = pixel_tree_mode
        self.pixel_multi_mode = PixelMultiMode.Collapse
        self.delta_t_max = 7650
        self.ref_time = 255
        self.tps = 7650
        self.time_mode = TimeMode.AbsoluteT
        self.in_interval_count = 0
        self.chunk_frames = chunk_frames
        self.roi: Optional[Roi] = None
        self.feature_detection = False

        device_path()  # refuses platforms without an XLA path
        self.n_state = self.n  # ShardedVideo pads to a multiple of devices

        self.state = ops.init_state(self.n_state)
        self._c_thresh_baseline_applied = False

        meta = self._make_meta()
        self.encoder = Encoder.new_empty(meta, EncoderOptions.default(plane))
        self.encoder_type = EncoderType.Empty

        self._chunk_fns: dict = {}
        self._warmed: set = set()  # background-compiled (cap, pack, T) keys
        self._cap_mult = 1  # event capacity = _cap_mult * N * T per chunk
        self._pack = 4  # slot-packing lanes (K_SLOTS disables packing)
        self.running_intensities = np.zeros(plane.shape, dtype=np.uint8)
        self._last_runnings = None
        self._inflight: list = []  # submitted, not-yet-collected chunks
        # With an Empty encoder, events can stay on device ("the void",
        # matching the reference's EmptyOutput bench mode, empty/stream.rs):
        # collect then skips the device->host event fetch entirely.
        self.void_events = False
        self._keep_running_frame = False  # set True to always sync display
        self.instantaneous_view_mode = 0  # FramedViewMode.Intensity
        self.show_features = 0  # ShowFeatureMode.Off
        self.feature_rate_adjustment = False
        self.feature_cluster = False
        self.features: set = set()  # persistent feature coords (x, y)
        self.display_frame_features = np.zeros(plane.shape, dtype=np.uint8)

    # -- builder methods (ref: video.rs:271-317 VideoBuilder) --

    def _make_meta(self, source_camera=SourceCamera.FramedU8, adu_interval=0):
        return CodecMetadata(
            codec_version=LATEST_CODEC_VERSION,
            time_mode=self.time_mode,
            plane=self.plane,
            tps=self.tps,
            ref_interval=self.ref_time,
            delta_t_max=self.delta_t_max,
            source_camera=source_camera,
            adu_interval=adu_interval,
        )

    def time_parameters(
        self, tps: int, ref_time: int, delta_t_max: int, time_mode=None
    ) -> "Video":
        """ref: video.rs:493-537"""
        if delta_t_max < ref_time:
            raise SourceError(
                f"delta_t_max {delta_t_max} < ref_time {ref_time}"
            )
        self.tps = tps
        self.ref_time = ref_time
        self.delta_t_max = delta_t_max
        if time_mode is not None:
            self.time_mode = TimeMode(time_mode)
        self._chunk_fns.clear()
        return self

    def write_out(
        self,
        source_camera: Optional[SourceCamera],
        time_mode: Optional[TimeMode],
        pixel_multi_mode: Optional[PixelMultiMode],
        adu_interval: Optional[int],
        encoder_type: EncoderType,
        encoder_options: EncoderOptions,
        write,
        entropy: str = "cabac",
    ) -> "Video":
        """Attach the output encoder (ref: video.rs:546-636). `entropy`
        selects the compressed stage: "cabac" (reference-compatible
        `addec`) or "rans" (own interleaved-rANS `addrn`)."""
        self.pixel_multi_mode = (
            PixelMultiMode.Collapse
            if pixel_multi_mode is None
            else pixel_multi_mode
        )
        if time_mode is not None:
            self.time_mode = TimeMode(time_mode)
        meta = self._make_meta(
            source_camera or SourceCamera.FramedU8, adu_interval or 0
        )
        meta.time_mode = self.time_mode
        if encoder_type == EncoderType.Raw:
            self.encoder = Encoder(RawOutput(meta, write), encoder_options)
        elif encoder_type == EncoderType.Compressed:
            self.encoder = Encoder.new_compressed(
                meta, write, encoder_options, entropy=entropy
            )
        else:
            self.encoder = Encoder.new_empty(meta, encoder_options)
        self.encoder_type = encoder_type
        self._chunk_fns.clear()
        return self

    def end_write_stream(self):
        """Flush pending frames and close the writer (ref: video.rs:641-648)."""
        self.flush()
        writer = self.encoder.close_writer()
        meta = self._make_meta()
        self.encoder = Encoder.new_empty(meta, self.encoder.options)
        return writer

    # -- quality control --

    def update_crf(self, crf: int) -> None:
        """ref: video.rs:1241-1251"""
        self.encoder.options.crf = Crf(crf, self.plane)
        self.encoder.sync_crf()
        base = self.encoder.options.crf.get_parameters().c_thresh_baseline
        self.state = self.state._replace(
            c_thresh=jnp.full((self.n_state,), base, jnp.int32),
            c_increase_counter=jnp.zeros((self.n_state,), jnp.int32),
        )

    def update_quality_manual(
        self,
        c_thresh_baseline: int,
        c_thresh_max: int,
        delta_t_max_multiplier: int,
        c_increase_velocity: int,
        feature_c_radius: float,
    ) -> None:
        """ref: video.rs:1264-1287"""
        crf = self.encoder.options.crf
        crf.override_c_thresh_baseline(c_thresh_baseline)
        crf.override_c_thresh_max(c_thresh_max)
        crf.override_c_increase_velocity(c_increase_velocity)
        crf.override_feature_c_radius(int(feature_c_radius))
        self.delta_t_max = delta_t_max_multiplier * self.ref_time
        self.encoder.sync_crf()
        self._chunk_fns.clear()
        self.state = self.state._replace(
            c_thresh=jnp.full((self.n_state,), c_thresh_baseline, jnp.int32),
            c_increase_counter=jnp.zeros((self.n_state,), jnp.int32),
        )

    def update_delta_t_max(self, dtm: int) -> None:
        self.delta_t_max = max(self.ref_time, dtm)
        self._chunk_fns.clear()

    def update_roi(self, roi: Optional[Roi]) -> None:
        self.roi = roi

    def _apply_roi(self) -> None:
        """Lower c_thresh inside the ROI (ref: video.rs:865-881)."""
        if self.roi is None:
            return
        base = min(
            self.encoder.options.crf.get_parameters().c_thresh_baseline, 2
        )
        mask = np.zeros(self.plane.shape, dtype=bool)
        mask[
            self.roi.start_y : self.roi.end_y + 1,
            self.roi.start_x : self.roi.end_x + 1,
            :,
        ] = True
        c = np.array(self.state.c_thresh)
        c[: self.n][mask.reshape(-1)] = base
        self.state = self.state._replace(c_thresh=jnp.asarray(c))

    # -- getters (API parity) --

    def get_ref_time(self):
        return self.ref_time

    def get_delta_t_max(self):
        return self.delta_t_max

    def get_tps(self):
        return self.tps

    def get_time_mode(self):
        return self.time_mode

    def get_encoder_options(self):
        return self.encoder.get_options()

    def get_event_size(self):
        return self.encoder.meta.event_size

    # -- transcoding --

    def _params(self) -> ops.TranscodeParams:
        p = self.encoder.options.crf.get_parameters()
        return ops.TranscodeParams(
            mode=int(self.pixel_tree_mode),
            multi_mode=int(self.pixel_multi_mode),
            time_mode=int(self.time_mode),
            ref_time=self.ref_time,
            delta_t_max=self.delta_t_max,
            c_thresh_max=p.c_thresh_max,
            c_increase_velocity=max(p.c_increase_velocity, 1),
        )

    def _chunk_fn(self, cap: int, pack: int = 4):
        return ops.make_transcode_chunk(self._params(), cap, pack)

    def _prewarm_chunk_fn(self, cap: int, pack: int, T: int) -> None:
        """AOT-compile a chunk graph on a background thread so capacity-step
        transitions (cap_mult growth on overflow, decay afterwards) never
        stall the stream with a 20-50 s compile (round-1 diagnosed the color
        1080p "slowdown" as exactly this thrash). The persistent XLA cache
        makes each warm a one-time cost per machine."""
        key = (cap, pack, T, self._params())
        if key in self._warmed:
            return
        self._warmed.add(key)

        import threading

        import jax

        def run():
            try:
                fn = self._chunk_fn(cap, pack)
                n = self.n_state
                sd = jax.ShapeDtypeStruct
                state = jax.tree.map(
                    lambda x: sd(x.shape, x.dtype), self.state
                )
                fn.lower(
                    state,
                    sd((T, n), jnp.uint8),
                    sd((), jnp.float32),
                    sd((n,), jnp.uint8),
                ).compile()
            except Exception:
                pass  # warm-up is best-effort; the foreground path compiles

        threading.Thread(target=run, daemon=True).start()

    def integrate_matrix(
        self, matrix: np.ndarray, time_spanned: float
    ) -> EventArray:
        """Transcode one input interval; returns this interval's events (also
        fed to the encoder). ref: video.rs:651-778.

        For throughput, prefer `integrate_matrix_batch` (amortizes the jit
        dispatch over many frames) — this single-frame path exists for API
        parity and interactive use.
        """
        matrix = np.asarray(matrix)
        if matrix.ndim == 2:
            matrix = matrix[..., None]
        return self.integrate_matrix_batch(matrix[None, ...], time_spanned)

    def integrate_matrix_batch(
        self, frames: np.ndarray, time_spanned: Optional[float] = None
    ) -> EventArray:
        """Transcode T frames (T, H, W, C) through one device chunk."""
        return self.collect_chunk(self.submit_chunk(frames, time_spanned))

    def submit_chunk(self, frames: np.ndarray, time_spanned=None) -> dict:
        """Enqueue a device chunk without blocking; pair with collect_chunk.

        The next chunk is enqueued on the previous chunk's (still
        unmaterialized) output state BEFORE the previous chunk's events are
        fetched, so its compute overlaps the previous device->host event
        transfer. This is safe under overflow: capacity overflow truncates
        only the event buffer, never the carried state, so the overflow
        re-run (collect_chunk) recovers events without invalidating later
        chunks. Two chunks may be in flight; older ones are collected here
        (their events reach the encoder in order).
        """
        frames = np.asarray(frames)
        T = frames.shape[0]
        flat = frames.reshape(T, -1)
        if flat.shape[1] != self.n:
            raise SourceError(
                f"frame shape {frames.shape[1:]} != plane {self.plane.shape}"
            )
        if time_spanned is None:
            time_spanned = float(self.ref_time)

        if self.in_interval_count == 0:
            self.state = ops.set_initial_d(
                self.state, jnp.asarray(flat[0].astype(np.int32))
            )
        self._apply_roi()
        self.in_interval_count += T

        frames_u8 = jnp.asarray(flat.astype(np.uint8))
        t = jnp.float32(time_spanned)
        if (
            (self.feature_detection or self._keep_running_frame)
            and self._inflight
        ):
            # chain the running-frame carry ON DEVICE: the previous chunk's
            # final running frame feeds this chunk with no host sync, so
            # submit/collect pipelining survives features-on (the round-3
            # path flushed before every chunk, serializing the pipeline)
            run0 = self._inflight[-1]["outs"][8][-1]
        else:
            run0 = jnp.asarray(self.running_intensities.reshape(-1))

        # cap quantized to power-of-two multiples of N so the jit cache
        # stays warm across chunks; K_SLOTS*N*T is an exact upper bound,
        # so small chunks get it immediately (no overflow recompiles)
        mult = min(self._cap_mult, ops.K_SLOTS)
        if self.n_state * T <= FULL_CAP_MAX_PX:
            mult = ops.K_SLOTS
        cap = mult * self.n_state * T
        fn = self._chunk_fn(cap, self._pack)
        if mult < ops.K_SLOTS:
            # an overflow would block on a fresh compile; warm it now
            next_cap = min(mult * 2, ops.K_SLOTS) * self.n_state * T
            self._prewarm_chunk_fn(next_cap, self._pack, T)
        state_before = self.state
        with tracing.stage("video.submit_chunk", items=T * self.n):
            outs = fn(self.state, frames_u8, t, run0)
        self.state = outs[0]  # optimistic; collect_chunk reverts on overflow
        pending = {
            "outs": outs,
            "state_before": state_before,
            "frames_u8": frames_u8,
            "t": t,
            "run0": run0,
            "T": T,
            "mult": mult,
            "cap": cap,
            "pack": self._pack,
        }
        self._inflight.append(pending)
        while len(self._inflight) > 2:
            self._collect_oldest()
        return pending

    def collect_chunk(self, pending: dict) -> EventArray:
        """Block on a submitted chunk (collecting older ones first, in
        order); feed its events to the encoder."""
        ev = None
        while any(p is pending for p in self._inflight):
            ev = self._collect_oldest()
        if ev is None:
            raise SourceError("collect_chunk: unknown pending handle")
        return ev

    def _collect_oldest(self) -> EventArray:
        pending = self._inflight.pop(0)
        T = pending["T"]
        outs = pending["outs"]
        mult, cap, pack = pending["mult"], pending["cap"], pending["pack"]
        while True:
            (
                new_state, pixd, tt, t16, t_base, t16_ok, total, per_int,
                runnings, pack_max,
            ) = outs
            # one host round-trip for all control scalars
            with tracing.stage("video.collect.control_fetch"):
                total_i, per_int_max, pack_max_i, t16_ok_b, t_base_i = (
                    jax.device_get(
                        (total, jnp.max(per_int), pack_max, t16_ok, t_base)
                    )
                )
            total_i = int(total_i)
            take = ops.per_interval_take(cap, T)
            overflowed = total_i > cap or int(per_int_max) > min(
                take, ops.K_SLOTS * self.n_state
            )
            pack_overflow = pack < ops.K_SLOTS and int(pack_max_i) > pack
            if not overflowed and not pack_overflow:
                # decay the capacity once bursts pass (a scene-change chunk
                # shouldn't permanently inflate the compaction prefix)
                if int(per_int_max) * 8 < take and self._cap_mult > 1:
                    self._cap_mult //= 2
            if pack_overflow:
                # a pixel emitted more events than the packed lanes hold:
                # this plane/content needs the lossless-slot graph
                # permanently
                self._pack = pack = ops.K_SLOTS
            elif not overflowed or mult >= ops.K_SLOTS:
                break
            else:
                # capacity overflow: grow the buffer
                mult *= 2
                self._cap_mult = mult
                cap = min(mult, ops.K_SLOTS) * self.n_state * T
            # rerun synchronously from the untouched pre-chunk state
            # (overflow truncates only the event buffer, never the carried
            # state, so chunks already submitted on top of it stay valid)
            fn = self._chunk_fn(cap, pack)
            outs = fn(
                pending["state_before"], pending["frames_u8"], pending["t"],
                pending["run0"],
            )
        if not self._inflight:
            self.state = new_state
        # else: newer chunks are still in flight and self.state already
        # points at the NEWEST chunk's (optimistic) output state from
        # submit_chunk; reverting it to this older chunk's output would
        # make the next submit integrate from stale state
        self._last_runnings = runnings  # (T, N) u8, fetched lazily on demand
        if self.feature_detection or self._keep_running_frame:
            self.running_intensities = np.asarray(
                runnings[-1][: self.n]
            ).reshape(self.plane.shape)

        if self.void_events and not self.feature_detection:
            return EventArray.empty()
        with tracing.stage("video.collect.event_fetch", items=total_i):
            if bool(t16_ok_b):
                # 6-byte wire path: u16 timestamps relative to the chunk base
                pixd_h, t16_h = jax.device_get(
                    (pixd[:total_i], t16[:total_i])
                )
                t_host = t16_h.astype(np.uint32) + np.uint32(int(t_base_i))
            else:
                pixd_h, t_host = jax.device_get(
                    (pixd[:total_i], tt[:total_i])
                )
        pixd = np.asarray(pixd_h)
        pix = (pixd >> 8).astype(np.int64)
        d = (pixd & 0xFF).astype(np.uint8)
        events = self._events_from_flat(pix, d, t_host)
        with tracing.stage("video.encode", items=len(events)):
            self.encoder.ingest_event_array(events)
        if self.feature_detection:
            # runnings stays on device: FAST masks are computed there and
            # only per-candidate bits come back (no (T, N) frame fetch)
            self._handle_features(events, np.asarray(per_int), runnings)
        return events

    # -- feature pipeline (ref: video.rs:883-1227) --

    def update_detect_features(
        self,
        detect_features: bool,
        show_features=0,
        feature_rate_adjustment: bool = False,
        feature_cluster: bool = False,
    ) -> None:
        self.feature_detection = detect_features
        self.show_features = show_features
        self.feature_rate_adjustment = feature_rate_adjustment
        self.feature_cluster = feature_cluster

    def _handle_features(self, events, per_int, runnings) -> None:
        """Per-interval FAST feature maintenance over the event coordinates
        (ref: video.rs:883-1112). Candidate coords are gathered host-side
        (vector numpy over the chunk's events); the FAST masks are computed
        ON DEVICE over the chunk's running frames in one batched call and
        only the per-candidate corner bits come back (same decisions as the
        numpy fast_mask — pinned by tests/test_utils_tools.py)."""
        from ..utils.viz import ShowFeatureMode, draw_feature_coord

        H, W = self.plane.height, self.plane.width
        offsets = np.concatenate([[0], np.cumsum(per_int)])
        self.display_frame_features = self.running_intensities.copy()
        # ONE pass over the chunk's events (no per-interval Python loop):
        # candidate rule — channel 0/None, non-empty d, coord differs from
        # the circularly-next event's coord WITHIN its interval
        # (ref: video.rs:900-917). The circular next is arange+1 with each
        # interval's last event wrapping to that interval's first.
        n_ev = len(events)
        xs, ys, cs, ds = events.x, events.y, events.c, events.d
        nxt = np.arange(1, n_ev + 1, dtype=np.int64)
        ends = offsets[1:] - 1
        starts = offsets[:-1]
        nonempty = ends >= starts
        nxt[ends[nonempty]] = starts[nonempty]
        cand = (
            ((cs == NO_CHANNEL) | (cs == 0))
            & (ds != 255)
            & ((xs != xs[nxt]) | (ys != ys[nxt]))
        )
        ci = np.flatnonzero(cand)

        new_features: list = []
        if len(ci):
            ii = np.repeat(
                np.arange(len(per_int), dtype=np.int32), per_int
            )[ci]
            xx = xs[ci].astype(np.int32)
            yy = ys[ci].astype(np.int32)
            is_f = np.asarray(
                self._feature_mask_lookup(runnings, ii, yy, xx)
            ).astype(bool)
            # Exact replay of the stream-order set updates, vectorized:
            # membership after the chunk = the key's LAST candidate's mask
            # bit, and a key was ADDED iff some candidate has f=True while
            # the previous state was False (previous candidate's bit, or
            # the pre-chunk set membership for the key's first candidate).
            key = yy.astype(np.int64) * W + xx
            sk = np.lexsort((np.arange(len(key)), key))
            k_s, f_s = key[sk], is_f[sk]
            first = np.ones(len(k_s), bool)
            first[1:] = k_s[1:] != k_s[:-1]
            last = np.empty(len(k_s), bool)
            last[:-1] = first[1:]
            last[-1] = True
            prev = np.empty(len(k_s), bool)
            prev[1:] = f_s[:-1]
            uk = k_s[first]
            ux, uy = (uk % W).astype(int), (uk // W).astype(int)
            prev[first] = [
                (int(x), int(y)) in self.features for x, y in zip(ux, uy)
            ]
            added = np.logical_and(f_s, ~prev)
            added_any = np.logical_or.reduceat(added, np.flatnonzero(first))
            final_f = f_s[last]
            for x, y, fin, add in zip(ux, uy, final_f, added_any):
                k = (int(x), int(y))
                if add:
                    new_features.append(k)
                if fin:
                    self.features.add(k)
                else:
                    self.features.discard(k)

        params = self.encoder.options.crf.get_parameters()
        if self.show_features == ShowFeatureMode.Hold:
            for (x, y) in self.features:
                draw_feature_coord(
                    x, y, self.display_frame_features, self.plane.channels != 1
                )
        if self.show_features == ShowFeatureMode.Instant:
            for (x, y) in set(new_features):
                draw_feature_coord(
                    x, y, self.display_frame_features, self.plane.channels != 1
                )
        if (
            self.feature_rate_adjustment
            and params.feature_c_radius > 0
            and new_features
        ):
            # one state fetch + one write for ALL new features (the old
            # loop round-tripped the full c_thresh plane per feature)
            r = params.feature_c_radius
            c_full = np.array(self.state.c_thresh)
            c = c_full[: self.n].reshape(self.plane.shape[:2] + (-1,))
            for (x, y) in set(new_features):
                lo_y, hi_y = max(y - r, 0), min(y + r, H - 1)
                lo_x, hi_x = max(x - r, 0), min(x + r, W - 1)
                c[lo_y : hi_y + 1, lo_x : hi_x + 1, :] = min(
                    params.c_thresh_baseline, 2
                )
            c_full[: self.n] = c.reshape(-1)
            self.state = self.state._replace(c_thresh=jnp.asarray(c_full))
        if self.feature_cluster and new_features:
            self.cluster(set(new_features))

    def _feature_mask_lookup(self, runnings, ii, yy, xx) -> np.ndarray:
        """FAST-corner bits for candidate (interval, y, x) coords: batched
        device fast_mask_jax over the chunk's running frames + gather.
        Candidate count pads to a sticky power of two (stable jit shapes)."""
        n_c = len(ii)
        pad = 1 << max(8, (n_c - 1).bit_length())
        pad = self._feat_pad = max(pad, getattr(self, "_feat_pad", 0))
        padw = (0, pad - n_c)
        fn = _make_feature_lookup(
            self.plane.height, self.plane.width, self.plane.channels, self.n
        )
        with tracing.stage("video.features.mask_lookup", items=n_c):
            cand = np.zeros((3, pad), np.int32)
            cand[0, :n_c] = ii
            cand[1, :n_c] = yy
            cand[2, :n_c] = xx
            bits = fn(jnp.asarray(runnings), jnp.asarray(cand))
            return np.unpackbits(np.asarray(bits))[:n_c].astype(bool)

    def cluster(self, points_set: set) -> list:
        """DBSCAN over feature coordinates; returns bounding boxes
        (ref: video.rs:1114-1227: eps = min_resolution/3, min_pts = 3)."""
        from ..utils.viz import draw_rect

        points = np.array(sorted(points_set), dtype=np.float32)
        if len(points) < 3:
            return []
        eps2 = (self.plane.min_resolution() / 3.0) ** 2
        min_pts = 3
        d2 = ((points[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        neighbors = [np.flatnonzero(d2[i] <= eps2) for i in range(len(points))]
        visited = np.zeros(len(points), dtype=bool)
        clusters = []
        for i in range(len(points)):
            if visited[i]:
                continue
            visited[i] = True
            if len(neighbors[i]) < min_pts:
                continue
            cluster = {i}
            frontier = list(neighbors[i])
            k = 0
            while k < len(frontier):
                j = frontier[k]
                if not visited[j]:
                    visited[j] = True
                    if len(neighbors[j]) >= min_pts:
                        frontier.extend(
                            n for n in neighbors[j] if n not in cluster
                        )
                cluster.add(j)
                k += 1
            clusters.append(cluster)
        bboxes = []
        for cluster in clusters:
            pts = points[list(cluster)]
            min_x, min_y = pts.min(axis=0).astype(int)
            max_x, max_y = pts.max(axis=0).astype(int)
            if (max_x - min_x) * (max_y - min_y) < self.plane.area_wh() // 4:
                bboxes.append((int(min_x), int(min_y), int(max_x), int(max_y)))
                draw_rect(
                    int(min_x), int(min_y), int(max_x), int(max_y),
                    self.display_frame_features, self.plane.channels != 1,
                )
        return bboxes

    def _events_from_flat(self, pix, d, t) -> EventArray:
        C = self.plane.channels
        W = self.plane.width
        c = (pix % C).astype(np.uint8) if C > 1 else np.full(len(pix), NO_CHANNEL, np.uint8)
        xy = pix // C
        x = (xy % W).astype(np.uint16)
        y = (xy // W).astype(np.uint16)
        return EventArray(x, y, c, d, t)

    def flush(self) -> None:
        """Collect any in-flight chunks (their events reach the encoder)."""
        while self._inflight:
            self._collect_oldest()

    # -- checkpoint / resume (beyond the reference, which has none: its
    # only resume surface is decode-side seek — SURVEY section 5) --

    def save_checkpoint(self, path) -> None:
        """Persist the transcoder state so a long job can resume mid-stream
        (pair with the encoder's byte position, which the caller owns).
        Captures the pixel-state arrays and the interval counter; quality
        settings are reconstructed from the builder calls on resume."""
        self.flush()
        state = {f"state_{k}": np.asarray(v)
                 for k, v in zip(ops.PixelState._fields, self.state)}
        np.savez_compressed(
            path,
            in_interval_count=np.int64(self.in_interval_count),
            n=np.int64(self.n),
            n_state=np.int64(self.n_state),
            running_intensities=self.running_intensities,
            **state,
        )

    def load_checkpoint(self, path) -> None:
        """Restore state saved by save_checkpoint (same plane/config)."""
        z = np.load(path)
        if int(z["n"]) != self.n:
            raise SourceError(
                f"checkpoint plane volume {int(z['n'])} != {self.n}"
            )
        if int(z["n_state"]) != self.n_state:
            raise SourceError(
                "checkpoint was taken with a different plane padding"
            )
        fields = {
            k: jnp.asarray(z[f"state_{k}"]) for k in ops.PixelState._fields
        }
        # checkpoints taken with shallower arenas resume at full depth
        self.state = ops.pad_state_depth(ops.PixelState(**fields), ops.DEPTH)
        self.in_interval_count = int(z["in_interval_count"])
        self.running_intensities = z["running_intensities"]

    def detect_features(self, detect: bool, show_features=None) -> "Video":
        self.feature_detection = detect
        return self
