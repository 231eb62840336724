"""Multi-device transcoder: the user-facing Video API over a device mesh.

`ShardedVideo` is `transcoder.video.Video` with the chunk step replaced by
the XLA chunk under `shard_map` (parallel/sharding.make_chunk_sharded): the
pixel plane row-bands across every device of the mesh, each device
integrates and compacts its own band, and there are NO collectives in the
hot loop (pixels never communicate — the data-parallel form of the
reference's rayon row chunking, ref
adder-codec-rs/src/transcoder/source/video.rs:677-734). Event buffers stay
per-device; collection assembles the global reference single-thread order
on the host (parallel/sharding.assemble_sharded_events), so .adder output
bytes are identical to the single-device path.

Differences from the single-device Video, by design:

- The plane pads to a multiple of the device count; pad-pixel events are
  filtered after host assembly.
- The u16 wire-timestamp compression of the event fetch is skipped
  (events fetch as u32 per-device prefixes).

Combine with parallel/multihost.py for multi-host jobs: build the global
mesh over all processes' devices, feed `submit_chunk` the global frame
array formed from per-host row bands, and collect per-host parts instead
of the global assembly.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..core.types import EventArray, Mode, PlaneSize
from ..ops import integrate as ops
from ..parallel import sharding as sh
from ..utils import tracing
from .video import FULL_CAP_MAX_PX, SourceError, Video


class ShardedVideo(Video):
    """Video over a jax.sharding.Mesh (multi-device; SURVEY §2.5 P1)."""

    def __init__(
        self,
        plane: PlaneSize,
        pixel_tree_mode: Mode,
        chunk_frames: int = 8,
        mesh=None,
    ):
        super().__init__(plane, pixel_tree_mode, chunk_frames)
        self.mesh = mesh if mesh is not None else sh.make_mesh()
        self.n_devices = int(np.prod(self.mesh.devices.shape))
        unit = self.n_devices
        self.n_state = ((self.n + unit - 1) // unit) * unit
        self.n_local = self.n_state // self.n_devices
        self.state = self._shard(ops.init_state(self.n_state))
        self._frames_sharding = jax.sharding.NamedSharding(
            self.mesh, jax.sharding.PartitionSpec(None, "px")
        )
        self._flat_sharding = jax.sharding.NamedSharding(
            self.mesh, jax.sharding.PartitionSpec("px")
        )

    # -- sharded plumbing --

    def _shard(self, state: ops.PixelState) -> ops.PixelState:
        return sh.shard_state(state, self.mesh)

    def _chunk_fn(self, cap_per_dev: int, pack: int = 4):
        key = (cap_per_dev, pack, self._params())
        fn = self._chunk_fns.get(key)
        if fn is None:
            fn = sh.make_chunk_sharded(
                self._params(), cap_per_dev, self.mesh, pack=pack
            )
            self._chunk_fns[key] = fn
        return fn

    def _prewarm_chunk_fn(self, cap, pack, T):  # pragma: no cover
        pass  # background AOT warm-up is a single-device optimization

    # -- transcoding --

    def submit_chunk(self, frames: np.ndarray, time_spanned=None) -> dict:
        """Enqueue one sharded device chunk; pair with collect_chunk.
        Same pipelining and overflow contract as Video.submit_chunk, with
        per-DEVICE event capacity."""
        if self.feature_detection:
            self.flush()
        frames = np.asarray(frames)
        T = frames.shape[0]
        flat = frames.reshape(T, -1)
        if flat.shape[1] != self.n:
            raise SourceError(
                f"frame shape {frames.shape[1:]} != plane {self.plane.shape}"
            )
        if time_spanned is None:
            time_spanned = float(self.ref_time)
        if self.n_state != self.n:
            flat = np.pad(flat, ((0, 0), (0, self.n_state - self.n)))
        if self.in_interval_count == 0:
            self.state = self._shard(
                ops.set_initial_d(
                    self.state, jnp.asarray(flat[0].astype(np.int32))
                )
            )
        if self.roi is not None:
            self._apply_roi()
            self.state = self._shard(self.state)
        self.in_interval_count += T

        frames_u8 = jax.device_put(
            jnp.asarray(flat.astype(np.uint8)), self._frames_sharding
        )
        t = jnp.float32(time_spanned)
        run0 = jax.device_put(
            jnp.asarray(
                np.pad(
                    self.running_intensities.reshape(-1),
                    (0, self.n_state - self.n),
                )
            ),
            self._flat_sharding,
        )

        mult = min(self._cap_mult, ops.K_SLOTS)
        if self.n_local * T <= FULL_CAP_MAX_PX:
            mult = ops.K_SLOTS
        cap = mult * self.n_local * T
        fn = self._chunk_fn(cap, self._pack)
        state_before = self.state
        with tracing.stage("sharded.submit_chunk", items=T * self.n):
            outs = fn(self.state, frames_u8, t, run0)
        self.state = outs[0]
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

    def _collect_oldest(self) -> EventArray:
        pending = self._inflight.pop(0)
        T = pending["T"]
        outs = pending["outs"]
        mult, cap, pack = pending["mult"], pending["cap"], pending["pack"]
        D = self.n_devices
        while True:
            (
                new_state, bufs_p, bufs_t, totals, per_int, pmax, runnings,
            ) = outs
            with tracing.stage("sharded.collect.control_fetch"):
                totals_h, per_int_h, pmax_h = jax.device_get(
                    (totals, per_int, pmax)
                )
            totals_h = np.asarray(totals_h)
            per_int_h = np.asarray(per_int_h)
            take = ops.per_interval_take(cap, T)
            overflowed = int(totals_h.max()) > cap or int(
                per_int_h.max()
            ) > min(take, ops.K_SLOTS * self.n_local)
            pack_overflow = pack < ops.K_SLOTS and int(np.max(pmax_h)) > pack
            if not overflowed and not pack_overflow:
                if int(per_int_h.max()) * 8 < take and self._cap_mult > 1:
                    self._cap_mult //= 2
                break
            if pack_overflow:
                self._pack = pack = ops.K_SLOTS
            elif mult >= ops.K_SLOTS:
                break
            else:
                mult *= 2
                self._cap_mult = mult
                cap = min(mult, ops.K_SLOTS) * self.n_local * T
            fn = self._chunk_fn(cap, pack)
            outs = fn(
                pending["state_before"], pending["frames_u8"], pending["t"],
                pending["run0"],
            )
        if not self._inflight:
            self.state = new_state
        # else: self.state already holds the NEWEST in-flight chunk's
        # optimistic output (submit_chunk); reverting to this older
        # chunk's state would corrupt every later chunk (see
        # Video._collect_oldest for the full contract)
        self._last_runnings = runnings
        if self.feature_detection or self._keep_running_frame:
            self.running_intensities = np.asarray(
                runnings[-1][: self.n]
            ).reshape(self.plane.shape)

        if self.void_events and not self.feature_detection:
            return EventArray.empty()

        total_i = int(totals_h.sum())
        with tracing.stage("sharded.collect.event_fetch", items=total_i):
            # fetch per-device buffer prefixes in one batched device_get
            prefixes = []
            for d in range(D):
                k = int(totals_h[d])
                prefixes.append(bufs_p[d * cap : d * cap + k])
                prefixes.append(bufs_t[d * cap : d * cap + k])
            fetched = jax.device_get(tuple(prefixes))
        with tracing.stage("sharded.collect.assemble", items=total_i):
            # per-device prefixes -> interval-major global reference order
            pixd, t_host, per_t = sh.assemble_sharded_events(
                fetched[0::2], fetched[1::2], per_int_h, self.n_local
            )
        pix = (pixd >> 8).astype(np.int64)
        d_vals = (pixd & 0xFF).astype(np.uint8)
        if self.n_state != self.n:
            # pad pixels are filtered after assembly (not masked in-kernel)
            keep = pix < self.n
            interval = np.repeat(np.arange(T), per_t)
            per_t = np.bincount(interval[keep], minlength=T)
            pix, d_vals, t_host = pix[keep], d_vals[keep], t_host[keep]
        events = self._events_from_flat(pix, d_vals, t_host)
        with tracing.stage("sharded.encode", items=len(events)):
            self.encoder.ingest_event_array(events)
        if self.feature_detection:
            self._handle_features(events, per_t, np.asarray(runnings))
        return events

    def load_checkpoint(self, path) -> None:
        super().load_checkpoint(path)
        self.state = self._shard(self.state)
