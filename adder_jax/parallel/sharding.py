"""Multi-device scaling: pixel-plane sharding over a jax.sharding.Mesh.

Replacement for the reference's rayon row-chunk parallelism
(ref: adder-codec-rs/src/transcoder/source/video.rs:677-734 and SURVEY
section 2.5): pixels never communicate during integration, so the plane
shards cleanly along the flattened pixel axis. Each device runs the plain
XLA chunk (ops.make_transcode_chunk) on its contiguous row band under
shard_map and compacts its own events; there are no collectives in the hot
loop. The host restores the reference's single-thread order from the
per-device buffers and their per-interval counts.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import integrate as ops


def make_mesh(devices=None, axis_name: str = "px") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def _state_specs(axis_name: str) -> ops.PixelState:
    """PartitionSpec tree for a PixelState: node arrays (DEPTH, N) shard
    along N, per-pixel arrays (N,) shard along N, scalars replicate."""
    node, flat = P(None, axis_name), P(axis_name)
    return ops.PixelState(
        node_d=node,
        node_integ=node,
        node_dt=node,
        best_d=node,
        best_dt=node,
        length=flat,
        base_val=flat,
        c_thresh=flat,
        c_increase_counter=flat,
        last_fired_t=flat,
        running_t=flat,
        need_pop=flat,
        dtm_reached=flat,
        popped_dtm=flat,
        overflow=P(),
    )


def state_sharding(mesh: Mesh, axis_name: str = "px"):
    """Sharding tree for a PixelState (see _state_specs)."""
    return jax.tree.map(
        lambda spec: NamedSharding(mesh, spec), _state_specs(axis_name),
        is_leaf=lambda x: isinstance(x, P),
    )


def shard_state(state: ops.PixelState, mesh: Mesh, axis_name: str = "px"):
    return jax.device_put(state, state_sharding(mesh, axis_name))


def make_chunk_sharded(
    p: ops.TranscodeParams,
    event_cap_per_dev: int,
    mesh: Mesh,
    pack: int = 4,
    axis_name: str = "px",
):
    """ops.make_transcode_chunk on every device's row band via shard_map.

    Signature: (state, frames (T, N) u8, time, run0 (N,)) ->
    (state, bufs_pixd (D*cap,), bufs_t (D*cap,), totals (D,),
    per_interval (D, T), pack_max (D,), runnings (T, N)).

    Device d's events sit in [d*cap, d*cap + totals[d]) in its local
    single-thread order (interval-major, local pixel ids);
    `assemble_sharded_events` restores the global order. Overflow is the
    caller's to detect, with the single-device contract per device:
    totals[d] > cap or per_interval[d] above per_interval_take means a
    capacity rerun, pack_max[d] > pack a rerun with pack=K_SLOTS."""
    local = ops.make_transcode_chunk(p, event_cap_per_dev, pack)
    st_spec = _state_specs(axis_name)

    def body(state, frames, time, run0):
        (
            st, buf_pixd, buf_t, _t16, _tb, _ok, total, per_int, runnings,
            pmax,
        ) = local(state, frames, time, run0)
        return (
            st, buf_pixd, buf_t,
            total.reshape(1), per_int.reshape(1, -1), pmax.reshape(1),
            runnings,
        )

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(st_spec, P(None, axis_name), P(), P(axis_name)),
        out_specs=(
            st_spec, P(axis_name), P(axis_name),
            P(axis_name), P(axis_name, None), P(axis_name),
            P(None, axis_name),
        ),
        # the replicated overflow counter differs per device; device 0's
        # value is kept (it is diagnostic only)
        check_vma=False,
    )
    return jax.jit(fn)


def assemble_sharded_events(dev_pixd, dev_t, per_interval,
                            n_local_px: int, dev_ids=None):
    """Merge per-device event prefixes into the reference's single-thread
    order: interval-major across devices, devices in row-band order within
    an interval (row-band sharding keeps raster order).

    dev_pixd/dev_t: one host array per device, its first totals[d] events.
    per_interval (n, T): the chunk's per-device interval counts.
    dev_ids: mesh positions of the devices (default 0..n-1); device d's
    local pixel ids are offset by d * n_local_px. Returns (pixd, t,
    per_interval (T,)) with global pixel ids."""
    per_interval = np.asarray(per_interval, np.int64)
    nd, T = per_interval.shape
    dev_ids = list(range(nd)) if dev_ids is None else list(dev_ids)
    offs = np.zeros((nd, T + 1), np.int64)
    np.cumsum(per_interval, axis=1, out=offs[:, 1:])
    for i, d in enumerate(dev_ids):
        if offs[i, -1] != len(dev_pixd[i]):
            raise ValueError(
                f"device {d}: per-interval counts sum to {offs[i, -1]}, "
                f"but {len(dev_pixd[i])} events were given"
            )
    parts_p, parts_t = [], []
    for t in range(T):
        for i, d in enumerate(dev_ids):
            a, b = int(offs[i, t]), int(offs[i, t + 1])
            if a == b:
                continue
            # local -> global pixel ids ride the high 24 bits of pixd
            base = np.uint32(d * n_local_px) << np.uint32(8)
            parts_p.append(np.asarray(dev_pixd[i][a:b], np.uint32) + base)
            parts_t.append(np.asarray(dev_t[i][a:b]))
    total_per_t = per_interval.sum(axis=0)
    if not parts_p:
        return np.zeros(0, np.uint32), np.zeros(0, np.uint32), total_per_t
    return np.concatenate(parts_p), np.concatenate(parts_t), total_per_t
