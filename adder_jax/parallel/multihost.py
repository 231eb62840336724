"""Multi-host scale-out: per-host ingest sharding + event stream merging.

The reference is a single-process, multi-threaded codec — it has no
distributed story at all (SURVEY §2.5: mpsc channels only; ref
adder-codec-rs/src/transcoder/source/video.rs:677-734 is rayon row
chunking). This design extends the same row-block decomposition across
hosts:

- The pixel plane row-shards over ALL devices of ALL hosts (one global
  `Mesh` over `jax.devices()`, which JAX orders by process index, so each
  host's addressable devices hold one contiguous band of rows).
- **Ingest is sharded across hosts**: each host decodes ONLY its own row band
  of the input video (`host_rows`/`local_band_frames`) and forms its
  process-local shard of the global (T, N) frame array with
  `jax.make_array_from_process_local_data`. No frame bytes ever cross
  hosts; the jit'd sharded transcode step then runs SPMD over the global
  mesh with no collectives in the hot loop (pixels are independent).
- **Event collection stays host-local**: each host assembles its
  addressable devices' event buffers into an interval-major local stream
  (`assemble_host_events`) and writes a part file (`write_event_part`).
  `merge_event_parts` — run by host 0 or offline — restores the global
  reference single-thread order (interval-major across hosts, raster
  within an interval) and can feed any Encoder.

Single-process (num_processes=1) every helper degrades to the plain
sharded path, which is how tests/test_multihost.py pins the merge logic:
an 8-device CPU mesh is partitioned into two simulated "hosts" whose
merged parts must equal the one-shot global assembly byte for byte.
"""

from __future__ import annotations

import os

import numpy as np

import jax

from .sharding import assemble_sharded_events, make_mesh  # noqa: F401

_PART_MAGIC = "adpt"
_PART_VERSION = 1
_INIT_DONE = [False]  # fallback init flag if the private global_state moves


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> bool:
    """Initialize jax.distributed for a multi-host job. Returns True when a
    multi-process runtime was initialized, False for the single-process
    no-op (no coordinator given and no cluster env detected). Safe to call
    twice (the second call is a no-op)."""
    if num_processes in (None, 0, 1) and coordinator_address is None and (
        "JAX_COORDINATOR_ADDRESS" not in os.environ
    ):
        return False
    # IMPORTANT: do not call jax.process_count()/jax.devices() here — any
    # backend-initializing call before jax.distributed.initialize makes
    # initialize() raise ("backends already initialized"). Detect a prior
    # initialize via the distributed global state instead.
    try:
        from jax._src import distributed as _jdist

        if getattr(_jdist.global_state, "client", None) is not None:
            return True  # already initialized
    except Exception:  # pragma: no cover - private-API drift fallback
        if _INIT_DONE[0]:
            return True
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    _INIT_DONE[0] = True
    return True


def host_pixel_slice(n: int, process_id: int | None = None,
                     num_processes: int | None = None) -> tuple[int, int]:
    """This host's contiguous slice [p0, p1) of the flattened pixel axis
    under equal row-block sharding of n pixels over all hosts. n must
    divide evenly by the process count (the same constraint the device
    sharding imposes; pad the plane like the single-host paths do)."""
    pid = jax.process_index() if process_id is None else process_id
    nproc = jax.process_count() if num_processes is None else num_processes
    if n % nproc:
        raise ValueError(
            f"pixel count {n} not divisible by {nproc} processes; pad the "
            "plane to a multiple (same contract as the device sharding)"
        )
    per = n // nproc
    return pid * per, (pid + 1) * per


def host_rows(height: int, width: int, channels: int = 1,
              process_id: int | None = None,
              num_processes: int | None = None) -> tuple[int, int]:
    """The [row0, row1) band of input-frame rows this host must DECODE to
    cover its pixel slice. Bands of different hosts overlap by at most one
    row (when the pixel split is not row-aligned)."""
    rowpx = width * channels
    p0, p1 = host_pixel_slice(height * rowpx, process_id, num_processes)
    return p0 // rowpx, -(-p1 // rowpx)  # floor, ceil


def local_band_frames(frames_band: np.ndarray, height: int, width: int,
                      channels: int = 1, process_id: int | None = None,
                      num_processes: int | None = None) -> np.ndarray:
    """Slice a host's decoded row band (T, rows, W[, C]) down to its exact
    process-local pixel shard (T, n_local) in flattened order. The band
    must be the one host_rows() prescribed."""
    rowpx = width * channels
    r0, _ = host_rows(height, width, channels, process_id, num_processes)
    p0, p1 = host_pixel_slice(
        height * rowpx, process_id, num_processes
    )
    T = frames_band.shape[0]
    flat = np.ascontiguousarray(frames_band).reshape(T, -1)
    a = p0 - r0 * rowpx
    return flat[:, a : a + (p1 - p0)]


def make_global_frames(local_frames, mesh, axis_name: str = "px"):
    """Build the global (T, N) frame array from each process's local shard
    (T, n_local) without any cross-host frame traffic."""
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(None, axis_name)
    )
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(local_frames)
    )


def addressable_host_view(bufs_pixd, bufs_t, totals, per_interval, mesh):
    """Pull THIS host's addressable per-device event prefixes out of the
    sharded chunk outputs (parallel/sharding.make_chunk_sharded). Returns
    (dev_pixd, dev_t, per_interval, dev_ids): per-device host arrays, their
    (n_local_devices, T) interval counts, and the devices' global mesh
    positions (ascending)."""
    mesh_devs = list(mesh.devices.reshape(-1))
    shards = sorted(
        bufs_pixd.addressable_shards,
        key=lambda s: mesh_devs.index(s.device),
    )
    dev_ids = [mesh_devs.index(s.device) for s in shards]
    by_dev_t = {s.device: s.data for s in bufs_t.addressable_shards}
    tot = np.asarray(totals)  # totals/counts are tiny: fetch replicated rows
    per = np.asarray(per_interval)
    dev_pixd = [np.asarray(s.data[: int(tot[i])]) for i, s in zip(dev_ids, shards)]
    dev_t = [
        np.asarray(by_dev_t[s.device][: int(tot[i])])
        for i, s in zip(dev_ids, shards)
    ]
    return dev_pixd, dev_t, per[dev_ids], dev_ids


def assemble_host_events(dev_pixd, dev_t, per_interval, dev_ids,
                         n_local_px: int):
    """One host's interval-major event stream from its devices' event
    prefixes (the single-host sharded assembly, with GLOBAL pixel ids from
    the devices' mesh positions). Returns (pixd, t, per_interval (T,)),
    where per_interval segments the stream by interval for the cross-host
    merge."""
    return assemble_sharded_events(
        dev_pixd, dev_t, per_interval, n_local_px, dev_ids=dev_ids
    )


def write_event_part(path, pixd, t, per_interval, pixel_offset: int,
                     process_id: int | None = None):
    """Persist one host's interval-major event stream as a part file
    (compressed npz). pixel_offset = the host's first global pixel id,
    which orders parts within an interval at merge time."""
    pid = jax.process_index() if process_id is None else process_id
    np.savez_compressed(
        path,
        magic=np.frombuffer(_PART_MAGIC.encode(), dtype=np.uint8),
        version=np.int64(_PART_VERSION),
        process_id=np.int64(pid),
        pixel_offset=np.int64(pixel_offset),
        pixd=np.asarray(pixd, dtype=np.uint32),
        t=np.asarray(t, dtype=np.int64),
        per_interval=np.asarray(per_interval, dtype=np.int64),
    )


def read_event_part(path):
    """Load a part file -> dict with pixd/t/per_interval/pixel_offset."""
    with np.load(path) as z:
        if bytes(z["magic"].tobytes()) != _PART_MAGIC.encode():
            raise ValueError(f"{path}: not an adder event part file")
        if int(z["version"]) != _PART_VERSION:
            raise ValueError(
                f"{path}: unsupported part version {int(z['version'])}"
            )
        return {
            "pixel_offset": int(z["pixel_offset"]),
            "process_id": int(z["process_id"]),
            "pixd": z["pixd"],
            "t": z["t"],
            "per_interval": z["per_interval"],
        }


def merge_event_parts(parts):
    """Merge per-host part dicts (as from read_event_part) into the global
    reference single-thread stream: interval-major across hosts, hosts
    ordered by pixel_offset within each interval (row-block sharding keeps
    raster order). Returns (pixd, t)."""
    parts = sorted(parts, key=lambda p: p["pixel_offset"])
    if not parts:
        return np.empty(0, np.uint32), np.empty(0, np.int64)
    T = len(parts[0]["per_interval"])
    offs = []
    for p in parts:
        if len(p["per_interval"]) != T:
            raise ValueError("event parts disagree on interval count")
        per = np.asarray(p["per_interval"], dtype=np.int64)
        offs.append(np.concatenate([[0], np.cumsum(per)]))
    out_p, out_t = [], []
    for t in range(T):
        for p, off in zip(parts, offs):
            a, b = int(off[t]), int(off[t + 1])
            if a != b:
                out_p.append(p["pixd"][a:b])
                out_t.append(p["t"][a:b])
    if not out_p:
        return np.empty(0, np.uint32), np.empty(0, np.int64)
    return np.concatenate(out_p), np.concatenate(out_t)
