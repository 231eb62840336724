"""Multi-host ingest + event-part merge tests (simulated on the CPU mesh).

The reference has no distributed story (SURVEY §2.5); these pin this
one (adder_jax/parallel/multihost.py): an 8-device CPU mesh is
partitioned into simulated "hosts", each host assembles only its devices'
event buffers into an interval-major part, and the merged parts must equal
the one-shot global assembly byte for byte."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from adder_jax.ops import integrate as ops
from adder_jax.parallel import multihost as mh
from adder_jax.parallel import sharding as sh


def cpu_devices(n):
    try:
        devs = jax.devices("cpu")
    except RuntimeError:
        return None
    return devs[:n] if len(devs) >= n else None


def _run_sharded(mesh, ndev, n_local, T, seed=6):
    n = n_local * ndev
    p = ops.TranscodeParams()
    cap = ops.K_SLOTS * n_local * T
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (T, n)).astype(np.uint8)
    state = ops.set_initial_d(
        ops.init_state(n), jnp.asarray(frames[0].astype(np.int32))
    )
    run0 = jnp.zeros((n,), jnp.uint8)
    fn = sh.make_chunk_sharded(p, cap, mesh)
    st_sh = sh.shard_state(state, mesh)
    outs = fn(st_sh, jnp.asarray(frames), jnp.float32(255.0), run0)
    return cap, outs


def _prefixes(bufs, totals, cap, dev_ids):
    return [bufs[d * cap : d * cap + int(totals[d])] for d in dev_ids]


def test_init_multihost_single_process_noop():
    assert mh.init_multihost() is False
    assert jax.process_count() == 1


def test_host_pixel_slice_and_rows():
    # 2 hosts over a 6x8 plane: 24 px each = 3 rows each, row-aligned
    assert mh.host_pixel_slice(48, 0, 2) == (0, 24)
    assert mh.host_pixel_slice(48, 1, 2) == (24, 48)
    assert mh.host_rows(6, 8, 1, 0, 2) == (0, 3)
    assert mh.host_rows(6, 8, 1, 1, 2) == (3, 6)
    # non-row-aligned split: 3 hosts over 4 rows of 6 -> 8 px per host,
    # middle host's band straddles rows 1-3
    assert mh.host_pixel_slice(24, 1, 3) == (8, 16)
    assert mh.host_rows(4, 6, 1, 1, 3) == (1, 3)
    with pytest.raises(ValueError):
        mh.host_pixel_slice(25, 0, 2)


def test_local_band_frames_covers_exact_shard():
    H, W, T, nproc = 5, 4, 3, 2  # 20 px -> 10 px/host, straddling row 2
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (T, H, W)).astype(np.uint8)
    flat = frames.reshape(T, -1)
    got = []
    for pid in range(nproc):
        r0, r1 = mh.host_rows(H, W, 1, pid, nproc)
        band = frames[:, r0:r1]  # what this host would decode
        local = mh.local_band_frames(band, H, W, 1, pid, nproc)
        p0, p1 = mh.host_pixel_slice(H * W, pid, nproc)
        np.testing.assert_array_equal(local, flat[:, p0:p1])
        got.append(local)
    np.testing.assert_array_equal(np.concatenate(got, axis=1), flat)


def test_make_global_frames_single_process():
    devs = cpu_devices(2)
    if devs is None:
        pytest.skip("need 2 cpu devices")
    mesh = sh.make_mesh(devs)
    T, n = 2, 64
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (T, n)).astype(np.uint8)
    glob = mh.make_global_frames(frames, mesh)
    assert glob.shape == (T, n)
    np.testing.assert_array_equal(np.asarray(glob), frames)


@pytest.mark.parametrize("ndev,nhosts", [(4, 2), (8, 4)])
def test_host_parts_merge_matches_global(tmp_path, ndev, nhosts):
    """Simulated multi-host collection: per-host assemble_host_events +
    part files + merge_event_parts == the one-shot global assembly."""
    devs = cpu_devices(ndev)
    if devs is None:
        pytest.skip(f"need {ndev} cpu devices")
    mesh = sh.make_mesh(devs)
    n_local, T = 128, 3
    cap, outs = _run_sharded(mesh, ndev, n_local, T)
    (_, bufs_p, bufs_t, totals, per_int_d, _pmax, _run) = outs
    bufs_p = np.asarray(bufs_p)
    bufs_t = np.asarray(bufs_t)
    totals = np.asarray(totals)
    per_int_d = np.asarray(per_int_d)

    every = list(range(ndev))
    ref_p, ref_t, _ = sh.assemble_sharded_events(
        _prefixes(bufs_p, totals, cap, every),
        _prefixes(bufs_t, totals, cap, every), per_int_d, n_local,
    )
    assert len(ref_p) > 0
    # multi-interval events, else the interval-major merge is untested
    assert np.count_nonzero(per_int_d.sum(axis=0)) >= 2

    dper = ndev // nhosts
    parts = []
    for h in range(nhosts):
        dev_ids = list(range(h * dper, (h + 1) * dper))
        hp, ht, per_int = mh.assemble_host_events(
            _prefixes(bufs_p, totals, cap, dev_ids),
            _prefixes(bufs_t, totals, cap, dev_ids),
            per_int_d[dev_ids], dev_ids, n_local,
        )
        path = tmp_path / f"events.part{h}.npz"
        mh.write_event_part(
            path, hp, ht, per_int, pixel_offset=h * dper * n_local,
            process_id=h,
        )
        parts.append(mh.read_event_part(path))

    merged_p, merged_t = mh.merge_event_parts(parts)
    np.testing.assert_array_equal(merged_p, ref_p)
    np.testing.assert_array_equal(merged_t, ref_t)


def test_addressable_host_view_covers_all_devices_single_process():
    """In a single-process run every shard is addressable: the host view +
    assemble_host_events must reproduce the global assembly."""
    ndev = 2
    devs = cpu_devices(ndev)
    if devs is None:
        pytest.skip("need 2 cpu devices")
    mesh = sh.make_mesh(devs)
    n_local, T = 128, 2
    cap, outs = _run_sharded(mesh, ndev, n_local, T, seed=9)
    (_, bufs_p, bufs_t, totals, per_int_d, _pmax, _run) = outs
    tot = np.asarray(totals)
    every = list(range(ndev))
    ref_p, ref_t, _ = sh.assemble_sharded_events(
        _prefixes(np.asarray(bufs_p), tot, cap, every),
        _prefixes(np.asarray(bufs_t), tot, cap, every),
        np.asarray(per_int_d), n_local,
    )
    lp, lt, lper, dev_ids = mh.addressable_host_view(
        bufs_p, bufs_t, totals, per_int_d, mesh
    )
    assert dev_ids == list(range(ndev))
    hp, ht, _ = mh.assemble_host_events(lp, lt, lper, dev_ids, n_local)
    np.testing.assert_array_equal(hp, ref_p)
    np.testing.assert_array_equal(ht, ref_t)


def test_merge_event_parts_empty_and_validation():
    p0, t0 = mh.merge_event_parts([])
    assert len(p0) == 0 and len(t0) == 0
    a = {"pixel_offset": 0, "per_interval": np.array([0, 0]),
         "pixd": np.empty(0, np.uint32), "t": np.empty(0, np.int64)}
    b = {"pixel_offset": 8, "per_interval": np.array([0]),
         "pixd": np.empty(0, np.uint32), "t": np.empty(0, np.int64)}
    with pytest.raises(ValueError):
        mh.merge_event_parts([a, b])
