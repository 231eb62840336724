"""Multi-device sharding tests on a virtual CPU mesh.

The plain XLA chunk runs on every device's row band under shard_map
(parallel/sharding.make_chunk_sharded): pixels never communicate, so the
hot loop has no collectives, and the host assembly must restore the
single-device stream — interval-major across devices — exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from adder_jax.ops import integrate as ops
from adder_jax.parallel import sharding as sh


def cpu_devices(n):
    try:
        devs = jax.devices("cpu")
    except RuntimeError:
        return None
    return devs[:n] if len(devs) >= n else None


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_chunk_matches_single(ndev):
    devs = cpu_devices(ndev)
    if devs is None:
        pytest.skip(f"need {ndev} cpu devices (xla_force_host_platform_device_count)")
    mesh = sh.make_mesh(devs)
    n_local, T = 64, 3
    n = n_local * ndev
    p = ops.TranscodeParams()
    cap = ops.K_SLOTS * n_local * T

    rng = np.random.default_rng(6)
    frames = rng.integers(0, 256, (T, n)).astype(np.uint8)
    state = ops.set_initial_d(
        ops.init_state(n), jnp.asarray(frames[0].astype(np.int32))
    )
    run0 = jnp.zeros((n,), jnp.uint8)

    # single-device reference (same graph, unsharded)
    ref = ops.make_transcode_chunk(p, cap * ndev, 4)(
        state, jnp.asarray(frames), jnp.float32(255.0), run0
    )
    ref_total = int(ref[6])
    # several intervals fire, so a plain device-major concatenation of the
    # per-device buffers would be out of order
    assert np.count_nonzero(np.asarray(ref[7])) >= 2

    fn = sh.make_chunk_sharded(p, cap, mesh)
    st2, bufs_p, bufs_t, totals, per_int, pmax, runnings = fn(
        sh.shard_state(state, mesh), jnp.asarray(frames), jnp.float32(255.0),
        run0,
    )
    totals = np.asarray(totals)
    assert int(totals.sum()) == ref_total
    assert int(np.max(np.asarray(pmax))) == int(ref[9])
    bufs_p, bufs_t = np.asarray(bufs_p), np.asarray(bufs_t)
    pixd, t, per_t = sh.assemble_sharded_events(
        [bufs_p[d * cap : d * cap + int(totals[d])] for d in range(ndev)],
        [bufs_t[d * cap : d * cap + int(totals[d])] for d in range(ndev)],
        np.asarray(per_int), n_local,
    )
    np.testing.assert_array_equal(per_t, np.asarray(ref[7]))
    np.testing.assert_array_equal(pixd, np.asarray(ref[1][:ref_total]))
    np.testing.assert_array_equal(t, np.asarray(ref[2][:ref_total]))
    np.testing.assert_array_equal(np.asarray(runnings), np.asarray(ref[8]))
    for f_s, f_r in zip(st2[:-1], ref[0][:-1]):
        np.testing.assert_array_equal(np.asarray(f_s), np.asarray(f_r))


def test_assemble_rejects_inconsistent_counts():
    """A device whose interval counts do not sum to its event prefix (a
    truncated buffer) is an error, not a silently short stream."""
    pixd = [np.arange(3, dtype=np.uint32), np.arange(2, dtype=np.uint32)]
    t = [np.zeros(3, np.uint32), np.zeros(2, np.uint32)]
    with pytest.raises(ValueError, match="device 1"):
        sh.assemble_sharded_events(pixd, t, np.array([[2, 1], [1, 2]]), 8)
