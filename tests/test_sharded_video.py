"""ShardedVideo (multi-device Video API) parity tests on the CPU mesh.

The sharded transcoder must produce the exact event stream of the
single-device Video (which is itself oracle- and fixture-pinned): same
events, same reference single-thread order, across multiple chunks,
including plane padding (pad-pixel filtering) and raw-encoder bytes."""

import io

import numpy as np
import pytest

import jax

from adder_jax.codec.encoder import EncoderOptions, EncoderType
from adder_jax.core.types import (
    Mode, PixelMultiMode, PlaneSize, SourceCamera, TimeMode,
)
from adder_jax.parallel import sharding as sh
from adder_jax.transcoder.sharded import ShardedVideo
from adder_jax.transcoder.video import Video


def cpu_mesh(n):
    try:
        devs = jax.devices("cpu")
    except RuntimeError:
        return None
    if len(devs) < n:
        return None
    return sh.make_mesh(devs[:n])


def _mk_frames(plane, T, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(
        0, 256, (T, plane.height, plane.width, plane.channels)
    ).astype(np.uint8)


def _configure(v):
    v.time_parameters(255 * 10, 255, 255 * 10, TimeMode.DeltaT)
    v.update_quality_manual(0, 0, 1, 0, 0)
    return v


def _events_tuple(ev):
    return (
        np.asarray(ev.x), np.asarray(ev.y), np.asarray(ev.c),
        np.asarray(ev.d), np.asarray(ev.t),
    )


@pytest.mark.parametrize("ndev", [2, 4])
def test_sharded_video_matches_single_device(ndev):
    mesh = cpu_mesh(ndev)
    if mesh is None:
        pytest.skip(f"need {ndev} cpu devices")
    plane = PlaneSize(24, 20, 1)  # 480 px: divides evenly, no padding
    T = 3
    ref = _configure(Video(plane, Mode.FramePerfect))
    svid = _configure(
        ShardedVideo(plane, Mode.FramePerfect, mesh=mesh)
    )
    assert svid.n_state == 480

    for chunk in range(2):
        frames = _mk_frames(plane, T, seed=chunk)
        ev_ref = ref.integrate_matrix_batch(frames)
        ev_sh = svid.integrate_matrix_batch(frames)
        for a, b in zip(_events_tuple(ev_ref), _events_tuple(ev_sh)):
            np.testing.assert_array_equal(a, b)
    assert svid.in_interval_count == ref.in_interval_count


def test_sharded_video_color_and_continuous():
    mesh = cpu_mesh(2)
    if mesh is None:
        pytest.skip("need 2 cpu devices")
    plane = PlaneSize(16, 8, 3)  # 384 channel-px
    T = 2
    ref = _configure(Video(plane, Mode.Continuous))
    svid = _configure(
        ShardedVideo(plane, Mode.Continuous, mesh=mesh)
    )
    frames = _mk_frames(plane, T, seed=3)
    ev_ref = ref.integrate_matrix_batch(frames)
    ev_sh = svid.integrate_matrix_batch(frames)
    for a, b in zip(_events_tuple(ev_ref), _events_tuple(ev_sh)):
        np.testing.assert_array_equal(a, b)


def test_sharded_video_raw_encoder_bytes_identical():
    mesh = cpu_mesh(2)
    if mesh is None:
        pytest.skip("need 2 cpu devices")
    plane = PlaneSize(16, 16, 1)  # 256 px
    T = 2
    out_ref, out_sh = io.BytesIO(), io.BytesIO()
    ref = _configure(Video(plane, Mode.FramePerfect))
    svid = _configure(
        ShardedVideo(plane, Mode.FramePerfect, mesh=mesh)
    )
    for v, w in ((ref, out_ref), (svid, out_sh)):
        v.write_out(
            SourceCamera.FramedU8, TimeMode.DeltaT, PixelMultiMode.Collapse,
            None, EncoderType.Raw, EncoderOptions.default(plane), w,
        )
    frames = _mk_frames(plane, T, seed=5)
    ref.integrate_matrix_batch(frames)
    svid.integrate_matrix_batch(frames)
    ref.flush()
    svid.flush()
    ref.end_write_stream()
    svid.end_write_stream()
    assert out_sh.getvalue() == out_ref.getvalue()
    assert len(out_sh.getvalue()) > 33  # header + events actually written


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_video_pads_plane(ndev):
    """A plane the device count does not divide is padded; pad-pixel
    events are filtered after assembly and the stream is unchanged."""
    mesh = cpu_mesh(ndev)
    if mesh is None:
        pytest.skip(f"need {ndev} cpu devices")
    plane = PlaneSize(7, 5, 1)  # 35 px: pads on every mesh size here
    ref = _configure(Video(plane, Mode.Continuous))
    svid = _configure(ShardedVideo(plane, Mode.Continuous, mesh=mesh))
    assert svid.n_state > svid.n and svid.n_state % ndev == 0
    for chunk in range(2):
        frames = _mk_frames(plane, 3, seed=20 + chunk)
        ev_ref = ref.integrate_matrix_batch(frames)
        ev_sh = svid.integrate_matrix_batch(frames)
        assert len(ev_ref) > 0
        for a, b in zip(_events_tuple(ev_ref), _events_tuple(ev_sh)):
            np.testing.assert_array_equal(a, b)


def _pipeline_stream(video_factory, frames_chunks, plane):
    """Raw-encoded bytes from submit_chunk-ing every chunk up front (deep
    pipelining: submit auto-collects once >2 are in flight) then flushing."""
    out = io.BytesIO()
    v = _configure(video_factory())
    v.write_out(
        SourceCamera.FramedU8, TimeMode.DeltaT, PixelMultiMode.Collapse,
        None, EncoderType.Raw, EncoderOptions.default(plane), out,
    )
    for fr in frames_chunks:
        v.submit_chunk(fr)
    v.flush()
    v.end_write_stream()
    return out.getvalue()


def _sequential_stream(video_factory, frames_chunks, plane):
    out = io.BytesIO()
    v = _configure(video_factory())
    v.write_out(
        SourceCamera.FramedU8, TimeMode.DeltaT, PixelMultiMode.Collapse,
        None, EncoderType.Raw, EncoderOptions.default(plane), out,
    )
    for fr in frames_chunks:
        v.collect_chunk(v.submit_chunk(fr))
    v.flush()
    v.end_write_stream()
    return out.getvalue()


def test_deep_pipelining_matches_sequential():
    """>2 chunks in flight must not corrupt the carried state (advisor
    round-3 high finding: _collect_oldest reverted self.state to the
    OLDEST chunk's output, so chunk 4+ integrated from stale state)."""
    plane = PlaneSize(16, 16, 1)
    chunks = [_mk_frames(plane, 3, seed=s) for s in range(5)]
    seq = _sequential_stream(lambda: Video(plane, Mode.FramePerfect),
                             chunks, plane)
    pipe = _pipeline_stream(lambda: Video(plane, Mode.FramePerfect),
                            chunks, plane)
    assert pipe == seq
    assert len(seq) > 33


def test_deep_pipelining_matches_sequential_sharded():
    mesh = cpu_mesh(2)
    if mesh is None:
        pytest.skip("need 2 cpu devices")
    plane = PlaneSize(16, 16, 1)
    chunks = [_mk_frames(plane, 2, seed=10 + s) for s in range(5)]

    def mk():
        return ShardedVideo(plane, Mode.FramePerfect, mesh=cpu_mesh(2))

    seq = _sequential_stream(mk, chunks, plane)
    pipe = _pipeline_stream(mk, chunks, plane)
    assert pipe == seq
    assert len(seq) > 33
