"""Framer golden tests against committed reference fixtures.

Mirrors the reference's test_sample_ordered / test_sample_unordered
(ref: adder-codec-rs/tests/integration_tests.rs:818-962): decode the v0
`.adder` fixtures, reconstruct at 60 fps, compare byte-for-byte with the
committed golden `sample_3.gray` (405 frames).
"""

import io

import numpy as np
import pytest

from adder_jax.codec.decoder import open_file_decoder
from adder_jax.core.types import Event, EventArray, PlaneSize, SourceCamera, SourceType, TimeMode
from adder_jax.framer.driver import FramerBuilder, FrameSequence
from adder_jax.framer.scale_intensity import FramedViewMode


def reconstruct(path, fps, batched=True):
    dec = open_file_decoder(str(path))
    m = dec.meta
    assert m.tps // m.ref_interval == int(fps)
    fs = (
        FramerBuilder(m.plane)
        .time_parameters(m.tps, m.ref_interval, m.delta_t_max, fps)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
        .finish()
    )
    out = io.BytesIO()
    count = 0
    if batched:
        events = dec.digest_all()
        fs.ingest_event_array(events)
        count += fs.write_multi_frame_bytes(out)
    else:
        while True:
            batch = dec.digest_batch(1024)
            if len(batch) == 0:
                break
            if fs.ingest_event_array(batch):
                count += fs.write_multi_frame_bytes(out)
    return out.getvalue(), count


@pytest.mark.parametrize("name", ["sample_3_ordered.adder", "sample_3_unordered.adder"])
@pytest.mark.parametrize("batched", [True, False], ids=["one-batch", "streamed"])
def test_sample_3_golden(samples_dir, name, batched):
    got, count = reconstruct(samples_dir / name, 60.0, batched)
    golden = (samples_dir / "sample_3.gray").read_bytes()
    assert count == 405
    assert got == golden


def test_framer_doctest_equivalent():
    """ref: driver.rs:409-436 doctest — one event at t=1000 with tpf=1000
    yields frame value 2^5 * tpf / t = 32."""
    fs = (
        FramerBuilder(PlaneSize(10, 10, 3))
        .time_parameters(50000, 1000, 1000, 50.0)
        .codec_meta(1, TimeMode.DeltaT)
        .source_info(SourceType.U8, SourceCamera.FramedU8)
        .finish()
    )
    fs.ingest_event(Event(5, 5, 1, 5, 1000))
    f = fs.frames[fs.frames_written]
    pix = (5 * 10 + 5) * 3 + 1
    assert f.filled[pix]
    assert f.values[pix] == 32


def test_framer_buffer_limit():
    """buffer_limit forcibly completes frame 0 (ref: driver.rs:1116-1122)."""
    b = FramerBuilder(PlaneSize(4, 4, 1))
    b.buffer_limit = 2
    fs = (
        b.time_parameters(2400, 100, 1000, 24.0)
        .codec_meta(2, TimeMode.AbsoluteT)
        .source_info(SourceType.U8, SourceCamera.FramedU8)
        .finish()
    )
    # single pixel far ahead in time; others never fire
    assert not fs.is_frame_0_filled()
    fs.ingest_event(Event(0, 0, None, 5, 2000))
    assert fs.is_frame_0_filled()


@pytest.mark.parametrize("dtype", [np.uint16, np.uint32, np.uint64])
def test_framer_wider_output_types(samples_dir, dtype):
    """u16/u32/u64 outputs (ref: scale_intensity.rs FrameValue impls)."""
    dec = open_file_decoder(str(samples_dir / "sample_3_ordered.adder"))
    m = dec.meta
    b = FramerBuilder(m.plane)
    b.out_dtype = dtype
    fs = (
        b.time_parameters(m.tps, m.ref_interval, m.delta_t_max, 60.0)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
        .finish()
    )
    fs.ingest_event_array(dec.digest_all())
    vals, filled = fs.pop_next_frame()
    assert vals.dtype == dtype
    # u8 golden frame scaled up: top byte must match the u8 reconstruction
    info = np.iinfo(dtype)
    assert vals.max() > info.max // 4


def test_framer_coordless_output(samples_dir):
    """EventCoordless passthrough frames (ref: scale_intensity.rs:32-52)."""
    from adder_jax.framer.driver import unpack_coordless

    dec = open_file_decoder(str(samples_dir / "sample_3_ordered.adder"))
    m = dec.meta
    b = FramerBuilder(m.plane)
    b.coordless = True
    fs = (
        b.time_parameters(m.tps, m.ref_interval, m.delta_t_max, 60.0)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
        .finish()
    )
    fs.ingest_event_array(dec.digest_all())
    vals, filled = fs.pop_next_frame()
    d, dt = unpack_coordless(vals)
    assert d.max() <= 255 and d.max() > 0
    assert dt.max() > 0


def test_framer_feature_intervals(samples_dir):
    """In-framer FAST binned by output frame (ref: driver.rs:482-553)."""
    dec = open_file_decoder(str(samples_dir / "nyc_source_v2.adder"))
    m = dec.meta
    b = FramerBuilder(m.plane)
    b.detect_features = True
    fs = (
        b.time_parameters(m.tps, m.ref_interval, m.delta_t_max, 30.0)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
        .finish()
    )
    fs.ingest_event_array(dec.digest_batch(100000))
    total = sum(len(fi.features) for fi in fs.features)
    assert total > 0
    fi = fs.pop_features()
    assert fi.end_ts > 0


# --- native-vs-numpy ingest parity ------------------------------------------


def _random_stream(rng, plane, n, t_mode):
    """Random event batches honoring the per-pixel ordering invariant
    (driver.rs:1068-1074): DeltaT ts are per-event deltas (any order works);
    AbsoluteT streams are sorted by t."""
    x = rng.integers(0, plane.width, n).astype(np.uint16)
    y = rng.integers(0, plane.height, n).astype(np.uint16)
    if plane.channels == 1:
        c = np.full(n, 255, np.uint8)
    else:
        c = rng.integers(0, plane.channels, n).astype(np.uint8)
    d = rng.integers(0, 130, n).astype(np.uint8)
    d[rng.random(n) < 0.05] = 255  # D_EMPTY
    if t_mode == TimeMode.AbsoluteT:
        t = np.sort(rng.integers(1, 60_000, n).astype(np.uint32))
    else:
        t = rng.integers(0, 3_000, n).astype(np.uint32)
    return EventArray(x, y, c, d, t)


def _run_stream(fs, batches, force_numpy, monkeypatch_ctx):
    if force_numpy:
        import adder_jax.framer.driver as drv

        monkeypatch_ctx.setattr(
            "adder_jax.framer.native_ingest.ingest_native",
            lambda *_a, **_k: False,
        )
    frames = []
    for b in batches:
        fs.ingest_event_array(b)
        while fs.is_frame_0_filled():
            frames.append(fs.pop_next_frame())
    fs.flush_frame_buffer()
    if fs.is_frame_0_filled():
        frames.append(fs.pop_next_frame())
    return frames


@pytest.mark.parametrize("view_mode", list(FramedViewMode))
@pytest.mark.parametrize(
    "t_mode", [TimeMode.DeltaT, TimeMode.AbsoluteT], ids=["deltaT", "absT"]
)
def test_native_ingest_parity_views(monkeypatch, view_mode, t_mode):
    """Native C++ ingest (ops/native/framer_fill.cpp) must be bit-exact vs
    the numpy segmented-scan path across view modes, time modes, and
    multi-batch carries."""
    from adder_jax.framer import native_ingest

    if native_ingest._get_lib() is None:
        pytest.skip("native framer unavailable")
    rng = np.random.default_rng(1234 + int(view_mode) * 7 + int(t_mode))
    plane = PlaneSize(17, 11, 3)
    batches = [_random_stream(rng, plane, n, t_mode) for n in (800, 1, 500)]

    def build():
        b = FramerBuilder(plane)
        b.view_mode = view_mode
        return (
            b.time_parameters(24_000, 1000, 4000, 24.0)
            .codec_meta(2, t_mode)
            .source_info(SourceType.U8, SourceCamera.FramedU8)
            .finish()
        )

    fs_n = build()
    frames_n = _run_stream(fs_n, batches, False, monkeypatch)
    fs_p = build()
    frames_p = _run_stream(fs_p, batches, True, monkeypatch)

    assert len(frames_n) == len(frames_p)
    for (va, fa), (vb, fb) in zip(frames_n, frames_p):
        assert np.array_equal(fa, fb)
        assert np.array_equal(va, vb)
    assert np.array_equal(fs_n.running_ts, fs_p.running_ts)
    assert np.array_equal(fs_n.last_filled, fs_p.last_filled)
    assert np.array_equal(fs_n.last_intensity, fs_p.last_intensity)
    assert sorted(fs_n.frames.keys()) == sorted(fs_p.frames.keys())


@pytest.mark.parametrize("dtype", [np.uint16, np.uint64])
def test_native_ingest_parity_dtypes_coordless(monkeypatch, dtype):
    """Wider outputs and EventCoordless packing through the native path."""
    from adder_jax.framer import native_ingest

    if native_ingest._get_lib() is None:
        pytest.skip("native framer unavailable")
    rng = np.random.default_rng(77)
    plane = PlaneSize(9, 7, 1)
    batches = [_random_stream(rng, plane, 600, TimeMode.DeltaT)]

    for coordless in (False, True):

        def build():
            b = FramerBuilder(plane)
            b.out_dtype = dtype
            b.coordless = coordless
            return (
                b.time_parameters(24_000, 1000, 4000, 24.0)
                .codec_meta(1, TimeMode.DeltaT)
                .source_info(SourceType.U8, SourceCamera.FramedU8)
                .finish()
            )

        fs_n = build()
        frames_n = _run_stream(fs_n, batches, False, monkeypatch)
        monkeypatch.undo()
        fs_p = build()
        frames_p = _run_stream(fs_p, batches, True, monkeypatch)
        monkeypatch.undo()
        assert len(frames_n) == len(frames_p)
        for (va, fa), (vb, fb) in zip(frames_n, frames_p):
            assert np.array_equal(va, vb) and np.array_equal(fa, fb)
        assert np.array_equal(fs_n.last_intensity, fs_p.last_intensity)
