"""Device framer vs host framer parity (CPU jit; the same code runs on the GPU).

The device framer fills (d, dt) payloads on the accelerator and converts
values on pop through the identical host f64 path, so popped frames must be
byte-identical to the host FrameSequence — including the committed
sample_3 405-frame golden.
"""

import io

import numpy as np
import pytest

from adder_jax.codec.decoder import open_file_decoder
from adder_jax.core.types import (
    EventArray,
    PlaneSize,
    SourceCamera,
    SourceType,
    TimeMode,
)
from adder_jax.framer.device import DeviceFramer
from adder_jax.framer.driver import FramerBuilder


def _builder(plane, tps, ref, dtm, fps, version, time_mode, camera):
    return (
        FramerBuilder(plane)
        .time_parameters(tps, ref, dtm, fps)
        .codec_meta(version, time_mode)
        .source_info(SourceType.U8, camera)
    )


def _random_events(plane, k_per_px, dtm, seed, absolute):
    """Per-pixel event chains honoring the delta_t_max contract: every gap
    (and the first event) is within dtm ticks — the same guarantee real
    transcoded streams carry, which bounds framer span lengths."""
    rng = np.random.default_rng(seed)
    W, H = plane.width, plane.height
    npx = W * H
    gaps = rng.integers(1, dtm, (npx, k_per_px)).astype(np.uint64)
    t_abs = np.cumsum(gaps, axis=1)
    pix = np.repeat(np.arange(npx), k_per_px)
    x = (pix % W).astype(np.uint16)
    y = (pix // W).astype(np.uint16)
    c = np.full(len(pix), 255, np.uint8)
    d = rng.integers(0, 32, len(pix)).astype(np.uint8)
    d[rng.random(len(pix)) < 0.05] = 255  # D_EMPTY fillers
    t = (t_abs if absolute else gaps).reshape(-1).astype(np.uint32)
    return EventArray(x, y, c, d, t)


@pytest.mark.parametrize(
    "version,time_mode",
    [(2, TimeMode.AbsoluteT), (0, TimeMode.DeltaT)],
    ids=["absolute", "delta"],
)
def test_device_matches_host_random(version, time_mode):
    plane = PlaneSize(32, 24, 1)
    tps, ref = 60_000, 1000
    dtm = 8000
    absolute = time_mode == TimeMode.AbsoluteT
    b = _builder(
        plane, tps, ref, dtm, 60.0, version, time_mode,
        SourceCamera.FramedU8,
    )
    ev = _random_events(plane, 6, dtm, 3, absolute)

    host = b.finish()
    host.ingest_event_array(ev)
    dev = DeviceFramer(b, batch_cap=1024)
    dev.ingest_event_array(ev)

    # drive both like simulproc: pop all complete frames, then one flush
    host_frames = []
    while host.is_frame_0_filled():
        vals, _ = host.pop_next_frame()
        host_frames.append(vals)
    if host.flush_frame_buffer():
        while host.is_frame_0_filled():
            vals, _ = host.pop_next_frame()
            host_frames.append(vals)

    dev_frames = []
    while dev.is_frame_0_filled():
        dev_frames.append(dev.pop_next_frame())
    if dev.flush_frame_buffer():
        while True:
            f = dev.pop_next_frame()
            if f is None:
                break
            dev_frames.append(f)

    assert len(dev_frames) == len(host_frames), (
        len(dev_frames), len(host_frames)
    )
    for i, (df, hf) in enumerate(zip(dev_frames, host_frames)):
        np.testing.assert_array_equal(df, hf, err_msg=f"frame {i}")


@pytest.mark.parametrize(
    "version,time_mode",
    [(2, TimeMode.AbsoluteT), (0, TimeMode.DeltaT)],
    ids=["absolute", "delta"],
)
@pytest.mark.parametrize("view", ["D", "DeltaT", "SAE", "coordless"])
def test_device_matches_host_views(view, version, time_mode):
    """SAE / D / DeltaT view modes and EventCoordless output on the device
    framer match the host framer byte-for-byte (ref: scale_intensity.rs
    FrameValue impls; driver.rs:1017-1043)."""
    from adder_jax.framer.scale_intensity import FramedViewMode

    plane = PlaneSize(16, 12, 1)
    tps, ref, dtm = 60_000, 1000, 8000
    absolute = time_mode == TimeMode.AbsoluteT
    b = _builder(
        plane, tps, ref, dtm, 60.0, version, time_mode,
        SourceCamera.FramedU8,
    )
    if view == "coordless":
        b.coordless = True
    else:
        b.view_mode = FramedViewMode[view]
    ev = _random_events(plane, 5, dtm, 9, absolute)

    host = b.finish()
    host.ingest_event_array(ev)
    dev = DeviceFramer(b, batch_cap=512)
    dev.ingest_event_array(ev)

    host_frames = []
    while host.is_frame_0_filled():
        vals, _ = host.pop_next_frame()
        host_frames.append(vals)
    dev_frames = []
    while dev.is_frame_0_filled():
        dev_frames.append(dev.pop_next_frame())
    assert len(dev_frames) == len(host_frames) and dev_frames
    for i, (df, hf) in enumerate(zip(dev_frames, host_frames)):
        np.testing.assert_array_equal(df, hf, err_msg=f"frame {i}")


@pytest.mark.slow
@pytest.mark.parametrize("name", ["sample_3_ordered.adder"])
def test_sample_3_golden_device(samples_dir, name):
    """The 405-frame golden through the device path (VERDICT r1 item 6)."""
    path = samples_dir / name
    dec = open_file_decoder(str(path))
    m = dec.meta
    b = (
        FramerBuilder(m.plane)
        .time_parameters(m.tps, m.ref_interval, m.delta_t_max, 60.0)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
    )
    dev = DeviceFramer(b, batch_cap=1 << 15)
    events = dec.digest_all()
    dev.ingest_event_array(events)
    out = io.BytesIO()
    count = 0
    while True:
        f = dev.pop_next_frame()
        if f is None:
            break
        out.write(f.tobytes())
        count += 1
    golden = (samples_dir / "sample_3.gray").read_bytes()
    assert count == 405, count
    assert out.getvalue() == golden
