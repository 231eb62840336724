"""Tests for cv utils, info, stream migration, adder-to-dvs, prophesee."""

import io
import subprocess
import sys

import numpy as np
import pytest

from adder_jax.codec.decoder import open_file_decoder
from adder_jax.codec.encoder import Encoder, EncoderOptions, EncoderType
from adder_jax.codec.header import CodecMetadata, LATEST_CODEC_VERSION
from adder_jax.core.types import (
    Coord,
    Event,
    EventArray,
    PixelMultiMode,
    PlaneSize,
    SourceCamera,
    TimeMode,
)
from adder_jax.models.adder_to_dvs import adder_to_dvs
from adder_jax.transcoder.prophesee import Prophesee, decode_events_np, parse_header
from adder_jax.utils import cv
from adder_jax.utils.info import adder_info
from adder_jax.utils.stream_migration import migrate_v2


# --- FAST features ---


def test_fast_corner_detection():
    img = np.full((20, 20, 1), 50, dtype=np.uint8)
    img[:10, :10, 0] = 200  # bright quadrant corner at (9,9)-ish
    plane = PlaneSize(20, 20, 1)
    mask = cv.fast_mask(img)
    # scalar and dense agree everywhere
    for y in range(20):
        for x in range(20):
            assert mask[y, x] == cv.is_feature(Coord(x, y, None), plane, img), (x, y)
    assert mask.any()  # the quadrant boundary yields corners


def test_fast_uniform_image_no_features():
    img = np.full((16, 16, 1), 128, dtype=np.uint8)
    assert not cv.fast_mask(img).any()


def test_fast_jax_matches_numpy():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (32, 32), dtype=np.uint8)
    want = cv.fast_mask(img)
    got = np.asarray(cv.fast_mask_jax(img))
    assert np.array_equal(want, got)


# --- quality metrics ---


def test_quality_metrics():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, (32, 32, 1), dtype=np.uint8)
    m = cv.calculate_quality_metrics(a, a.copy(), cv.QualityMetrics(ssim=0.0))
    assert m.mse == pytest.approx(1e-7)
    assert m.psnr > 100
    assert m.ssim == pytest.approx(100.0, abs=1e-6)

    b = np.clip(a.astype(int) + rng.integers(-10, 11, a.shape), 0, 255).astype(np.uint8)
    m2 = cv.calculate_quality_metrics(a, b, cv.QualityMetrics(ssim=0.0))
    assert 0 < m2.mse < 200
    assert 20 < m2.psnr < 50
    assert 0 < m2.ssim < 100


# --- adder-info ---


def test_adder_info_fixture(samples_dir):
    out = adder_info(str(samples_dir / "nyc_source_v2.adder"), dynamic_range=True)
    assert "Width: 320" in out
    assert "Height: 180" in out
    assert "ADDER event count: 242906" in out
    assert "Realized range:" in out


def test_adder_info_cli(samples_dir):
    r = subprocess.run(
        [sys.executable, "tools/adder_info.py", "-i", str(samples_dir / "nyc_v1.adder")],
        capture_output=True, text=True, cwd="/root/repo",
    )
    assert r.returncode == 0, r.stderr
    assert "Codec version: 1" in r.stdout


# --- stream migration ---


def test_migrate_v2_roundtrip(tmp_path):
    """DeltaT v1 stream -> AbsoluteT v3; per-pixel absolute times must be the
    rounded cumulative sums (ref: stream_migration.rs tests)."""
    plane = PlaneSize(4, 4, 1)
    meta_v1 = CodecMetadata(
        codec_version=1, plane=plane, tps=255 * 30, ref_interval=255,
        delta_t_max=2550, time_mode=TimeMode.DeltaT,
        source_camera=SourceCamera.FramedU8,
    )
    src = tmp_path / "v1.adder"
    enc = Encoder.new_raw(meta_v1, open(src, "wb"), EncoderOptions.default(plane))
    evs = [
        Event(0, 0, None, 5, 255),
        Event(0, 0, None, 6, 510),
        Event(0, 0, None, 4, 100),
        Event(1, 0, None, 3, 130),
    ]
    enc.ingest_events(evs)
    enc.close_writer().close()

    dec = open_file_decoder(str(src))
    out_meta = CodecMetadata(
        codec_version=LATEST_CODEC_VERSION, plane=plane, tps=255 * 30,
        ref_interval=255, delta_t_max=2550, time_mode=TimeMode.AbsoluteT,
        source_camera=SourceCamera.FramedU8,
    )
    dst = tmp_path / "v3.adder"
    enc2 = Encoder.new_raw(out_meta, open(dst, "wb"), EncoderOptions.default(plane))
    migrate_v2(dec, enc2).close_writer().close()

    back = open_file_decoder(str(dst))
    assert back.meta.codec_version == 3
    assert back.meta.time_mode == TimeMode.AbsoluteT
    got = list(back.digest_all())
    # pixel (0,0): t=255 -> abs 255 (tracker 255); t=510 -> 255+510=765
    # (tracker 765); t=100 -> 765+100=865 (tracker round 1020)
    assert got[0].t == 255
    assert got[1].t == 765
    assert got[2].t == 865
    assert got[3].t == 130


# --- adder-to-dvs ---


def test_adder_to_dvs_roundtrip(samples_dir, tmp_path):
    out = io.BytesIO()
    stats = adder_to_dvs(
        str(samples_dir / "nyc_source_v2.adder"), out, "binary",
        theta=0.01, max_events=40000,
    )
    data = out.getvalue()
    assert stats["n_dvs_events"] > 0
    # header parse + binary records parse back with the prophesee decoder
    f = io.BytesIO(data)

    class _F(io.BytesIO):
        pass

    bod_reader = io.BytesIO(data)
    bod, ev_type, ev_size, (h, w) = parse_header(bod_reader)
    assert (h, w) == (180, 320)
    assert ev_size == 8
    t, x, y, p = decode_events_np(data[bod:])
    assert len(t) == stats["n_dvs_events"]
    assert x.max() < 320 and y.max() < 180
    assert set(np.unique(p)).issubset({0, 1})


def test_adder_to_dvs_text(samples_dir):
    out = io.BytesIO()
    stats = adder_to_dvs(
        str(samples_dir / "nyc_source_v2.adder"), out, "text",
        theta=0.05, max_events=20000,
    )
    lines = [l for l in out.getvalue().decode().splitlines() if not l.startswith("%")]
    assert len(lines) == stats["n_dvs_events"]
    if lines:
        t, x, y, p = lines[0].split()
        assert p in ("0", "1")


# --- prophesee source ---


def make_prophesee_file(path, w, h, events):
    """events: list of (t, x, y, p)."""
    with open(path, "wb") as f:
        f.write(f"% Height {h}\n".encode())
        f.write(f"% Width {w}\n".encode())
        f.write(b"% end\n")
        f.write(bytes([0, 8]))
        rec = np.zeros((len(events), 2), dtype="<u4")
        for i, (t, x, y, p) in enumerate(events):
            rec[i, 0] = t
            rec[i, 1] = (p << 28) | (y << 14) | x
        f.write(rec.tobytes())


def test_prophesee_transcode(tmp_path):
    w, h = 16, 12
    rng = np.random.default_rng(0)
    events = []
    t = 10
    for _ in range(400):
        t += rng.integers(1, 2000)
        events.append((t, rng.integers(0, w), rng.integers(0, h), rng.integers(0, 2)))
    raw = tmp_path / "test.raw"
    make_prophesee_file(raw, w, h, events)

    src = Prophesee(20, str(raw))
    assert src.plane.width == w and src.plane.height == h
    assert src.video.tps == 20 * 1_000_000
    assert src.video.delta_t_max == 40

    path = tmp_path / "out.adder"
    src.write_out(
        SourceCamera.Dvs, TimeMode.AbsoluteT, PixelMultiMode.Collapse, None,
        EncoderType.Raw, EncoderOptions.default(src.plane), open(path, "wb"),
    )
    n = 0
    while True:
        try:
            n += len(src.consume())
        except EOFError:
            break
    src.end_write_stream().close()

    dec = open_file_decoder(str(path))
    got = dec.digest_all()
    assert len(got) > w * h  # at least the bootstrap events
    assert got.x.max() < w and got.y.max() < h
    # per-pixel monotonic timestamps (AbsoluteT contract)
    per_px = {}
    for e in got:
        key = (e.x, e.y)
        assert e.t >= per_px.get(key, 0), (key, e.t, per_px.get(key))
        per_px[key] = e.t


def test_adder_recompress_roundtrip(tmp_path, samples_dir):
    """raw -> addrn -> raw preserves the event stream (AbsoluteT fixture);
    DeltaT inputs are refused for compressed outputs."""
    import pathlib
    import subprocess
    import sys as _sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    tool = repo / "tools" / "adder_recompress.py"
    src = samples_dir / "bunny_v2_t.adder"
    mid = tmp_path / "bunny.addrn"
    back = tmp_path / "bunny_back.adder"
    r1 = subprocess.run(
        [_sys.executable, str(tool), "-i", str(src), "-o", str(mid),
         "--codec", "rans"], capture_output=True, text=True, timeout=300,
    )
    assert r1.returncode == 0, r1.stderr[-1500:]
    r2 = subprocess.run(
        [_sys.executable, str(tool), "-i", str(mid), "-o", str(back),
         "--codec", "raw"], capture_output=True, text=True, timeout=300,
    )
    assert r2.returncode == 0, r2.stderr[-1500:]

    from adder_jax.codec.decoder import open_file_decoder

    a = open_file_decoder(str(src)).digest_all()
    b = open_file_decoder(str(back)).digest_all()
    assert sorted(zip(a.x, a.y, a.d, a.t)) == sorted(zip(b.x, b.y, b.d, b.t))

    # DeltaT input refused for compressed output
    r3 = subprocess.run(
        [_sys.executable, str(tool),
         "-i", str(samples_dir / "nyc_source_v2.adder"),
         "-o", str(tmp_path / "x.addec"), "--codec", "cabac"],
        capture_output=True, text=True, timeout=300,
    )
    assert r3.returncode == 1
    assert "AbsoluteT" in r3.stderr


def test_adder_to_dvs_vectorized_matches_scalar(samples_dir):
    """The lane-vectorized DVS transcode core must reproduce the scalar
    reference-shaped loop exactly (stream order, t, polarity, counts)."""
    from adder_jax.codec.decoder import open_file_decoder
    from adder_jax.models.adder_to_dvs import (
        _transcode_core,
        _transcode_core_scalar,
    )

    dec = open_file_decoder(str(samples_dir / "nyc_source_v2.adder"))
    events = dec.digest_all()[:30000]
    got = _transcode_core(events, dec.meta, 0.01)
    want = _transcode_core_scalar(events, dec.meta, 0.01)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert len(got[0]) > 0
