"""Container (L1/L2) tests: header versions, raw event round-trips, fixtures.

Mirrors the reference test strategy:
- header sizes 25/29/33/37 per codec version (ref decoder.rs:414-489)
- raw event byte layout 9 B mono / 11 B color
- decode of committed reference `.adder` fixtures, byte-for-byte compatibility
"""

import io

import numpy as np
import pytest

from adder_jax.codec import raw as rawcodec
from adder_jax.codec.decoder import Decoder, open_file_decoder
from adder_jax.codec.encoder import Encoder, EncoderOptions, EventOrder
from adder_jax.codec.header import (
    MAGIC_RAW,
    CodecMetadata,
    Eof,
    SeekError,
    WrongMagic,
    decode_header,
    encode_header,
)
from adder_jax.core.types import (
    EOF_PX_ADDRESS,
    NO_CHANNEL,
    Event,
    EventArray,
    PlaneSize,
    SourceCamera,
    TimeMode,
)


def make_meta(version=3, channels=1, w=100, h=100):
    return CodecMetadata(
        codec_version=version,
        plane=PlaneSize(w, h, channels),
        tps=7650,
        ref_interval=255,
        delta_t_max=2550,
        time_mode=TimeMode.AbsoluteT,
        source_camera=SourceCamera.FramedU8,
        adu_interval=1,
    )


@pytest.mark.parametrize("version,size", [(0, 25), (1, 29), (2, 33), (3, 37)])
def test_header_sizes(version, size):
    meta = make_meta(version)
    buf = encode_header(meta, MAGIC_RAW)
    assert len(buf) == size
    meta2, magic = decode_header(io.BytesIO(buf))
    assert magic == MAGIC_RAW
    assert meta2.header_size == size
    assert meta2.codec_version == version
    assert meta2.plane == meta.plane
    assert meta2.tps == meta.tps
    assert meta2.ref_interval == meta.ref_interval
    assert meta2.delta_t_max == meta.delta_t_max
    if version >= 1:
        assert meta2.source_camera == meta.source_camera
    if version >= 2:
        assert meta2.time_mode == meta.time_mode
    if version >= 3:
        assert meta2.adu_interval == meta.adu_interval


def test_header_wrong_magic():
    with pytest.raises(WrongMagic):
        decode_header(io.BytesIO(b"nomagic" + b"\0" * 30))


def test_event_sizes():
    mono = EventArray.from_events([Event(1, 2, None, 3, 4)])
    color = EventArray.from_events([Event(1, 2, 1, 3, 4)])
    assert len(rawcodec.encode_events(mono, 1)) == 9
    assert len(rawcodec.encode_events(color, 3)) == 11


def test_event_roundtrip_mono():
    rng = np.random.default_rng(42)
    n = 1000
    ev = EventArray(
        rng.integers(0, 100, n).astype(np.uint16),
        rng.integers(0, 100, n).astype(np.uint16),
        np.full(n, NO_CHANNEL, np.uint8),
        rng.integers(0, 128, n).astype(np.uint8),
        rng.integers(0, 1 << 31, n).astype(np.uint32),
    )
    buf = rawcodec.encode_events(ev, 1)
    assert len(buf) == n * 9
    back = rawcodec.decode_events(buf, 1)
    assert back == ev


def test_event_roundtrip_color():
    rng = np.random.default_rng(7)
    n = 1000
    ev = EventArray(
        rng.integers(0, 100, n).astype(np.uint16),
        rng.integers(0, 100, n).astype(np.uint16),
        rng.integers(0, 3, n).astype(np.uint8),
        rng.integers(0, 128, n).astype(np.uint8),
        rng.integers(0, 1 << 31, n).astype(np.uint32),
    )
    buf = rawcodec.encode_events(ev, 3)
    assert len(buf) == n * 11
    back = rawcodec.decode_events(buf, 3)
    assert back == ev


def test_encoder_decoder_roundtrip_file(tmp_path):
    meta = make_meta(version=3, channels=1)
    path = tmp_path / "out.adder"
    enc = Encoder.new_raw(meta, open(path, "wb"), EncoderOptions.default(meta.plane))
    events = [
        Event(0, 0, None, 5, 100),
        Event(1, 0, None, 6, 200),
        Event(99, 99, None, 7, 300),
    ]
    enc.ingest_events(events)
    enc.close_writer().close()

    dec = open_file_decoder(str(path))
    assert dec.meta.plane == meta.plane
    assert dec.meta.time_mode == TimeMode.AbsoluteT
    got = dec.digest_all()
    assert [e for e in got] == events
    # scalar API + Eof
    dec.set_input_stream_position(dec.meta.header_size)
    for e in events:
        assert dec.digest_event() == e
    with pytest.raises(Eof):
        dec.digest_event()


def test_decoder_seek_alignment(tmp_path):
    meta = make_meta()
    path = tmp_path / "o.adder"
    enc = Encoder.new_raw(meta, open(path, "wb"), EncoderOptions.default(meta.plane))
    enc.ingest_event(Event(1, 1, None, 1, 1))
    enc.close_writer().close()
    dec = open_file_decoder(str(path))
    with pytest.raises(SeekError):
        dec.set_input_stream_position(dec.meta.header_size + 1)
    dec.set_input_stream_position(dec.meta.header_size + 9)


def test_eof_position(tmp_path):
    meta = make_meta()
    path = tmp_path / "o.adder"
    enc = Encoder.new_raw(meta, open(path, "wb"), EncoderOptions.default(meta.plane))
    for i in range(10):
        enc.ingest_event(Event(i, 0, None, 1, i))
    enc.close_writer().close()
    dec = open_file_decoder(str(path))
    assert dec.get_eof_position() == dec.meta.header_size + 10 * 9


def test_interleaved_ordering(tmp_path):
    """Interleaved mode must emit events sorted by t (ref encoder.rs:255-272)."""
    meta = make_meta()
    opts = EncoderOptions.default(meta.plane)
    opts.event_order = EventOrder.Interleaved
    path = tmp_path / "o.adder"
    enc = Encoder.new_raw(meta, open(path, "wb"), opts)
    rng = np.random.default_rng(3)
    ts = rng.integers(0, 100_000, 500).astype(np.uint32)
    ev = EventArray(
        np.zeros(500, np.uint16),
        np.zeros(500, np.uint16),
        np.full(500, NO_CHANNEL, np.uint8),
        np.ones(500, np.uint8),
        ts,
    )
    enc.ingest_event_array(ev)
    enc.close_writer().close()
    got = open_file_decoder(str(path)).digest_all()
    assert len(got) == 500
    assert np.all(np.diff(got.t.astype(np.int64)) >= 0)


def test_interleaved_large_stream_batched(tmp_path):
    """A million-event interleaved stream across many batches stays globally
    t-sorted and preserves arrival order at equal timestamps (the sorted
    reorder buffer merges incrementally — no per-batch full re-sort)."""
    meta = make_meta()
    opts = EncoderOptions.default(meta.plane)
    opts.event_order = EventOrder.Interleaved
    path = tmp_path / "big.adder"
    enc = Encoder.new_raw(meta, open(path, "wb"), opts)
    rng = np.random.default_rng(11)
    n_batches, b = 100, 10_000
    total = n_batches * b
    base = 0
    for i in range(n_batches):
        # timestamps advance with jitter bounded well inside delta_t_max
        ts = (base + rng.integers(0, meta.delta_t_max, b)).astype(np.uint32)
        # x encodes arrival index so equal-t stability is checkable
        ev = EventArray(
            (np.arange(i * b, (i + 1) * b) % 65536).astype(np.uint16),
            np.zeros(b, np.uint16),
            np.full(b, NO_CHANNEL, np.uint8),
            np.ones(b, np.uint8),
            ts,
        )
        enc.ingest_event_array(ev)
        base += meta.delta_t_max // 4
    enc.close_writer().close()
    got = open_file_decoder(str(path)).digest_all()
    assert len(got) == total
    assert np.all(np.diff(got.t.astype(np.int64)) >= 0)


# --- reference fixture compatibility ---


def test_fixture_nyc_v2(samples_dir):
    dec = open_file_decoder(str(samples_dir / "nyc_source_v2.adder"))
    m = dec.meta
    assert m.codec_version == 2
    assert m.header_size == 33
    assert (m.plane.width, m.plane.height, m.plane.channels) == (320, 180, 1)
    assert m.tps == 7650
    assert m.ref_interval == 255
    assert m.delta_t_max == 2550
    assert m.event_size == 9
    events = dec.digest_all()
    assert len(events) > 1000
    # every event in-bounds
    assert events.x.max() < 320 and events.y.max() < 180


def test_fixture_nyc_v1(samples_dir):
    dec = open_file_decoder(str(samples_dir / "nyc_v1.adder"))
    assert dec.meta.codec_version == 1
    assert dec.meta.header_size == 29
    events = dec.digest_all()
    assert len(events) > 1000
    assert events.x.max() < 320 and events.y.max() < 180


def test_fixture_bunny_v2_t(samples_dir):
    dec = open_file_decoder(str(samples_dir / "bunny_v2_t.adder"))
    m = dec.meta
    assert m.codec_version == 2
    assert m.time_mode == TimeMode.AbsoluteT
    events = dec.digest_all()
    assert len(events) > 0
    assert events.x.max() < m.plane.width and events.y.max() < m.plane.height


def test_fixture_v0(samples_dir):
    dec = open_file_decoder(str(samples_dir / "sample_3_ordered.adder"))
    m = dec.meta
    assert m.codec_version == 0
    assert m.header_size == 25
    events = dec.digest_all()
    assert len(events) > 0
    assert events.x.max() < m.plane.width


def test_fixture_reencode_identical(samples_dir, tmp_path):
    """Decode a reference raw file and re-encode it; bytes must be identical."""
    src = samples_dir / "nyc_source_v2.adder"
    dec = open_file_decoder(str(src))
    events = dec.digest_all()
    path = tmp_path / "re.adder"
    enc = Encoder.new_raw(dec.meta, open(path, "wb"), EncoderOptions.default(dec.meta.plane))
    enc.ingest_event_array(events)
    enc.close_writer().close()
    assert path.read_bytes() == src.read_bytes()


def test_event_drop_manual(tmp_path):
    """EventDrop manual EMA rate limiter drops events when the rate exceeds
    the target (ref: encoder.rs:234-253)."""
    from adder_jax.codec.encoder import EventDrop

    meta = make_meta()
    opts = EncoderOptions.default(meta.plane)
    opts.event_drop = EventDrop(mode="manual", target_event_rate=10.0, alpha=0.9)
    path = tmp_path / "drop.adder"
    enc = Encoder.new_raw(meta, open(path, "wb"), opts)
    ev = EventArray(
        np.zeros(10000, np.uint16),
        np.zeros(10000, np.uint16),
        np.full(10000, NO_CHANNEL, np.uint8),
        np.ones(10000, np.uint8),
        np.arange(10000, dtype=np.uint32),
    )
    enc.ingest_event_array(ev)
    enc.close_writer().close()
    kept = open_file_decoder(str(path)).digest_all()
    # a 10 ev/s target against a burst of 10k must drop nearly everything
    assert len(kept) < 10000


def test_event_drop_ema_matches_scalar_recurrence():
    """The native EMA keep-set is bit-identical to the scalar double
    recurrence (ref: encoder.rs:234-253) and handles 1M events quickly."""
    import time as _time

    from adder_jax.codec.compressed import event_drop_ema

    rng = np.random.default_rng(3)
    for alpha, target, t_diff, rate0 in [
        (0.9, 10.0, 1e-6, 0.0),
        (0.999, 5e5, 2e-6, 1e5),
        (0.5, 1e9, 1e-3, 0.0),  # nothing dropped
        (0.7, 0.0, 1.0, 50.0),  # everything dropped
    ]:
        n = 4096
        keep_ref = np.ones(n, dtype=bool)
        rate = rate0
        for i in range(n):
            new_rate = alpha * rate + (1.0 - alpha) / t_diff
            if new_rate > target:
                rate *= alpha
                keep_ref[i] = False
            else:
                rate = new_rate
        keep, final = event_drop_ema(n, rate0, alpha, t_diff, target)
        assert np.array_equal(keep, keep_ref)
        assert final == rate

    t0 = _time.perf_counter()
    keep, _ = event_drop_ema(1_000_000, 0.0, 0.99, 1e-6, 5e5)
    assert (_time.perf_counter() - t0) < 0.5
    assert 0 < keep.sum() < 1_000_000
