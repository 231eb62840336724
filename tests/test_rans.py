"""Interleaved-rANS entropy stage (`addrn`, own format).

The cube residual transforms are shared with the reference-compatible
`addec` path; only the entropy coding differs (static per-ADU tables,
8-lane interleaved rANS). So the decoded event stream of an `addrn` blob
must equal the `addec` blob's byte-for-byte, at both lossless and lossy
settings.
"""

import io

import numpy as np
import pytest

from adder_jax.codec import compressed as cc
from adder_jax.codec.decoder import Decoder, open_file_decoder
from adder_jax.codec.encoder import Encoder, EncoderOptions, EncoderType
from adder_jax.codec.header import MAGIC_RANS, CodecError, CodecMetadata
from adder_jax.core.types import EventArray, PlaneSize, SourceCamera, TimeMode


def _events(n=20000, W=320, H=180, seed=0, tmax=255 * 8):
    rng = np.random.default_rng(seed)
    xs = rng.integers(0, W, n).astype(np.uint16)
    ys = rng.integers(0, H, n).astype(np.uint16)
    cs = np.full(n, 255, np.uint8)
    ds = rng.integers(0, 64, n).astype(np.uint8)
    ts = rng.integers(0, tmax, n).astype(np.uint32)
    order = np.lexsort((ts, ys.astype(np.int64) * W + xs))
    return EventArray(xs[order], ys[order], cs[order], ds[order], ts[order])


@pytest.mark.parametrize("c_thresh_max", [0, 7])
def test_adu_roundtrip_matches_cabac(c_thresh_max):
    W, H = 320, 180
    ev = _events()
    blob_r = cc.compress_adu(ev, W, H, 1, 0, 255, 8, c_thresh_max, rans=True)
    blob_c = cc.compress_adu(ev, W, H, 1, 0, 255, 8, c_thresh_max)
    back_r = cc.decompress_adu(blob_r, W, H, 1, 0, 255, 8, rans=True)
    back_c = cc.decompress_adu(blob_c, W, H, 1, 0, 255, 8)
    for f in ("x", "y", "c", "d", "t"):
        np.testing.assert_array_equal(
            getattr(back_r, f), getattr(back_c, f)
        )
    # beats the 9 B/event raw size (reference's own compression gate)
    assert len(blob_r) < 9 * len(ev)


def test_lossless_roundtrip_exact():
    W, H = 64, 64
    ev = _events(n=3000, W=W, H=H, seed=3, tmax=255 * 4)
    blob = cc.compress_adu(ev, W, H, 1, 0, 255, 4, 0, rans=True)
    back = cc.decompress_adu(blob, W, H, 1, 0, 255, 4, rans=True)
    # same multiset (drain order differs from ingest order)
    key_in = sorted(zip(ev.x, ev.y, ev.d, ev.t))
    key_out = sorted(zip(back.x, back.y, back.d, back.t))
    assert key_in == key_out


def _meta(W=64, H=64, adu_interval=4):
    return CodecMetadata(
        codec_version=3,
        time_mode=TimeMode.AbsoluteT,
        plane=PlaneSize(W, H, 1),
        tps=255 * 30,
        ref_interval=255,
        delta_t_max=255 * 4,
        source_camera=SourceCamera.FramedU8,
        adu_interval=adu_interval,
    )


def test_stream_roundtrip_and_magic():
    W = H = 64
    ev = _events(n=5000, W=W, H=H, seed=7, tmax=255 * 16)
    buf = io.BytesIO()
    enc = Encoder.new_compressed(
        _meta(W, H), buf, EncoderOptions.default(PlaneSize(W, H, 1)),
        entropy="rans",
    )
    enc.ingest_event_array(ev)
    enc.close_writer()
    data = buf.getvalue()
    assert data[:5] == MAGIC_RANS

    dec = Decoder(io.BytesIO(data))
    assert dec.get_compression_type() == EncoderType.Compressed
    out = dec.digest_all()
    assert len(out) > 0
    # lossless CRF0-style settings: compare against the cabac stream's events
    buf2 = io.BytesIO()
    enc2 = Encoder.new_compressed(
        _meta(W, H), buf2, EncoderOptions.default(PlaneSize(W, H, 1)),
    )
    enc2.ingest_event_array(ev)
    enc2.close_writer()
    out2 = Decoder(io.BytesIO(buf2.getvalue())).digest_all()
    for f in ("x", "y", "c", "d", "t"):
        np.testing.assert_array_equal(getattr(out, f), getattr(out2, f))


def test_corrupt_blob_rejected():
    W = H = 64
    ev = _events(n=2000, W=W, H=H, seed=9, tmax=255 * 4)
    blob = bytearray(cc.compress_adu(ev, W, H, 1, 0, 255, 4, 0, rans=True))
    # truncate mid-payload
    with pytest.raises(CodecError):
        cc.decompress_adu(
            bytes(blob[: len(blob) // 2]), W, H, 1, 0, 255, 4, rans=True
        )
    # flip frequency-table bytes
    blob[14] ^= 0xFF
    with pytest.raises(CodecError):
        cc.decompress_adu(bytes(blob), W, H, 1, 0, 255, 4, rans=True)


@pytest.mark.slow
def test_decode_speed_exceeds_cabac():
    """The point of the stage: interleaved static decode is faster than the
    serial adaptive coder (recorded, not asserted hard — CI hosts vary)."""
    import time

    W, H = 320, 180
    ev = _events(n=50000, W=W, H=H, seed=1, tmax=255 * 8)
    blob_r = cc.compress_adu(ev, W, H, 1, 0, 255, 8, 0, rans=True)
    blob_c = cc.compress_adu(ev, W, H, 1, 0, 255, 8, 0)
    for _ in range(2):  # warm
        cc.decompress_adu(blob_r, W, H, 1, 0, 255, 8, rans=True)
        cc.decompress_adu(blob_c, W, H, 1, 0, 255, 8)
    t0 = time.perf_counter()
    cc.decompress_adu(blob_r, W, H, 1, 0, 255, 8, rans=True)
    t_r = time.perf_counter() - t0
    t0 = time.perf_counter()
    cc.decompress_adu(blob_c, W, H, 1, 0, 255, 8)
    t_c = time.perf_counter() - t0
    # generous 2x slack for noisy CI; measured ~4-5x faster
    assert t_r < t_c * 2.0, (t_r, t_c)
