"""Decoder robustness fuzzing (the reference ships a fuzz target for its
vendored coder; these are the equivalent quick in-CI checks): adversarial
bytes must produce clean errors or bounded output — never hangs, crashes,
or unbounded allocation."""

import io

import numpy as np
import pytest

from adder_jax.codec import compressed as cc
from adder_jax.codec.decoder import Decoder, open_file_decoder
from adder_jax.codec.encoder import Encoder, EncoderOptions
from adder_jax.codec.header import (
    MAGIC_COMPRESSED,
    MAGIC_RANS,
    MAGIC_RAW,
    CodecError,
    CodecMetadata,
    Eof,
    WrongMagic,
    encode_header,
)
from adder_jax.core.types import EventArray, PlaneSize, SourceCamera, TimeMode


def _meta(adu_interval=4):
    return CodecMetadata(
        codec_version=3,
        time_mode=TimeMode.AbsoluteT,
        plane=PlaneSize(48, 32, 1),
        tps=255 * 30,
        ref_interval=255,
        delta_t_max=255 * 4,
        source_camera=SourceCamera.FramedU8,
        adu_interval=adu_interval,
    )


def test_random_bytes_never_hang():
    rng = np.random.default_rng(0)
    for i in range(30):
        blob = rng.integers(0, 256, rng.integers(0, 400)).astype(np.uint8)
        with pytest.raises((CodecError, Eof, WrongMagic, ValueError)):
            Decoder(io.BytesIO(blob.tobytes()))


@pytest.mark.parametrize("magic", [MAGIC_RAW, MAGIC_COMPRESSED, MAGIC_RANS])
def test_valid_header_random_payload(magic):
    rng = np.random.default_rng(7)
    hdr = encode_header(_meta(), magic)
    for i in range(10):
        payload = rng.integers(0, 256, int(rng.integers(0, 3000))).astype(
            np.uint8
        ).tobytes()
        dec = Decoder(io.BytesIO(hdr + payload))
        try:
            ev = dec.digest_all()
            # bounded: a garbage payload can't imply more events than bytes
            assert len(ev) <= (len(payload) // 4) + 64
        except (CodecError, Eof):
            pass


@pytest.mark.parametrize("entropy", ["cabac", "rans"])
def test_truncated_compressed_stream(entropy):
    rng = np.random.default_rng(3)
    n = 3000
    plane = PlaneSize(48, 32, 1)
    xs = rng.integers(0, 48, n).astype(np.uint16)
    ys = rng.integers(0, 32, n).astype(np.uint16)
    cs = np.full(n, 255, np.uint8)
    ds = rng.integers(0, 32, n).astype(np.uint8)
    ts = rng.integers(1, 255 * 16, n).astype(np.uint32)
    order = np.lexsort((ts, ys.astype(np.int64) * 48 + xs))
    ev = EventArray(xs[order], ys[order], cs[order], ds[order], ts[order])
    buf = io.BytesIO()
    enc = Encoder.new_compressed(
        _meta(), buf, EncoderOptions.default(plane), entropy=entropy
    )
    enc.ingest_event_array(ev)
    enc.close_writer()
    data = buf.getvalue()
    for cut in [len(data) // 3, len(data) // 2, len(data) - 3]:
        dec = Decoder(io.BytesIO(data[:cut]))
        try:
            out = dec.digest_all()
            assert len(out) <= n + 1
        except (CodecError, Eof):
            pass


def test_aedat4_garbage_rejected():
    from adder_jax.utils.aedat4 import MAGIC, Aedat4Reader

    rng = np.random.default_rng(1)
    with pytest.raises(ValueError):
        Aedat4Reader(io.BytesIO(b"not an aedat file at all"))
    # valid magic + garbage header must fail cleanly, not crash
    blob = MAGIC + rng.integers(0, 256, 64).astype(np.uint8).tobytes()
    with pytest.raises(Exception):
        r = Aedat4Reader(io.BytesIO(blob))
        list(r.packets())
