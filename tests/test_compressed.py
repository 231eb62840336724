"""Compressed codec tests, mirroring the reference's strategy:
round-trips at ADU and stream level, skip-cube handling, compression-ratio
asserts vs raw bytes, lossless-at-CRF0 and +-5-tick lossy t fidelity
(ref: compressed/stream.rs:443-947, event_adu.rs:240-449).
"""

import io

import numpy as np
import pytest

from adder_jax.codec.compressed import compress_adu, decompress_adu
from adder_jax.codec.decoder import Decoder, open_file_decoder
from adder_jax.codec.encoder import Encoder, EncoderOptions, EncoderType
from adder_jax.codec.header import CodecMetadata, MAGIC_COMPRESSED
from adder_jax.core.types import (
    NO_CHANNEL,
    Event,
    EventArray,
    PlaneSize,
    SourceCamera,
    TimeMode,
)


def synth_events(n, w, h, channels, t_span, seed=0, start_t=0):
    """Per-pixel monotonic event streams over a plane."""
    rng = np.random.default_rng(seed)
    xs, ys, cs, ds, ts = [], [], [], [], []
    n_px = max(n // 4, 1)
    for _ in range(n_px):
        x = rng.integers(0, w)
        y = rng.integers(0, h)
        c = NO_CHANNEL if channels == 1 else rng.integers(0, channels)
        k = rng.integers(1, 8)
        t = start_t + rng.integers(0, t_span // 2)
        for _ in range(k):
            xs.append(x)
            ys.append(y)
            cs.append(c)
            ds.append(rng.integers(0, 100))
            ts.append(t)
            t += rng.integers(1, max(t_span // 8, 2))
    return EventArray(
        np.array(xs, np.uint16),
        np.array(ys, np.uint16),
        np.array(cs, np.uint8),
        np.array(ds, np.uint8),
        np.array(ts, np.uint32),
    )


def sort_key(ev):
    return sorted(
        [(e.c if e.c is not None else -1, e.y, e.x, i) for i, e in enumerate(ev)]
    )


def expected_stream_survivors(events: EventArray, ref_interval: int,
                              adu_interval: int) -> dict:
    """EXACT per-pixel survivor sequences of the compressed stream path:
    replicates the ADU rotation (compressed.py ingest_event_array — one
    rotation per triggering event, the trigger lands in the NEW adu) and
    the cube ingest drop rule (adder_entropy.cpp ingest_adu, line-equal to
    event_cube.rs:127-141: drop when the pixel's list has >1 entries and
    t <= last.t; lists reset per ADU)."""
    span = ref_interval * max(adu_interval, 1)
    t = events.t.astype(np.int64)
    xs, ys, cs, ds = events.x, events.y, events.c, events.d
    start_t = 0
    survivors: dict = {}
    lists: dict = {}
    for j in range(len(events)):
        if t[j] > start_t + span:
            lists = {}  # ADU rotation: fresh cube pixel lists
            start_t += span
        k = (int(xs[j]), int(ys[j]), None if cs[j] == NO_CHANNEL else int(cs[j]))
        lst = lists.setdefault(k, [])
        if len(lst) > 1 and int(t[j]) <= lst[-1][1]:
            continue
        lst.append((int(ds[j]), int(t[j])))
        survivors.setdefault(k, []).append((int(ds[j]), int(t[j])))
    return survivors


def group_by_pixel(ev, apply_drop_rule=False):
    d = {}
    for e in ev:
        d.setdefault((e.x, e.y, e.c), []).append((e.d, e.t))
    if apply_drop_rule:
        # cube ingest drops non-monotonic events once the pixel list has >1
        # entries (ref: event_cube.rs:127-141)
        for k, evs in d.items():
            kept = []
            for de, te in evs:
                if len(kept) > 1 and te <= kept[-1][1]:
                    continue
                kept.append((de, te))
            d[k] = kept
    return d


@pytest.mark.parametrize("channels", [1, 3], ids=["mono", "color"])
def test_adu_roundtrip_lossless(channels):
    w, h = 40, 30
    dt_ref, num_intervals = 255, 8
    ev = synth_events(200, w, h, channels, dt_ref * num_intervals, seed=1)
    blob = compress_adu(ev, w, h, channels, 0, dt_ref, num_intervals, 0)
    back = decompress_adu(blob, w, h, channels, 0, dt_ref, num_intervals)
    # drain order differs from ingest order; compare per-pixel sequences
    want = group_by_pixel(ev, apply_drop_rule=True)
    got = group_by_pixel(back)
    assert set(got) == set(want)
    for k in want:
        kept = want[k]
        assert got[k] == kept, (k, got[k][:4], kept[:4])


def test_adu_roundtrip_lossy_slack():
    """c_thresh_max=7: d exact, t within +-5 ticks (ref stream.rs:694-699)."""
    w, h = 32, 32
    dt_ref, num_intervals = 255, 8
    ev = synth_events(300, w, h, 1, dt_ref * num_intervals, seed=2)
    blob = compress_adu(ev, w, h, 1, 0, dt_ref, num_intervals, 7)
    back = decompress_adu(blob, w, h, 1, 0, dt_ref, num_intervals)
    want = group_by_pixel(ev, apply_drop_rule=True)
    got = group_by_pixel(back)
    assert set(got) == set(want)
    for k in want:
        assert len(got[k]) == len(want[k])
        for (gd, gt), (wd, wt) in zip(got[k], want[k]):
            assert gd == wd
            assert abs(int(gt) - int(wt)) <= 5, (k, gt, wt)


def test_adu_empty():
    blob = compress_adu(EventArray.empty(), 32, 32, 1, 0, 255, 8, 0)
    assert len(blob) > 0  # skip-cube symbols + EOF
    back = decompress_adu(blob, 32, 32, 1, 0, 255, 8)
    assert len(back) == 0


def test_stream_roundtrip_and_ratio(tmp_path):
    """Full Encoder/Decoder compressed stream round trip + size < raw."""
    w, h = 48, 32
    meta = CodecMetadata(
        codec_version=3,
        plane=PlaneSize(w, h, 1),
        tps=255 * 30,
        ref_interval=255,
        delta_t_max=255 * 8,
        time_mode=TimeMode.AbsoluteT,
        source_camera=SourceCamera.FramedU8,
        adu_interval=8,
    )
    # several ADUs worth of events, globally time-ordered
    evs = []
    for adu in range(4):
        evs.append(
            synth_events(
                400, w, h, 1, 255 * 8, seed=adu, start_t=adu * 255 * 8
            )
        )
    allev = EventArray.concatenate(evs)
    order = np.argsort(allev.t, kind="stable")
    allev = allev[order]

    path = tmp_path / "c.adder"
    enc = Encoder.new_compressed(meta, open(path, "wb"), EncoderOptions.default(meta.plane))
    enc.options.crf.update_quality(0)
    enc.sync_crf()
    enc.ingest_event_array(allev)
    enc.close_writer().close()

    raw_size = len(allev) * 9
    comp_size = path.stat().st_size
    assert comp_size < raw_size, (comp_size, raw_size)

    dec = open_file_decoder(str(path))
    assert dec.magic == MAGIC_COMPRESSED
    assert dec.meta.adu_interval == 8
    back = dec.digest_all()
    # EXACT survivor sets: the expected drop set is computable host-side
    # (ADU rotation + cube ingest rule), so no blanket tolerance
    want = expected_stream_survivors(allev, 255, 8)
    got = group_by_pixel(back)
    assert set(got) == set(want)
    for k in sorted(want):
        assert got[k] == want[k], (k, got[k][:4], want[k][:4])


def test_fixture_reencode_compressed_smaller(samples_dir, tmp_path):
    """Decode a committed raw fixture, re-encode compressed; file must be
    smaller than raw (ref: adder-codec-core/tests/integration_tests.rs:12-80)."""
    dec = open_file_decoder(str(samples_dir / "nyc_source_v2.adder"))
    events = dec.digest_all()
    # nyc fixture is DeltaT mode; compressed path needs AbsoluteT-like
    # monotonic t per pixel — reconstruct absolute times per pixel
    import numpy as np

    pix = (events.y.astype(np.int64) * 320 + events.x.astype(np.int64))
    order = np.argsort(pix, kind="stable")
    t_abs = events.t.astype(np.uint64).copy()
    spix = pix[order]
    st = events.t[order].astype(np.uint64)
    seg = np.ones(len(spix), bool)
    seg[1:] = spix[1:] != spix[:-1]
    tot = np.cumsum(st)
    base = np.maximum.accumulate(np.where(seg, tot - st, 0))
    t_abs[order] = (tot - base).astype(np.uint64)
    ev_abs = EventArray(events.x, events.y, events.c, events.d, t_abs.astype(np.uint32))
    order2 = np.argsort(ev_abs.t, kind="stable")
    ev_abs = ev_abs[order2]

    meta = dec.meta
    meta.adu_interval = 10
    meta.codec_version = 3  # adu_interval is a v3 header extension
    meta.time_mode = TimeMode.AbsoluteT
    path = tmp_path / "re.addec"
    enc = Encoder.new_compressed(meta, open(path, "wb"), EncoderOptions.default(meta.plane))
    enc.ingest_event_array(ev_abs)
    enc.close_writer().close()
    assert path.stat().st_size < len(events) * 9

    back = open_file_decoder(str(path)).digest_all()
    # exact expected-drop accounting (no 95% blanket): every survivor of
    # the ADU/cube ingest rules must come back — counts and d sequences
    # exact; t carries the documented +-5-tick lossy envelope (the
    # default encoder options are lossy; ref stream.rs:694-699)
    want = expected_stream_survivors(ev_abs, meta.ref_interval, 10)
    got = group_by_pixel(back)
    assert set(got) == set(want)
    n_want = sum(len(v) for v in want.values())
    assert len(back) == n_want, (len(back), n_want, len(ev_abs))
    for k in sorted(want):
        gl, wl = got[k], want[k]
        assert len(gl) == len(wl), (k, len(gl), len(wl))
        assert [d for d, _ in gl] == [d for d, _ in wl], k
        for (_, gt), (_, wt) in zip(gl, wl):
            assert abs(int(gt) - int(wt)) <= 5, (k, gt, wt)


def _write_compressed(tmp_path, n_adus=4, w=48, h=32, name="seek.adder"):
    meta = CodecMetadata(
        codec_version=3,
        plane=PlaneSize(w, h, 1),
        tps=255 * 30,
        ref_interval=255,
        delta_t_max=255 * 8,
        time_mode=TimeMode.AbsoluteT,
        source_camera=SourceCamera.FramedU8,
        adu_interval=8,
    )
    evs = [
        synth_events(300, w, h, 1, 255 * 8, seed=a, start_t=a * 255 * 8)
        for a in range(n_adus)
    ]
    allev = EventArray.concatenate(evs)
    allev = allev[np.argsort(allev.t, kind="stable")]
    path = tmp_path / name
    enc = Encoder.new_compressed(
        meta, open(path, "wb"), EncoderOptions.default(meta.plane)
    )
    enc.options.crf.update_quality(0)
    enc.sync_crf()
    enc.ingest_event_array(allev)
    enc.close_writer().close()
    return path, allev


def test_compressed_seek_adu_boundaries(tmp_path):
    """`addec` streams seek at ADU boundaries: replaying from a boundary
    yields exactly the events of the remaining ADUs, with correct start_t
    (ref: decoder.rs:225-231, compressed/stream.rs:394-400)."""
    from adder_jax.codec.header import SeekError

    path, _ = _write_compressed(tmp_path)
    dec = open_file_decoder(str(path))
    full = dec.digest_all()

    boundaries = dec.get_adu_boundaries()
    assert boundaries[0] == dec.meta.header_size
    assert len(boundaries) >= 3  # several ADUs + end-of-stream

    # replay from the start == full decode (loop restart without reopening)
    dec.set_input_stream_position(dec.meta.header_size)
    again = dec.digest_all()
    assert len(again) == len(full)
    assert np.array_equal(again.t, full.t)
    assert np.array_equal(again.d, full.d)

    # seek into the middle: suffix decode, timestamps continue (not reset)
    mid = boundaries[1]
    dec.set_input_stream_position(mid)
    tail = dec.digest_all()
    assert 0 < len(tail) < len(full)
    assert tail.t.min() >= 255 * 8  # second ADU's start_t span

    # EOF position reporting
    assert dec.get_eof_position() == boundaries[-1]

    # non-boundary positions are rejected
    with pytest.raises(SeekError):
        dec.set_input_stream_position(dec.meta.header_size + 1)


def test_compressed_truncated_adu_is_eof(tmp_path):
    """A truncated final ADU ends the stream cleanly (Eof, no crash)."""
    path, _ = _write_compressed(tmp_path, name="trunc.adder")
    data = path.read_bytes()
    cut = path.with_suffix(".cut")
    cut.write_bytes(data[: len(data) - len(data) // 3])
    dec = open_file_decoder(str(cut))
    some = dec.digest_all()  # whole ADUs before the cut still decode
    assert len(some) >= 0  # and no exception escaped
    assert len(dec.digest_batch(100)) == 0  # subsequent reads report EOF


def test_compressed_corrupt_adu_bounded(tmp_path):
    """Corrupting ADU payload bytes must not hang or exhaust memory: decode
    either raises CodecError/Eof or returns (garbage) events — bounded."""
    from adder_jax.codec.header import CodecError, Eof

    path, _ = _write_compressed(tmp_path, name="corrupt.adder")
    data = bytearray(path.read_bytes())
    dec0 = open_file_decoder(str(path))
    header = dec0.meta.header_size
    rng = np.random.default_rng(0)
    for trial in range(8):
        bad = bytearray(data)
        # flip random payload bytes after the first ADU length prefix
        for _ in range(40):
            i = rng.integers(header + 4, len(bad))
            bad[i] = rng.integers(0, 256)
        p = path.with_suffix(f".bad{trial}")
        p.write_bytes(bytes(bad))
        dec = open_file_decoder(str(p))
        try:
            out = dec.digest_all()
            assert len(out) < 5_000_000
        except (CodecError, Eof):
            pass


def _abs_meta(w, h, dt_ref, num_intervals):
    return CodecMetadata(
        codec_version=3,
        plane=PlaneSize(w, h, 1),
        tps=7650,
        ref_interval=dt_ref,
        delta_t_max=dt_ref * num_intervals,
        time_mode=TimeMode.AbsoluteT,
        source_camera=SourceCamera.FramedU8,
        adu_interval=num_intervals,
    )


def _raster_events(passes, w, h, skip_fn, t0=280):
    xs, ys, ts = [], [], []
    counter = 0
    for i in range(passes):
        for y in range(h):
            for x in range(w):
                if skip_fn(i, y, x):
                    continue
                xs.append(x)
                ys.append(y)
                ts.append(t0 + counter)
                counter += 1
    return xs, ys, ts, counter


def _ev(xs, ys, ts):
    n = len(xs)
    return EventArray(
        np.array(xs, np.uint16), np.array(ys, np.uint16),
        np.full(n, NO_CHANNEL, np.uint8), np.full(n, 7, np.uint8),
        np.array(ts, np.uint32),
    )


def test_compress_decompress_barely_full(tmp_path):
    """Transliterated ref stream.rs:511-608: a raster pass whose
    timestamps clamp at the ADU span boundary (duplicate-t pileup at the
    edge), plus one event in the next ADU; the candidate pixel's stream
    round-trips exactly at lossless settings."""
    w, h = 16, 30
    dt_ref, num_intervals = 255, 10
    span = dt_ref * num_intervals
    cand = (7, 12)  # (y, x)
    xs, ys, ts = [], [], []
    counter = 0
    done = False
    for y in range(h):
        if done:
            break
        for x in range(w):
            xs.append(x)
            ys.append(y)
            ts.append(min(280 + counter, span))
            if 280 + counter > span:
                done = True
                break
            counter += 1
    xs.append(0)
    ys.append(0)
    ts.append(span + 1)  # rotates into the next ADU
    ev = _ev(xs, ys, ts)

    meta = _abs_meta(w, h, dt_ref, num_intervals)
    path = tmp_path / "barely.addec"
    enc = Encoder.new_compressed(
        meta, open(path, "wb"), EncoderOptions.default(meta.plane)
    )
    enc.options.crf.update_quality(0)
    enc.sync_crf()
    enc.ingest_event_array(ev)
    enc.close_writer().close()
    assert path.stat().st_size < len(ev) * 9

    back = open_file_decoder(str(path)).digest_all()
    got = group_by_pixel(back)
    want = expected_stream_survivors(ev, dt_ref, num_intervals)
    key = (cand[1], cand[0], None)
    assert got.get(key, []) == want[key]
    for k in sorted(want):
        assert got.get(k, []) == want[k], (k, got.get(k, [])[:4], want[k][:4])


def test_compress_decompress_several_with_skip(tmp_path):
    """Transliterated ref stream.rs:822-947: skip cubes toggle per pass
    (top-left cube empty every 3rd pass), pixel (14,14) never fires until
    ONE far-in-the-past out-of-order event lands mid-stream; the candidate
    pixel's stream survives with exact d and t at lossless settings."""
    w = h = 30
    dt_ref, num_intervals = 255, 10
    cand = (7, 12)  # (y, x)

    def skip(i, y, x):
        return (y == 14 and x == 14) or (i % 3 == 0 and y >= 16 and x < 16)

    xs1, ys1, ts1, c1 = _raster_events(10, w, h, skip)
    xs2, ys2, ts2, c2 = _raster_events(10, w, h, skip, t0=280 + c1)
    xs = xs1 + [14] + xs2
    ys = ys1 + [14] + ys2
    ts = ts1 + [280] + ts2  # the late event: timestamp far in the past
    ev = _ev(xs, ys, ts)

    meta = _abs_meta(w, h, dt_ref, num_intervals)
    path = tmp_path / "skip.addec"
    enc = Encoder.new_compressed(
        meta, open(path, "wb"), EncoderOptions.default(meta.plane)
    )
    enc.options.crf.update_quality(0)
    enc.sync_crf()
    enc.ingest_event_array(ev)
    enc.close_writer().close()
    assert path.stat().st_size < len(ev) * 9

    back = open_file_decoder(str(path)).digest_all()
    got = group_by_pixel(back)
    want = expected_stream_survivors(ev, dt_ref, num_intervals)
    key = (cand[1], cand[0], None)
    assert got.get(key, []) == want[key]
    n_want = sum(len(v) for v in want.values())
    assert len(back) == n_want, (len(back), n_want)


def test_addrn_truncated_raw_side_channel_bounded(tmp_path):
    """addrn v3 carries FULL-escape low bytes in a raw side channel after
    the three coded streams; truncating or corrupting inside it must fail
    cleanly (CodecError / short decode), never crash or hang."""
    from adder_jax.codec.compressed import compress_adu, decompress_adu
    from adder_jax.codec.header import CodecError

    w, h = 48, 32
    ev = synth_events(600, w, h, 1, 255 * 8, seed=7, start_t=0)
    ev = ev[np.argsort(ev.t, kind="stable")]
    blob = compress_adu(ev, w, h, 1, 0, 255, 8, 7, rans=True)
    full = decompress_adu(blob, w, h, 1, 0, 255, 8, rans=True)
    assert len(full) > 0

    for cut in (1, 2, 4, 8, 16, 32):
        bad = blob[: len(blob) - cut]
        try:
            out = decompress_adu(bad, w, h, 1, 0, 255, 8, rans=True)
            assert len(out) <= len(full)
        except CodecError:
            pass

    rng = np.random.default_rng(1)
    for _ in range(6):
        bad = bytearray(blob)
        for _ in range(8):  # corrupt tail bytes (raw section lives there)
            i = int(rng.integers(len(bad) - 64, len(bad)))
            bad[i] = int(rng.integers(0, 256))
        try:
            out = decompress_adu(bytes(bad), w, h, 1, 0, 255, 8, rans=True)
            assert len(out) < 5_000_000
        except CodecError:
            pass
