"""End-to-end transcode tests: frames -> Video/encoder -> .adder -> framer.

The full-stack analogue of the reference's simulproc dark test
(ref: src/bin/adder_simulproc.rs:169-268): synthetic frames are transcoded
through the device kernel + encoder into a `.adder` file, byte-compared
against an oracle-driven encode, then reconstructed and checked against the
source frames.
"""

import io

import numpy as np
import pytest

from adder_jax.codec.decoder import open_file_decoder
from adder_jax.codec.encoder import Encoder, EncoderOptions, EncoderType, RawOutput
from adder_jax.core.types import (
    Coord,
    EventArray,
    Mode,
    PixelMultiMode,
    PlaneSize,
    SourceCamera,
    TimeMode,
)
from adder_jax.framer.driver import FramerBuilder
from adder_jax.transcoder import pixel_oracle as O
from adder_jax.transcoder.framed import FramedArray
from adder_jax.transcoder.video import Video


def synth_frames(T, H, W, C=1, seed=0):
    rng = np.random.default_rng(seed)
    frames = np.zeros((T, H, W, C), dtype=np.uint8)
    cur = rng.integers(0, 256, (H, W, C))
    for t in range(T):
        step = rng.integers(-4, 5, (H, W, C))
        jump = rng.random((H, W, C)) < 0.03
        cur = np.where(jump, rng.integers(0, 256, (H, W, C)), np.clip(cur + step, 0, 255))
        frames[t] = cur
    return frames


def oracle_encode(frames, tps, ref_time, dtm, time_mode, crf_params, c0=10):
    """Reference-order scalar encode: per interval, raster pixels, per-pixel
    emit order (the reference's single-thread contract)."""
    T, H, W, C = frames.shape
    plane = PlaneSize(W, H, C)
    pixels = []
    for y in range(H):
        for x in range(W):
            for c in range(C):
                px = O.PixelArena(1.0, Coord(x, y, None if C == 1 else c))
                px.set_time_mode(time_mode)
                px.c_thresh = c0
                fv = int(frames[0, y, x, c])
                px.arena[0].d = O.get_d_from_intensity(float(fv)) if fv else 128
                px.base_val = fv
                pixels.append(px)
    out = []
    flat = frames.reshape(T, -1)
    for t in range(T):
        for i, px in enumerate(pixels):
            buf = []
            O.integrate_for_px(
                px,
                int(flat[t, i]),
                float(flat[t, i]),
                float(ref_time),
                buf,
                Mode.FramePerfect,
                PixelMultiMode.Collapse,
                dtm,
                ref_time,
                crf_params[0],
                max(crf_params[1], 1),
            )
            out.extend(buf)
    return out


@pytest.mark.parametrize("channels", [1, 3], ids=["mono", "color"])
def test_transcode_matches_oracle_bytes(tmp_path, channels):
    frames = synth_frames(12, 8, 10, channels)
    src = FramedArray(frames, source_fps=24.0, chunk_frames=4)
    src.auto_time_parameters(255, 255 * 4, TimeMode.AbsoluteT)
    path = tmp_path / "out.adder"
    src.write_out(
        SourceCamera.FramedU8,
        TimeMode.AbsoluteT,
        PixelMultiMode.Collapse,
        None,
        EncoderType.Raw,
        EncoderOptions.default(src.video.plane),
        open(path, "wb"),
    )
    while True:
        try:
            src.consume_batch()
        except EOFError:
            break
    src.video.end_write_stream().close()

    # independent scalar encode
    p = src.video.encoder.options.crf.get_parameters()
    want_events = oracle_encode(
        frames, 255 * 24, 255, 255 * 4, TimeMode.AbsoluteT, (7, 7), c0=10
    )
    dec = open_file_decoder(str(path))
    got = list(dec.digest_all())
    assert len(got) == len(want_events), (len(got), len(want_events))
    assert got == want_events


def test_transcode_reconstruct_quality(tmp_path):
    """CRF0 lossless round trip: reconstruction approximates source frames."""
    frames = synth_frames(16, 12, 14, 1, seed=3)
    src = FramedArray(frames, source_fps=30.0, chunk_frames=8)
    src.auto_time_parameters(255, 255 * 4, TimeMode.AbsoluteT)
    src.crf(0)
    path = tmp_path / "out.adder"
    src.write_out(
        SourceCamera.FramedU8,
        TimeMode.AbsoluteT,
        PixelMultiMode.Collapse,
        None,
        EncoderType.Raw,
        EncoderOptions.default(src.video.plane),
        open(path, "wb"),
    )
    while True:
        try:
            src.consume_batch()
        except EOFError:
            break
    src.video.end_write_stream().close()

    dec = open_file_decoder(str(path))
    m = dec.meta
    fps = m.tps / m.ref_interval
    fs = (
        FramerBuilder(m.plane)
        .time_parameters(m.tps, m.ref_interval, m.delta_t_max, fps)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
        .finish()
    )
    fs.ingest_event_array(dec.digest_all())
    recon = []
    while fs.is_frame_0_filled():
        vals, filled = fs.pop_next_frame()
        recon.append(vals)
    assert len(recon) >= 12
    recon = np.stack(recon)
    # compare frames 1.. (first frame bootstraps D targets)
    n = min(len(recon), len(frames)) - 1
    err = recon[1 : n + 1].astype(np.float64) - frames[1 : n + 1].astype(np.float64)
    mse = float((err**2).mean())
    psnr = 10 * np.log10(255.0**2 / max(mse, 1e-9))
    assert psnr > 38.0, psnr


def test_consume_single_matches_batch(tmp_path):
    frames = synth_frames(6, 6, 6, 1, seed=9)
    outs = []
    for use_batch in (False, True):
        src = FramedArray(frames, source_fps=24.0, chunk_frames=3)
        src.auto_time_parameters(100, 400, TimeMode.AbsoluteT)
        buf = io.BytesIO()
        src.write_out(
            SourceCamera.FramedU8,
            TimeMode.AbsoluteT,
            PixelMultiMode.Collapse,
            None,
            EncoderType.Raw,
            EncoderOptions.default(src.video.plane),
            buf,
        )
        while True:
            try:
                if use_batch:
                    src.consume_batch()
                else:
                    src.consume()
            except EOFError:
                break
        src.video.end_write_stream()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


def test_checkpoint_resume_bitexact(tmp_path):
    """Transcoding 2 chunks straight equals 1 chunk + checkpoint/restore +
    1 chunk (the reference has no transcoder checkpointing at all)."""
    import io

    from adder_jax.codec.encoder import EncoderOptions, EncoderType
    from adder_jax.core.types import (
        PixelMultiMode,
        PlaneSize,
        SourceCamera,
        TimeMode,
    )
    from adder_jax.transcoder.video import Video
    from adder_jax.core.types import Mode

    rng = np.random.default_rng(4)
    H, W, T = 24, 32, 4
    frames = rng.integers(0, 256, (2 * T, H, W, 1)).astype(np.uint8)

    def fresh(writer):
        v = Video(PlaneSize(W, H, 1), Mode.FramePerfect, chunk_frames=T)
        v.time_parameters(255 * 30, 255, 255 * 4, TimeMode.AbsoluteT)
        v.write_out(
            SourceCamera.FramedU8, TimeMode.AbsoluteT,
            PixelMultiMode.Collapse, None, EncoderType.Raw,
            EncoderOptions.default(v.plane), writer,
        )
        v.update_quality_manual(0, 0, 4, 1, 2.0)
        return v

    straight = io.BytesIO()
    v1 = fresh(straight)
    v1.integrate_matrix_batch(frames[:T])
    v1.integrate_matrix_batch(frames[T:])
    v1.end_write_stream()

    part1 = io.BytesIO()
    v2 = fresh(part1)
    v2.integrate_matrix_batch(frames[:T])
    ckpt = tmp_path / "state.npz"
    v2.save_checkpoint(ckpt)
    v2.end_write_stream()  # close part1 (appends its EOF event)
    # brand-new instance resumes from the checkpoint
    part2 = io.BytesIO()
    v3 = fresh(part2)
    v3.load_checkpoint(ckpt)
    v3.integrate_matrix_batch(frames[T:])
    v3.end_write_stream()

    # straight stream == part1 events + part2 events (headers identical,
    # EOF events only at each close; compare event payloads)
    hdr = len(straight.getvalue()) - 0
    s = straight.getvalue()
    p1 = part1.getvalue()
    p2 = part2.getvalue()
    # both part streams carry the same header; strip part2's header and
    # part1's trailing EOF event (9 bytes) before concatenating
    header_len = v1.encoder.meta.header_size
    ev_size = v1.encoder.meta.event_size
    joined = p1[:-ev_size] + p2[header_len:]
    assert joined == s


def test_framed_stream_matches_eager(tmp_path):
    """FramedStream (threaded decode prefetch + pipelined chunks) writes
    byte-identical .adder output to the eager Framed on the same clip."""
    import pathlib

    from adder_jax.transcoder.framed import Framed, FramedStream

    mp4 = pathlib.Path(
        "/root/reference/adder-codec-rs/tests/samples/lake_scaled_hd_crop.mp4"
    )
    if not mp4.exists():
        pytest.skip("lake fixture unavailable")

    outs = []
    for cls in (Framed, FramedStream):
        src = cls(str(mp4), color_input=False, chunk_frames=8, max_frames=48)
        src.auto_time_parameters(255, 255 * 4, TimeMode.AbsoluteT)
        buf = io.BytesIO()
        src.write_out(
            SourceCamera.FramedU8, TimeMode.AbsoluteT,
            PixelMultiMode.Collapse, None, EncoderType.Raw,
            EncoderOptions.default(src.video.plane), buf,
        )
        while True:
            try:
                src.consume_batch()
            except EOFError:
                break
        src.video.end_write_stream()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert len(outs[0]) > 33
