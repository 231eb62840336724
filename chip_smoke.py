"""Smoke run of adder_jax's main paths on the GPU, each against its reference.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # only ShardedVideo over 4 cards
    python chip_smoke.py --trace DIR   # phases 1-5, plus a profiler trace
                                       # of the 1080p mono steady pass

Phases (one JSON line each):
 1. device: the GPU's kind, count, name and power limit; no GPU is a failure.
 2. framed_mono_1080p: FramedArray -> Video -> raw Encoder in the reference's
    criterion configuration; .adder bytes equal the same run on the CPU.
 3. framed_color_crf3: 1080p colour at CRF 3; bytes equal the CPU run.
 4. reconstruct: phase 2's bytes through the device framer on the GPU;
    frames equal the host framer's.
 5. prophesee_dvs: a seeded 640x480 Prophesee RAW through the batched scan
    engine on the GPU; per-pixel event sequences equal the scalar oracle's.
 6. (--four-cards only) sharded_4k: ShardedVideo over 4 GPUs at 3840x2160
    mono; bytes equal one-card Video.

The CPU references run in this same process on jax.devices("cpu"). Any
failed phase raises, so the script exits non-zero and prints no result; the
last line of a passing run is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import tempfile
import time

import numpy as np

import jax

from adder_jax.codec.decoder import Decoder
from adder_jax.codec.encoder import EncoderOptions, EncoderType
from adder_jax.core.types import Mode, PixelMultiMode, SourceCamera, TimeMode
from adder_jax.framer.device import DeviceFramer
from adder_jax.framer.driver import FramerBuilder
from adder_jax.ops import integrate as ops
from adder_jax.transcoder.framed import FramedArray
from adder_jax.transcoder.prophesee import Prophesee
from adder_jax.utils import scenes, tracing

REF_TIME = 255


class PhaseFailed(AssertionError):
    pass


def _emit(**record) -> None:
    print(json.dumps(record), flush=True)


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


def check_device() -> dict:
    """Phase 1: refuse to run without a GPU (no CPU fallback)."""
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX's default backend is {backend!r}"
        )
    dev = jax.devices()[0]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return {
        "platform": dev.platform,
        "kind": dev.device_kind,
        "count": len(jax.devices()),
        "nvidia_smi": smi,
    }


def criterion_config(src) -> None:
    """The reference's criterion bench configuration
    (benches/framed_to_adder_hd.rs): FramePerfect, DeltaT, lossless
    c_thresh 0/0, delta_t_max = 24 * ref_time; raw output."""
    src.time_parameters(REF_TIME * 24, REF_TIME, REF_TIME * 24, TimeMode.DeltaT)
    src.write_out(
        SourceCamera.FramedU8, TimeMode.DeltaT, PixelMultiMode.Collapse,
        None, EncoderType.Raw, EncoderOptions.default(src.video.plane),
        io.BytesIO(),
    )
    src.quality_manual(0, 0, 24, 1, 0)


def crf_config(src, crf: int) -> None:
    """simulproc's defaults (ref: bin/adder_simulproc.rs): AbsoluteT,
    delta_t_max = 30 * ref_time, the given CRF on source and encoder."""
    src.auto_time_parameters(REF_TIME, REF_TIME * 30, TimeMode.AbsoluteT)
    options = EncoderOptions.default(src.video.plane)
    options.crf.update_quality(crf)
    src.write_out(
        SourceCamera.FramedU8, TimeMode.AbsoluteT, PixelMultiMode.Collapse,
        None, EncoderType.Raw, options, io.BytesIO(),
    )
    src.crf(crf)


def transcode(frames: np.ndarray, chunk_frames: int, configure,
              video_factory=None) -> bytes:
    """Frames -> FramedArray -> Video -> raw Encoder -> .adder bytes, on
    JAX's current default device."""
    src = FramedArray(frames, source_fps=24.0, chunk_frames=chunk_frames)
    if video_factory is not None:
        src.video = video_factory(src.video.plane)
    configure(src)
    while True:
        try:
            src.consume_batch()
        except EOFError:
            break
    writer = src.video.end_write_stream()
    return writer.getvalue()


def framed_phase(name: str, frames: np.ndarray, chunk_frames: int,
                 configure, device, ref_device) -> tuple[dict, bytes]:
    """Phases 2 and 3: the device run twice (compile, then steady) and the
    reference-device run once; .adder bytes must be identical."""
    with jax.default_device(device):
        t0 = time.perf_counter()
        data = transcode(frames, chunk_frames, configure)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        again = transcode(frames, chunk_frames, configure)
        steady_s = time.perf_counter() - t0
    with jax.default_device(ref_device):
        t0 = time.perf_counter()
        ref = transcode(frames, chunk_frames, configure)
        ref_s = time.perf_counter() - t0
    _require(again == data, f"{name}: two device runs differ")
    _require(data == ref, f"{name}: device bytes differ from the reference")
    n_events = _count_events(data)
    _require(n_events > 0, f"{name}: no events")
    T, H, W, C = frames.shape
    return {
        "phase": name,
        "shape": [T, H, W, C],
        "chunks": -(-T // chunk_frames),
        "events": n_events,
        "adder_bytes": len(data),
        "compile_s": round(first_s - steady_s, 3),
        "steady_s": round(steady_s, 4),
        "reference_s": round(ref_s, 3),
        "bytes_identical": True,
    }, data


def _count_events(data: bytes) -> int:
    return len(Decoder(io.BytesIO(data)).digest_all())


def _framer_builder(dec) -> FramerBuilder:
    m = dec.meta
    return (
        FramerBuilder(m.plane)
        .time_parameters(m.tps, m.ref_interval, m.delta_t_max,
                         m.tps / max(m.ref_interval, 1))
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
    )


def _drain(framer) -> list:
    """Pop every complete frame, then back-fill and pop frame by frame up
    to the last frame any event reached (the shutdown flush, repeated —
    in a stream whose delta_t_max spans most of it, few frames complete on
    their own)."""
    out = []

    def pop_filled():
        while framer.is_frame_0_filled():
            out.append(framer.pop_next_frame())

    pop_filled()
    while framer.flush_frame_buffer():
        out.append(framer.pop_next_frame())
        pop_filled()
    # the host framer pops (values, filled mask); the device one values
    return [f[0] if isinstance(f, tuple) else f for f in out]


def reconstruct_phase(data: bytes, device) -> dict:
    """Phase 4: device framer frames == host framer frames."""
    dec = Decoder(io.BytesIO(data))
    events = dec.digest_all()
    b = _framer_builder(dec)
    t0 = time.perf_counter()
    host = b.finish()
    host.ingest_event_array(events)
    host_frames = _drain(host)
    host_s = time.perf_counter() - t0
    with jax.default_device(device):
        t0 = time.perf_counter()
        dev = DeviceFramer(b)
        dev.ingest_event_array(events)
        dev_frames = _drain(dev)
        dev_s = time.perf_counter() - t0
    _require(len(host_frames) > 0, "reconstruct: no frames")
    _require(
        len(dev_frames) == len(host_frames),
        f"reconstruct: {len(dev_frames)} device frames vs "
        f"{len(host_frames)} host frames",
    )
    for i, (a, h) in enumerate(zip(dev_frames, host_frames)):
        _require(
            a.dtype == h.dtype and np.array_equal(a, h),
            f"reconstruct: frame {i} differs",
        )
    return {
        "phase": "reconstruct",
        "events": len(events),
        "frames": len(host_frames),
        "device_s": round(dev_s, 3),
        "host_s": round(host_s, 3),
        "frames_identical": True,
    }


def _pixel_streams(path: str, batched: bool) -> dict:
    src = Prophesee(20, path, batched=batched)
    src.write_out(
        SourceCamera.Dvs, TimeMode.AbsoluteT, PixelMultiMode.Collapse, None,
        EncoderType.Raw, EncoderOptions.default(src.plane), io.BytesIO(),
    )
    parts = []
    while True:
        try:
            parts.append(src.consume())
        except EOFError:
            break
    src.end_write_stream()
    x = np.concatenate([p.x for p in parts]).astype(np.int64)
    y = np.concatenate([p.y for p in parts]).astype(np.int64)
    d = np.concatenate([p.d for p in parts])
    t = np.concatenate([p.t for p in parts])
    # per-pixel order is the contract; a stable sort by pixel keeps it
    order = np.argsort(y * src.plane.width + x, kind="stable")
    return {"x": x[order], "y": y[order], "d": d[order], "t": t[order]}


def prophesee_phase(W: int, H: int, n_events: int, span_us: int,
                    device) -> dict:
    """Phase 5: batched scan engine on `device` == scalar oracle, per pixel."""
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "dvs.raw")
        t, x, y, p = scenes.random_dvs_events(
            n_events, W, H, 1000, 1000 + span_us, seed=5
        )
        scenes.write_prophesee_raw(path, t, x, y, p, W, H)
        with jax.default_device(device):
            t0 = time.perf_counter()
            got = _pixel_streams(path, batched=True)
            dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = _pixel_streams(path, batched=False)
        oracle_s = time.perf_counter() - t0
    n_out = len(want["t"])
    _require(n_out > 0, "prophesee_dvs: no events")
    for k in ("x", "y", "d", "t"):
        _require(
            np.array_equal(got[k], want[k]),
            f"prophesee_dvs: per-pixel {k} sequences differ from the oracle",
        )
    return {
        "phase": "prophesee_dvs",
        "plane": [W, H],
        "dvs_events": n_events,
        "adder_events": n_out,
        "device_s": round(dev_s, 3),
        "oracle_s": round(oracle_s, 3),
        "per_pixel_identical": True,
    }


def sharded_phase(frames: np.ndarray, chunk_frames: int, devices) -> dict:
    """Phase 6: ShardedVideo over `devices` == one-device Video, bytes."""
    from adder_jax.parallel.sharding import make_mesh
    from adder_jax.transcoder.sharded import ShardedVideo

    mesh = make_mesh(devices)
    with jax.default_device(devices[0]):
        t0 = time.perf_counter()
        ref = transcode(frames, chunk_frames, criterion_config)
        single_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = transcode(
        frames, chunk_frames, criterion_config,
        video_factory=lambda plane: ShardedVideo(
            plane, Mode.FramePerfect, chunk_frames, mesh=mesh
        ),
    )
    sharded_s = time.perf_counter() - t0
    _require(got == ref, "sharded: bytes differ from one-device Video")
    T, H, W, C = frames.shape
    return {
        "phase": "sharded_4k",
        "devices": len(devices),
        "shape": [T, H, W, C],
        "events": _count_events(ref),
        "sharded_s": round(sharded_s, 3),
        "single_s": round(single_s, 3),
        "bytes_identical": True,
    }


def trace_mono(frames: np.ndarray, chunk_frames: int, device,
               log_dir: str) -> dict:
    """The steady mono pass under the profiler, reduced to device metrics,
    plus the 1080p chunk's compiled memory footprint."""
    with jax.default_device(device):
        transcode(frames, chunk_frames, criterion_config)  # warm
        with tracing.device_trace(log_dir):
            transcode(frames, chunk_frames, criterion_config)
        # the chunk Video compiles for this plane: criterion parameters,
        # capacity N * T, 4 packed lanes
        n = frames.shape[1] * frames.shape[2]
        p = ops.TranscodeParams(
            mode=int(Mode.FramePerfect), time_mode=int(TimeMode.DeltaT),
            ref_time=REF_TIME, delta_t_max=REF_TIME * 24, c_thresh_max=0,
            c_increase_velocity=1,
        )
        sd = jax.ShapeDtypeStruct
        mem = ops.make_transcode_chunk(p, n * chunk_frames, 4).lower(
            jax.eval_shape(lambda: ops.init_state(n)),
            sd((chunk_frames, n), np.uint8), sd((), np.float32),
            sd((n,), np.uint8),
        ).compile().memory_analysis()
    summary = tracing.device_trace_summary(log_dir)
    return {
        "phase": "trace_mono",
        "trace_dir": log_dir,
        "busy_share": round(summary["busy_share"], 4),
        "window_ms": round(summary["window_ms"], 3),
        "busy_ms": round(summary["busy_ms"], 3),
        "copy_ms": summary["copy_ms"],
        "kernels": [[k, round(ms, 3), c] for k, ms, c in summary["kernels"]],
        "memory": {
            "argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "alias_bytes": mem.alias_size_in_bytes,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card ShardedVideo phase")
    ap.add_argument("--trace", metavar="DIR",
                    help="also trace the 1080p mono steady pass into DIR")
    args = ap.parse_args(argv)

    info = check_device()
    _emit(phase="device", **info)
    gpu = jax.devices()[0]
    device = {"platform": info["platform"], "kind": info["kind"],
              "count": info["count"]}

    if args.four_cards:
        devices = jax.devices()
        _require(len(devices) >= 4, f"--four-cards: {len(devices)} GPUs")
        frames = scenes.moving_blobs(8, 2160, 3840, 1, seed=11)
        _emit(**sharded_phase(frames, 4, devices[:4]))
        print(json.dumps({"ok": True, "device": device}), flush=True)
        return 0

    cpu = jax.devices("cpu")[0]
    mono = scenes.moving_blobs(16, 1080, 1920, 1, seed=7)
    rec, mono_bytes = framed_phase(
        "framed_mono_1080p", mono, 8, criterion_config, gpu, cpu
    )
    _emit(**rec)
    color = scenes.moving_blobs(8, 1080, 1920, 3, seed=9)
    rec, _ = framed_phase(
        "framed_color_crf3", color, 4, lambda s: crf_config(s, 3), gpu, cpu
    )
    _emit(**rec)
    _emit(**reconstruct_phase(mono_bytes, gpu))
    _emit(**prophesee_phase(640, 480, 200_000, 100_000, gpu))
    if args.trace:
        _emit(**trace_mono(mono, 8, gpu, args.trace))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
