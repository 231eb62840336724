#!/usr/bin/env python
"""Framed video -> ADDER with simultaneous reconstruction
(ref: adder-codec-rs/src/bin/adder_simulproc.rs)."""

import argparse
import sys

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))

from adder_jax.core.types import TimeMode
from adder_jax.models.simulproc import SimulProcArgs, simulproc_from_args


def main():
    p = argparse.ArgumentParser(description="simultaneous transcode + reconstruct")
    p.add_argument(
        "--args-filename", default="",
        help="TOML preset overriding defaults (ref: bin/args/*.toml)",
    )
    p.add_argument("-i", "--input-filename", required=False, default="")
    p.add_argument(
        "--trace", action="store_true",
        help="print a per-stage timing summary (utils/tracing.py)",
    )
    p.add_argument("--output-events-filename", default="")
    p.add_argument("--output-raw-video-filename", default="")
    p.add_argument("--color-input", action="store_true")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--ref-time", type=int, default=255)
    p.add_argument("--delta-t-max", type=int, default=7650)
    p.add_argument("--frame-count-max", type=int, default=0)
    p.add_argument("--frame-idx-start", type=int, default=0)
    p.add_argument("--crf", type=int, default=3)
    p.add_argument("--time-mode", choices=["delta_t", "absolute"], default="absolute")
    p.add_argument(
        "--integration-mode", default="",
        help='"collapse" for PixelMultiMode::Collapse; default Normal',
    )
    a = p.parse_args()

    if a.args_filename:
        # TOML presets, like the reference's --args-filename
        import tomllib

        with open(a.args_filename, "rb") as f:
            preset = tomllib.load(f)
        for k, v in preset.items():
            key = k.replace("-", "_")
            if hasattr(a, key):
                setattr(a, key, v)
    if not a.input_filename:
        p.error("--input-filename required (directly or via --args-filename)")
    if not a.output_events_filename:
        p.error("--output-events-filename required (directly or via --args-filename)")

    args = SimulProcArgs(
        input_filename=a.input_filename,
        output_events_filename=a.output_events_filename,
        output_raw_video_filename=a.output_raw_video_filename,
        color_input=a.color_input,
        scale=a.scale,
        ref_time=a.ref_time,
        delta_t_max=a.delta_t_max,
        frame_count_max=a.frame_count_max,
        frame_idx_start=a.frame_idx_start,
        crf=a.crf,
        time_mode=TimeMode.AbsoluteT if a.time_mode == "absolute" else TimeMode.DeltaT,
        integration_mode=a.integration_mode,
    )
    if a.trace:
        from adder_jax.utils import tracing

        tracing.set_enabled(True)
    ev_writer = open(args.output_events_filename, "wb")
    raw_writer = (
        open(args.output_raw_video_filename, "wb")
        if args.output_raw_video_filename
        else None
    )
    proc = simulproc_from_args(args, ev_writer, raw_writer)
    n = proc.run()
    ev_writer.close()
    if raw_writer:
        raw_writer.close()
    print(f"wrote {n} reconstructed frames")
    if a.trace:
        from adder_jax.utils import tracing

        print(tracing.summary_table())


if __name__ == "__main__":
    main()
