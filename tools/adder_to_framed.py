#!/usr/bin/env python
"""Reconstruct frames from an .adder file (ref: bin/adder_to_framed.rs)."""

import argparse
import sys

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))

from adder_jax.codec.decoder import open_file_decoder
from adder_jax.framer.driver import FramerBuilder


def main():
    p = argparse.ArgumentParser(description="ADDER -> raw frames")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True, help="raw gray/bgr24 output")
    p.add_argument("--fps", type=float, default=0.0, help="0 = tps/ref_interval")
    args = p.parse_args()

    dec = open_file_decoder(args.input)
    m = dec.meta
    fps = args.fps or (m.tps / m.ref_interval)
    fs = (
        FramerBuilder(m.plane)
        .time_parameters(m.tps, m.ref_interval, m.delta_t_max, fps)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
        .finish()
    )
    n = 0
    with open(args.output, "wb") as out:
        fs.ingest_event_array(dec.digest_all())
        n += fs.write_multi_frame_bytes(out)
        if fs.flush_frame_buffer():
            n += fs.write_multi_frame_bytes(out)
    print(f"wrote {n} frames ({m.plane.width}x{m.plane.height}x{m.plane.channels})")

from adder_jax.codec.header import CodecError  # noqa: E402
if __name__ == "__main__":
    try:
        main()
    except CodecError as e:
        sys.exit(f"error: not a valid ADDER stream: {e}")
    except FileNotFoundError as e:
        sys.exit(f"error: {e}")
