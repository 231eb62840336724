#!/usr/bin/env python
"""Decode an .adder file and reconstruct instantaneous frames.

Equivalent of the reference's examples/events_to_instantaneous_frames.rs:
drive the Decoder + FrameSequence pair directly.
"""

import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from adder_jax.codec.decoder import open_file_decoder
from adder_jax.framer.driver import FramerBuilder

path = sys.argv[1] if len(sys.argv) > 1 else (
    "/root/reference/adder-codec-rs/tests/samples/sample_3_ordered.adder"
)
dec = open_file_decoder(path)
m = dec.meta
fs = (
    FramerBuilder(m.plane)
    .time_parameters(m.tps, m.ref_interval, m.delta_t_max, m.tps / m.ref_interval)
    .codec_meta(m.codec_version, m.time_mode)
    .source_info(dec.get_source_type(), m.source_camera)
    .finish()
)
count = 0
while True:
    batch = dec.digest_batch(1 << 16)
    if len(batch) == 0:
        break
    if fs.ingest_event_array(batch):
        while fs.is_frame_0_filled():
            frame, _ = fs.pop_next_frame()
            count += 1
print(f"reconstructed {count} frames of {m.plane.width}x{m.plane.height}")
