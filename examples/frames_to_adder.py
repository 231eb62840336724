#!/usr/bin/env python
"""Transcode synthetic frames to an .adder file on the accelerator."""

import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

from adder_jax.codec.encoder import EncoderOptions, EncoderType
from adder_jax.core.types import PixelMultiMode, SourceCamera, TimeMode
from adder_jax.transcoder.framed import FramedArray

rng = np.random.default_rng(0)
frames = np.clip(
    rng.integers(80, 176, (32, 64, 96, 1))
    + np.linspace(0, 40, 32)[:, None, None, None],
    0, 255,
).astype(np.uint8)

src = FramedArray(frames, source_fps=24.0, chunk_frames=8)
src.auto_time_parameters(255, 255 * 30, TimeMode.AbsoluteT)
src.crf(3)
out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/example.adder"
src.write_out(
    SourceCamera.FramedU8, TimeMode.AbsoluteT, PixelMultiMode.Collapse,
    None, EncoderType.Raw, EncoderOptions.default(src.video.plane),
    open(out, "wb"),
)
n = 0
while True:
    try:
        n += len(src.consume_batch())
    except EOFError:
        break
src.video.end_write_stream().close()
print(f"wrote {n} events to {out}")
