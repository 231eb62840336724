#!/usr/bin/env python
"""Prophesee RAW -> ADDER transcode (ref: bin/prophesee_to_adder.rs)."""

import argparse
import sys

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))

from adder_jax.codec.encoder import EncoderOptions, EncoderType
from adder_jax.core.types import PixelMultiMode, SourceCamera, TimeMode
from adder_jax.transcoder.prophesee import Prophesee


def main():
    p = argparse.ArgumentParser(description="Prophesee RAW -> ADDER")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--ref-time", type=int, default=20)
    p.add_argument("--crf", type=int, default=3)
    p.add_argument("--max-intervals", type=int, default=0)
    p.add_argument(
        "--batched", action=argparse.BooleanOptionalAction, default=True,
        help="integrate on the dense device kernel (ops/dvs_batch.py); "
             "--no-batched selects the scalar per-event oracle",
    )
    args = p.parse_args()

    src = Prophesee(args.ref_time, args.input, batched=args.batched)
    src.crf(args.crf)
    src.write_out(
        SourceCamera.Dvs,
        TimeMode.AbsoluteT,
        PixelMultiMode.Collapse,
        None,
        EncoderType.Raw,
        EncoderOptions.default(src.plane),
        open(args.output, "wb"),
    )
    n_events = 0
    intervals = 0
    while True:
        try:
            n_events += len(src.consume())
        except EOFError:
            break
        intervals += 1
        if args.max_intervals and intervals >= args.max_intervals:
            break
    src.end_write_stream().close()
    print(f"transcoded {n_events} ADDER events over {intervals} view intervals")


if __name__ == "__main__":
    main()
