#!/usr/bin/env python
"""Migrate a v0/v1 DeltaT .adder file to v2+ AbsoluteT
(ref: bin/migrate_raw_v0_v1_to_v2.rs)."""

import argparse
import sys

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))

from adder_jax.codec.decoder import open_file_decoder
from adder_jax.codec.encoder import Encoder, EncoderOptions
from adder_jax.codec.header import CodecMetadata, LATEST_CODEC_VERSION
from adder_jax.core.types import TimeMode
from adder_jax.utils.stream_migration import migrate_v2


def main():
    p = argparse.ArgumentParser(description="migrate to codec v2+ AbsoluteT")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args()

    dec = open_file_decoder(args.input)
    m = dec.meta
    out_meta = CodecMetadata(
        codec_version=LATEST_CODEC_VERSION,
        time_mode=TimeMode.AbsoluteT,
        plane=m.plane,
        tps=m.tps,
        ref_interval=m.ref_interval,
        delta_t_max=m.delta_t_max,
        source_camera=m.source_camera,
        adu_interval=m.adu_interval,
    )
    enc = Encoder.new_raw(
        out_meta, open(args.output, "wb"), EncoderOptions.default(m.plane)
    )
    enc = migrate_v2(dec, enc)
    enc.close_writer().close()
    print(f"migrated {args.input} (v{m.codec_version}) -> {args.output} (v{LATEST_CODEC_VERSION})")

from adder_jax.codec.header import CodecError  # noqa: E402
if __name__ == "__main__":
    try:
        main()
    except CodecError as e:
        sys.exit(f"error: not a valid ADDER stream: {e}")
    except FileNotFoundError as e:
        sys.exit(f"error: {e}")
