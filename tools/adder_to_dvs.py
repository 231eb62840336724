#!/usr/bin/env python
"""Transcode an ADDER file to DVS polarity events (ref: adder-to-dvs CLI)."""

import argparse
import sys

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))

from adder_jax.models.adder_to_dvs import adder_to_dvs


def main():
    p = argparse.ArgumentParser(description="ADDER -> DVS events")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--output-events", required=True)
    p.add_argument("--output-mode", choices=["binary", "text"], default="binary")
    p.add_argument("--theta", type=float, default=0.01)
    p.add_argument("--reorder", action="store_true")
    args = p.parse_args()
    with open(args.output_events, "wb") as f:
        stats = adder_to_dvs(
            args.input, f, args.output_mode, args.theta, args.reorder
        )
    print(
        f"{stats['n_adder_events']} ADDER events -> "
        f"{stats['n_dvs_events']} DVS events"
    )

from adder_jax.codec.header import CodecError  # noqa: E402
if __name__ == "__main__":
    try:
        main()
    except CodecError as e:
        sys.exit(f"error: not a valid ADDER stream: {e}")
    except FileNotFoundError as e:
        sys.exit(f"error: {e}")
