#!/usr/bin/env python
"""Print ADDER stream metadata + statistics (ref: adder-info CLI)."""

import argparse
import sys

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))

from adder_jax.utils.info import adder_info


def main():
    p = argparse.ArgumentParser(description="ADDER stream info")
    p.add_argument("-i", "--input", required=True, help="Input .adder path")
    p.add_argument(
        "-d", "--dynamic-range", action="store_true",
        help="Calculate dynamic range of the event stream",
    )
    args = p.parse_args()
    print(adder_info(args.input, args.dynamic_range), end="")

from adder_jax.codec.header import CodecError  # noqa: E402
if __name__ == "__main__":
    try:
        main()
    except CodecError as e:
        sys.exit(f"error: not a valid ADDER stream: {e}")
    except FileNotFoundError as e:
        sys.exit(f"error: {e}")
