#!/usr/bin/env python
"""Play back an .adder file: reconstruct frames, optionally write an mp4
(ref: bin_cv/adder_video_player.rs; headless — display needs a GUI)."""

import argparse
import sys

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))

import numpy as np

from adder_jax.framer.scale_intensity import FramedViewMode
from adder_jax.models.player import AdderPlayer
from adder_jax.utils.viz import write_frames_to_video


def main():
    p = argparse.ArgumentParser(description="ADDER stream player")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output-video", default="", help="mp4 output path")
    p.add_argument(
        "--view-mode", choices=["intensity", "d", "delta_t", "sae"],
        default="intensity",
    )
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--realtime", action="store_true", help="pace to stream rate")
    args = p.parse_args()

    vm = {
        "intensity": FramedViewMode.Intensity,
        "d": FramedViewMode.D,
        "delta_t": FramedViewMode.DeltaT,
        "sae": FramedViewMode.SAE,
    }[args.view_mode]
    player = AdderPlayer(args.input, view_mode=vm)
    frames = []
    for frame in player.frames(realtime=args.realtime):
        frames.append(frame)
        if args.max_frames and len(frames) >= args.max_frames:
            break
    print(
        f"played {player.stats.frames_emitted} frames, "
        f"{player.stats.events_total} events, "
        f"{player.stats.events_per_sec/1e6:.2f} Mev/s"
    )
    if args.output_video and frames:
        ok = write_frames_to_video(np.stack(frames), args.output_video, player.fps)
        print(f"wrote {args.output_video}" if ok else "video write failed")

from adder_jax.codec.header import CodecError  # noqa: E402
if __name__ == "__main__":
    try:
        main()
    except CodecError as e:
        sys.exit(f"error: not a valid ADDER stream: {e}")
    except FileNotFoundError as e:
        sys.exit(f"error: {e}")
