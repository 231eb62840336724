"""Visualize the DVS events of an aedat4 file as a video.

ref: adder-codec-rs/src/bin_cv/aedat4_dvs_visualize.rs — frames start at
gray 128; each event paints its pixel 255 (ON) or 0 (OFF) in the frame
bucket t // (1e6 / fps); output is raw gray8 plus an ffmpeg-encoded mp4
when ffmpeg is available.
"""

import argparse
import sys
import pathlib

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description="aedat4 DVS visualizer")
    ap.add_argument("-i", "--input", required=True, help="input .aedat4")
    ap.add_argument("--output-video", required=True,
                    help="output path (.gray8 raw; .mp4 if ffmpeg present)")
    ap.add_argument("--fps", type=float, default=100.0)
    args = ap.parse_args()

    from adder_jax.utils.aedat4 import Aedat4Reader, EventsPacket

    try:
        reader = Aedat4Reader(args.input)
    except (OSError, ValueError) as e:
        print(f"error: cannot open {args.input}: {e}", file=sys.stderr)
        return 1

    sx = sy = 0
    for info in reader.streams.values():
        if info.size_x:
            sx, sy = info.size_x, info.size_y
    W, H = sx or 346, sy or 260

    frame_length = 1_000_000.0 / args.fps  # microsecond ticks per frame
    frames: dict[int, np.ndarray] = {}
    base_t = None
    event_count = 0

    for pkt in reader.packets():
        if not isinstance(pkt, EventsPacket) or len(pkt.events) == 0:
            continue
        ev = pkt.events
        t = ev["t"].astype(np.int64)
        if base_t is None:
            base_t = int(t[0])
        rel = t - base_t
        idx = (rel / frame_length).astype(np.int64)
        event_count += len(ev)
        for fi in np.unique(idx):
            m = idx == fi
            frame = frames.setdefault(
                int(fi), np.full((H, W), 128, np.uint8)
            )
            frame[ev["y"][m], ev["x"][m]] = np.where(
                ev["on"][m] != 0, 255, 0
            ).astype(np.uint8)
    reader.close()

    if not frames:
        print("no DVS events found", file=sys.stderr)
        return 1

    raw_path = pathlib.Path(args.output_video).with_suffix(".gray8")
    hi = max(frames)
    with open(raw_path, "wb") as f:
        for i in range(hi + 1):
            f.write(
                frames.get(i, np.full((H, W), 128, np.uint8)).tobytes()
            )
    print(f"DVS event count: {event_count}; {hi + 1} frames -> {raw_path}")

    if args.output_video.endswith(".mp4"):
        from adder_jax.utils.viz import write_frames_to_video

        stack = np.stack(
            [frames.get(i, np.full((H, W), 128, np.uint8))
             for i in range(hi + 1)]
        )
        if write_frames_to_video(stack, args.output_video, fps=args.fps):
            print(f"encoded {args.output_video}")
        else:
            print("mp4 encode unavailable; raw output remains", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
