#!/usr/bin/env python
"""Transcode with feature detection enabled and log CRF/feature statistics
(ref: bin_cv/evaluate_feature_detection_transcode.rs)."""

import argparse
import sys

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))

import numpy as np

from adder_jax.core.types import PlaneSize, TimeMode
from adder_jax.transcoder.framed import Framed
from adder_jax.utils.cv import fast_mask, feature_precision_recall_accuracy
from adder_jax.utils.logging import FeatureLogger
from adder_jax.utils.viz import ShowFeatureMode


def main():
    p = argparse.ArgumentParser(description="feature-detection evaluation")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--crf", type=int, default=3)
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--max-frames", type=int, default=120)
    p.add_argument("--log", default="feature_eval.jsonl")
    args = p.parse_args()

    src = Framed(args.input, False, args.scale, max_frames=args.max_frames)
    src.auto_time_parameters(255, 255 * 30, TimeMode.AbsoluteT)
    src.crf(args.crf)
    src.video.update_detect_features(True, ShowFeatureMode.Off, False, False)

    with open(args.log, "w") as fh:
        logger = FeatureLogger(fh, src.video.plane)
        chunk = 0
        while True:
            try:
                events = src.consume_batch()
            except EOFError:
                break
            chunk += 1
            # ground truth: dense FAST over the current reconstruction
            gt_mask = fast_mask(src.video.running_intensities)
            gt = {(int(x), int(y)) for y, x in np.argwhere(gt_mask)}
            pred = set(src.video.features)
            pr, rc, acc = feature_precision_recall_accuracy(
                gt, pred, src.video.plane
            )
            logger.log_precision_recall(pr, rc, acc)
            logger.log_bitrate(
                len(events) * src.video.tps / max(
                    src.video.chunk_frames * src.video.ref_time, 1
                ),
                src.video.get_event_size(),
            )
    print(f"evaluated {chunk} chunks -> {args.log}")

from adder_jax.codec.header import CodecError  # noqa: E402
if __name__ == "__main__":
    try:
        main()
    except CodecError as e:
        sys.exit(f"error: not a valid ADDER stream: {e}")
    except FileNotFoundError as e:
        sys.exit(f"error: {e}")
