"""Cross-implementation golden test: the reference's strongest committed
parity gate, `dark` (ref: src/bin/adder_simulproc.rs:169-268) — transcode
`lake_scaled_hd_crop.mp4` and compare reconstructed frames against the
Rust-produced `lake_scaled_out` golden.

Reference config: mono, scale 1.0, ref_time 255, delta_t_max 6120, CRF 0,
TimeMode::DeltaT, PixelMultiMode::Normal, thread_count 1, frame_idx_start 1.

Decode-layer facts (established empirically against the golden):

1. video-rs frame seek is KEYFRAME-granular: `frame_start(1)` lands on the
   next keyframe, which in the committed mp4 is frame 250 (stss box:
   keyframes at samples 1 and 251). The golden's frame 0 correlates 0.998
   with source frame 250 and < 0.1 with frame 1. Our source decodes
   sequentially and slices exactly, so the test passes frame_idx_start=250
   directly.
2. With the native ffmpeg decode path (transcoder/ffdec.py — the same
   libavcodec/libswscale the reference's video-rs wraps) the ENTIRE
   pipeline is byte-exact: `cmp == 0` against the committed golden, the
   reference's own assertion. The cv2 fallback path differs from swscale
   by +-1 on ~2% of decoded pixels (different YUV->RGB integer rounding),
   so when ffmpeg libraries are absent the gate falls back to the
   documented 95%-per-frame / 97%-overall byte-identity envelope.
"""

import io
import pathlib

import numpy as np
import pytest

from adder_jax.core.types import TimeMode
from adder_jax.models.simulproc import SimulProcArgs, simulproc_from_args

SAMPLES = pathlib.Path("/root/reference/adder-codec-rs/tests/samples")


@pytest.mark.slow
def test_lake_dark_golden():
    mp4 = SAMPLES / "lake_scaled_hd_crop.mp4"
    golden_path = SAMPLES / "lake_scaled_out"
    if not mp4.exists() or not golden_path.exists():
        pytest.skip("lake fixtures unavailable")
    golden = np.frombuffer(golden_path.read_bytes(), np.uint8)
    assert len(golden) == 11 * 50 * 200  # 11 committed frames at 200x50

    args = SimulProcArgs(
        input_filename=str(mp4),
        color_input=False,
        scale=1.0,
        ref_time=255,
        delta_t_max=6120,
        frame_count_max=0,
        # the reference asks for frame 1; video-rs keyframe-granular seek
        # lands on 250 (see module docstring)
        frame_idx_start=250,
        crf=0,
        time_mode=TimeMode.DeltaT,
        integration_mode="",  # Normal
    )
    ev = io.BytesIO()
    raw = io.BytesIO()
    proc = simulproc_from_args(args, ev, raw)

    # the reference's framer paces at the source fps: tpf truncates to 254
    assert proc.framer.tpf == 254
    assert proc.source.video.tps == 6113  # (255 * 23.976..) as u32

    proc.run()
    out = np.frombuffer(raw.getvalue(), np.uint8)

    # the reference notes its own output "might be larger than" the golden;
    # prefix-compare like its cmp does
    assert len(out) >= len(golden), (len(out), len(golden))
    m = len(golden)
    if proc.source.decoder == "ffmpeg":
        # swscale-exact decode: the reference's own byte-exact gate
        # (adder_simulproc.rs:238-262 `cmp` -> empty output)
        assert bytes(out[:m]) == bytes(golden), (
            f"{int((out[:m] != golden).sum())} of {m} bytes differ"
        )
    else:
        # cv2 fallback: +-1 source-decode envelope (module docstring)
        diff = out[:m].astype(np.int32) - golden[:m].astype(np.int32)
        neq_total = int((diff != 0).sum())
        assert neq_total <= 0.03 * m, f"{neq_total} of {m} bytes differ"
        per_frame = (diff != 0).reshape(11, -1).sum(axis=1)
        assert (per_frame <= 0.05 * 10000).all(), per_frame.tolist()
