"""chip_smoke.py's phase functions at tiny sizes on virtual CPU devices (the
script itself needs a GPU; here one CPU device stands in for the card and
another for the reference device)."""

import numpy as np
import pytest

import jax

import chip_smoke


def _random_frames(T, H, W, C, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (T, H, W, C)
    ).astype(np.uint8)


def test_check_device_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.check_device()


@pytest.mark.parametrize("channels", [1, 3], ids=["mono", "color"])
def test_framed_phase_tiny(channels):
    dev, ref = jax.devices("cpu")[:2]
    frames = _random_frames(6, 8, 12, channels, seed=channels)
    configure = (
        chip_smoke.criterion_config if channels == 1
        else lambda s: chip_smoke.crf_config(s, 3)
    )
    rec, data = chip_smoke.framed_phase(
        "tiny", frames, 3, configure, dev, ref
    )
    assert rec["bytes_identical"] and rec["chunks"] == 2
    assert rec["events"] > 0 and len(data) == rec["adder_bytes"]


def test_framed_phase_detects_a_mismatch():
    """A reference that differs fails the phase instead of passing."""
    dev, ref = jax.devices("cpu")[:2]
    frames = _random_frames(4, 6, 8, 1, seed=4)
    calls = []

    def configure(src):
        calls.append(1)
        chip_smoke.criterion_config(src)
        if len(calls) == 3:  # the reference-device run
            src.quality_manual(5, 9, 24, 1, 0)

    with pytest.raises(chip_smoke.PhaseFailed, match="differ"):
        chip_smoke.framed_phase("tiny", frames, 2, configure, dev, ref)


def test_reconstruct_phase_tiny():
    dev, ref = jax.devices("cpu")[:2]
    frames = _random_frames(6, 8, 12, 1, seed=11)
    _, data = chip_smoke.framed_phase(
        "tiny", frames, 3, chip_smoke.criterion_config, dev, ref
    )
    rec = chip_smoke.reconstruct_phase(data, dev)
    # the first interval only seeds D, so one frame fewer comes back
    assert rec["frames_identical"] and rec["frames"] >= len(frames) - 1


def test_prophesee_phase_tiny():
    rec = chip_smoke.prophesee_phase(12, 10, 300, 30_000, jax.devices("cpu")[0])
    assert rec["per_pixel_identical"] and rec["adder_events"] > 0


def test_sharded_phase_tiny():
    frames = _random_frames(4, 6, 10, 1, seed=3)
    rec = chip_smoke.sharded_phase(frames, 2, jax.devices("cpu")[:4])
    assert rec["bytes_identical"] and rec["devices"] == 4
