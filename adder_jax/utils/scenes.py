"""Seeded synthetic inputs: moving-blob framed video and Prophesee RAW
event files, generated in bulk so loading them stays cheap set-up."""

from __future__ import annotations

import numpy as np


def moving_blobs(T: int, H: int, W: int, C: int = 1, seed: int = 7,
                 n_blobs: int = 6) -> np.ndarray:
    """(T, H, W, C) uint8 frames: a smooth sinusoidal background with
    `n_blobs` Gaussian blobs drifting across it (wrapping at the edges).
    Channels see the same blobs over phase-shifted backgrounds."""
    rng = np.random.default_rng(seed)
    x = np.arange(W, dtype=np.float32)[None, :]
    y = np.arange(H, dtype=np.float32)[:, None]
    cx0 = rng.uniform(0, W, n_blobs)
    cy0 = rng.uniform(0, H, n_blobs)
    vx = rng.uniform(-25, 25, n_blobs)
    vy = rng.uniform(-15, 15, n_blobs)
    backgrounds = [
        (128 + 60 * np.sin(x / 97.0 + c) + 30 * np.cos(y / 53.0 - c)).astype(
            np.float32
        )
        for c in range(C)
    ]
    frames = np.empty((T, H, W, C), dtype=np.uint8)
    for t in range(T):
        blobs = np.zeros((H, W), np.float32)
        for b in range(n_blobs):
            cx = (cx0[b] + vx[b] * t) % W
            cy = (cy0[b] + vy[b] * t) % H
            r2 = (x - cx) ** 2 + (y - cy) ** 2
            blobs += 90.0 * np.exp(-r2 / (2 * 60.0**2))
        for c in range(C):
            frames[t, :, :, c] = np.clip(backgrounds[c] + blobs, 0, 255)
    return frames


def random_dvs_events(n: int, W: int, H: int, t0: int, t1: int,
                      seed: int = 2):
    """n uniformly placed DVS events with sorted timestamps in [t0, t1):
    (t u32, x, y, polarity) arrays."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(t0, t1, n)).astype(np.uint32)
    x = rng.integers(0, W, n)
    y = rng.integers(0, H, n)
    p = rng.integers(0, 2, n)
    return t, x, y, p


def write_prophesee_raw(path, t, x, y, p, W: int, H: int) -> None:
    """A Prophesee RAW file: '% Height/Width' header, the (type 0, size 8)
    record marker, then (t u32, p<<28 | y<<14 | x u32) little-endian
    records (ref: prophesee.rs:367-452)."""
    words = (
        (np.asarray(p, np.uint64) << 28)
        | (np.asarray(y, np.uint64) << 14)
        | np.asarray(x, np.uint64)
    )
    rec = np.empty(len(t) * 2, "<u4")
    rec[0::2] = t
    rec[1::2] = words.astype(np.uint32)
    with open(path, "wb") as f:
        f.write(f"% Height {H}\n% Width {W}\n".encode())
        f.write(bytes([0, 8]))
        f.write(rec.tobytes())
