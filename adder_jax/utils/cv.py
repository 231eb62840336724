"""Computer-vision utilities: FAST features and quality metrics.

ref: adder-codec-rs/src/utils/cv.rs. The reference ports OpenCV's scalar
FAST-9/16 with a threshold table; here the detector is additionally provided
as a dense whole-plane pass (`fast_mask`, numpy, and `fast_mask_jax` for the
device pipeline) — every pixel is scored at once with 16 shifted views, which
is the natural data-parallel formulation of the corner test.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.types import Coord, PlaneSize

INTENSITY_THRESHOLD = 30
STREAK_SIZE = 9

# Bresenham circle of radius 3, [x, y] offsets (ref: cv.rs:26-31)
CIRCLE3 = [
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
]


def is_feature(coord: Coord, plane: PlaneSize, img: np.ndarray) -> bool:
    """Scalar FAST-9/16 corner check at one coordinate (ref: cv.rs:56-212).

    `img` is (H, W, C) uint8; only channel 0 is inspected, borders excluded.
    """
    if coord.is_border(plane.width, plane.height, 3) or coord.c_usize() != 0:
        return False
    x, y = coord.x, coord.y
    p = int(img[y, x, 0])
    t = INTENSITY_THRESHOLD
    samples = np.array(
        [int(img[y + dy, x + dx, 0]) for dx, dy in CIRCLE3], dtype=np.int32
    )
    bright = samples > p + t
    dark = samples < p - t
    return _streak(dark) or _streak(bright)


def _streak(mask: np.ndarray) -> bool:
    ext = np.concatenate([mask, mask[: STREAK_SIZE - 1]])
    run = 0
    for v in ext:
        run = run + 1 if v else 0
        if run >= STREAK_SIZE:
            return True
    return False


def fast_mask(img: np.ndarray, threshold: int = INTENSITY_THRESHOLD) -> np.ndarray:
    """Dense FAST-9/16: (H, W) bool mask of corners on channel 0.

    Vectorized equivalent of the reference's per-coordinate `is_feature`
    (identical decisions; the reference's staged d-checks and early exits are
    pure speed optimizations of the same predicate).
    """
    if img.ndim == 3:
        img = img[..., 0]
    H, W = img.shape
    p = img.astype(np.int16)
    bright = np.zeros((16, H, W), dtype=bool)
    dark = np.zeros((16, H, W), dtype=bool)
    for i, (dx, dy) in enumerate(CIRCLE3):
        shifted = np.roll(np.roll(img, -dy, axis=0), -dx, axis=1).astype(np.int16)
        bright[i] = shifted > p + threshold
        dark[i] = shifted < p - threshold
    corner = _streak_mask(bright) | _streak_mask(dark)
    corner[:3, :] = corner[-3:, :] = False
    corner[:, :3] = corner[:, -3:] = False
    return corner


def _streak_mask(m: np.ndarray) -> np.ndarray:
    """Circular run >= STREAK_SIZE along axis 0 of a (16, H, W) mask."""
    ext = np.concatenate([m, m[: STREAK_SIZE - 1]], axis=0)
    run = np.zeros(ext.shape[1:], dtype=np.int8)
    out = np.zeros(ext.shape[1:], dtype=bool)
    for i in range(ext.shape[0]):
        run = np.where(ext[i], run + 1, 0).astype(np.int8)
        out |= run >= STREAK_SIZE
    return out


def fast_mask_jax(img, threshold: int = INTENSITY_THRESHOLD):
    """JAX dense FAST-9/16 over (H, W) uint8/int — jit friendly
    (rolls + elementwise, no gathers)."""
    import jax.numpy as jnp

    p = img.astype(jnp.int32)
    marks = []
    for dx, dy in CIRCLE3:
        s = jnp.roll(jnp.roll(p, -dy, axis=0), -dx, axis=1)
        marks.append((s > p + threshold, s < p - threshold))
    bright = jnp.stack([m[0] for m in marks])
    dark = jnp.stack([m[1] for m in marks])

    def streak(m):
        ext = jnp.concatenate([m, m[: STREAK_SIZE - 1]], axis=0)
        run = jnp.zeros(ext.shape[1:], jnp.int32)
        out = jnp.zeros(ext.shape[1:], bool)
        for i in range(ext.shape[0]):
            run = jnp.where(ext[i], run + 1, 0)
            out = out | (run >= STREAK_SIZE)
        return out

    corner = streak(bright) | streak(dark)
    H, W = img.shape[:2]
    border = (
        (jnp.arange(H)[:, None] >= 3)
        & (jnp.arange(H)[:, None] < H - 3)
        & (jnp.arange(W)[None, :] >= 3)
        & (jnp.arange(W)[None, :] < W - 3)
    )
    return corner & border


def handle_color(frame_bgr: np.ndarray, color: bool) -> np.ndarray:
    """BGR -> gray (ITU-R 601 luma, truncating) or passthrough
    (ref: cv.rs:215-232). Used by general BGR inputs (aedat4 APS frames
    through the EDI path)."""
    if color:
        return frame_bgr
    gray = (
        frame_bgr[..., 0].astype(np.float64) * 0.114
        + frame_bgr[..., 1].astype(np.float64) * 0.587
        + frame_bgr[..., 2].astype(np.float64) * 0.299
    )
    return gray.astype(np.uint8)[..., None]


def handle_color_rgb_videors(frame_rgb: np.ndarray, color: bool) -> np.ndarray:
    """The framed-source conversion applied to frames already in video-rs
    RGB order (the native ffmpeg decode path): coefficients
    (0.114, 0.587, 0.299) land on channels (0, 1, 2) exactly as the
    reference computes them (ref: cv.rs:215-232 via framed.rs:128), i.e.
    the 0.114 weight on RED — truncating, not rounding. Color passthrough
    keeps RGB (the reference's channel order for color transcodes)."""
    if color:
        return frame_rgb
    gray = (
        frame_rgb[..., 0].astype(np.float64) * 0.114
        + frame_rgb[..., 1].astype(np.float64) * 0.587
        + frame_rgb[..., 2].astype(np.float64) * 0.299
    )
    return gray.astype(np.uint8)[..., None]


def handle_color_videors(frame_bgr: np.ndarray, color: bool) -> np.ndarray:
    """The framed-source conversion, reference-faithful to a quirk that is
    golden-pinned against the committed `lake_scaled_out`: the reference
    applies coefficients (0.114, 0.587, 0.299) to channels (0, 1, 2) of
    frames that video-rs delivers in RGB order, so the 0.114 weight lands
    on RED (truncated, not rounded). cv2 delivers BGR, so the weights are
    mirrored here to reproduce the same bytes. Only the mp4 framed source
    uses this; other BGR inputs use the ITU-correct handle_color."""
    if color:
        return frame_bgr
    b = frame_bgr[..., 0].astype(np.float64)
    g = frame_bgr[..., 1].astype(np.float64)
    r = frame_bgr[..., 2].astype(np.float64)
    gray = 0.114 * r + 0.587 * g + 0.299 * b
    return gray.astype(np.uint8)[..., None]


def feature_precision_recall_accuracy(
    gt_coords: set, prediction: set, plane: PlaneSize
) -> tuple:
    """Precision/recall/accuracy of predicted features vs ground truth
    (ref: cv.rs:235-279). Both sets contain (x, y) tuples."""
    tp = len(gt_coords & prediction)
    fp = len(prediction - gt_coords)
    fn = len(gt_coords - prediction)
    total = plane.area_wh()
    tn = total - tp - fp - fn
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    accuracy = (tp + tn) / total
    return precision, recall, accuracy


# --- quality metrics (ref: cv.rs:282-429) -----------------------------------


@dataclass
class QualityMetrics:
    psnr: Optional[float] = 0.0
    mse: Optional[float] = 0.0
    ssim: Optional[float] = None


def calculate_quality_metrics(
    original: np.ndarray, reconstructed: np.ndarray, results: QualityMetrics
) -> QualityMetrics:
    if original.shape != reconstructed.shape:
        raise ValueError("shapes must match")
    mse = calculate_mse(original, reconstructed)
    if mse == 0.0:
        mse = 1e-7  # keep PSNR defined (ref: cv.rs:316-319)
    if results.mse is not None:
        results.mse = mse
    if results.psnr is not None:
        results.psnr = calculate_psnr(mse)
    if results.ssim is not None:
        results.ssim = calculate_ssim(original, reconstructed)
    return results


def calculate_mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))


def calculate_psnr(mse: float) -> float:
    return 20.0 * np.log10(255.0) - 10.0 * np.log10(mse)


_WINDOW = 8
_C1 = (0.01 * 255.0) ** 2
_C2 = (0.03 * 255.0) ** 2


def calculate_ssim(original: np.ndarray, reconstructed: np.ndarray) -> float:
    """Sliding 8x8-window SSIM averaged over channels, scaled to [0, 100].

    Matches the reference's formulation (ref: cv.rs:353-429), including its
    use of raw (un-normalized) sums for variance/covariance.
    """
    scores = []
    for c in range(original.shape[2]):
        a = original[..., c].astype(np.float64)
        b = reconstructed[..., c].astype(np.float64)
        mu_a = _win_mean(a)
        mu_b = _win_mean(b)
        n = _WINDOW * _WINDOW
        # reference covariance = sum((x-mx)(y-my)) without dividing by n
        var_a = (_win_mean(a * a) - mu_a**2) * n
        var_b = (_win_mean(b * b) - mu_b**2) * n
        cov = (_win_mean(a * b) - mu_a * mu_b) * n
        num = (2 * mu_a * mu_b + _C1) * (2 * cov + _C2)
        den = (mu_a**2 + mu_b**2 + _C1) * (var_a + var_b + _C2)
        scores.append(float(np.mean(num / den)))
    return float(np.mean(scores)) * 100.0


def _win_mean(x: np.ndarray) -> np.ndarray:
    """Mean over all sliding 8x8 windows via integral image."""
    ii = np.zeros((x.shape[0] + 1, x.shape[1] + 1))
    ii[1:, 1:] = np.cumsum(np.cumsum(x, axis=0), axis=1)
    w = _WINDOW
    s = ii[w:, w:] - ii[:-w, w:] - ii[w:, :-w] + ii[:-w, :-w]
    return s / (w * w)


# --- log-intensity clamps (ref: cv.rs:432-449), used by DVS integration -----


def clamp_u8(frame_val: float, last_val_ln: float) -> tuple:
    if frame_val <= 0.0:
        return 0.0, np.log1p(0.0)
    if frame_val > 255.0:
        return 255.0, np.log1p(1.0)
    return frame_val, last_val_ln


def mid_clamp_u8(frame_val: float, last_val_ln: float) -> tuple:
    if frame_val < 0.0 or frame_val > 255.0:
        return 128.0, np.log1p(128.0 / 255.0)
    return frame_val, last_val_ln
