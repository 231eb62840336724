"""Core ADDER types: events, plane geometry, D-value tables, sentinels.

Re-design of the reference's core types
(ref: adder-codec-core/src/lib.rs:180-260, 369-395).

The key departure from the reference: events are a *struct-of-arrays*
(`EventArray`) rather than a per-event struct, so that the whole pipeline —
transcode, codec IO, framing — can operate on dense numpy / JAX tensors.
A scalar `Event` namedtuple is kept for tests and small host-side tooling.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np

# --- D value constants (ref: adder-codec-core/src/lib.rs:184-193, 241) ---

D_MAX = 127
D_ZERO_INTEGRATION = 128
D_NO_EVENT = 253
D_EMPTY = 255
D_START = 7

# Maximum intensity for 8-bit framed input (ref: lib.rs:238)
MAX_INTENSITY = 255.0

# D_SHIFT[n] = 2^n for n in 0..=127, D_SHIFT[128] = 0
# (ref: adder-codec-core/src/lib.rs:220-235)
D_SHIFT = np.array([1 << n for n in range(128)] + [0], dtype=np.object_)
D_SHIFT_F64 = np.array(
    [float(1 << n) for n in range(128)] + [0.0], dtype=np.float64
)
D_SHIFT_F32 = D_SHIFT_F64.astype(np.float32)

# EOF sentinel pixel address (ref: lib.rs:260)
EOF_PX_ADDRESS = 0xFFFF

# Sentinel channel value meaning "no channel" (reference uses Option<u8>;
# we use 255 in the dense representation since planes have <= 3 channels).
NO_CHANNEL = 255


class SourceCamera(enum.IntEnum):
    """Input source type (ref: adder-codec-core/src/lib.rs:35-47).

    Values match the bincode u32 variant indices used in header extension V1.
    """

    FramedU8 = 0
    FramedU16 = 1
    FramedU32 = 2
    FramedU64 = 3
    FramedF32 = 4
    FramedF64 = 5
    Dvs = 6
    DavisU8 = 7
    Atis = 8
    Asint = 9


def is_framed(source_camera: SourceCamera) -> bool:
    """ref: adder-codec-core/src/lib.rs:50-60"""
    return SourceCamera.FramedU8 <= source_camera <= SourceCamera.FramedF64


class SourceType(enum.IntEnum):
    """Bit-depth class of the input source (ref: lib.rs:441-448)."""

    U8 = 0
    U16 = 1
    U32 = 2
    U64 = 3
    F32 = 4
    F64 = 5


SOURCE_CAMERA_TO_TYPE = {
    SourceCamera.FramedU8: SourceType.U8,
    SourceCamera.FramedU16: SourceType.U16,
    SourceCamera.FramedU32: SourceType.U32,
    SourceCamera.FramedU64: SourceType.U64,
    SourceCamera.FramedF32: SourceType.F32,
    SourceCamera.FramedF64: SourceType.F64,
    SourceCamera.Dvs: SourceType.U8,
    SourceCamera.DavisU8: SourceType.U8,
    SourceCamera.Atis: SourceType.U8,
    SourceCamera.Asint: SourceType.F64,
}


class TimeMode(enum.IntEnum):
    """Time representation of events (ref: lib.rs:72-83).

    Values match bincode u32 variant indices in header extension V2.
    """

    DeltaT = 0
    AbsoluteT = 1  # default in the reference
    Mixed = 2


class Mode(enum.IntEnum):
    """Pixel integration mode (ref: lib.rs:195-205)."""

    FramePerfect = 0
    Continuous = 1


class PixelMultiMode(enum.IntEnum):
    """Multi-event handling per interval (ref: lib.rs:207-213)."""

    Normal = 0
    Collapse = 1  # default in the reference


class PlaneError(ValueError):
    pass


@dataclass(frozen=True)
class PlaneSize:
    """Image plane geometry (ref: adder-codec-core/src/lib.rs:86-178)."""

    width: int = 1
    height: int = 1
    channels: int = 1

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0 or self.channels <= 0:
            raise PlaneError(
                f"plane dimensions invalid: {self.width}x{self.height}x{self.channels}"
            )

    @property
    def w(self) -> int:
        return self.width

    @property
    def h(self) -> int:
        return self.height

    @property
    def c(self) -> int:
        return self.channels

    def area_wh(self) -> int:
        return self.width * self.height

    def area_wc(self) -> int:
        return self.width * self.channels

    def area_hc(self) -> int:
        return self.height * self.channels

    def volume(self) -> int:
        return self.area_wh() * self.channels

    def min_resolution(self) -> int:
        return min(self.width, self.height)

    def max_resolution(self) -> int:
        return max(self.width, self.height)

    @property
    def shape(self) -> tuple:
        """(H, W, C) numpy layout used throughout the framework."""
        return (self.height, self.width, self.channels)


class Coord(NamedTuple):
    """Scalar pixel coordinate (ref: lib.rs:263-359). c=None for mono."""

    x: int
    y: int
    c: Optional[int] = None

    def c_usize(self) -> int:
        return 0 if self.c is None else self.c

    def is_eof(self) -> bool:
        return self.x == EOF_PX_ADDRESS and self.y == EOF_PX_ADDRESS

    def is_valid(self) -> bool:
        return not (self.x == EOF_PX_ADDRESS or self.y == EOF_PX_ADDRESS)

    def is_border(self, width: int, height: int, cs: int) -> bool:
        return (
            self.x < cs or self.x >= width - cs or self.y < cs or self.y >= height - cs
        )


class Event(NamedTuple):
    """Scalar ADDER event (ref: lib.rs:369-377): pixel (x,y,c) accumulated
    2^d intensity units ending at time t (absolute or delta per TimeMode)."""

    x: int
    y: int
    c: Optional[int]
    d: int
    t: int

    @property
    def coord(self) -> Coord:
        return Coord(self.x, self.y, self.c)


EOF_EVENT = Event(x=EOF_PX_ADDRESS, y=EOF_PX_ADDRESS, c=0, d=0, t=0)


# --- Struct-of-arrays event batch -------------------------------------------

# numpy structured dtype for host-side bulk storage (not the wire format)
EVENT_DTYPE = np.dtype(
    [("x", "<u2"), ("y", "<u2"), ("c", "u1"), ("d", "u1"), ("t", "<u4")]
)


class EventArray:
    """A batch of events as struct-of-arrays.

    `c` uses NO_CHANNEL (255) for mono (2-D) events. Arrays are always
    1-D of equal length.
    """

    __slots__ = ("x", "y", "c", "d", "t")

    def __init__(self, x, y, c, d, t):
        self.x = np.asarray(x, dtype=np.uint16)
        self.y = np.asarray(y, dtype=np.uint16)
        self.c = np.asarray(c, dtype=np.uint8)
        self.d = np.asarray(d, dtype=np.uint8)
        self.t = np.asarray(t, dtype=np.uint32)

    @classmethod
    def empty(cls) -> "EventArray":
        return cls(
            np.empty(0, np.uint16),
            np.empty(0, np.uint16),
            np.empty(0, np.uint8),
            np.empty(0, np.uint8),
            np.empty(0, np.uint32),
        )

    @classmethod
    def from_events(cls, events) -> "EventArray":
        events = list(events)
        n = len(events)
        out = cls(
            np.empty(n, np.uint16),
            np.empty(n, np.uint16),
            np.empty(n, np.uint8),
            np.empty(n, np.uint8),
            np.empty(n, np.uint32),
        )
        for i, e in enumerate(events):
            out.x[i] = e.x
            out.y[i] = e.y
            out.c[i] = NO_CHANNEL if e.c is None else e.c
            out.d[i] = e.d
            out.t[i] = e.t
        return out

    def __len__(self) -> int:
        return len(self.x)

    def __getitem__(self, idx) -> "Event | EventArray":
        if isinstance(idx, (int, np.integer)):
            c = int(self.c[idx])
            return Event(
                int(self.x[idx]),
                int(self.y[idx]),
                None if c == NO_CHANNEL else c,
                int(self.d[idx]),
                int(self.t[idx]),
            )
        return EventArray(self.x[idx], self.y[idx], self.c[idx], self.d[idx], self.t[idx])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    @classmethod
    def concatenate(cls, arrays) -> "EventArray":
        arrays = [a for a in arrays if len(a)]
        if not arrays:
            return cls.empty()
        if len(arrays) == 1:
            return arrays[0]
        return cls(
            np.concatenate([a.x for a in arrays]),
            np.concatenate([a.y for a in arrays]),
            np.concatenate([a.c for a in arrays]),
            np.concatenate([a.d for a in arrays]),
            np.concatenate([a.t for a in arrays]),
        )

    def to_structured(self) -> np.ndarray:
        out = np.empty(len(self), dtype=EVENT_DTYPE)
        out["x"], out["y"], out["c"], out["d"], out["t"] = (
            self.x,
            self.y,
            self.c,
            self.d,
            self.t,
        )
        return out

    def __eq__(self, other) -> bool:
        if not isinstance(other, EventArray):
            return NotImplemented
        return (
            len(self) == len(other)
            and bool(np.array_equal(self.x, other.x))
            and bool(np.array_equal(self.y, other.y))
            and bool(np.array_equal(self.c, other.c))
            and bool(np.array_equal(self.d, other.d))
            and bool(np.array_equal(self.t, other.t))
        )

    def __repr__(self):
        return f"EventArray(n={len(self)})"


def get_d_from_intensity(intensity: float) -> int:
    """floor(log2(intensity)) clamped to D_MAX; D_ZERO_INTEGRATION below 1.0.

    ref: adder-codec-rs/src/transcoder/event_pixel_tree.rs:482-499
    (uses integer truncation then leading_zeros, i.e. floor(log2(trunc(x))))
    """
    if intensity < 1.0:
        return D_ZERO_INTEGRATION
    return min(int(intensity).bit_length() - 1, D_MAX)
