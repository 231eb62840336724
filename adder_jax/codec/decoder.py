"""Decoder container: magic sniffing, header parse, event digestion, seek.

ref: adder-codec-core/src/codec/decoder.rs, lib.rs:461-495 (open_file_decoder).

Bulk redesign: the primary read path is `digest_all` / `digest_batch`,
which slurp the remaining stream and decode it with one vectorized numpy
pass (cut at the in-band EOF event). The scalar `digest_event` matches the
reference's one-at-a-time API for tooling/tests.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Optional

from ..core.types import (
    Event,
    EventArray,
    SOURCE_CAMERA_TO_TYPE,
    SourceType,
)
from . import raw as rawcodec
from .encoder import EncoderType
from .header import (
    MAGIC_COMPRESSED,
    MAGIC_RANS,
    MAGIC_RAW,
    CodecMetadata,
    CodecError,
    Eof,
    SeekError,
    decode_header,
)


class Decoder:
    """ADDER stream decoder over a seekable binary reader."""

    def __init__(self, reader: BinaryIO):
        self.reader = reader
        self.meta, self.magic = decode_header(reader)
        self._compressed_input = None
        if self.magic in (MAGIC_COMPRESSED, MAGIC_RANS):
            from .compressed import CompressedInput  # deferred: heavier dep

            self._compressed_input = CompressedInput(
                self.meta, reader,
                entropy="rans" if self.magic == MAGIC_RANS else "cabac",
            )

    # -- introspection --

    def get_source_type(self) -> SourceType:
        """ref: decoder.rs:84-99"""
        return SOURCE_CAMERA_TO_TYPE[self.meta.source_camera]

    def get_compression_type(self) -> EncoderType:
        return (
            EncoderType.Compressed
            if self.magic in (MAGIC_COMPRESSED, MAGIC_RANS)
            else EncoderType.Raw
        )

    # -- scalar API (parity with reference digest_event, decoder.rs:207) --

    def digest_event(self) -> Event:
        if self._compressed_input is not None:
            return self._compressed_input.digest_event()
        buf = self.reader.read(self.meta.event_size)
        if len(buf) < self.meta.event_size:
            raise Eof()
        ev = rawcodec.decode_events(buf, self.meta.plane.channels)
        if rawcodec.find_eof(ev) == 0:
            raise Eof()
        return ev[0]

    # -- bulk API (the vectorized fast path) --

    def digest_all(self) -> EventArray:
        """Decode every remaining event up to the EOF marker in one pass."""
        if self._compressed_input is not None:
            return self._compressed_input.digest_all()
        buf = self.reader.read()
        events = rawcodec.decode_events(buf, self.meta.plane.channels)
        n = rawcodec.find_eof(events)
        return events[:n]

    def digest_batch(self, max_events: int) -> EventArray:
        """Decode up to `max_events` events; empty batch means EOF reached."""
        if self._compressed_input is not None:
            return self._compressed_input.digest_batch(max_events)
        pos = self.reader.tell()
        buf = self.reader.read(max_events * self.meta.event_size)
        events = rawcodec.decode_events(buf, self.meta.plane.channels)
        n = rawcodec.find_eof(events)
        if n < len(events) or len(buf) % self.meta.event_size:
            # reposition to just after the last consumed whole event so a
            # subsequent read sees the EOF marker (or clean alignment) again
            self.reader.seek(pos + n * self.meta.event_size)
        return events[:n]

    # -- seeking (ref: decoder.rs:225-258, raw/stream.rs:211-227) --

    def set_input_stream_position(self, pos: int) -> None:
        """Absolute byte seek. Raw streams seek to any event boundary
        (event-size alignment check, ref: raw/stream.rs:211-227); `addec`
        streams seek only to ADU boundaries (length-prefixed frames,
        ref: compressed/stream.rs:394-400) and reset the in-flight ADU."""
        if self._compressed_input is not None:
            self._compressed_input.seek(pos)
            return
        if (pos - self.meta.header_size) % self.meta.event_size != 0:
            raise SeekError(f"bad position {pos}")
        self.reader.seek(pos)

    def get_adu_boundaries(self) -> list:
        """Valid seek targets for a compressed stream (byte offsets of each
        length-prefixed ADU frame plus end-of-stream)."""
        if self._compressed_input is None:
            raise CodecError("raw streams have no ADU boundaries")
        return self._compressed_input.scan_adu_boundaries()

    def get_input_stream_position(self) -> int:
        return self.reader.tell()

    def get_eof_position(self) -> int:
        """Byte offset of the end of the event payload (scan, position
        restored). Raw: offset of the EOF marker event. Compressed: end of
        the last whole ADU frame."""
        if self._compressed_input is not None:
            return self._compressed_input.scan_adu_boundaries()[-1]
        pos = self.reader.tell()
        self.reader.seek(self.meta.header_size)
        buf = self.reader.read()
        events = rawcodec.decode_events(buf, self.meta.plane.channels)
        n = rawcodec.find_eof(events)
        self.reader.seek(pos)
        return self.meta.header_size + n * self.meta.event_size


def open_file_decoder(path: str) -> Decoder:
    """Open a `.adder` file, sniffing raw vs compressed by magic.

    ref: adder-codec-core/src/lib.rs:461-495
    """
    return Decoder(open(path, "rb"))
