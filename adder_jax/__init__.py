"""adder_jax — a JAX ADDER event-video framework.

A from-scratch re-design of the capabilities of ac-freeman/adder-codec-rs
(ADDER: Address, Decimation, Delta-t Event Representation) built on
JAX/XLA: framed/DVS/Prophesee sources are transcoded to ADDER events
by a dense masked state-machine kernel over the pixel plane, compressed with
a source-modeled entropy stage, and reconstructed back to frames.

Layer map (mirrors reference SURVEY.md section 1):
  core/        L1 event & plane types, D tables
  codec/       L2 container: header, raw codec, encoder/decoder, compression
  transcoder/  L3 intensity -> events (JAX kernels + sources)
  framer/      L3 events -> frames
  ops/         device kernels (integration, compaction, FAST features)
  parallel/    multi-device sharding (jax.sharding / shard_map) and
               multi-host ingest/collection (parallel/multihost.py);
               the mesh-wide Video API is transcoder/sharded.py
  utils/       cv metrics, pipelines, visualization
  models/      end-to-end pipeline models (transcode, simul, player)
"""

__version__ = "0.1.0"

from .runtime import configure_compilation_cache as _configure_cache

_configure_cache()

from .core.types import (  # noqa: F401
    D_EMPTY,
    D_MAX,
    D_NO_EVENT,
    D_SHIFT,
    D_SHIFT_F32,
    D_SHIFT_F64,
    D_START,
    D_ZERO_INTEGRATION,
    EOF_EVENT,
    EOF_PX_ADDRESS,
    MAX_INTENSITY,
    NO_CHANNEL,
    Coord,
    Event,
    EventArray,
    Mode,
    PixelMultiMode,
    PlaneError,
    PlaneSize,
    SourceCamera,
    SourceType,
    TimeMode,
    is_framed,
)
