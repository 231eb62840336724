#!/usr/bin/env python
"""Time full-file event digestion (ref: bin/decode_benchmark.rs), and
optionally the reconstruction stage: --frame adds host framing, --device
frames on the accelerator (framer/device.py) and reports device-framing
throughput."""

import argparse
import sys
import time

sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))

from adder_jax.codec.decoder import open_file_decoder


def main():
    p = argparse.ArgumentParser(description="decode benchmark")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("--fps", type=float, default=60.0)
    p.add_argument(
        "--frame", action="store_true",
        help="also reconstruct frames (host framer)",
    )
    p.add_argument(
        "--device", action="store_true",
        help="also reconstruct frames on the accelerator (device framer)",
    )
    args = p.parse_args()
    t0 = time.perf_counter()
    dec = open_file_decoder(args.input)
    events = dec.digest_all()
    dt = time.perf_counter() - t0
    print(
        f"digested {len(events)} events in {dt*1000:.1f} ms "
        f"({len(events)/max(dt,1e-9)/1e6:.1f} Mev/s)"
    )
    if not (args.frame or args.device):
        return

    from adder_jax.framer.driver import FramerBuilder

    m = dec.meta
    b = (
        FramerBuilder(m.plane)
        .time_parameters(m.tps, m.ref_interval, m.delta_t_max, args.fps)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
    )
    if args.device:
        from adder_jax.framer.device import DeviceFramer

        fr = DeviceFramer(b)
        fr.ingest_event_array(events)  # warm ingest + pop ops off the clock
        fr.drain()
        fr = DeviceFramer(b)
        t0 = time.perf_counter()
        fr.ingest_event_array(events)
        frames = fr.drain()
        dt = time.perf_counter() - t0
        label = "device-framed"
    else:
        fr = b.finish()
        t0 = time.perf_counter()
        fr.ingest_event_array(events)
        frames = []
        while fr.is_frame_0_filled():
            frames.append(fr.pop_next_frame()[0])
        if fr.flush_frame_buffer():
            while fr.is_frame_0_filled():
                frames.append(fr.pop_next_frame()[0])
        dt = time.perf_counter() - t0
        label = "host-framed"
    n_px = len(frames) * m.plane.volume()
    print(
        f"{label} {len(frames)} frames in {dt*1000:.1f} ms "
        f"({n_px/max(dt,1e-9)/1e6:.1f} Mpx/s, "
        f"{len(events)/max(dt,1e-9)/1e6:.1f} Mev/s)"
    )


from adder_jax.codec.header import CodecError  # noqa: E402
if __name__ == "__main__":
    try:
        main()
    except CodecError as e:
        sys.exit(f"error: not a valid ADDER stream: {e}")
    except FileNotFoundError as e:
        sys.exit(f"error: {e}")
