"""Benchmark of adder_jax's paths on the GPU.

Prints one JSON line per metric, each naming the platform and device kind
it ran on; the LAST line repeats the headline metric. Needs a GPU: with
none it exits non-zero before measuring anything.

Sections:
- parity: the 1080p-config chunk (ops.make_transcode_chunk) on the GPU vs
  the same chunk on the CPU, event streams byte-compared. A mismatch is a
  failure, not a metric.
- mono / color device loops: the chunk over 1080p frames staged on the
  device, events left there — a kernel-layer rate, in the reference's
  criterion bench configuration (framed_to_adder_hd.rs: lossless c_thresh
  0/0, delta_t_max = 24*ref, DeltaT).
- e2e: host frames through Video.submit/collect, events fetched and fed to
  the Empty encoder (the reference's no-IO bench semantics,
  codec/empty/stream.rs:9-63), with and without FAST feature detection.
- dvs device: the DVS scan engine's integration rate over pre-planned lane
  batches; dvs e2e: the host-driven Prophesee source, windowed and bulk.
- reconstruction, compression and ADDER->DVS: these read the reference's
  nyc fixture and print a skipped line naming it when it is absent.
"""

import json
import sys
import time

import numpy as np

# every metric emitted during the run, in order — re-emitted as one
# compact trailing block so a tail capture of stdout keeps every section
_ALL_METRICS = []
_DEVICE = {}


def _emit(metric, value, unit):
    rec = {"metric": metric, "value": value, "unit": unit, **_DEVICE}
    _ALL_METRICS.append(rec)
    print(json.dumps(rec), flush=True)


def _skipped(section, why):
    print(f"# {section} skipped: {why}", flush=True)


def _emit_trailing_summary(headline_metric):
    """Re-emit every metric compactly, headline LAST."""
    print("# == trailing summary: all metrics re-emitted ==", flush=True)
    head = [r for r in _ALL_METRICS if r["metric"] == headline_metric]
    rest = [r for r in _ALL_METRICS if r["metric"] != headline_metric]
    for rec in rest + head[-1:]:
        print(json.dumps(rec, separators=(",", ":")), flush=True)


def _flat_frames(T, H, W, C, seed=7):
    from adder_jax.utils.scenes import moving_blobs

    return moving_blobs(T, H, W, C, seed=seed).reshape(T, H * W * C)


def _bench_params(ops):
    from adder_jax.core.types import Mode, PixelMultiMode, TimeMode

    # the reference's own criterion bench config (framed_to_adder_hd.rs:24-39)
    return ops.TranscodeParams(
        mode=int(Mode.FramePerfect),
        multi_mode=int(PixelMultiMode.Collapse),
        time_mode=int(TimeMode.DeltaT),
        ref_time=255,
        delta_t_max=255 * 24,
        c_thresh_max=0,
        c_increase_velocity=1,
    )


def _check_chunk(ops, outs, cap, T, pack):
    total = int(outs[6])
    per_max = int(np.max(np.asarray(outs[7])))
    if total > cap or per_max > ops.per_interval_take(cap, T):
        raise RuntimeError(f"event capacity overflow ({total} > {cap})")
    if int(outs[9]) > pack:
        raise RuntimeError(f"pack-lane overflow ({int(outs[9])} > {pack})")


def _device_loop(jax, jnp, ops, H, W, C, n_chunks=4, T=16):
    """The chunk scan over frames staged on the device; events stay there.
    Capacity N*T and 4 packed lanes, as Video starts a 1080p stream."""
    n = H * W * C
    frames = _flat_frames(T * n_chunks, H, W, C)
    p = _bench_params(ops)
    cap, pack = n * T, 4
    fn = ops.make_transcode_chunk(p, cap, pack)
    state = ops.set_initial_d(
        ops.init_state(n), jnp.asarray(frames[0].astype(np.int32))
    )
    run0 = jnp.zeros((n,), jnp.uint8)
    t = jnp.float32(255.0)
    chunks = [
        jax.device_put(frames[i * T : (i + 1) * T]) for i in range(n_chunks)
    ]
    outs = fn(state, chunks[0], t, run0)  # compile + initial burst
    _check_chunk(ops, outs, cap, T, pack)
    state = outs[0]
    kept = []
    t0 = time.perf_counter()
    for c in chunks[1:]:
        outs = fn(state, c, t, run0)
        state = outs[0]
        kept.append(outs)
    jax.block_until_ready(kept)
    dt = (time.perf_counter() - t0) / ((n_chunks - 1) * T)
    for o in kept:
        _check_chunk(ops, o, cap, T, pack)
    return n / dt / 1e6


def _e2e_loop(jax, H=1080, W=1920, n_chunks=2, T=16, features=False):
    """Host frames -> Video submit/collect -> events -> Empty encoder.
    features=True additionally runs per-interval FAST-9/16 detection
    (device fast_mask_jax batches + host DBSCAN; ref video.rs:883-1112)."""
    from adder_jax.core.types import Mode, PlaneSize, TimeMode
    from adder_jax.transcoder.video import Video
    from adder_jax.utils import tracing

    shaped = _flat_frames(T * n_chunks, H, W, 1).reshape(-1, H, W, 1)
    video = Video(PlaneSize(W, H, 1), Mode.FramePerfect)
    video.time_parameters(255 * 24, 255, 255 * 24, TimeMode.DeltaT)
    video.update_quality_manual(0, 0, 24, 1, 0)
    if features:
        video.update_detect_features(True)

    def run():
        # pipelined submit: up to two chunks in flight so device compute
        # and event fetch overlap the next chunk's upload
        t0 = time.perf_counter()
        for i in range(n_chunks):
            video.submit_chunk(shaped[i * T : (i + 1) * T])
        video.flush()
        return time.perf_counter() - t0

    # warm pass on the SAME video: compiles and capacity steps stay learned
    run()
    was = tracing.enabled()
    tracing.set_enabled(True)
    tracing.reset()
    dt = run() / n_chunks
    tag = " features-on" if features else ""
    print(f"# e2e{tag} stage trace (timed pass):", file=sys.stderr)
    for line in tracing.summary_table().splitlines():
        print(f"#   {line}", file=sys.stderr)
    tracing.set_enabled(was)
    return H * W * T / dt / 1e6


def _parity_check(jax, jnp, ops):
    """The GPU chunk vs the CPU chunk on one plane: event streams and
    carried state must be byte-identical; raises otherwise."""
    H, W, T = 64, 256, 4
    n = H * W
    frames = _flat_frames(T, H, W, 1, seed=3)
    p = _bench_params(ops)
    cap = ops.K_SLOTS * n * T
    fn = ops.make_transcode_chunk(p, cap, ops.K_SLOTS)
    got = []
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev):
            state = ops.set_initial_d(
                ops.init_state(n), jnp.asarray(frames[0].astype(np.int32))
            )
            o = fn(state, jnp.asarray(frames), jnp.float32(255.0),
                   jnp.zeros((n,), jnp.uint8))
            tot = int(o[6])
            got.append(
                [np.asarray(o[1][:tot]), np.asarray(o[2][:tot])]
                + [np.asarray(x) for x in o[0]]
            )
    for a, b in zip(*got):
        if not np.array_equal(a, b):
            raise RuntimeError("GPU chunk differs from the CPU chunk")


def _dvs_raw(path, n_events, W, H, t1, seed):
    from adder_jax.utils.scenes import random_dvs_events, write_prophesee_raw

    t, x, y, p = random_dvs_events(n_events, W, H, 1000, t1, seed=seed)
    write_prophesee_raw(path, t, x, y, p, W, H)
    return t, x, y, p


def _dvs_loop(tmp_dir, n_events=100_000, n_bulk=1_200_000, W=346, H=260,
              span=200_000):
    """Synthetic Prophesee RAW -> ADDER via the batched device path (the
    DVS default; ref serial loop: prophesee.rs:116-297), host-driven
    (includes host lane planning). Returns (windowed Mev/s, bulk Mev/s)."""
    import os

    from adder_jax.codec.encoder import EncoderOptions, EncoderType
    from adder_jax.core.types import PixelMultiMode, SourceCamera, TimeMode
    from adder_jax.transcoder.prophesee import Prophesee

    path = os.path.join(tmp_dir, "windowed.raw")
    _dvs_raw(path, n_events, W, H, span, seed=2)
    stickies = ("_scan_take", "_scan_lpad", "_mask_take")

    def run(p, view_fps=60, void=False, seeds=None):
        src = Prophesee(20, p, batched=True, view_fps=view_fps)
        src.write_out(
            SourceCamera.Dvs, TimeMode.AbsoluteT, PixelMultiMode.Collapse,
            None, EncoderType.Empty, EncoderOptions.default(src.plane), None,
        )
        # void: the Empty encoder discards everything anyway — skip the
        # event materialization (the reference's EmptyOutput semantics)
        src.void_events = void
        # seed the sticky compile shapes so the timed pass reuses the
        # executables the warm pass built
        for k, v in (seeds or {}).items():
            if v:
                setattr(src, k, v)
        t0 = time.perf_counter()
        try:
            while True:
                src.consume()
        except EOFError:
            pass
        import jax

        jax.block_until_ready(src._dev_state)
        return time.perf_counter() - t0, {
            k: getattr(src, k, 0) for k in stickies
        }

    _, seeds = run(path)  # compiles at the sticky shapes
    dt, _ = run(path, seeds=seeds)
    windowed = n_events / dt / 1e6

    # offline bulk mode: one big window (view_fps=1), void output
    bulk_path = os.path.join(tmp_dir, "bulk.raw")
    _dvs_raw(bulk_path, n_bulk, W, H, n_bulk, seed=7)
    _, seeds2 = run(bulk_path, view_fps=1, void=True, seeds=seeds)
    dt_b, _ = run(bulk_path, view_fps=1, void=True, seeds=seeds2)
    return windowed, n_bulk / dt_b / 1e6


def _dvs_device_loop(jax, jnp, n_events=600_000, W=346, H=260, windows=4):
    """Device integration rate of the DVS scan engine over lane batches
    planned up front and staged on the device (dispatches chained with no
    intermediate sync). Ref serial loop: prophesee.rs:116-297."""
    from adder_jax.core.types import Mode, TimeMode
    from adder_jax.ops import dvs_batch as B
    from adder_jax.ops import integrate as I
    from adder_jax.utils.scenes import random_dvs_events

    n = W * H
    t, x, y, pol = random_dvs_events(n_events, W, H, 1000, 400_000, seed=5)
    # mirrors Prophesee._tp(): Continuous, AbsoluteT, dtm = 2*ref
    # (ref: prophesee.rs:70-76)
    p = I.TranscodeParams(
        mode=int(Mode.Continuous),
        time_mode=int(TimeMode.AbsoluteT),
        ref_time=255,
        delta_t_max=510,
        c_thresh_max=10,
        c_increase_velocity=1,
    )
    last_t = np.zeros(n, np.uint32)
    last_ln = np.full(n, float(np.log1p(128.0 / 255.0)), np.float64)
    bounds = np.linspace(0, n_events, windows + 1).astype(np.int64)
    batches, counts, L_pad, most = [], [], 1, 1
    for w in range(windows):
        a, b = bounds[w], bounds[w + 1]
        lanes = B.plan_dvs_batch(
            t[a:b], x[a:b], y[a:b], pol[a:b], W, n, last_t, last_ln,
            0.02, p.ref_time,
        )
        counts.append(int(sum(int(ln.tick_mask.sum()) for ln in lanes)))
        most = max(most, max(
            max(int(ln.gap_mask.sum()), int(ln.tick_mask.sum()))
            for ln in lanes
        ))
        L_pad = max(L_pad, 1 << (len(lanes) - 1).bit_length())
        batches.append(lanes)
    K = 16 + 3  # slots per sub-step of the engine's depth-16 arenas
    take = 1 << (max(64, most * K) - 1).bit_length()
    fn = B.make_dvs_scan_step(p, take)
    staged = [
        [jax.device_put(a) for a in B.stack_lanes(lanes, L_pad)]
        for lanes in batches
    ]
    st = I.init_state(n, depth=16)
    st, *_ = fn(st, *staged[0])  # compile
    jax.block_until_ready(st)
    t0 = time.perf_counter()
    outs = []
    for s in staged[1:]:
        o = fn(st, *s)
        st = o[0]
        outs.append(o)
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    for o in outs:
        if int(o[4]) > take:
            raise RuntimeError("dvs sub-step overflowed its compaction take")
    return sum(counts[1:]) / dt / 1e6


_NYC = "/root/reference/adder-codec-rs/tests/samples/nyc_source_v2.adder"


def _nyc_events():
    from adder_jax.codec.decoder import open_file_decoder

    t0 = time.perf_counter()
    dec = open_file_decoder(_NYC)
    events = dec.digest_all()
    return dec, events, time.perf_counter() - t0


def _framer_loop():
    """Reconstruction throughput (BASELINE config 'ADDER->framed'; ref
    decode-side harness: bin/decode_benchmark.rs:28-32): digest the
    reference nyc fixture, then host-frame it. Returns
    (digest Mev/s, framer Mev/s, frames reconstructed)."""
    from adder_jax.framer.driver import FramerBuilder

    dec, events, digest_dt = _nyc_events()
    m = dec.meta
    fps = m.tps / max(m.ref_interval, 1)
    fs = (
        FramerBuilder(m.plane)
        .time_parameters(m.tps, m.ref_interval, m.delta_t_max, fps)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
        .finish()
    )
    t0 = time.perf_counter()
    fs.ingest_event_array(events)
    n_frames = 0
    while fs.is_frame_0_filled():
        fs.pop_next_frame()
        n_frames += 1
    frame_dt = time.perf_counter() - t0

    # device framer (framer/device.py — the accelerator reconstruction
    # path; ref decode_benchmark.rs drives the host one)
    from adder_jax.framer.device import DeviceFramer

    db = (
        FramerBuilder(m.plane)
        .time_parameters(m.tps, m.ref_interval, m.delta_t_max, fps)
        .codec_meta(m.codec_version, m.time_mode)
        .source_info(dec.get_source_type(), m.source_camera)
    )
    # warm pass: a full ingest+drain (compiles the batch step AND every
    # pop/recycle op shape — a prefix warm leaves the drain ops cold and
    # times ~30 s of XLA compiles on a 1-core host)
    df = DeviceFramer(db)
    df.ingest_event_array(events)
    df.drain()
    # decomposed stage trace on the timed pass: pack/dispatch are host+h2d,
    # sync_fetch and pop_d2h are device round trips, convert is host math
    from adder_jax.utils import tracing

    was = tracing.enabled()
    tracing.set_enabled(True)
    tracing.reset()
    df = DeviceFramer(db)
    t0 = time.perf_counter()
    df.ingest_event_array(events)
    dev_frames = len(df.drain())
    dev_dt = time.perf_counter() - t0
    print("# device framer stage trace (timed pass):")
    for line in tracing.summary_table().splitlines():
        print(f"#   {line}")
    tracing.set_enabled(was)
    return (
        len(events) / digest_dt / 1e6,
        len(events) / frame_dt / 1e6,
        n_frames,
        len(events) / dev_dt / 1e6,
        dev_frames,
    )


def _nyc_absolute_t(events):
    """nyc fixture is DeltaT; the ADU pipeline spans absolute time —
    telescope per-pixel deltas to absolute t (same as the compression
    suite's fixture prep)."""
    from adder_jax.core.types import EventArray

    pix = events.y.astype(np.int64) * 320 + events.x.astype(np.int64)
    order = np.argsort(pix, kind="stable")
    t_abs = events.t.astype(np.uint64).copy()
    spix = pix[order]
    st = events.t[order].astype(np.uint64)
    seg = np.ones(len(spix), bool)
    seg[1:] = spix[1:] != spix[:-1]
    tot = np.cumsum(st)
    base = np.maximum.accumulate(np.where(seg, tot - st, 0))
    t_abs[order] = (tot - base).astype(np.uint64)
    ev = EventArray(
        events.x, events.y, events.c, events.d, t_abs.astype(np.uint32)
    )
    return ev[np.argsort(ev.t, kind="stable")]


def _expected_survivors(ev, ref_interval: int, adu_interval: int):
    """EXACT survivor mask of the compressed stream path, vectorized.

    Replays the ADU rotation (one rotation per triggering event —
    compressed.py ingest_event_array) and the cube ingest drop rule
    (event_cube.rs:127-141: drop when the pixel already kept >1 events and
    t does not advance). The first two stream events of a (pixel, ADU)
    group are always kept, and a dropped event never raises the group's
    running max, so for rank >= 2: keep iff t > cummax(previous t)."""
    n = len(ev)
    t = ev.t.astype(np.int64)
    span = ref_interval * max(adu_interval, 1)
    adu = np.empty(n, np.int64)
    start_t, i, k = 0, 0, 0
    while i < n:
        # first event past the span (order-agnostic, like the real ingest
        # loop — the stream need not be globally t-sorted)
        rel = np.flatnonzero(t[i:] > start_t + span)
        cut = i + int(rel[0]) if len(rel) else n
        adu[i:cut] = k
        if cut >= n:
            break
        adu[cut] = k + 1  # the trigger lands in the NEW adu
        start_t += span
        i, k = cut + 1, k + 1
    pix = (
        ev.y.astype(np.int64) * 65536 + ev.x.astype(np.int64)
    ) * 4 + np.where(ev.c == 255, 0, ev.c).astype(np.int64)
    group = adu * (1 << 34) + pix
    order = np.argsort(group, kind="stable")
    g = group[order]
    ts = t[order]
    new_seg = np.empty(n, bool)
    new_seg[:1] = True
    new_seg[1:] = g[1:] != g[:-1]
    seg_id = np.cumsum(new_seg) - 1
    first = np.flatnonzero(new_seg)
    rank = np.arange(n) - first[seg_id]
    # segmented cummax: a per-segment ramp keeps maxima from crossing
    # segment boundaries (t values are < 2^40 here)
    ramp = seg_id.astype(np.int64) * (1 << 40)
    cm = np.maximum.accumulate(ts + ramp) - ramp
    prev_cm = np.empty(n, np.int64)
    prev_cm[0] = -(1 << 62)
    prev_cm[1:] = cm[:-1]
    prev_cm[new_seg] = -(1 << 62)
    keep_sorted = (rank < 2) | (ts > prev_cm)
    keep = np.empty(n, bool)
    keep[order] = keep_sorted
    return keep


def _compression_loop():
    """Source-modeled entropy coding throughput (BASELINE config
    'compressed .adder'; ref: compressed/stream.rs): encode + decode Mev/s
    and size ratio vs raw, for the reference-compatible addec (CABAC) and
    the own addrn (interleaved rANS) codec, on the nyc fixture.
    Asserts the EXACT survivor multiset (no blanket tolerance) and prints
    the native ingest/transform/entropy stage breakdown."""
    import ctypes
    import io
    import os

    from adder_jax.codec.compressed import _get_lib
    from adder_jax.codec.decoder import Decoder
    from adder_jax.codec.encoder import Encoder, EncoderOptions
    from adder_jax.core.types import TimeMode

    dec, events, _ = _nyc_events()
    ev = _nyc_absolute_t(events)
    meta = dec.meta
    meta.adu_interval = 10
    meta.codec_version = 3
    meta.time_mode = TimeMode.AbsoluteT
    raw_bytes = len(events) * 9
    keep = _expected_survivors(ev, meta.ref_interval, 10)
    want = ev[np.flatnonzero(keep)]
    want_key = np.lexsort((want.d, want.c, want.x, want.y))
    lib = _get_lib()
    lib.adder_entropy_stats.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int
    ]
    stats = (ctypes.c_uint64 * 6)()
    out = {}
    for entropy in ("cabac", "rans"):
        lib.adder_entropy_stats(stats, 1)  # reset
        buf = io.BytesIO()
        t0 = time.perf_counter()
        enc = Encoder.new_compressed(
            meta, buf, EncoderOptions.default(meta.plane), entropy=entropy
        )
        enc.ingest_event_array(ev)
        enc.close_writer()
        enc_dt = time.perf_counter() - t0
        lib.adder_entropy_stats(stats, 0)
        print(
            f"# {entropy} native stage breakdown: "
            f"ingest {stats[0]/1e6:.1f} ms, transform {stats[1]/1e6:.1f} ms, "
            f"entropy {stats[2]/1e6:.1f} ms over {stats[3]} ADUs "
            f"({stats[5]} coded symbols; cabac reports transform+entropy "
            f"fused under entropy: the model adapts per symbol)"
        )
        data = buf.getvalue()
        buf2 = io.BytesIO(data)
        t0 = time.perf_counter()
        back = Decoder(buf2).digest_all()
        dec_dt = time.perf_counter() - t0
        # EXACT survivor multiset: decode returns cube-raster order, t is
        # lossy-quantized; (x, y, c, d) must match the replayed drop rule
        assert len(back) == len(want), (len(back), len(want))
        back_key = np.lexsort((back.d, back.c, back.x, back.y))
        for f in ("x", "y", "c", "d"):
            assert np.array_equal(
                getattr(back, f)[back_key], getattr(want, f)[want_key]
            ), f"survivor field {f} mismatch"
        out[entropy] = (
            len(ev) / enc_dt / 1e6,
            len(back) / dec_dt / 1e6,
            len(data) / raw_bytes,
        )

    # ADU worker-pool scaling (stream.rs:264-319 spawns per-ADU threads):
    # only measurable where a second core exists — on 1-core hosts the
    # pool is bypassed (see CompressedOutput) and this stays absent
    if (os.cpu_count() or 1) > 1:

        def timed_encode(workers: str) -> float:
            os.environ["ADDER_ADU_WORKERS"] = workers
            try:
                best = 1e9
                for _ in range(2):
                    buf = io.BytesIO()
                    t0 = time.perf_counter()
                    enc = Encoder.new_compressed(
                        meta, buf, EncoderOptions.default(meta.plane),
                        entropy="rans",
                    )
                    enc.ingest_event_array(ev)
                    enc.close_writer()
                    best = min(best, time.perf_counter() - t0)
                return len(ev) / best / 1e6
            finally:
                os.environ.pop("ADDER_ADU_WORKERS", None)

        one = timed_encode("0")
        pooled = timed_encode(str(min(4, os.cpu_count())))
        out["pool_scaling"] = (one, pooled, pooled / max(one, 1e-9))
    return out


def _adder_to_dvs_loop(tmp_dir):
    """ADDER->DVS conversion + round trip (BASELINE config e; ref:
    adder-to-dvs/src/main.rs:477): conversion rate on the nyc fixture,
    and an EVENT-DOMAIN round trip — synthetic DVS raw -> Prophesee
    transcode -> .adder -> adder_to_dvs at the same theta -> per-pixel
    polarity-count precision/recall vs the input events. (A frame-PSNR
    round trip is ill-posed: DVS streams carry temporal contrast from an
    unknown absolute level, so reconstructions differ by design.)
    Precision ~1 means the conversion invents essentially nothing;
    recall measures the representation's temporal quantization on an
    adversarially random stream (polarity flips inside one ADDER
    integration span cancel). Returns
    (convert Mev/s, n_dvs_events, precision, recall)."""
    import io
    import os

    from adder_jax.codec.encoder import EncoderOptions, EncoderType
    from adder_jax.core.types import (
        PixelMultiMode, SourceCamera, TimeMode,
    )
    from adder_jax.models.adder_to_dvs import adder_to_dvs
    from adder_jax.transcoder.prophesee import (
        Prophesee, decode_events_np, parse_header,
    )

    # conversion rate on the reference nyc fixture (real content; the
    # synthetic blob scene is too smooth to cross the DVS theta)
    t0 = time.perf_counter()
    with open(os.path.join(tmp_dir, "nyc.dvs.raw"), "wb") as f:
        nyc_stats = adder_to_dvs(_NYC, f, output_mode="binary",
                                 theta=0.01, max_events=60000)
    conv_dt = time.perf_counter() - t0
    rate = 60000 / conv_dt / 1e6

    def round_trip(tag, t, x, y, p, W, H):
        """DVS raw -> Prophesee transcode -> .adder -> adder_to_dvs at the
        same theta -> per-pixel polarity-count precision/recall."""
        n_ev = len(t)
        w = (
            (p.astype(np.uint64) << 28)
            | (y.astype(np.uint64) << 14)
            | x.astype(np.uint64)
        )
        rec = np.empty(n_ev * 2, np.uint32)
        rec[0::2] = t
        rec[1::2] = w.astype(np.uint32)
        raw = os.path.join(tmp_dir, f"rt_{tag}.raw")
        with open(raw, "wb") as f:
            f.write(f"% Height {H}\n% Width {W}\n".encode())
            f.write(bytes([0, 8]))
            f.write(rec.tobytes())

        a_path = os.path.join(tmp_dir, f"rt_{tag}.adder")
        src = Prophesee(20, raw, batched=True, view_fps=1)  # bulk windows
        theta = src.camera_theta
        src.write_out(
            SourceCamera.Dvs, TimeMode.AbsoluteT, PixelMultiMode.Collapse,
            None, EncoderType.Raw, EncoderOptions.default(src.plane),
            open(a_path, "wb"),
        )
        while True:
            try:
                src.consume()
            except EOFError:
                break
        src.end_write_stream().close()

        out = io.BytesIO()
        stats = adder_to_dvs(a_path, out, output_mode="binary", theta=theta)
        data = out.getvalue()
        bod, _, _, _ = parse_header(io.BytesIO(data))
        _, x2, y2, p2 = decode_events_np(data[bod:])

        def keyed(xa, ya, pa):
            k = (
                ya.astype(np.int64) * W + xa.astype(np.int64)
            ) * 2 + pa.astype(np.int64)
            return np.bincount(k, minlength=W * H * 2)

        ca, cb = keyed(x, y, p), keyed(x2, y2, p2)
        matched = np.minimum(ca, cb).sum()
        precision = float(matched / max(cb.sum(), 1))
        recall = float(matched / max(ca.sum(), 1))
        return precision, recall, stats["n_dvs_events"]

    # (a) adversarially RANDOM stream: per-pixel polarity flips land inside
    # one ADDER integration span and cancel by representation — recall here
    # measures temporal quantization, not conversion quality
    W, H, n_ev = 64, 48, 20000
    rng = np.random.default_rng(3)
    t = np.sort(rng.integers(1000, 120_000, n_ev)).astype(np.uint32)
    x = rng.integers(0, W, n_ev)
    y = rng.integers(0, H, n_ev)
    p = rng.integers(0, 2, n_ev)
    precision, recall, n_rt = round_trip("rand", t, x, y, p, W, H)

    # (b) STRUCTURED scene (r04 verdict item 6): a vertical edge sweeping
    # right — pixel x brightens when the edge arrives at t = 1000 + x*P and
    # darkens when it leaves E ticks later. A real edge is a BURST of
    # same-polarity events (8 x theta = 0.16 log contrast — single events
    # at theta = 0.02 sit below ADDER's D-quantization resolution and
    # vanish in ANY converter); bursts are same-polarity (accumulate — only
    # opposite polarities can cancel) and arrival/departure are separated
    # by E >> delta_t_max so nothing cancels inside one integration span.
    # High recall here demonstrates the random stream's recall loss is
    # representation quantization, not a conversion bug.
    P, E, BURST, STEP = 400, 12_000, 8, 4
    cols = np.arange(W, dtype=np.int64)
    base_on = 1000 + cols * P  # (W,)
    burst = np.arange(BURST, dtype=np.int64) * STEP  # (BURST,)
    # per (col, row, burst-step) event grids, ON then OFF
    ts_on = (base_on[:, None, None] + burst[None, None, :]).repeat(H, axis=1)
    ts_off = ts_on + E
    xg = np.broadcast_to(cols[:, None, None], ts_on.shape)
    yg = np.broadcast_to(
        np.arange(H, dtype=np.int64)[None, :, None], ts_on.shape
    )
    t_s = np.concatenate([ts_on.ravel(), ts_off.ravel()])
    x_s = np.concatenate([xg.ravel(), xg.ravel()])
    y_s = np.concatenate([yg.ravel(), yg.ravel()])
    half = ts_on.size
    p_s = np.concatenate(
        [np.ones(half, np.int64), np.zeros(half, np.int64)]
    )
    o = np.argsort(t_s, kind="stable")
    prec_s, rec_s, _ = round_trip(
        "edge", t_s[o].astype(np.uint32), x_s[o], y_s[o], p_s[o], W, H
    )

    n_total = n_rt + nyc_stats["n_dvs_events"]
    return rate, n_total, precision, recall, prec_s, rec_s


def main():
    import os
    import subprocess
    import tempfile

    import jax
    import jax.numpy as jnp

    from adder_jax.ops import integrate as ops

    if jax.default_backend() != "gpu":
        raise SystemExit(
            f"bench.py needs a GPU; JAX's default backend is "
            f"{jax.default_backend()!r}"
        )
    dev = jax.devices()[0]
    _DEVICE.update(platform=dev.platform, device_kind=dev.device_kind)
    print("# " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    start = time.perf_counter()

    def _mark(name):
        print(
            f"# bench section {name} done at t+{time.perf_counter() - start:.0f}s",
            file=sys.stderr, flush=True,
        )

    _parity_check(jax, jnp, ops)
    _emit("gpu_vs_cpu_event_parity", 1, "bool")
    _mark("parity")

    color = _device_loop(jax, jnp, ops, 1080, 1920, 3, n_chunks=3, T=16)
    _emit("framed_to_adder_1080p_color_device", color, "Mch-px/s")
    _mark("color")

    _emit("framed_to_adder_1080p_e2e", _e2e_loop(jax), "Mpx/s")
    _mark("e2e")
    _emit(
        "framed_to_adder_1080p_e2e_features", _e2e_loop(jax, features=True),
        "Mpx/s",
    )
    _mark("e2e_features")

    _emit("prophesee_dvs_device_integrate", _dvs_device_loop(jax, jnp),
          "Mev/s")
    _mark("dvs_device")
    with tempfile.TemporaryDirectory() as td:
        dvs, dvs_bulk = _dvs_loop(td)
    _emit("prophesee_to_adder_dvs_transcode", dvs, "Mev/s")
    _emit("prophesee_to_adder_dvs_transcode_bulk", dvs_bulk, "Mev/s")
    _mark("dvs")

    if os.path.exists(_NYC):
        dig, frm, n_frames, dev_frm, n_dev = _framer_loop()
        _emit("adder_decode_digest", dig, "Mev/s")
        _emit("adder_to_framed_reconstruct", frm, "Mev/s")
        _emit("adder_to_framed_reconstruct_device", dev_frm, "Mev/s")
        print(f"# framer reconstructed {n_frames} frames "
              f"(device path: {n_dev})", file=sys.stderr)
        _mark("framer")
        comp = _compression_loop()
        scaling = comp.pop("pool_scaling", None)
        for name, (enc_r, dec_r, ratio) in comp.items():
            tag = "addec" if name == "cabac" else "addrn"
            _emit(f"compressed_{tag}_encode", enc_r, "Mev/s")
            _emit(f"compressed_{tag}_decode", dec_r, "Mev/s")
            _emit(f"compressed_{tag}_ratio_vs_raw", ratio, "x")
        if scaling is not None:
            _emit("compressed_adu_pool_speedup", scaling[2], "x")
        _mark("compression")
        with tempfile.TemporaryDirectory() as td:
            rate, n_dvs, prec, rec, prec_s, rec_s = _adder_to_dvs_loop(td)
        _emit("adder_to_dvs_convert", rate, "Mev/s")
        _emit("adder_to_dvs_roundtrip_event_precision", prec, "frac")
        _emit("adder_to_dvs_roundtrip_event_recall", rec, "frac")
        _emit("adder_to_dvs_structured_precision", prec_s, "frac")
        _emit("adder_to_dvs_structured_recall", rec_s, "frac")
        print(f"# adder_to_dvs emitted {n_dvs} DVS events", file=sys.stderr)
        _mark("dvs_roundtrip")
    else:
        _skipped("reconstruction, compression and adder_to_dvs",
                 f"input file {_NYC} is absent")

    mono = _device_loop(jax, jnp, ops, 1080, 1920, 1, n_chunks=4, T=16)
    _emit("framed_to_adder_1080p_mono_device", mono, "Mpx/s")
    _mark("mono")
    _emit_trailing_summary("framed_to_adder_1080p_mono_device")


if __name__ == "__main__":
    sys.exit(main())
