"""The framed device path: ops.make_transcode_chunk and the Video logic
around it (slot packing, capacity and pack-lane reruns, state carried
across chunks), the device-path choice and the compilation-cache rule.

The plain reference here is one jitted `integrate_interval` per interval
with the events compacted on the host in (pixel, slot) order — the
reference's single-thread order."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from adder_jax import runtime
from adder_jax.codec.encoder import EncoderOptions, EncoderType
from adder_jax.core.types import (
    Mode, PixelMultiMode, PlaneSize, SourceCamera, TimeMode,
)
from adder_jax.ops import integrate as ops
from adder_jax.transcoder import video as video_mod
from adder_jax.transcoder.video import Video

N = 512
T = 3


def _frames(rng, t=T, n=N):
    # random content plus a static quarter (pixel-intervals with no events)
    frames = rng.integers(0, 256, (t, n)).astype(np.uint8)
    frames[:, : n // 4] = 128
    return frames


def _state0(frames):
    return ops.set_initial_d(
        ops.init_state(frames.shape[1]),
        jnp.asarray(frames[0].astype(np.int32)),
    )


def _run_chunk(p, frames, pack, state=None, cap=None):
    n = frames.shape[1]
    cap = cap or ops.K_SLOTS * n * len(frames)
    fn = ops.make_transcode_chunk(p, cap, pack)
    state = _state0(frames) if state is None else state
    return fn(state, jnp.asarray(frames), jnp.float32(p.ref_time),
              jnp.zeros((n,), jnp.uint8))


def _reference(p, frames, state=None):
    """Interval-by-interval reference: (pixd, t, per_interval, max events
    per pixel-interval, final state, running frames)."""
    step = jax.jit(
        lambda st, f: ops.integrate_interval(
            st, f.astype(jnp.float32), f.astype(jnp.int32),
            jnp.float32(p.ref_time), p,
        )
    )
    st = _state0(frames) if state is None else state
    run = np.zeros(frames.shape[1], np.uint8)
    pixd, ts, per, runs, most = [], [], [], [], 0
    for f in frames:
        st, sd, stt, sm, (rval, rhas) = step(st, jnp.asarray(f))
        sd, stt, sm = np.asarray(sd), np.asarray(stt), np.asarray(sm)
        pix, slot = np.nonzero(sm.T)  # (pixel, slot)-major
        pixd.append((pix.astype(np.uint32) << 8) | (sd[slot, pix] & 0xFF))
        ts.append(stt[slot, pix])
        per.append(len(pix))
        most = max(most, int(sm.sum(axis=0).max()))
        run = np.where(np.asarray(rhas), np.asarray(rval), run)
        runs.append(run)
    return (np.concatenate(pixd).astype(np.uint32), np.concatenate(ts),
            np.array(per), most, st, np.stack(runs))


def _assert_chunk_matches(out, ref):
    st, pixd, t, _, _, _, total, per_int, runnings, _ = out
    r_pixd, r_t, r_per, _, r_st, r_runs = ref
    total = int(total)
    assert total == len(r_pixd) > 0
    np.testing.assert_array_equal(np.asarray(per_int), r_per)
    np.testing.assert_array_equal(np.asarray(pixd[:total]), r_pixd)
    np.testing.assert_array_equal(np.asarray(t[:total]), r_t)
    np.testing.assert_array_equal(np.asarray(runnings), r_runs)
    for a, b in zip(st, r_st):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


MODES = [
    (Mode.FramePerfect, PixelMultiMode.Collapse, TimeMode.AbsoluteT),
    (Mode.FramePerfect, PixelMultiMode.Collapse, TimeMode.DeltaT),
    (Mode.Continuous, PixelMultiMode.Collapse, TimeMode.AbsoluteT),
]


@pytest.mark.parametrize("mode,multi,tm", MODES,
                         ids=lambda v: getattr(v, "name", str(v)))
def test_chunk_matches_interval_steps(mode, multi, tm):
    p = ops.TranscodeParams(
        mode=int(mode), multi_mode=int(multi), time_mode=int(tm),
        ref_time=255, delta_t_max=255 * 4,
    )
    frames = _frames(np.random.default_rng(7))
    _assert_chunk_matches(_run_chunk(p, frames, 4), _reference(p, frames))


# Continuous/Normal at dtm == ref emits up to 3 events per pixel-interval
# on random content: 2 packed lanes overflow, 4 and K_SLOTS hold them all
_MULTI = ops.TranscodeParams(
    mode=int(Mode.Continuous), multi_mode=int(PixelMultiMode.Normal),
    ref_time=255, delta_t_max=255,
)


@pytest.mark.parametrize("pack", [2, 4, ops.K_SLOTS])
def test_chunk_pack_lanes(pack):
    frames = np.random.default_rng(5).integers(0, 256, (T, N)).astype(np.uint8)
    ref = _reference(_MULTI, frames)
    out = _run_chunk(_MULTI, frames, pack)
    most = ref[3]
    assert most > 2, "the content must put 3+ events in a pixel-interval"
    if pack < ops.K_SLOTS:
        # packing reports the per-pixel maximum, so overflow is detectable
        assert int(out[9]) == most
    if pack >= most:
        _assert_chunk_matches(out, ref)


def test_chunk_state_carry_across_chunks():
    """Two chained chunks == one chunk over the same intervals."""
    p = ops.TranscodeParams(ref_time=255, delta_t_max=255 * 4)
    frames = _frames(np.random.default_rng(13), t=2 * T)
    ref = _reference(p, frames)
    a = _run_chunk(p, frames[:T], 4)
    b = _run_chunk(p, frames[T:], 4, state=a[0])
    ta, tb = int(a[6]), int(b[6])
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(a[1][:ta]), np.asarray(b[1][:tb])]), ref[0]
    )
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(a[2][:ta]), np.asarray(b[2][:tb])]), ref[1]
    )
    for x, y in zip(b[0], ref[4]):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("t_len", [1, 8])
def test_chunk_lengths(t_len):
    """A single-interval chunk and a long one, both starting from a state
    two intervals in (so even one interval pops events)."""
    p = ops.TranscodeParams(ref_time=255, delta_t_max=255 * 4)
    frames = _frames(np.random.default_rng(19), t=t_len + 2)
    st = _reference(p, frames[:2])[4]
    _assert_chunk_matches(
        _run_chunk(p, frames[2:], 4, state=st), _reference(p, frames[2:], st)
    )


def _video_events(frames, mode, dtm, configure=None, chunk=3):
    plane = PlaneSize(frames.shape[2], frames.shape[1], 1)
    v = Video(plane, mode)
    v.time_parameters(255 * 30, 255, dtm, TimeMode.AbsoluteT)
    out = io.BytesIO()
    v.write_out(
        SourceCamera.FramedU8, TimeMode.AbsoluteT, PixelMultiMode.Normal,
        None, EncoderType.Raw, EncoderOptions.default(plane), out,
    )
    if configure:
        configure(v)
    for i in range(0, len(frames), chunk):
        v.integrate_matrix_batch(frames[i:i + chunk, ..., None])
    v.end_write_stream()
    return v, out.getvalue()


def test_video_capacity_overflow_rerun(monkeypatch):
    """A chunk whose events overflow the N*T starting capacity is re-run
    from the pre-chunk state with a doubled cap; the stream is exact."""
    frames = np.random.default_rng(3).integers(
        0, 256, (6, 16, 32)).astype(np.uint8)
    _, want = _video_events(frames, Mode.Continuous, 255 * 2)
    monkeypatch.setattr(video_mod, "FULL_CAP_MAX_PX", 0)
    v, got = _video_events(frames, Mode.Continuous, 255 * 2)
    assert v._cap_mult > 1, "the starting capacity must have overflowed"
    assert got == want


def test_video_pack_overflow_rerun():
    """A pixel with more events than the packed lanes forces the lossless
    K_SLOTS graph; the rerun recovers the exact stream."""
    frames = np.random.default_rng(5).integers(
        0, 256, (6, 16, 32)).astype(np.uint8)
    _, want = _video_events(
        frames, Mode.Continuous, 255,
        configure=lambda v: setattr(v, "_pack", ops.K_SLOTS),
    )
    v, got = _video_events(
        frames, Mode.Continuous, 255,
        configure=lambda v: setattr(v, "_pack", 2),
    )
    assert v._pack == ops.K_SLOTS
    assert got == want


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_device_path_runs_xla(platform):
    assert runtime.device_path(platform) == "xla"


@pytest.mark.parametrize("platform", ["metal", "neuron"])
def test_device_path_refuses_other_platforms(platform):
    with pytest.raises(RuntimeError, match=platform):
        runtime.device_path(platform)


_CACHE_PROBE = """
import jax, jax.numpy as jnp, numpy as np
import adder_jax
from adder_jax import runtime
from adder_jax.ops import integrate as ops
# cache even a fast compile, so an entry lands on any machine
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
n, T = 256, 2
p = ops.TranscodeParams()
fn = ops.make_transcode_chunk(p, ops.K_SLOTS * n * T, 4)
fn(ops.init_state(n), jnp.zeros((T, n), jnp.uint8), jnp.float32(255.0),
   jnp.zeros((n,), jnp.uint8))[6].block_until_ready()
print(jax.config.jax_compilation_cache_dir)
print(runtime.default_cache_dir())
"""


@pytest.mark.parametrize("env_set", [True, False], ids=["env", "default"])
def test_compilation_cache_location(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is where the entries land and
    the program sets no other directory; otherwise the cache is the fixed
    in-checkout path .cache/xla_<host key>."""
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-c", _CACHE_PROBE], env=env, cwd=repo,
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    used, default = r.stdout.split()[-2:]
    assert default == os.path.join(
        repo, ".cache", f"xla_{runtime.host_cache_key()}"
    )
    if env_set:
        assert used == str(tmp_path)
        assert any(tmp_path.iterdir()), "no cache entry landed there"
    else:
        assert used == default


@pytest.mark.gpu
def test_chunk_gpu_matches_cpu(gpu_device):
    """The compiled GPU chunk is byte-identical to the CPU chunk."""
    p = ops.TranscodeParams(
        mode=int(Mode.Continuous), ref_time=255, delta_t_max=255 * 4,
    )
    frames = _frames(np.random.default_rng(29), t=4, n=1 << 16)
    outs = []
    for dev in (gpu_device, jax.devices("cpu")[0]):
        with jax.default_device(dev):
            out = _run_chunk(p, frames, 4)
            total = int(out[6])
            outs.append((np.asarray(out[1][:total]), np.asarray(out[2][:total])))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
