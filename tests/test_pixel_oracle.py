"""Pixel-tree oracle golden tests.

Transliterated expectations from the reference's unit suite
(ref: adder-codec-rs/src/transcoder/event_pixel_tree.rs:534-1259), including
the MMSys'23 paper example. These pin the oracle to the reference semantics;
the JAX kernel is then pinned to the oracle.
"""

import numpy as np
import pytest

from adder_jax.core.types import (
    Coord,
    D_EMPTY,
    Mode,
    PixelMultiMode,
    TimeMode,
)
from adder_jax.transcoder.pixel_oracle import PixelArena

C = Coord(0, 0, None)
CONT = Mode.Continuous
FP = Mode.FramePerfect
NORMAL = PixelMultiMode.Normal


def integ(tree, intensity, time, mode, dtm, ref_time):
    tree.integrate(intensity, time, mode, dtm, ref_time, 0, 255, NORMAL)


def f32_eq(a, b, tol=1.2e-7 * 4):
    return abs(float(a) - float(b)) <= max(abs(float(b)), 1.0) * tol


def make_tree():
    """ref: event_pixel_tree.rs:541-639"""
    dtm = 10_000
    tree = PixelArena(100.0, C)
    tree.set_time_mode(TimeMode.DeltaT)

    assert tree.arena[0].d == 6
    integ(tree, 100.0, 20.0, CONT, dtm, 20)
    assert tree.arena[0].best_d == 6
    assert int(tree.arena[0].best_dt) == 12
    assert tree.arena[0].d == 7
    assert f32_eq(tree.arena[0].integration, 100.0)
    assert f32_eq(tree.arena[0].delta_t, 20.0)
    assert tree.arena[0].alt

    node = tree.arena[1]
    assert node.best_d is None
    assert node.d == 6
    assert node.integration == 36.0
    assert f32_eq(node.delta_t, 7.2)

    integ(tree, 100.0, 20.0, CONT, dtm, 20)
    assert tree.arena[0].best_d == 7
    assert f32_eq(tree.arena[0].best_dt, 25.6)
    assert tree.arena[0].d == 8
    assert f32_eq(tree.arena[0].integration, 200.0)
    assert f32_eq(tree.arena[0].delta_t, 40.0)
    assert tree.arena[1].d == 7
    assert f32_eq(tree.arena[1].integration, 72.0)
    assert f32_eq(tree.arena[1].delta_t, 14.4)
    assert tree.arena[1].best_d == 6
    assert f32_eq(tree.arena[1].best_dt, 12.8)
    assert tree.arena[1].alt
    alt_alt = tree.arena[2]
    assert alt_alt.d == 6
    assert alt_alt.best_d is None
    assert not alt_alt.alt
    assert f32_eq(alt_alt.integration, 8.0)
    assert abs(float(alt_alt.delta_t) - 1.6) < 0.2e-4
    return tree


def make_tree2():
    """ref: event_pixel_tree.rs:641-709"""
    dtm = 10_000
    tree = make_tree()
    integ(tree, 30.0, 34.0, CONT, dtm, 34)

    root = tree.arena[0]
    assert root.d == 8
    assert f32_eq(root.integration, 230.0)
    assert f32_eq(root.delta_t, 74.0)
    assert tree.arena[1].d == 7
    assert f32_eq(tree.arena[1].integration, 102.0)
    assert f32_eq(tree.arena[1].delta_t, 48.4)
    assert tree.arena[2].d == 6
    assert f32_eq(tree.arena[2].integration, 38.0)
    assert f32_eq(tree.arena[2].delta_t, 35.6)

    integ(tree, 26.0, 34.0, CONT, dtm, 34)
    assert tree.arena[0].d == 9
    assert f32_eq(tree.arena[0].integration, 256.0)
    assert f32_eq(tree.arena[0].delta_t, 108.0)
    assert tree.arena[0].best_d == 8
    assert float(tree.arena[0].best_dt) == 108.0
    alt = tree.arena[1]
    assert alt.d == 4
    assert float(alt.integration) == 0.0
    assert float(alt.delta_t) == 0.0
    assert alt.best_d is None
    assert not alt.alt
    return tree


def test_make_tree():
    make_tree()


def test_make_tree2():
    make_tree2()


def test_pop_best_states():
    """ref: event_pixel_tree.rs:722-741"""
    tree = make_tree()
    events = []
    tree.pop_best_events(events, CONT, NORMAL, 20, 0.0)
    assert len(events) == 2
    assert events[0].d == 7
    assert events[0].t == 25
    assert events[1].d == 6
    assert events[1].t == 12
    assert tree.arena[0].d == 6
    assert f32_eq(tree.arena[0].integration, 8.0)
    assert abs(float(tree.arena[0].delta_t) - 1.6) < 0.2e-4


def test_pop_best_states2():
    """ref: event_pixel_tree.rs:744-755"""
    tree = make_tree2()
    events = []
    tree.pop_best_events(events, CONT, NORMAL, 34, 0.0)
    assert len(events) == 1
    assert events[0].d == 8
    assert events[0].t == 108
    assert tree.arena[0].d == 4
    assert float(tree.arena[0].integration) == 0.0
    assert float(tree.arena[0].delta_t) == 0.0


def test_d_max():
    """ref: event_pixel_tree.rs:758-794"""
    dtm = 100_000_000
    big = float(1 << 126)
    tree = PixelArena(big, C)
    tree.set_time_mode(TimeMode.DeltaT)
    tree.integrate(big + 5.0, 100_000.0, CONT, dtm, 100_000, 0, 255, NORMAL)
    assert tree.need_to_pop_top
    events = []
    tree.pop_best_events(events, CONT, NORMAL, 100_000, 0.0)
    assert not tree.need_to_pop_top
    assert len(events) == 1
    assert events[0].d == 126
    assert events[0].t == 100_000
    assert float(tree.arena[0].integration) == 0.0


def test_dtm():
    """ref: event_pixel_tree.rs:797-834"""
    dtm = 240_000
    tree = PixelArena(245.0, C)
    tree.set_time_mode(TimeMode.DeltaT)
    for _ in range(48):
        integ(tree, 245.0, 5_000.0, FP, dtm, 5_000)
    assert tree.need_to_pop_top
    tree.pop_top_event(245.0, FP, 5_000)
    assert not tree.need_to_pop_top
    assert float(tree.arena[0].delta_t) == 70_000.0


def test_new_dtm():
    """dtm = max time to FIRST event at new intensity (ref: :837-925)."""
    dtm = 2_000
    tree = PixelArena(245.0, C)
    tree.set_time_mode(TimeMode.DeltaT)
    integ(tree, 245.0, 1_000.0, FP, dtm, 5_000)
    assert not tree.need_to_pop_top
    integ(tree, 245.0, 1_000.0, FP, dtm, 5_000)
    assert tree.need_to_pop_top

    tree.pop_top_event(245.0, FP, 5_000)
    assert not tree.need_to_pop_top

    for _ in range(48):
        integ(tree, 245.0, 1_000.0, FP, dtm, 5_000)
    assert not tree.need_to_pop_top
    assert float(tree.arena[0].delta_t) == 48_000.0

    tree.pop_best_events([], FP, PixelMultiMode.Collapse, 5_000, 0.0)
    integ(tree, 600.0, 3_000.0, FP, dtm, 5_000)
    assert tree.need_to_pop_top


def test_big_integration():
    """ref: event_pixel_tree.rs:928-966"""
    dtm = 1_000_000
    tree = PixelArena(146.0, C)
    integ(tree, 146.0, 2_000.0, CONT, dtm, 2_000)
    integ(tree, 2_790.863, 38_231.0, CONT, dtm, 38_231)
    head = tree.arena[0]
    assert float(head.integration) == float(np.float32(2790.863) + np.float32(146.0))
    assert float(head.delta_t) == 38_231.0 + 2_000.0
    assert head.best_d == head.d - 1


def test_big_integration2():
    """ref: event_pixel_tree.rs:969-1003"""
    dtm = 10_000_000
    tree = PixelArena(255.0, C)
    while True:
        integ(tree, 255.0, 2_000.0, CONT, dtm, 2_000)
        if tree.need_to_pop_top:
            break
    head = tree.arena[0]
    assert float(head.integration) == 1.275e6
    assert float(head.delta_t) == float(dtm)
    assert head.best_d == head.d - 1


def test_paper_example():
    """MMSys'23 paper example (ref: event_pixel_tree.rs:1021-1060)."""
    dtm = 10_000
    tree = PixelArena(101.0, C)
    assert tree.arena[0].d == 6
    integ(tree, 101.0, 20.0, CONT, dtm, 20)
    assert tree.arena[0].best_d is not None
    integ(tree, 40.0, 30.0, CONT, dtm, 30)
    assert tree.arena[0].best_d == 7
    assert f32_eq(tree.arena[1].delta_t, 9.75)


def test_absolute_mode_1():
    """ref: event_pixel_tree.rs:1063-1126"""
    dtm = 10_000
    tree = PixelArena(101.0, C)
    tree.set_time_mode(TimeMode.AbsoluteT)
    assert tree.arena[0].d == 6
    integ(tree, 101.0, 20.0, CONT, dtm, 20)
    assert tree.arena[0].best_d is not None
    integ(tree, 40.0, 30.0, CONT, dtm, 30)
    integ(tree, 140.0, 30.0, CONT, dtm, 30)
    integ(tree, 103.0, 30.0, CONT, dtm, 30)
    events = []
    tree.pop_best_events(events, CONT, PixelMultiMode.Collapse, 30, 0.0)
    assert events[0].d == 8
    assert events[0].t == 74
    assert events[1].d == 7
    assert events[1].t == 110


def test_set_d_continuous_delta():
    """ref: event_pixel_tree.rs:1129-1192"""
    dtm = 10_000
    tree = PixelArena(101.0, C)
    tree.set_time_mode(TimeMode.DeltaT)
    integ(tree, 101.0, 20.0, CONT, dtm, 20)
    integ(tree, 40.0, 30.0, CONT, dtm, 30)
    integ(tree, 140.0, 30.0, CONT, dtm, 30)
    integ(tree, 107.0, 30.0, CONT, dtm, 30)
    events = []
    tree.pop_best_events(events, CONT, PixelMultiMode.Collapse, 30, 0.0)
    ev = tree.set_d_for_continuous(10.0, 30)
    assert ev is not None
    assert ev.t == 1
    assert ev.d == 255


def test_set_d_continuous_absolute():
    """ref: event_pixel_tree.rs:1195-1258"""
    dtm = 10_000
    tree = PixelArena(101.0, C)
    tree.set_time_mode(TimeMode.AbsoluteT)
    integ(tree, 101.0, 20.0, CONT, dtm, 20)
    integ(tree, 40.0, 30.0, CONT, dtm, 30)
    integ(tree, 140.0, 30.0, CONT, dtm, 30)
    integ(tree, 107.0, 30.0, CONT, dtm, 30)
    events = []
    tree.pop_best_events(events, CONT, PixelMultiMode.Collapse, 30, 0.0)
    ev = tree.set_d_for_continuous(10.0, 30)
    assert ev is not None
    assert ev.t == 110
    assert ev.d == 255
