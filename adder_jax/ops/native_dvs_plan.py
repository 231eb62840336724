"""ctypes loader for the native DVS lane planners (ops/native/dvs_plan.cpp).

Built on demand with g++ (ops/native_build.py). Callers fall back to the
numpy reference planners in ops/dvs_batch.py when the toolchain is
unavailable or ADDER_NATIVE_DVS_PLAN=0. Both planners mutate the
caller's last_t / last_ln chain state in place (copy-back when the input
needed a contiguity/dtype conversion), exactly like the numpy twins.
"""

from __future__ import annotations

import ctypes
import threading
import numpy as np

from .native_build import load as _load_native

_lib = None
_lib_ready = False
_lib_lock = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)


def _get_lib():
    global _lib, _lib_ready
    if _lib_ready:
        return _lib
    with _lib_lock:
        if _lib_ready:
            return _lib
        lib = _load_native("dvs_plan", "ADDER_NATIVE_DVS_PLAN")
        if lib is not None:
            lib.adder_plan_dvs.restype = ctypes.c_long
            lib.adder_plan_dvs.argtypes = [
                _i64p, _i32p, _u8p, ctypes.c_long, ctypes.c_long,
                _u32p, _f64p, _f64p, ctypes.c_double, ctypes.c_double,
                _i32p, _i32p, _u8p, _i32p, _f32p, _f32p,
                _u8p, _i32p, _f32p, _f32p, _f32p, _i64p,
            ]
            lib.adder_plan_davis.restype = ctypes.c_long
            lib.adder_plan_davis.argtypes = [
                _i64p, _i32p, _u8p, ctypes.c_long, ctypes.c_long,
                _i64p, _f64p, _f64p, ctypes.c_double, ctypes.c_double,
                ctypes.c_double,
                _i32p, _i32p, _f32p, _f32p, _f32p, _i32p,
            ]
        _lib = lib
        _lib_ready = True
        return _lib


def _io_view(arr: np.ndarray, dtype) -> np.ndarray:
    """Contiguous view of `arr` as `dtype` for an in/out parameter; a copy
    if conversion is needed (caller copies back afterwards)."""
    return np.ascontiguousarray(arr, dtype=dtype)


def plan_dvs_native(ts, xs, ys, ps, width, last_t, last_ln, theta, ref,
                    val_cache=None):
    """Native plan_dvs_batch_compact. Returns a DvsCompact or None when
    the native library is unavailable. `val_cache` (f64 (N,), NaN = not
    cached) memoizes exp(last_ln) between events AND between windows —
    the caller owns it alongside last_ln; a fresh NaN array is used when
    not provided (still halves the in-window exp count)."""
    lib = _get_lib()
    if lib is None:
        return None
    from .dvs_batch import DvsCompact

    n_ev = len(ts)
    t64 = np.ascontiguousarray(ts, dtype=np.int64)
    pix = np.ascontiguousarray(
        np.asarray(ys, dtype=np.int64) * width + np.asarray(xs, dtype=np.int64),
        dtype=np.int32,
    )
    pol = np.ascontiguousarray(np.asarray(ps) != 0, dtype=np.uint8)
    lt = _io_view(last_t, np.uint32)
    ln = _io_view(last_ln, np.float64)
    if val_cache is None:
        val_cache = np.full(len(ln), np.nan, np.float64)

    out_pix = np.empty(n_ev, np.int32)
    out_lane = np.empty(n_ev, np.int32)
    out_gon = np.empty(n_ev, np.uint8)
    out_gfv = np.empty(n_ev, np.int32)
    out_gint = np.empty(n_ev, np.float32)
    out_gtime = np.empty(n_ev, np.float32)
    out_ton = np.empty(n_ev, np.uint8)
    out_tfv = np.empty(n_ev, np.int32)
    out_tint = np.empty(n_ev, np.float32)
    out_ttime = np.empty(n_ev, np.float32)
    out_gval = np.empty(n_ev, np.float32)
    out_gn = np.empty(n_ev, np.int64)
    rows = lib.adder_plan_dvs(
        t64.ctypes.data_as(_i64p), pix.ctypes.data_as(_i32p),
        pol.ctypes.data_as(_u8p), ctypes.c_long(n_ev),
        ctypes.c_long(len(lt)),
        lt.ctypes.data_as(_u32p), ln.ctypes.data_as(_f64p),
        val_cache.ctypes.data_as(_f64p),
        ctypes.c_double(theta), ctypes.c_double(ref),
        out_pix.ctypes.data_as(_i32p), out_lane.ctypes.data_as(_i32p),
        out_gon.ctypes.data_as(_u8p), out_gfv.ctypes.data_as(_i32p),
        out_gint.ctypes.data_as(_f32p), out_gtime.ctypes.data_as(_f32p),
        out_ton.ctypes.data_as(_u8p), out_tfv.ctypes.data_as(_i32p),
        out_tint.ctypes.data_as(_f32p), out_ttime.ctypes.data_as(_f32p),
        out_gval.ctypes.data_as(_f32p), out_gn.ctypes.data_as(_i64p),
    )
    if rows < 0:
        raise ValueError("adder_plan_dvs: pixel index out of range")
    if lt is not last_t:
        last_t[...] = lt
    if ln is not last_ln:
        last_ln[...] = ln
    r = int(rows)
    return DvsCompact(
        out_pix[:r], out_lane[:r], out_gon[:r].view(bool), out_gfv[:r],
        out_gint[:r], out_gtime[:r], out_ton[:r].view(bool), out_tfv[:r],
        out_tint[:r], out_ttime[:r], out_gval[:r], out_gn[:r],
    )


def plan_davis_native(
    ts, xs, ys, ons, width, last_t, last_ln, dvs_c, ref, ticks_per_micro,
    val_cache=None,
):
    """Native plan_davis_events_compact. Returns a DavisCompact or None
    when the native library is unavailable. `val_cache` as in
    plan_dvs_native."""
    lib = _get_lib()
    if lib is None:
        return None
    from .dvs_batch import DavisCompact

    n_ev = len(ts)
    t64 = np.ascontiguousarray(ts, dtype=np.int64)
    pix = np.ascontiguousarray(
        np.asarray(ys, dtype=np.int64) * width + np.asarray(xs, dtype=np.int64),
        dtype=np.int32,
    )
    onb = np.ascontiguousarray(np.asarray(ons) != 0, dtype=np.uint8)
    lt = _io_view(last_t, np.int64)
    ln = _io_view(last_ln, np.float64)
    if val_cache is None:
        val_cache = np.full(len(ln), np.nan, np.float64)

    out_pix = np.empty(n_ev, np.int32)
    out_lane = np.empty(n_ev, np.int32)
    out_fi = np.empty(n_ev, np.float32)
    out_dt = np.empty(n_ev, np.float32)
    out_fv = np.empty(n_ev, np.float32)
    out_fv8 = np.empty(n_ev, np.int32)
    rows = lib.adder_plan_davis(
        t64.ctypes.data_as(_i64p), pix.ctypes.data_as(_i32p),
        onb.ctypes.data_as(_u8p), ctypes.c_long(n_ev),
        ctypes.c_long(len(lt)),
        lt.ctypes.data_as(_i64p), ln.ctypes.data_as(_f64p),
        val_cache.ctypes.data_as(_f64p),
        ctypes.c_double(dvs_c), ctypes.c_double(ref),
        ctypes.c_double(ticks_per_micro),
        out_pix.ctypes.data_as(_i32p), out_lane.ctypes.data_as(_i32p),
        out_fi.ctypes.data_as(_f32p), out_dt.ctypes.data_as(_f32p),
        out_fv.ctypes.data_as(_f32p), out_fv8.ctypes.data_as(_i32p),
    )
    if rows < 0:
        raise ValueError("adder_plan_davis: pixel index out of range")
    if lt is not last_t:
        last_t[...] = lt
    if ln is not last_ln:
        last_ln[...] = ln
    r = int(rows)
    return DavisCompact(
        out_pix[:r], out_lane[:r], np.ones(r, bool), out_fi[:r],
        out_dt[:r], out_fv[:r], out_fv8[:r],
    )
