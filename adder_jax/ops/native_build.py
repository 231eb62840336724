"""Shared on-demand g++ build + ctypes load for the ops/native/ helpers.

Same scheme as codec/compressed._build_library: sources compile into the
repo-local native cache (override with ADDER_NATIVE_CACHE) the first
time they are needed; callers fall back to the numpy reference paths when
the toolchain is unavailable or ADDER_NATIVE_<NAME>=0.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import Optional

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent / "native"
_libs: dict = {}
_lock = threading.Lock()


def _cache_dir() -> pathlib.Path:
    cache = pathlib.Path(
        os.environ.get(
            "ADDER_NATIVE_CACHE",
            str(pathlib.Path(__file__).resolve().parents[2] / ".cache" / "native"),
        )
    )
    cache.mkdir(parents=True, exist_ok=True)
    return cache


def _build(src_name: str) -> pathlib.Path:
    src = _NATIVE_DIR / f"{src_name}.cpp"
    so = _cache_dir() / f"libadder_{src_name}.so"
    if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
        tmp = so.with_suffix(".so.tmp")
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(src)],
            check=True,
            capture_output=True,
        )
        tmp.replace(so)
    return so


def load(src_name: str, env_gate: str) -> Optional[ctypes.CDLL]:
    """Build (if stale) and dlopen ops/native/<src_name>.cpp. Returns None
    when disabled via `env_gate`=0 or the build/load fails (cached)."""
    key = src_name
    if key in _libs:
        return _libs[key]
    with _lock:
        if key in _libs:
            return _libs[key]
        lib = None
        if os.environ.get(env_gate, "1") != "0":
            try:
                lib = ctypes.CDLL(str(_build(src_name)))
            except (OSError, subprocess.CalledProcessError):
                lib = None
        _libs[key] = lib
        return lib
