"""Runtime configuration: the device-path choice and the persistent XLA
compilation cache.

The transcode interval graph is large (DEPTH-unrolled arena walk with
exact-rounding division); XLA's first compilation of it takes seconds to
tens of seconds on each backend. A persistent compilation cache makes every
process after the first start warm. Configured on package import: the cache
lives where JAX_COMPILATION_CACHE_DIR says when it is set (JAX reads that
variable itself), and otherwise at the fixed in-checkout path
`.cache/xla_<host key>`.
"""

from __future__ import annotations

import os
import pathlib

_configured = False

# Platforms whose devices run the XLA paths: "gpu" in deployment, "cpu" for
# the tests and the multi-device dry runs on virtual CPU devices.
SUPPORTED_PLATFORMS = ("gpu", "cpu")


def device_path(platform: str | None = None) -> str:
    """The device path for `platform` (default: JAX's default backend).

    Every supported platform runs the plain XLA paths (the framed chunk
    scan, the DVS lane scan, the device framer); any other platform is an
    error, never a silent fallback."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    if platform not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}: adder_jax runs on "
            f"{' or '.join(SUPPORTED_PLATFORMS)}"
        )
    return "xla"


def host_cache_key() -> str:
    """Short key identifying the host CPU model.

    XLA:CPU AOT executables cached on one machine load on another with
    mismatched feature sets ("could lead to execution errors such as
    SIGILL") and were observed to produce 1-ulp-different division results,
    breaking bit-parity. Scoping the cache directory per host model avoids
    reusing foreign executables."""
    import hashlib
    import platform
    import re

    model = platform.processor() or platform.machine() or "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            info = f.read()
        m = re.search(r"model name\s*:\s*(.+)", info)
        if m:
            model = m.group(1)
        # Same model name does not imply same ISA surface (VMs mask
        # features); foreign AOT executables warn "could lead to
        # execution errors such as SIGILL". Key by the flag set too.
        f = re.search(r"flags\s*:\s*(.+)", info)
        if f:
            model += "|" + " ".join(sorted(f.group(1).split()))
    except OSError:
        pass
    # Two VM shapes of the same CPU family can still report identical
    # model+flags while LLVM target tuning differs (observed: AOT entries
    # with +prefer-no-scatter/-gather loading on a host without them).
    # The core count separates the shapes.
    model += f"|ncpu={os.cpu_count()}"
    return hashlib.sha1(model.encode()).hexdigest()[:12]


def default_cache_dir() -> pathlib.Path:
    """The fixed in-checkout cache path used when JAX_COMPILATION_CACHE_DIR
    is not set (the path is part of the cache's key, so it never moves)."""
    return (
        pathlib.Path(__file__).resolve().parent.parent
        / ".cache"
        / f"xla_{host_cache_key()}"
    )


def process_map_count() -> int:
    """Number of memory mappings of this process (0 if unknowable)."""
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def bound_jit_mappings(threshold: int = 40_000) -> bool:
    """Drop JAX's in-process executable caches when the process nears the
    kernel's mapping limit; returns True when a purge happened.

    Every XLA:CPU executable holds several anonymous JIT-code mappings for
    the life of the process (JAX's global caches keep all of them alive).
    A process that compiles thousands of distinct programs — a long test
    session, a long-lived transcoding service crossing many capacity
    steps — runs into `vm.max_map_count` (default 65530), at which point
    the next mmap fails and LLVM SIGSEGVs mid-compile (diagnosed on a
    full-suite run: 60k+ anonymous mappings, deterministic crash in
    backend_compile_and_load). Re-compiles after a purge are mostly disk
    loads thanks to the persistent compilation cache."""
    if process_map_count() < threshold:
        return False
    import gc

    import jax

    jax.clear_caches()
    gc.collect()
    return True


def configure_compilation_cache() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        loc = default_cache_dir()
        try:
            loc.mkdir(parents=True, exist_ok=True)
        except OSError:
            return  # read-only checkout: run uncached
        jax.config.update("jax_compilation_cache_dir", str(loc))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
