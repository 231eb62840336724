"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

The suite runs on the CPU; multi-device tests run against 8 virtual CPU
devices, the same way the multi-device dry run does. Must run before jax
is imported anywhere. Tests that need a GPU are marked `gpu` and skip
without one (on a card: `JAX_PLATFORMS=cuda,cpu pytest -m gpu tests/`).
"""

import os
import sys

# CLI tools launched as subprocesses by tests inherit this pin
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pathlib

import jax

# Pin the platforms by config as well, before any backend initialization,
# so the suite never lands on a device the environment did not name.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pytest

# importing the package configures the persistent compilation cache
# (runtime.configure_compilation_cache: JAX_COMPILATION_CACHE_DIR, or the
# in-checkout .cache/xla_<host key>), so repeat runs skip the compiles
import adder_jax  # noqa: F401,E402

REFERENCE_SAMPLES = pathlib.Path("/root/reference/adder-codec-rs/tests/samples")


@pytest.fixture(scope="session")
def samples_dir() -> pathlib.Path:
    if not REFERENCE_SAMPLES.is_dir():
        pytest.skip("reference sample fixtures unavailable")
    return REFERENCE_SAMPLES


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when the process has none.
    Decided here, at run time — never while the test module is imported."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu pytest -m gpu")
    return devices[0]


# One pytest process compiles thousands of distinct XLA programs; each live
# executable holds several anonymous JIT-code mappings, and the suite was
# observed to segfault (LLVM, inside backend_compile_and_load) when the
# process crossed vm.max_map_count (65530). Purge JAX's executable caches
# whenever the mapping count nears the limit; the persistent compilation
# cache turns the recompiles into disk loads.
from adder_jax.runtime import bound_jit_mappings  # noqa: E402


@pytest.fixture(autouse=True)
def _bound_process_mappings():
    yield
    bound_jit_mappings()
