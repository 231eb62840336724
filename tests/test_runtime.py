"""Runtime utilities: host cache key and the JIT-mapping guard
(runtime.bound_jit_mappings — the fix for the vm.max_map_count suite
segfault)."""

import numpy as np

from adder_jax import runtime


def test_process_map_count_positive():
    n = runtime.process_map_count()
    assert n > 0  # /proc/self/maps readable on this platform


def test_bound_jit_mappings_below_threshold_noop():
    n = runtime.process_map_count()
    assert runtime.bound_jit_mappings(threshold=n + 10_000) is False


def test_bound_jit_mappings_purges_above_threshold():
    import jax
    import jax.numpy as jnp

    # materialize at least one cached executable so the purge has work
    jax.jit(lambda x: x * 2 + 1)(jnp.ones(8)).block_until_ready()
    assert runtime.bound_jit_mappings(threshold=1) is True
    # caches were dropped; recompiles still work afterwards
    out = jax.jit(lambda x: x * 3)(jnp.ones(8))
    np.testing.assert_array_equal(np.asarray(out), np.full(8, 3.0))


def test_host_cache_key_stable_and_core_count_sensitive():
    a = runtime.host_cache_key()
    assert a == runtime.host_cache_key()  # deterministic
    assert len(a) == 12
    int(a, 16)  # hex digest prefix
