"""A pytest plugin that keeps a test process under the operating system's
limit on memory mappings.

Every program the JAX package compiles for the CPU holds memory mappings
until JAX's caches are cleared: one insertion-wave build at a new shape,
metric or storage tier leaves about 4,300 of them, a bulk build about
5,000. A Linux process may hold ``vm.max_map_count`` mappings (65,530 by
default); the compilation that goes past it fails ("LLVM compilation
error: Cannot allocate memory") and aborts the interpreter inside
``backend_compile_and_load``. One worker that is handed some fifteen such
builds in a row gets there, and how many consecutive tests a worker is
handed grows with the number of tests collected.

The test files that run both packages name this module in
``pytest_plugins``, so it is registered in every process that collects
them, and its hook runs after every test of the session, whichever file
the test is in: above ``MAPS_HIGH_WATER`` mappings it drops the compiled
programs. A later test of the same shape compiles again, which costs
seconds; nothing else changes.
"""

import jax
import pytest

#: clear above this many mappings: far enough under the limit for the
#: largest test (≈ 10,000), and high enough that tests which share a
#: shape (most of a file) share its programs
MAPS_HIGH_WATER = 24_000


def mappings() -> int:
    """Memory mappings this process holds; ``MAPS_HIGH_WATER`` where there
    is no ``/proc`` to count them in, so that the caches are then cleared
    after every test."""
    try:
        with open("/proc/self/maps") as f:
            return sum(1 for _ in f)
    except OSError:
        return MAPS_HIGH_WATER


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    if mappings() >= MAPS_HIGH_WATER:
        jax.clear_caches()
