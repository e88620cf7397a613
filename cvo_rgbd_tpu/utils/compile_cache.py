"""Where JAX keeps its persistent compilation cache.

One helper for every entry point (the CLI, chip_smoke.py, bench.py):
if `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and no other
location is set here.  Otherwise the cache goes to a fixed `.jax_cache`
directory at the root of the checkout (git-ignored): the path is part
of the cache key, so it is never derived from a temporary name, a pid
or the time.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its one location and
    return that path."""
    import jax

    path = os.environ.get(ENV)
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    return path


class CacheCounter:
    """Counts persistent-cache hits and misses of this process (JAX's
    own monitoring events)."""

    _HIT = "/jax/compilation_cache/cache_hits"
    _MISS = "/jax/compilation_cache/cache_misses"

    def __init__(self):
        import jax

        self.hits = 0
        self.misses = 0
        jax.monitoring.register_event_listener(self._on_event)

    def _on_event(self, event, **_):
        if event == self._HIT:
            self.hits += 1
        elif event == self._MISS:
            self.misses += 1
