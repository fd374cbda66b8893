"""Caches of the pipeline's device constants.

A device constant (the leaf layout, the tree's split tables, the M2L
matrix) is built on the host and copied to the device once per key. The
copy is a blocking host read, which a CUDA graph capture refuses, so
the pipeline must find every constant it reads already built. Each cache
is an LRU over a weak-valued registry: a constant lives as long as
anything holds it (a solver's compiled programs hold theirs), however
many other keys pass through the LRU in between.
"""
from __future__ import annotations

import functools
import weakref


def device_constant(maxsize: int):
    """Decorate ``build(*key)`` into a cached ``get(*key)``: an
    ``functools.lru_cache`` of ``maxsize`` in front of a weak-valued
    registry of every value still referenced."""
    def wrap(build):
        registry: weakref.WeakValueDictionary = weakref.WeakValueDictionary()

        @functools.lru_cache(maxsize=maxsize)
        @functools.wraps(build)
        def get(*key):
            value = registry.get(key)
            if value is None:
                value = registry[key] = build(*key)
            return value

        return get
    return wrap
