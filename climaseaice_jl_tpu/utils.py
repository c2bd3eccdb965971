"""Pytree dataclass helpers and small utilities.

The whole framework is built from immutable dataclasses registered as JAX
pytrees.  Configuration-like fields (ints, strings, enums, callables, nested
config objects that never hold device arrays) are marked ``static`` so they
become part of the treedef (and therefore of the jit cache key), while array
fields are traced leaves.

This replaces the reference's mutable-struct + multiple-dispatch architecture
(e.g. /root/reference/src/sea_ice_model.jl:22-51) with the idiomatic JAX
"config pytree + pure step function" shape.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
from dataclasses import field as _field

import jax
import numpy as np


def static_field(**kwargs):
    """A dataclass field excluded from the pytree leaves (part of treedef)."""
    metadata = dict(kwargs.pop("metadata", {}) or {})
    metadata["static"] = True
    return _field(metadata=metadata, **kwargs)


def pytree_dataclass(cls=None, **kwargs):
    """Decorator: freeze a dataclass and register it as a JAX pytree.

    Fields created with :func:`static_field` go into the treedef; all other
    fields are children.  Instances get an ``evolve(**updates)`` method for
    functional updates.
    """

    def wrap(cls):
        cls = dataclasses.dataclass(frozen=True, **kwargs)(cls)
        fields = dataclasses.fields(cls)
        data_names = tuple(f.name for f in fields if not f.metadata.get("static"))
        meta_names = tuple(f.name for f in fields if f.metadata.get("static"))

        jax.tree_util.register_dataclass(cls, list(data_names), list(meta_names))

        def evolve(self, **updates):
            return dataclasses.replace(self, **updates)

        cls.evolve = evolve
        return cls

    if cls is None:
        return wrap
    return wrap(cls)


def tupleify(x):
    """Normalize ``None`` / scalar / sequence into a tuple (tupleit analog)."""
    if x is None:
        return ()
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,)


def asdtype(x, dtype):
    """Convert a python scalar / numpy value to a numpy scalar of ``dtype``."""
    return np.asarray(x, dtype=dtype)[()]


def enable_compile_cache():
    """Point JAX's persistent compilation cache at ``$JAX_COMPILATION_CACHE_DIR``
    when set, else at ``.jax_cache`` in the repository root, and return the
    path.  The path is fixed, never temporary, so that later runs from the
    same checkout find what earlier ones compiled.  Called by the GPU entry
    scripts (``chip_smoke.py``, ``bench.py``), never at package import."""
    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_info():
    """``name, power.limit`` of every NVIDIA card, one line each, from
    ``nvidia-smi`` (a child process that never touches JAX)."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()
