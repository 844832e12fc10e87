"""Pytree dataclass helper.

The reference framework passes scene/camera state through C++ objects
(``include/raytracer/RayTracer.h:64-576``). The equivalent here is a JAX
pytree: every field is a jnp array so the whole structure can cross ``jit``,
``grad``, ``shard_map`` and ``scan`` boundaries and be differentiated.
"""

from __future__ import annotations

import dataclasses
from typing import TypeVar

import jax

_T = TypeVar("_T")


def pytree_dataclass(cls: type[_T]) -> type[_T]:
    """Frozen dataclass registered as a JAX pytree (all fields are children)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    return cls


def static_dataclass(cls: type[_T]) -> type[_T]:
    """Frozen hashable dataclass for static (non-traced) configuration."""
    return dataclasses.dataclass(frozen=True)(cls)
