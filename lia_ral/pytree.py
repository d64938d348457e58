"""Immutable dataclasses registered as JAX pytrees.

Every field is a pytree child (array data); instances are frozen and
updated with ``.replace(**changes)``, so model and statistics containers
pass through ``jit``, ``vmap``, ``shard_map`` and ``jax.tree.map``.
"""

from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    """Frozen dataclass whose fields are all pytree children."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names,
                                            meta_fields=[])
