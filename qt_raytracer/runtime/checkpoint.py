"""Pytree checkpoints as one numpy ``.npz`` file.

The progressive accumulator (app/progressive.py) and the inverse-rendering
train state (diff/inverse.py) are small pytrees of arrays. A checkpoint is
their flattened leaves plus the tree structure, written to a temporary file
and renamed over the target, so a reader never sees a half-written file.
Loading checks the saved structure against a template, so a state saved by
another optimizer or trainable set fails loudly instead of restoring into
the wrong slots.
"""

from __future__ import annotations

import io
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

_TREEDEF = "__treedef__"


def save_pytree(path, tree) -> None:
    """Atomically write ``tree``'s leaves and structure to ``path``."""
    path = pathlib.Path(path)
    leaves, treedef = jax.tree.flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays[_TREEDEF] = np.array(str(treedef))
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(buf.getvalue())
    os.replace(tmp, path)


def load_pytree(path, template):
    """Read a checkpoint written by save_pytree into ``template``'s structure
    (leaves come back as jax arrays)."""
    leaves, treedef = jax.tree.flatten(template)
    with np.load(pathlib.Path(path)) as data:
        saved = str(data[_TREEDEF])
        if saved != str(treedef):
            raise ValueError(
                f"checkpoint {path} holds a different pytree structure:\n"
                f"  saved:    {saved}\n  expected: {treedef}")
        restored = [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(leaves))]
    return jax.tree.unflatten(treedef, restored)
