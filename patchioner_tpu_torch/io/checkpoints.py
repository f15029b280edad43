"""Parameter trees as flat `.npz` files.

Twin of `save_params_npz` / `load_params_npz` of
`patchioner_tpu/io/checkpoints.py`: each array is named by its path in the
tree as `jax.tree_util.keystr` writes it (`['blocks'][0]['qkv']['w']`, a
NamedTuple field as `.gpt2`), so a file either package writes loads in the
other. The Orbax training directories of that module are not ported.
"""

from __future__ import annotations

import os
import re
from typing import Any

import numpy as np
import torch

__all__ = ["save_params_npz", "load_params_npz"]

_KEY = re.compile(r"\[(\d+)\]|\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\")\]|\.(\w+)")


def _flatten(tree, path: str = ""):
    """(keystr path, leaf) pairs, dict keys sorted as jax flattens them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif hasattr(tree, "_fields"):  # a NamedTuple
        for k in tree._fields:
            yield from _flatten(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _parse(path: str) -> list:
    """A keystr path as its keys: ints for sequence indices, strings else."""
    keys, pos = [], 0
    for m in _KEY.finditer(path):
        if m.start() != pos:
            raise ValueError(f"cannot read the tree path {path!r}")
        index, key, attr = m.groups()
        keys.append(int(index) if index is not None else
                    attr if attr is not None else key[1:-1])
        pos = m.end()
    if pos != len(path) or not keys:
        raise ValueError(f"cannot read the tree path {path!r}")
    return keys


def _lists(node):
    """Nested dicts whose keys are all the indices 0..n-1 as lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"sequence indices {sorted(node)} are not 0..{len(node) - 1}")
        return [node[i] for i in range(len(node))]
    return node


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V":  # np.savez writes a bfloat16 array as raw bytes
        raise ValueError(f"an array of raw dtype {a.dtype} (a bf16 array saved by JAX) "
                         "cannot be read; save the tree in f32")
    return torch.from_numpy(np.array(a))


def save_params_npz(path: str, params: Any) -> None:
    """Every tensor or array of `params` (nested dicts, lists, tuples and
    NamedTuples) into one `.npz`; bf16 tensors are widened to f32, exactly.
    An extension-less path gets '.npz', as np.savez gives it."""
    arrays = {}
    for name, leaf in _flatten(params):
        if torch.is_tensor(leaf):
            leaf = leaf.detach().cpu()
            leaf = (leaf.float() if leaf.dtype == torch.bfloat16 else leaf).numpy()
        arrays[name] = np.asarray(leaf)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez(path, **arrays)


def load_params_npz(path: str) -> Any:
    """The tree of CPU tensors a `save_params_npz` file holds (either
    package's), its structure read from the names: dicts, and lists where
    the keys are indices; a NamedTuple's fields come back as a dict's
    keys. The JAX twin takes a template instead; the caller checks the
    tree's shapes (as `Patchioner.from_config` does)."""
    if not path.endswith(".npz") and not os.path.exists(path):
        path += ".npz"
    root: dict = {}
    with np.load(path) as data:
        for name in data.files:
            *parents, last = _parse(name)
            node = root
            for k in parents:
                node = node.setdefault(k, {})
            node[last] = _tensor(data[name])
    return _lists(root)
