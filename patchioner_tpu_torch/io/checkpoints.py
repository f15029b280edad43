"""Training checkpoints, and parameter trees as flat `.npz` files.

Twin of `patchioner_tpu/io/checkpoints.py`.

`CheckpointManager` keeps a training run's states, {params, opt_state,
step}, one directory a step (`<dir>/<step>/train_state.pt`, written by
`torch.save` under a temporary name and renamed), the last `max_to_keep`
of them, with `latest_step` and `restore` for resuming.
`load_decap_from_train_dir` and `load_mapper_from_train_dir` take the
params alone out of such a directory, checked against the config. The
JAX package's trainers write Orbax directories (a step holds
`_CHECKPOINT_METADATA` and `default/`); reading one needs orbax and jax,
which the port does not use, so they are refused with NotImplementedError.

`save_params_npz` / `load_params_npz`: each array is named by its path in
the tree as `jax.tree_util.keystr` writes it (`['blocks'][0]['qkv']['w']`, a
NamedTuple field as `.gpt2`), so a file either package writes loads in the
other.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["CheckpointManager", "load_decap_from_train_dir", "load_mapper_from_train_dir",
           "check_tree", "flatten_tree", "restore_into", "save_params_npz",
           "load_params_npz"]

_KEY = re.compile(r"\[(\d+)\]|\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\")\]|\.(\w+)")


def flatten_tree(tree, path: str = ""):
    """(keystr path, leaf) pairs, dict keys sorted as jax flattens them;
    None leaves (a linear without a bias) are skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_tree(tree[k], f"{path}[{k!r}]")
    elif hasattr(tree, "_fields"):  # a NamedTuple
        for k in tree._fields:
            yield from flatten_tree(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_tree(v, f"{path}[{i}]")
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
    for name, leaf in flatten_tree(params):
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


# ------------------------------------------------------------ train states

STATE_FILE = "train_state.pt"
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "default")


def _saveable(obj):
    """A train state as what `torch.load(weights_only=True)` reads back:
    an object with `state_dict` (an OptState) as that dict, a NamedTuple as
    a dict of its fields, tensors detached on the CPU."""
    if hasattr(obj, "state_dict"):
        return _saveable(obj.state_dict())
    if hasattr(obj, "_fields"):
        return {k: _saveable(v) for k, v in zip(obj._fields, obj)}
    if isinstance(obj, dict):
        return {k: _saveable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_saveable(v) for v in obj)
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    return obj


class CheckpointManager:
    """A training run's states under `directory`, one `<step>/` directory
    each: save, keep the last `max_to_keep`, find the latest, restore.
    A directory holding an Orbax step of the JAX package raises
    NotImplementedError."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> list:
        steps = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if not (name.isdigit() and os.path.isdir(path)):
                continue
            if os.path.exists(os.path.join(path, STATE_FILE)):
                steps.append(int(name))
            elif any(os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
                raise NotImplementedError(
                    f"{self.directory!r} holds an Orbax checkpoint (step {name}) of the JAX "
                    "package's trainers; reading one needs orbax and jax, which the port "
                    "does not use. Train with the port's CLIs, or export the params with "
                    "the JAX package's save_params_npz")
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> bool:
        """Write `state` as step `step`; a step not after the latest is
        skipped (False), as Orbax's manager skips it."""
        steps = self._steps()
        if steps and steps[-1] >= step:
            return False
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self.directory)
        try:
            torch.save(_saveable(state), os.path.join(tmp, STATE_FILE))
            os.replace(tmp, os.path.join(self.directory, str(step)))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in (steps + [step])[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """The saved state of `step` (default the latest) with CPU tensors,
        or None when the directory holds no step."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                          map_location="cpu", weights_only=True)


def check_tree(key: str, path: str, tree, template, config: str) -> None:
    """ValueError unless `tree` has the structure and shapes of `template`,
    the tree the config gives; the message names both."""

    def walk(got, want, at):
        if isinstance(want, dict):
            if not isinstance(got, dict) or sorted(got) != sorted(want):
                raise ValueError(
                    f"{key}={path!r}: {at or 'the tree'} holds "
                    f"{sorted(got) if isinstance(got, dict) else type(got).__name__} "
                    f"where the config ({config}) gives {sorted(want)}")
            for k in want:
                walk(got[k], want[k], f"{at}[{k!r}]")
        elif isinstance(want, (list, tuple)):
            if not isinstance(got, (list, tuple)) or len(got) != len(want):
                raise ValueError(
                    f"{key}={path!r}: {at} has "
                    f"{len(got) if isinstance(got, (list, tuple)) else 'no'} entries "
                    f"where the config ({config}) gives {len(want)}")
            for i, (g, w) in enumerate(zip(got, want)):
                walk(g, w, f"{at}[{i}]")
        elif want is None:  # a linear without a bias
            if got is not None:
                raise ValueError(f"{key}={path!r}: {at} is a tensor where the config "
                                 f"({config}) gives none")
        elif not torch.is_tensor(got) or got.shape != want.shape:
            shape = tuple(got.shape) if torch.is_tensor(got) else type(got).__name__
            raise ValueError(f"{key}={path!r}: {at} is {shape} where the "
                             f"config ({config}) gives {tuple(want.shape)}")

    walk(tree, template, "")


def _train_params(directory: str, step: Optional[int], what: str):
    state = CheckpointManager(directory).restore(step)
    if state is None:
        raise FileNotFoundError(f"no {what} training checkpoint steps under {directory!r}")
    if not isinstance(state, dict) or "params" not in state:
        raise ValueError(f"{directory!r} is not a {what} training checkpoint (no 'params')")
    return state["params"]


def load_decap_from_train_dir(directory: str, cfg, prefix_size: int,
                              step: Optional[int] = None):
    """The DeCap params (f32 CPU DecapParams) of a `train/cli.py`
    directory's step (default the latest), checked against the decoder's
    GPT2Config and the prefix width; the optimizer state is dropped.
    FileNotFoundError when the directory holds no step."""
    from patchioner_tpu_torch.models import decap, gpt2

    params = _train_params(directory, step, "decoder")
    template = {"gpt2": gpt2.param_template(cfg),
                "clip_project": {"w": torch.empty(prefix_size, cfg.n_embd, device="meta"),
                                 "b": torch.empty(cfg.n_embd, device="meta")}}
    check_tree("decap_weights", directory, params, template,
               f"n_layer {cfg.n_layer}, n_embd {cfg.n_embd}, vocab_size {cfg.vocab_size}, "
               f"n_positions {cfg.n_positions}, prefix_size {prefix_size}")
    return decap.DecapParams(**params)


def load_mapper_from_train_dir(directory: str, key: str, template, config: str,
                               step: Optional[int] = None) -> dict:
    """The mapper params (f32 CPU tree) of a `train/prefix_cli.py`
    directory's step (default the latest), checked against `template`, the
    tree the config gives (`config` describes it in the message, `key`
    names the config key)."""
    params = _train_params(directory, step, "prefix-mapper")
    check_tree(key, directory, params, template, config)
    return params


def _named(tree):
    """A NamedTuple as a dict of its fields, the way `CheckpointManager`
    saves it; the tensors themselves untouched."""
    if hasattr(tree, "_fields"):
        return {k: _named(v) for k, v in zip(tree._fields, tree)}
    if isinstance(tree, dict):
        return {k: _named(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_named(v) for v in tree]
    return tree


@torch.no_grad()
def restore_into(tree, saved) -> None:
    """Copy a restored state's params into the live tree's tensors, in
    place (so that an OptState over them stays valid); their paths and
    shapes must agree."""
    live = dict(flatten_tree(_named(tree)))
    got = dict(flatten_tree(_named(saved)))
    if live.keys() != got.keys():
        raise ValueError(f"the checkpoint's params {sorted(got)} are not the model's "
                         f"{sorted(live)}")
    for name, leaf in live.items():
        if leaf.shape != got[name].shape:
            raise ValueError(f"the checkpoint's {name} is {tuple(got[name].shape)}, the "
                             f"model's {tuple(leaf.shape)}")
        leaf.copy_(got[name])
