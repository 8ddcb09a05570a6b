"""Checkpoint I/O with {latest, step-tagged, best} retention (counterpart of
``speech2lip_tpu/core/checkpoint.py``), in the JAX package's format.

A checkpoint is one ``.npz``: every leaf of a tree under its flat path
key (components joined by '/': dict keys, list indices, NamedTuple field
names), plus a JSON header ``__scalars__`` (epoch_it, it, loss_val_best).
The keys are the JAX package's, so a checkpoint written by either package
loads in the other (``train_step.state_to_tree`` lays the port's
``TrainState`` out as the JAX one flattens).

Trees are nested dicts, lists, tuples and NamedTuples whose leaves are
tensors, numpy arrays or Python ints; ``None`` holds no leaf.  Loading
against a template is tolerant: missing keys keep the template's value,
unknown keys are ignored, a shape mismatch keeps the template's leaf.
"""

from __future__ import annotations

import datetime
import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _children(tree) -> Optional[Iterator[Tuple[str, Any]]]:
    """(path component, child) pairs of an inner node, None for a leaf."""
    if isinstance(tree, dict):
        return ((str(k), v) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return zip(tree._fields, tree)
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    return None


def flatten_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path key, leaf) pairs of ``tree`` in its own order."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for name, child in kids:
        yield from flatten_paths(child, prefix + _SEP + name if prefix
                                 else name)


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of one leaf; a Python int (the step counts) as int32,
    as the JAX package stores them."""
    if isinstance(leaf, torch.Tensor):
        return np.array(leaf.detach().cpu().numpy(), copy=True)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.array(leaf, copy=True)


def flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in flatten_paths(tree)}


def _save_flat(path: str, flat: Dict[str, np.ndarray],
               scalars: Optional[Dict[str, Any]]):
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, __scalars__=json.dumps(scalars or {}), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save(path: str, tree: Any, scalars: Optional[Dict[str, Any]] = None):
    """Atomically write ``tree`` (+ scalar header) to ``path`` (.npz)."""
    _save_flat(path, flatten(tree), scalars)


def _like(arr: np.ndarray, leaf):
    """``arr`` as the template leaf's type, dtype and device."""
    if isinstance(leaf, torch.Tensor):
        # (ascontiguousarray makes a 0-d array 1-d: keep the shape)
        return torch.from_numpy(np.ascontiguousarray(arr)).reshape(
            arr.shape).to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, int):
        return int(arr)
    return arr.astype(np.asarray(leaf).dtype)


def _rebuild(tree, flat: Dict[str, np.ndarray], prefix: str = ""):
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        arr = flat.get(prefix)
        if arr is None or tuple(arr.shape) != tuple(np.shape(tree)):
            return tree      # missing, or the architecture drifted
        return _like(arr, tree)
    new = [_rebuild(child, flat, prefix + _SEP + name if prefix else name)
           for name, child in kids]
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), new))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*new)
    return type(tree)(new)


def load(path: str, like: Any = None) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint.  With ``like`` (a template tree) the load is
    tolerant, as described above; without it returns the flat {path:
    array} dict."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with np.load(path, allow_pickle=False) as z:
        scalars = json.loads(str(z["__scalars__"]))
        flat = {k: z[k] for k in z.files if k != "__scalars__"}
    if like is None:
        return flat, scalars
    return _rebuild(like, flat), scalars


def unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """Rebuild a nested tree from the flat {path: array} form: path
    components split on '/', all-integer levels become lists."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def build(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            idxs = sorted(int(k) for k in keys)
            if idxs == list(range(len(idxs))):
                return [build(node[str(i)]) for i in idxs]
        return {k: build(v) for k, v in node.items()}

    return build(root)


def load_nested(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Load a checkpoint and rebuild its nested structure (no template)."""
    flat, scalars = load(path)
    return unflatten(flat), scalars


def check_weights(tree: Any) -> list:
    """Path keys of the floating leaves that hold a non-finite value."""
    bad = []
    for key, leaf in flatten_paths(tree):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                bad.append(key)
            continue
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(
                arr).all():
            bad.append(key)
    return bad


class CheckpointManager:
    """Directory-level manager of the retention policy: a rolling
    ``model.ckpt``, immutable ``model_<it>.ckpt`` backups, and
    ``model_best.ckpt`` with a timestamped copy of the previous best.

    ``async_=True`` copies the tree to host numpy arrays on the calling
    thread, then writes the file on a background thread, so the training
    loop does not wait for the disk; the next write or restore joins it.

    ``sharded=True`` writes each checkpoint as a directory through
    ``core.checkpoint_sharded`` (every rank calls the save; writes are
    synchronous), and ``restore`` reads such a directory wherever it
    finds one, as the JAX package's manager does.
    """

    LATEST = "model.ckpt"
    BEST = "model_best.ckpt"

    def __init__(self, out_dir: str, sharded: bool = False):
        self.out_dir = out_dir
        self.sharded = sharded
        os.makedirs(out_dir, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    def _p(self, name: str) -> str:
        return os.path.join(self.out_dir, name)

    def _write(self, path, tree, scalars, async_):
        self.wait()
        if self.sharded:
            from speech2lip_tpu_torch.core.checkpoint_sharded import \
                save_sharded
            save_sharded(path, tree, scalars)
            return
        flat = flatten(tree)   # host snapshot before the step moves on
        if not async_:
            _save_flat(path, flat, scalars)
            return
        self._pending = threading.Thread(
            target=_save_flat, args=(path, flat, scalars), daemon=True)
        self._pending.start()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def save_latest(self, tree, async_: bool = False, **scalars):
        self._write(self._p(self.LATEST), tree, scalars, async_)

    def save_step(self, tree, it: int, async_: bool = False, **scalars):
        self._write(self._p(f"model_{it}.ckpt"), tree,
                    dict(scalars, it=it), async_)

    def save_best(self, tree, **scalars):
        """Timestamped backup of the previous best, then overwrite.  Sharded:
        rank 0 copies the backup directory, and a barrier keeps the other
        ranks from overwriting their shard files while it copies."""
        from speech2lip_tpu_torch.parallel import distributed
        from speech2lip_tpu_torch.parallel.mesh import barrier
        best = self._p(self.BEST)
        self.wait()
        if os.path.exists(best) and (not self.sharded
                                     or distributed.is_main_process()):
            ts = datetime.datetime.now().strftime("%Y%m%d%H%M%S")
            if os.path.isdir(best):
                shutil.copytree(best, best + "." + ts)
            else:
                shutil.copy2(best, best + "." + ts)
        if self.sharded:
            barrier()
        self._write(best, tree, scalars, async_=False)

    def latest_step_file(self) -> Optional[str]:
        """Highest-numbered model_<it>.ckpt, else model.ckpt if present."""
        best_it, best_name = -1, None
        for f in os.listdir(self.out_dir):
            m = re.fullmatch(r"model_(\d+)\.ckpt", f)
            if m and int(m.group(1)) > best_it and int(m.group(1)) > 0:
                best_it, best_name = int(m.group(1)), f
        if best_name:
            return self._p(best_name)
        if os.path.exists(self._p(self.LATEST)):
            return self._p(self.LATEST)
        return None

    def restore(self, like, name: Optional[str] = None):
        """Load by name, or resume from ``latest_step_file``; returns (tree,
        scalars), or (like, {}) when there is nothing to load."""
        self.wait()
        path = self._p(name) if name else self.latest_step_file()
        if path is None or not os.path.exists(path):
            return like, {}
        if os.path.isdir(path):
            from speech2lip_tpu_torch.core.checkpoint_sharded import \
                restore_sharded
            return restore_sharded(path, like)
        return load(path, like)
