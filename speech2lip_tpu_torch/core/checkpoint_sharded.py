"""Checkpoints written by every rank (counterpart of
``speech2lip_tpu/core/checkpoint_sharded.py``), in the JAX package's
on-disk format, so a directory written by either package restores in the
other:

- ``shards-p<k>.npz``: rank k's blocks, under the keys ``<key>#<i>``;
- ``index-p<k>.json``: per leaf key its shape, dtype and blocks (file,
  key, ``[start, stop]`` bounds per axis);
- ``meta.json``: ``{"processes": N, "scalars": {...}}``, written by rank 0
  after a barrier, so a reader that sees it sees a complete checkpoint.

The port's state is replicated over its ranks, so rank 0 writes each
leaf as one block and the other ranks write an index of empty block
lists; restore assembles each leaf from whatever blocks the files hold,
the JAX package's sharded ones included.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np

from speech2lip_tpu_torch.core.checkpoint import (_children, _like, _to_numpy,
                                                  flatten_paths)
from speech2lip_tpu_torch.parallel import distributed
from speech2lip_tpu_torch.parallel.mesh import barrier


def save_sharded(dir_path: str, tree: Any,
                 scalars: Optional[Dict[str, Any]] = None):
    """Write ``tree`` to the directory ``dir_path``.  Called on every rank:
    each writes its shard and index files, then rank 0 writes
    ``meta.json`` once all of them are on disk, and no rank returns
    before it exists."""
    proc = distributed.process_index()
    os.makedirs(dir_path, exist_ok=True)
    blocks: Dict[str, np.ndarray] = {}
    index: Dict[str, Any] = {}
    fname = f"shards-p{proc}.npz"
    for key, leaf in flatten_paths(tree):
        arr = _to_numpy(leaf)
        entry = {"shape": list(arr.shape), "dtype": str(arr.dtype),
                 "blocks": []}
        if proc == 0:      # replicated: written once, by rank 0
            bkey = f"{key}#0"
            blocks[bkey] = arr
            entry["blocks"].append({"file": fname, "key": bkey,
                                    "bounds": [[0, d] for d in arr.shape]})
        index[key] = entry
    fd, tmp = tempfile.mkstemp(dir=dir_path, suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **blocks)
    os.replace(tmp, os.path.join(dir_path, fname))
    with open(os.path.join(dir_path, f"index-p{proc}.json"), "w") as f:
        json.dump(index, f)
    barrier()      # every shard and index file is on disk
    if proc == 0:
        with open(os.path.join(dir_path, "meta.json"), "w") as f:
            json.dump({"processes": distributed.process_count(),
                       "scalars": scalars or {}}, f)
    barrier()      # meta.json marks completion for every rank


def _merged_index(dir_path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(leaves' merged index, meta) over exactly ``meta["processes"]``
    index files: stale files of an earlier, larger group are ignored."""
    with open(os.path.join(dir_path, "meta.json")) as f:
        meta = json.load(f)
    leaves: Dict[str, Any] = {}
    for p in range(int(meta["processes"])):
        with open(os.path.join(dir_path, f"index-p{p}.json")) as f:
            part = json.load(f)
        for key, entry in part.items():
            leaves.setdefault(key, {"shape": entry["shape"],
                                    "dtype": entry["dtype"], "blocks": []})
            leaves[key]["blocks"].extend(entry["blocks"])
    return leaves, meta


def restore_sharded(dir_path: str, like: Any) -> Tuple[Any, Dict[str, Any]]:
    """Rebuild ``like``'s tree from a ``save_sharded`` directory of either
    package.  Tolerant as the JAX restore: a key the files lack keeps the
    template leaf, so does a leaf whose shape drifted, and a stored value
    is cast to the template leaf's dtype (and device).  Returns (tree,
    scalars)."""
    leaves, meta = _merged_index(dir_path)
    files: Dict[str, Any] = {}

    def npz(fname):
        if fname not in files:
            files[fname] = np.load(os.path.join(dir_path, fname))
        return files[fname]

    def assemble(entry):
        out = np.zeros(entry["shape"], dtype=np.dtype(entry["dtype"]))
        for blk in entry["blocks"]:
            sl = tuple(slice(a, b) for a, b in blk["bounds"])
            out[sl] = npz(blk["file"])[blk["key"]]
        return out

    def rebuild(tree, prefix):
        if tree is None:
            return None
        kids = _children(tree)
        if kids is None:
            entry = leaves.get(prefix)
            if entry is None or tuple(entry["shape"]) != tuple(
                    np.shape(tree)):
                return tree
            return _like(assemble(entry), tree)
        new = [rebuild(child, f"{prefix}/{name}" if prefix else name)
               for name, child in kids]
        if isinstance(tree, dict):
            return dict(zip(tree.keys(), new))
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*new)
        return type(tree)(new)

    try:
        return rebuild(like, ""), meta.get("scalars", {})
    finally:
        for z in files.values():
            z.close()
