"""Checkpoint / resume (port of ``obia_tpu/checkpoint.py``).

* :func:`save_pytree` / :func:`load_pytree` — nested dicts, lists and
  tuples of host arrays in one flat ``.npz`` file, each leaf under its
  path ``a/b/c``: the reference's fallback layout, so either package reads
  the other's file. The reference's orbax directories are not read here
  (orbax needs JAX).
* :class:`TileManifest` — a tile-granular job manifest, so a tiled run
  (``utils.tiling.create_tiled_segments``) can resume after a failure: each
  tile's status is durably recorded and completed tiles are skipped on a
  re-run.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten_like(like: Any, data, prefix: str = "") -> Any:
    """Rebuild the ``like`` structure (dicts/lists/tuples/namedtuples)
    from the flat key->array mapping ``_flatten`` produced, restoring
    leaf dtypes from the template."""
    if isinstance(like, dict):
        return {k: _unflatten_like(v, data, f"{prefix}{k}/")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten_like(v, data, f"{prefix}{i}/")
                for i, v in enumerate(like)]
        if hasattr(like, "_fields"):  # namedtuple
            return type(like)(*vals)
        return type(like)(vals)
    leaf = np.asarray(data[prefix.rstrip("/")])
    want = np.asarray(like).dtype
    return leaf if leaf.dtype == want else leaf.astype(want)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_pytree(path: str, tree: Any) -> None:
    """Save a pytree of arrays as ``path`` + ``.npz`` (``path`` as it is
    when it ends in ``.npz``)."""
    np.savez(_npz_path(path), **_flatten(tree))
    # only now — with the fresh .npz on disk — is it safe to drop a
    # stale orbax DIRECTORY at ``path`` that would shadow it when the
    # reference loads the checkpoint (its load_pytree prefers the
    # directory)
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)


def load_pytree(path: str, like: Optional[Any] = None) -> Any:
    """Load a checkpoint saved by :func:`save_pytree` (or by the reference
    on its ``.npz`` path). ``like`` gives the structure and leaf dtypes to
    restore; without it the tree is nested dicts keyed by path part."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is an orbax checkpoint directory; only the "
                         ".npz layout can be read without JAX")
    with np.load(_npz_path(path)) as npz:
        data = {key: npz[key] for key in npz.files}
    if like is not None:
        # restore the template's container types (tuples/lists would
        # otherwise come back as dicts keyed '0', '1', ...) and dtypes
        return _unflatten_like(like, data)
    tree: Dict[str, Any] = {}
    for key, value in data.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


class TileManifest:
    """Durable per-tile job status for resumable tiled runs."""

    def __init__(self, path: str):
        self.path = path
        self.state: Dict[str, Dict] = {}
        if os.path.exists(path):
            with open(path) as f:
                self.state = json.load(f)

    def is_done(self, tile_id: str) -> bool:
        return self.state.get(tile_id, {}).get("status") == "done"

    def mark(self, tile_id: str, status: str, **extra) -> None:
        self.state[tile_id] = {"status": status, **extra}
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.state, f, indent=1)
        os.replace(tmp, self.path)

    def pending(self, tile_ids: List[str]) -> List[str]:
        return [t for t in tile_ids if not self.is_done(t)]

    def failed(self) -> List[str]:
        return [t for t, v in self.state.items()
                if v.get("status") == "failed"]
