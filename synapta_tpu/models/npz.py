"""Parameter trees <-> ``.npz`` files.

A nested dict of arrays is stored flat, one array per leaf, under its
slash-joined path (``EncoderBlock_0/LayerNorm_0/scale``). Reading needs
only numpy; the tree comes back with the same paths, shapes, dtypes and
values.
"""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np


def _flatten(tree: Dict[str, Any], prefix: str, out: Dict[str, np.ndarray]):
    for k, v in tree.items():
        if "/" in k:
            raise ValueError(f"parameter name {k!r} contains '/'")
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            _flatten(v, path, out)
        else:
            out[path] = np.asarray(v)


def save_params(params: Dict[str, Any], path: str) -> None:
    """Write a nested dict of arrays to ``path`` (uncompressed .npz),
    atomically: a reader never sees a half-written file."""
    flat: Dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_params(path: str) -> Dict[str, Any]:
    """Read a tree written by save_params (numpy arrays as leaves)."""
    tree: Dict[str, Any] = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree
