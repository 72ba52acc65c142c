"""Minimal ``.npz`` checkpointing of parameter and optimizer trees — the
port of ``repro.training.checkpoint``: one array a leaf under the
reference's ``"/"``-joined key path (``distributed.sharding``'s
``tree_leaves_with_path``), so a checkpoint
holds the same keys whichever package wrote it.  numpy has no bfloat16:
a bf16 tensor is stored as its raw 16-bit words in the dtype JAX writes
(ml_dtypes' bfloat16, where that package is installed) or as int16, and
read back bit for bit (``convert.tensor_from_numpy``)."""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.convert import tensor_from_numpy
from repro_torch.distributed.sharding import (tree_leaves_with_path,
                                              tree_map_with_path)


def _bf16_dtype():
    try:
        import ml_dtypes
    except ImportError:
        return None
    return np.dtype(ml_dtypes.bfloat16)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        words = t.view(torch.int16).numpy()
        bf16 = _bf16_dtype()
        return words if bf16 is None else words.view(bf16)
    return t.numpy()


def _flatten(tree) -> dict:
    return {key: _to_numpy(leaf)
            for key, leaf in tree_leaves_with_path(tree)}


def save(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(tree))


def restore(path: str, template: Any) -> Any:
    """The tree ``template`` with each leaf read from ``path``, in the
    leaf's dtype and on its device."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")

    def read(key, leaf):
        arr = data[key]
        assert arr.shape == tuple(leaf.shape), (key, arr.shape, leaf.shape)
        if leaf.dtype == torch.bfloat16:      # the 16-bit words as stored
            return torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16).to(leaf.device)
        return tensor_from_numpy(arr, leaf.device).to(leaf.dtype)
    return tree_map_with_path(read, template)
