"""The weight bridge: the reference's parameter pytree -> the port's tensors.

``params_from_jax`` walks a nested dict / list of array leaves — the JAX
parameter pytree, converted to numpy by the caller (``np.asarray`` of a
JAX array works too; this module imports nothing of JAX) — and returns the
same nesting with torch tensors.  Every layout and dtype is kept: the
stacked ``blocks/*`` leaves keep their leading layer axis, ``dense_prefix``
stays a list, ``blocks/moe/{router/w, tables, edest, eslot, gtable}`` and
``moe_pool/{wi, wg, wo}`` keep their shapes, int32 stays int32 and bfloat16
stays bfloat16.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One array leaf -> a torch tensor of the same dtype and shape.
    numpy has no native bfloat16: JAX's (ml_dtypes) bfloat16 arrays are
    reinterpreted bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def params_from_jax(tree: Any, device="cpu") -> Any:
    """Convert a parameter pytree (dicts, lists, array leaves) to torch."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return tensor_from_numpy(tree, device)
