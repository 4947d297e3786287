"""Flat-npz checkpoints of the round state (port of
``repro.checkpoint.checkpoint``), in the reference's layout: the leaves in
``jax.tree.flatten`` order (``core.tree``: for ``KGTState`` x, y, cx, cy,
then round) as ``leaf_%05d`` arrays, and the metadata in
``<path>.meta.json``.  So a checkpoint crosses between the two packages
in both directions.

Host values take the reference's 32-bit types: ``KGTState.round``, a host
int here, is saved as the int32 scalar the reference writes.  A bfloat16
tensor is saved as float32 (exact; numpy has no bfloat16 without the JAX
package's dtypes) and restores into a bfloat16 template exactly, here and
in the reference.
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_lib


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.to(torch.float32)
        return x.numpy()
    if isinstance(x, (bool, np.bool_)):
        return np.asarray(x, np.bool_)
    if isinstance(x, (int, np.integer)):
        return np.asarray(x, np.int32)
    if isinstance(x, (float, np.floating)):
        return np.asarray(x, np.float32)
    raise TypeError(f"cannot checkpoint a leaf of type {type(x).__name__}")


def save(path: str, tree: Any, metadata: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f"leaf_{i:05d}": _to_numpy(x)
              for i, x in enumerate(tree_lib.leaves(tree))}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f)


def restore(path: str, template: Any) -> Any:
    """The checkpoint at ``path`` rebuilt into ``template``'s structure,
    dtypes and devices (shapes validated)."""
    flat_t, treedef = tree_lib.flatten(template)
    with np.load(path) as z:
        flat = [z[f"leaf_{i:05d}"] for i in range(len(flat_t))]
    out = []
    for i, (a, t) in enumerate(zip(flat, flat_t)):
        shape = tuple(t.shape) if isinstance(t, torch.Tensor) else ()
        if tuple(a.shape) != shape:
            raise ValueError(
                f"leaf {i}: checkpoint shape {a.shape} != template {shape}")
        if isinstance(t, torch.Tensor):
            out.append(torch.from_numpy(np.array(a)).to(t.device, t.dtype))
        else:
            out.append(type(t)(a.item()))
    return tree_lib.unflatten(treedef, out)


def load_metadata(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)


def latest(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    cands = sorted(f for f in os.listdir(ckpt_dir)
                   if f.endswith(".npz") and not f.endswith(".tmp.npz"))
    return os.path.join(ckpt_dir, cands[-1]) if cands else None
