"""Checkpoint/resume for sampler state (port of base_tpu.io.checkpoint).

The full sampler state (chain positions, cached log-posts and gradients,
adaptation state, the chunk cursor, accumulated samples and each
`torch.Generator`'s `get_state()`) is one tree of dicts, lists, tuples
(NamedTuples included) and tensors.  It is saved atomically: `torch.save`
to `path + ".tmp"`, then `os.replace`, so a run killed mid-save leaves the
previous checkpoint whole.  `restore_checkpoint` rebuilds the tree in the
structure of a `like` tree (Orbax's `restore(target=like)`), each tensor
checked against like's shape and dtype and placed on like's device.  The
file holds only containers and tensors, loaded with `weights_only=True`.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _plain(tree: Any) -> Any:
    """NamedTuples as tuples and numpy arrays as tensors, so that the file
    loads with weights_only=True."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_plain(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.tensor(tree)
    return tree


def _fit(saved: Any, like: Any, where: str) -> Any:
    """`saved` in the structure, types and devices of `like`."""
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            got = (sorted(saved) if isinstance(saved, dict)
                   else type(saved).__name__)
            raise ValueError(f"checkpoint {where or 'root'}: keys {got} != "
                             f"{sorted(like)}")
        return {k: _fit(saved[k], v, f"{where}.{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(f"checkpoint {where}: {len(like)} entries "
                             f"expected")
        items = [_fit(s, v, f"{where}[{i}]")
                 for i, (s, v) in enumerate(zip(saved, like))]
        return type(like)(*items) if hasattr(like, "_fields") else type(
            like)(items)
    if isinstance(like, (torch.Tensor, np.ndarray)):
        if (not isinstance(saved, torch.Tensor)
                or tuple(saved.shape) != tuple(like.shape)):
            raise ValueError(f"checkpoint {where}: shape "
                             f"{getattr(saved, 'shape', None)} != "
                             f"{tuple(like.shape)}")
        if isinstance(like, np.ndarray):
            out = saved.numpy()
            if out.dtype != like.dtype:
                raise ValueError(f"checkpoint {where}: dtype {out.dtype} != "
                                 f"{like.dtype}")
            return out
        if saved.dtype != like.dtype:
            raise ValueError(f"checkpoint {where}: dtype {saved.dtype} != "
                             f"{like.dtype}")
        return saved.to(like.device)
    return saved


def save_checkpoint(path: str, tree: Any) -> None:
    """Atomically save a state tree (overwrites `path`)."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save(_plain(tree), tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, like: Any) -> Any:
    """Restore a checkpoint into the structure of `like` (a tree with the
    right shapes and dtypes, e.g. a freshly initialised state)."""
    saved = torch.load(os.path.abspath(path), map_location="cpu",
                       weights_only=True)
    return _fit(saved, like, "")


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(path)
