"""Checkpoint and resume for spectral artifacts and sampler state.

A checkpoint is a directory holding one file, ``tree.pt``: ``torch.save`` of
a dict of CPU tensors (nested dicts, lists and numbers allowed), read back
with ``weights_only=True`` at the dtypes it was saved with.  The file is
written under a temporary name in the same directory, flushed to disk and
moved into place with ``os.replace``, so a write that is killed leaves at
most a temporary file, which :func:`is_saved` and :func:`load_pytree` never
take for a finished checkpoint.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from ..types import EigenPair

FILE = "tree.pt"


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    return tree


def _cast_like(tree: Any, like: Any) -> Any:
    """``tree``'s leaves at the dtype and device of ``like``'s."""
    if isinstance(tree, dict):
        return {k: _cast_like(v, like[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_like(v, w) for v, w in zip(tree, like))
    if isinstance(like, torch.Tensor):
        if tuple(tree.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf of shape {tuple(tree.shape)}, "
                             f"expected {tuple(like.shape)}")
        return tree.to(dtype=like.dtype, device=like.device)
    return tree


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree of tensors, arrays and numbers (overwrites, atomically)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=FILE + ".", suffix=".tmp", dir=path)
    try:
        with os.fdopen(fd, "wb") as fh:
            torch.save(_to_cpu(tree), fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, os.path.join(path, FILE))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def is_saved(path: str) -> bool:
    """Whether ``path`` holds a finished checkpoint."""
    return os.path.isfile(os.path.join(os.path.abspath(path), FILE))


def load_pytree(path: str, like: Optional[Any] = None) -> Any:
    """The tree saved at ``path``, on the CPU at its saved dtypes, or at the
    dtypes and devices of ``like``'s leaves."""
    tree = torch.load(os.path.join(os.path.abspath(path), FILE), map_location="cpu",
                      weights_only=True)
    return tree if like is None else _cast_like(tree, like)


def save_spectrum(path: str, eigenpair: EigenPair, anchors, counts) -> None:
    """Persist the spectral stage (anchors, cluster counts, eigenpair)."""
    save_pytree(path, {"values": eigenpair.values, "vectors": eigenpair.vectors,
                       "anchors": anchors, "counts": counts})


def load_spectrum(path: str):
    tree = load_pytree(path)
    return EigenPair(tree["values"], tree["vectors"]), tree["anchors"], tree["counts"]
