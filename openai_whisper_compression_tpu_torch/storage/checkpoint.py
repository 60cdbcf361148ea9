"""Model checkpointing: the plain fast checkpoint of a parameter tree.

The port of the JAX package's `storage/checkpoint.py`. Where JAX saves an
Orbax checkpoint directory, the port writes the npz format
(`formats.save_npz`) to `path + ".npz"`, which is the JAX package's own
fallback when Orbax is missing; an Orbax directory is a JAX library's
format and is refused on load.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from ..models.params import DEFAULT_DEVICE
from .formats import load_npz, save_npz


def save(params: Any, path: str) -> str:
    """Write `params` to `path` (*.npz) or to `path + ".npz"`; returns the
    file written."""
    if not path.endswith(".npz"):
        path = path.rstrip("/") + ".npz"
    save_npz(params, path)
    return path


def load(path: str, device: str | torch.device = DEFAULT_DEVICE) -> Any:
    """The tree of an npz checkpoint, on `device`."""
    if path.endswith(".npz"):
        return load_npz(path, device=device)
    if os.path.isdir(path):
        raise ValueError(f"{path!r} is a directory: an Orbax checkpoint, which "
                         "is a JAX library's format; the port reads the npz "
                         "checkpoints that save() writes")
    raise ValueError(f"{path!r} is not an npz checkpoint (save() writes "
                     f"{path.rstrip('/') + '.npz'!r})")
