"""Parameter trees between the JAX reference and the port, through numpy.

The port cannot reproduce ``jax.random`` streams, so tests and tools carry
the reference's weights across: ``jax.tree.map(np.asarray, params)`` on the
reference side, `to_torch` here.  Trees are nested dicts / lists / tuples
whose leaves are arrays; structure is preserved.

bf16 needs a detour: numpy has no bfloat16, JAX exports it as
``ml_dtypes.bfloat16``, and ``torch.from_numpy`` rejects that dtype — so the
bits travel as uint16 and are reinterpreted on the torch side (and the
reverse on the way back).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: the tensor must not alias a JAX buffer
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only needed when handing bf16 back to JAX

        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree: Any, device="cpu") -> Any:
    """Array tree (numpy or anything ``np.asarray`` accepts) → tensors on
    ``device``, bit-for-bit."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    return _leaf_to_torch(tree, device)


def to_numpy(tree: Any) -> Any:
    """Tensor tree → numpy arrays on the host (bf16 as ``ml_dtypes``)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return _leaf_to_numpy(tree)
