"""Parameter trees between the JAX reference and the port, through numpy.

The port cannot reproduce ``jax.random`` streams, so tests and tools carry
the reference's weights across: ``jax.tree.map(np.asarray, params)`` on the
reference side, `to_torch` here.  Trees are nested dicts / lists / tuples
whose leaves are arrays; structure is preserved.

bf16 and fp8-e4m3 need a detour: numpy has neither, JAX exports them as
``ml_dtypes.bfloat16`` / ``ml_dtypes.float8_e4m3fn``, and
``torch.from_numpy`` rejects those dtypes — so the bits travel as 16- or
8-bit integers and are reinterpreted on the torch side (and the reverse on
the way back).  int8 leaves (the paged pools' codes) cross as they are.

Two node types cross by their fields, so no reference class is imported:
an int8 weight (an object with ``q`` and ``scale``, the reference's
``QTensor``) becomes `repro_torch.serving.quant.QTensor`, and an optimizer
state (a named tuple called ``AdamWState``) becomes
`repro_torch.training.optimizer.AdamWState`; other named tuples keep
their type.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


# dtype name on the JAX side -> (same-width integer carrier, torch dtype)
_BITCAST = {"bfloat16": (np.int16, torch.bfloat16),
            "float8_e4m3fn": (np.int8, torch.float8_e4m3fn)}


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: the tensor must not alias a JAX buffer
    if a.dtype.name in _BITCAST:
        carrier, dt = _BITCAST[a.dtype.name]
        return torch.from_numpy(a.view(carrier)).view(dt).to(device)
    return torch.from_numpy(a).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    for name, (carrier, dt) in _BITCAST.items():
        if t.dtype == dt:
            import ml_dtypes  # only needed when handing bf16 / fp8 back to JAX

            int_dt = torch.int16 if carrier is np.int16 else torch.int8
            return t.view(int_dt).numpy().view(getattr(ml_dtypes, name))
    return t.numpy()


def _map(fn, tree: Any, leaf) -> Any:
    """``tree`` with ``leaf`` applied to every array, rebuilt node by node
    (``fn`` is the recursion)."""
    from repro_torch.serving.quant import QTensor
    from repro_torch.training.optimizer import AdamWState

    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        return QTensor(q=fn(tree.q), scale=fn(tree.scale))
    if hasattr(tree, "_fields"):  # a named tuple
        cls = AdamWState if type(tree).__name__ == "AdamWState" else type(tree)
        return cls(*(fn(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(fn(v) for v in tree)
    return leaf(tree)


def to_torch(tree: Any, device="cpu") -> Any:
    """Array tree (numpy or anything ``np.asarray`` accepts) → tensors on
    ``device``, bit-for-bit."""
    return _map(lambda t: to_torch(t, device), tree, lambda a: _leaf_to_torch(a, device))


def to_numpy(tree: Any) -> Any:
    """Tensor tree → numpy arrays on the host (bf16 as ``ml_dtypes``)."""
    return _map(to_numpy, tree, _leaf_to_numpy)
