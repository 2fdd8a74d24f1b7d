"""Checkpointing with atomic commit (the port of
``repro.training.checkpoint``), on the reference's on-disk layout:

    <dir>/step_<N>.tmp/         (written)
    <dir>/step_<N>/             (atomically renamed on commit)
        manifest.json           step, leaf names, shapes, dtypes
        <leaf>.npy              one file per leaf (the full array)

Leaf names are the reference's ``_leaf_name`` of the leaf's path: dict
keys and list indices as they are, named-tuple and dataclass fields as
``.field``, joined by ``__`` (``opt__.master__layers__0__w``), so a
checkpoint crosses between the packages in either direction.  A bf16 leaf
goes to disk as the reference writes it (a ``<V2`` array of the raw bits,
dtype ``bfloat16`` in the manifest; no ``ml_dtypes`` needed).  The
reference cannot restore such a leaf (numpy has no cast from ``V2``); the
port reads its bits back (ROADMAP C.10).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.quant import QTensor
from repro_torch.training.optimizer import AdamWState

_STEP_DIR = re.compile(r"step_\d{8}")


def _named(tree: Any, fn: Callable[[str, Any], Any], path: Tuple[str, ...] = ()) -> Any:
    """``tree`` rebuilt with ``fn(name, leaf)`` at every leaf, visiting the
    leaves in ``jax.tree_util``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        out = {k: _named(tree[k], fn, path + (str(k),)) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, QTensor):
        return QTensor(q=_named(tree.q, fn, path + (".q",)),
                       scale=_named(tree.scale, fn, path + (".scale",)))
    if isinstance(tree, AdamWState):
        return AdamWState(*(_named(getattr(tree, f), fn, path + ("." + f,))
                            for f in AdamWState._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_named(v, fn, path + (str(i),)) for i, v in enumerate(tree))
    return fn("__".join(path) or "root", tree)


def leaf_names(tree: Any) -> List[str]:
    """The leaves' checkpoint names, in the order they are written."""
    names: List[str] = []
    _named(tree, lambda n, x: names.append(n))
    return names


def _to_host(x) -> torch.Tensor:
    """A leaf as a CPU tensor in storage of its own (a snapshot)."""
    return torch.as_tensor(x).detach().to("cpu", copy=True)


def _save_leaf(path: str, t: torch.Tensor) -> Tuple[List[int], str]:
    """Write one leaf; returns its (shape, dtype name) for the manifest."""
    if t.dtype == torch.bfloat16:
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False, "shape": tuple(t.shape)})
            f.write(t.contiguous().view(torch.int16).numpy().astype("<i2").tobytes())
        return list(t.shape), "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def save_checkpoint(directory: str, step: int, tree: Any, keep: int = 3) -> str:
    """Write a checkpoint; atomic rename commit; prune to ``keep`` newest."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}

    def write(name, leaf):
        shape, dtype = _save_leaf(os.path.join(tmp, name + ".npy"), _to_host(leaf))
        manifest["leaves"].append({"name": name, "shape": shape, "dtype": dtype})

    _named(tree, write)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(directory, keep)
    return final


def _prune(directory: str, keep: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory) if _STEP_DIR.fullmatch(d))
    for d in ckpts[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory) if _STEP_DIR.fullmatch(d)]
    return max(steps) if steps else None


def _load_leaf(path: str, dtype_name: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype_name == "bfloat16":  # the raw bits, as a <V2 array
        return torch.from_numpy(arr.view("<i2").copy()).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, step: int, target: Any) -> Any:
    """Restore into the structure of ``target``: each leaf in the target
    leaf's dtype, on its device.  Raises ``KeyError`` for a leaf the
    checkpoint lacks and ``ValueError`` for a shape that differs."""
    src = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(src, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {m["name"]: m for m in manifest["leaves"]}

    def load(name, leaf):
        if name not in by_name:
            raise KeyError(f"checkpoint missing leaf {name}")
        t = _load_leaf(os.path.join(src, name + ".npy"), by_name[name]["dtype"])
        leaf = torch.as_tensor(leaf)
        if list(t.shape) != list(leaf.shape):
            raise ValueError(
                f"leaf {name}: checkpoint shape {tuple(t.shape)} != target {tuple(leaf.shape)}")
        return t.to(device=leaf.device, dtype=leaf.dtype)

    return _named(target, load)


class AsyncCheckpointer:
    """Snapshot-then-write-in-background (bounded to one in-flight save)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def save(self, step: int, tree: Any) -> None:
        self.wait()
        snapshot = _named(tree, lambda n, x: _to_host(x))
        self._thread = threading.Thread(target=self._write, args=(step, snapshot),
                                        daemon=True)
        self._thread.start()

    def _write(self, step: int, snapshot: Any) -> None:
        try:
            save_checkpoint(self.directory, step, snapshot, self.keep)
        except Exception as e:  # handed to the caller by wait()
            self._error = e

    def wait(self) -> None:
        """Join the save in flight; re-raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
