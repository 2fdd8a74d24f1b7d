"""What one step costs a rank, read on fake tensors: the port's counterpart
of the reference's compiled-HLO statistics (``repro.distributed.hlo_stats``
with XLA's ``memory_analysis`` / ``cost_analysis``).

- `MemoryTracker`, a dispatch mode that counts the bytes of the live
  storages per device: every op's outputs, the arguments registered with
  `MemoryTracker.track_args`, the scratch a kernel's fake
  implementation allocates (`repro_torch.kernels.build.note_alloc`), and
  the scratch some aten ops' CUDA implementations allocate and free inside
  the op, which no dispatch mode sees (`_SCRATCH`, measured on the H100).  A
  storage leaves the count when its last tensor dies (``weakref.finalize``
  on the storage).  It gives argument, output and temp bytes and the peak,
  on fake tensors and real ones alike.  It also sums the bytes every
  non-view op reads and writes.
- FLOPs through ``torch.utils.flop_counter.FlopCounterMode``, which counts
  the port's kernels by their registered formulas.
- The collectives from `repro_torch.distributed.comm`'s counter, by kind
  and group, with `comm_bytes` the reference's per-device convention (an
  all-reduce moves 2 x its tensor, an all-gather its output, a
  reduce-scatter its output, the rank's shard), so records compare with
  the reference's ``collective_stats``.  For a reduce-scatter this
  follows the reference's code (``hlo_stats._comm_bytes``, which counts
  every op but an all-reduce by its result), not its module docstring,
  which says "reduce-scatter → input bytes".  The reference counts
  a scanned layer's collectives once per loop body and scales by the trip
  count; the port has no scan, so its counts are per-step totals.
- `fake_tensors`, the fake-tensor mode the dry run runs in.  The
  reference's "emulation bound" (XLA:CPU upcasting bf16 products to f32)
  has no counterpart: fake tensors keep their dtypes.

Nothing here allocates device memory on fake tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import Counter
from dataclasses import dataclass, field
from typing import Any, Dict

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.distributed import comm
from repro_torch.kernels import build
# the kernels' FLOP formulas register when their modules are imported; a
# FlopCounterMode reads the registry when it is made, so import them first
from repro_torch.kernels import fairkv_decode, paged_fairkv_decode, snapkv_select  # noqa: F401


def comm_bytes(kind: str, result_bytes: int) -> int:
    """Per-device bytes a collective moves, by the reference's convention:
    an all-reduce 2 x its tensor (reduce-scatter + all-gather), an
    all-gather and a reduce-scatter their output (the module docstring)."""
    return 2 * result_bytes if kind == "all_reduce" else result_bytes


def collective_stats(counts: Counter) -> Dict[str, Dict[str, int]]:
    """``{"all-reduce": {"count", "bytes"}, ...}`` of a `comm` counter delta,
    in the reference's keys and byte convention, every group together."""
    out: Dict[str, Dict[str, int]] = {}
    for group in comm.by_kind(counts).values():
        for kind, v in group.items():
            d = out.setdefault(kind.replace("_", "-"), {"count": 0, "bytes": 0})
            d["count"] += v["calls"]
            d["bytes"] += comm_bytes(kind, v["bytes"])
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    returns = getattr(func, "_schema", None)
    return returns is not None and any(
        r.alias_info is not None and not r.alias_info.is_write for r in returns.returns)


# device scratch an op's CUDA implementation allocates beyond its outputs
# and frees before it returns (so no dispatch mode sees it), by the op's
# (args, outputs): what max_memory_allocated rose inside the op over its
# inputs and outputs on an NVIDIA H100 80GB HBM3 (torch 2.11; phase 23's
# gloo ranks): the softmax backward's a copy of its result, logsumexp's
# exp(x - max) of its input.  The list-form all-gather's flat buffer (its
# gathered bytes on gloo ranks sharing the card) is not counted: it set no
# measured peak.
_SCRATCH = {
    torch.ops.aten._softmax_backward_data.default: lambda args, outs: _nbytes(outs[0]),
    torch.ops.aten.logsumexp.default: lambda args, outs: _nbytes(args[0]),
}


class MemoryTracker(TorchDispatchMode):
    """Live storage bytes per device while the mode is on (see the module
    docstring).  Enter it last, above a `FakeTensorMode`, so that it sees
    every op first."""

    def __init__(self):
        super().__init__()
        self._live: Dict[int, tuple] = {}  # storage id -> (device, bytes)
        self.current: Counter = Counter()
        self.peak: Counter = Counter()
        self.argument: Counter = Counter()
        self._args: set = set()
        self.bytes_read = 0
        self.bytes_written = 0

    def __enter__(self):
        build.ALLOC_LISTENERS.append(self.track)
        return super().__enter__()

    def __exit__(self, *exc):
        build.ALLOC_LISTENERS.remove(self.track)
        return super().__exit__(*exc)

    def track(self, t: torch.Tensor) -> bool:
        """Count ``t``'s storage from now until it is freed; False when it
        is counted already."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return False
        dev, n = str(t.device), st.nbytes()
        self._live[key] = (dev, n)
        self.current[dev] += n
        self.peak[dev] = max(self.peak[dev], self.current[dev])
        weakref.finalize(st, self._free, key)
        return True

    def _free(self, key: int) -> None:
        dev, n = self._live.pop(key, (None, 0))
        if dev is not None:
            self.current[dev] -= n

    def track_args(self, tree: Any) -> None:
        """Register the step's arguments (any tree of tensors)."""
        for t in _tensors(tree):
            if self.track(t):
                self._args.add(t.untyped_storage()._cdata)
                self.argument[str(t.device)] += t.untyped_storage().nbytes()

    def output_bytes(self, tree: Any) -> Counter:
        """Bytes of the storages of ``tree`` that the step allocated."""
        out: Counter = Counter()
        seen = set()
        for t in _tensors(tree):
            key = t.untyped_storage()._cdata
            if key in self._live and key not in self._args and key not in seen:
                seen.add(key)
                out[str(t.device)] += t.untyped_storage().nbytes()
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self.track(t)
        scratch = _SCRATCH.get(func)
        if scratch is not None:
            dev = str(outs[0].device)
            self.peak[dev] = max(self.peak[dev], self.current[dev] + scratch(args, outs))
        if outs and not _is_view(func):  # ops that make no tensor move nothing
            self.bytes_read += sum(_nbytes(t) for t in tree_leaves((args, kwargs))
                                   if isinstance(t, torch.Tensor))
            self.bytes_written += sum(_nbytes(t) for t in outs)
        return out


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


@dataclass
class StepStats:
    """One step on one rank (bytes per device; this process holds one)."""

    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0
    flops: int = 0
    bytes_read: int = 0
    bytes_written: int = 0
    collectives: Dict[str, Dict[str, int]] = field(default_factory=dict)
    by_group: Dict[str, Dict[str, Dict[str, int]]] = field(default_factory=dict)

    def record(self) -> dict:
        """The reference's record keys (``memory``, ``cost``, ``collectives``)."""
        return {
            "memory": {"argument_bytes": self.argument_bytes,
                       "output_bytes": self.output_bytes,
                       "temp_bytes": self.temp_bytes,
                       "peak_bytes": self.peak_bytes,
                       "peak_per_device_gb": round(self.peak_bytes / 1e9, 3)},
            "cost": {"flops_per_device": self.flops,
                     "bytes_per_device": self.bytes_read + self.bytes_written},
            "collectives": self.collectives,
            "collectives_by_group": self.by_group,
        }


def measure(fn, args_tree: Any, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a `MemoryTracker` and a FLOP
    counter, ``args_tree`` (the tensors the step reads and keeps) counted as
    its arguments; returns ``(fn's result, StepStats)``.  Peak and temp
    count from the arguments: peak = argument + output + temp.  It runs in
    the caller's grad mode: a train step, measured with grad enabled,
    counts its saved activations, its gradients and its backward's
    temporaries (the backward of host tensors runs on the calling thread,
    under the modes)."""
    before = comm.snapshot()
    with FlopCounterMode(display=False) as fc, MemoryTracker() as mem:
        mem.track_args(args_tree)
        out = fn(*args, **kwargs)
        outb = mem.output_bytes(out)
    delta = comm.since(before)
    dev = max(mem.peak, key=mem.peak.get) if mem.peak else "cpu"
    arg, peak, o = mem.argument[dev], mem.peak[dev], outb[dev]
    return out, StepStats(argument_bytes=arg, output_bytes=o, temp_bytes=max(0, peak - arg - o),
                          peak_bytes=peak, flops=int(fc.get_total_flops()),
                          bytes_read=mem.bytes_read, bytes_written=mem.bytes_written,
                          collectives=collective_stats(delta), by_group=comm.by_kind(delta))


# ---------------------------------------------------------------------------
# Fake tensors
# ---------------------------------------------------------------------------

# Python entry points that set a device guard before dispatching: on a
# torch built without CUDA a fake CUDA tensor has no guard, so these run on
# the tensors' meta storage and the result is wrapped back onto the fake
# device (factories build on the CPU and move)
_GUARDED = (torch.Tensor.__getitem__, torch.Tensor.__setitem__, torch.Tensor.copy_,
            torch.Tensor.contiguous, torch.Tensor.__invert__)
_FACTORIES = (torch.as_tensor, torch.tensor)


def _cuda(x) -> bool:
    return isinstance(x, torch.Tensor) and x.device.type == "cuda"


class _MetaGuardedMethods(TorchFunctionMode):
    def __init__(self, mode):
        super().__init__()
        self.mode = mode

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import in_kernel_invocation_manager

        kwargs = kwargs or {}
        if func in _FACTORIES and torch.device(kwargs.get("device") or "cpu").type == "cuda":
            dev = torch.device(kwargs.pop("device"))
            return self._move(func(*args, **kwargs), dev)
        if func is torch.Tensor.to:
            rest = {k: v for k, v in kwargs.items() if k != "copy"}
            x, (dev, dtype) = args[0], _parse_to(args, rest)
            if not _cuda(x) and (dev is None or dev.type != "cuda"):
                return func(*args, **kwargs)
            dev, dtype = dev or x.device, dtype or x.dtype
            same = (dev, dtype) == (x.device, x.dtype) and not kwargs.get("copy", False)
            return x if same else self._move(x, dev, dtype)
        if func not in _GUARDED or not any(map(_cuda, tree_leaves((args, kwargs)))):
            return func(*args, **kwargs)
        device = next(a.device for a in tree_leaves((args, kwargs)) if _cuda(a))
        with in_kernel_invocation_manager(self.mode):
            out = func(*args, **kwargs)
        if out is None:  # __setitem__ wrote into its meta storage
            return None
        if func is torch.Tensor.copy_ or out is args[0]:  # in place, or already contiguous
            return args[0]
        new = all(out.untyped_storage()._cdata != a.untyped_storage()._cdata
                  for a in tree_leaves(args) if isinstance(a, torch.Tensor))
        return self._wrap(out, device, new)

    def _move(self, x, device, dtype=None):
        """A copy of fake ``x`` on ``device`` (and ``dtype``)."""
        from torch._subclasses.fake_tensor import in_kernel_invocation_manager

        with in_kernel_invocation_manager(self.mode):
            out = torch.ops.aten._to_copy.default(x, dtype=dtype or x.dtype)
        return self._wrap(out, device, new=True)

    def _wrap(self, out, device, new: bool):
        fake = self.mode.fake_tensor_converter.from_meta_and_device(self.mode, out, device)
        if new:
            build.note_alloc(fake)
        return fake


def _parse_to(args, kwargs):
    """(device, dtype) of a ``Tensor.to`` call, either None when not given;
    a bare ``"cuda"`` is ``cuda:0``."""
    dev, dtype = torch._C._nn._parse_to(*args[1:], **kwargs)[:2]
    dev = None if dev is None else torch.device(dev)
    if dev is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev, dtype


@contextlib.contextmanager
def fake_tensors():
    """A ``FakeTensorMode`` in which every tensor the block makes is fake:
    shapes, dtypes and devices without storage.  Fake ``cuda`` tensors need
    no card.  On a torch built without CUDA, the Python entry points that
    set a device guard (indexing, ``copy_``, ``contiguous``, ``~``, ``.to``,
    ``as_tensor`` / ``tensor`` on ``cuda``) run on a fake CUDA tensor's
    meta storage instead: the guard needs the CUDA runtime."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        if torch.backends.cuda.is_built():
            yield mode
        else:
            with _MetaGuardedMethods(mode):
                yield mode
