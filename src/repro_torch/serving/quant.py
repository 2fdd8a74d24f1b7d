"""Weight-only int8 quantization for serving (the port of
``repro.serving.quant``).

Symmetric per-output-channel int8 with a bf16 dequantization at each use:
the stored weights take half of bf16's bytes.  ``QTensor`` holds the codes
and their scale; ``deq`` materializes the bf16 weight transiently where a
product reads it, as the reference does (no fused int8 product: the step
reads the codes, writes the bf16 copy and reads it again).

The reference reaches int8 weights through `quantize_serve_params` applied
to an engine's serve tree (``engine.sp``), with no config field and no
CLI flag; so does the port.  jnp promotes ``fp32 x @ deq(w)`` (a bf16
weight) to fp32, while ``torch.matmul`` refuses mixed dtypes: every product
that reads a weight takes its operands from `operands`, which rounds the
weight through bf16 first and then promotes both sides as jnp does, so
the product sees the reference's numbers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple, Union

import torch

from repro_torch.distributed import comm


@dataclass
class QTensor:
    q: torch.Tensor  # int8, the weight's shape
    scale: torch.Tensor  # fp32, broadcastable along the channel axis

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16


def quantize_weight(w: torch.Tensor, channel_axis: int = -1) -> QTensor:
    """Symmetric per-channel int8 along ``channel_axis``: ``amax / 127``
    floored at ``1e-12 / 127``, round half to even, clip to +-127."""
    wf = w.float()
    reduce_dims = tuple(a for a in range(w.ndim) if a != channel_axis % w.ndim)
    amax = torch.amax(wf.abs(), dim=reduce_dims, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale)


def deq(w: Union[QTensor, torch.Tensor]) -> torch.Tensor:
    """The bf16 weight of a `QTensor`; a plain tensor passes through."""
    if isinstance(w, QTensor):
        return (w.q.float() * w.scale).to(torch.bfloat16)
    return w


def take0(w: Union[QTensor, torch.Tensor], idx: torch.Tensor):
    """Rows ``idx`` along axis 0 of a plain tensor or a `QTensor` (whose
    scale is taken along axis 0 only when it has more than one row)."""
    if isinstance(w, QTensor):
        return QTensor(q=w.q[idx], scale=w.scale[idx] if w.scale.shape[0] > 1 else w.scale)
    return w[idx]


def gather(w: Union[QTensor, torch.Tensor], group, dim: int):
    """A tensor or `QTensor` shard all-gathered over ``group`` (a
    `repro_torch.launch.mesh.Group`) along ``dim`` (`comm.all_gather`).  A
    `QTensor` gathers its codes, and its scale too where the scale's extent
    along ``dim`` is the codes' (per slot, per column; a broadcast scale
    over one code a rank gathers into equal copies); a scale that spans
    the whole dim already stays."""
    if not isinstance(w, QTensor):
        return comm.all_gather(w, group, dim=dim)
    scale = w.scale
    if scale.shape[dim] == w.q.shape[dim]:
        scale = comm.all_gather(scale, group, dim=dim)
    return QTensor(q=comm.all_gather(w.q, group, dim=dim), scale=scale)


def has_qtensor(tree: Any) -> bool:
    """True when a dict / list tree holds a `QTensor` leaf."""
    if isinstance(tree, QTensor):
        return True
    if isinstance(tree, dict):
        return any(has_qtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(has_qtensor(v) for v in tree)
    return False


# weights worth quantizing in the serve tree (big 2D+ projections)
_QUANT_KEYS = {
    "wq_s", "wk_s", "wv_s", "wo_s", "w1", "w2", "w3",
    "we1", "we2", "we3", "in_proj", "out_proj", "embed", "head",
    "c_wq", "c_wk", "c_wv", "c_wo", "wq", "wk", "wv", "wo",
}
# channel axis per key (the output/channel dim the scale attaches to)
_CHANNEL_AXIS = {
    "wq_s": 0, "wk_s": 0, "wv_s": 0, "wo_s": 3,
    "w1": 1, "w3": 1, "w2": 1,
    "we1": 2, "we3": 2, "we2": 2,
    "in_proj": 1, "out_proj": 1, "embed": 0, "head": 0,
    "c_wq": 1, "c_wk": 1, "c_wv": 1, "c_wo": 2,
    "wq": 1, "wk": 1, "wv": 1, "wo": 2,
}


def _is_big(v) -> bool:
    return torch.is_tensor(v) and v.ndim >= 2 and v.numel() >= 1 << 16


def quantize_serve_params(serve_params: Any) -> Any:
    """Quantize the large projection weights of a serve-layout param tree
    (a new tree; every other leaf is shared with ``serve_params``)."""
    if isinstance(serve_params, dict):
        return {k: (quantize_weight(v, _CHANNEL_AXIS.get(k, -1))
                    if k in _QUANT_KEYS and _is_big(v) else quantize_serve_params(v))
                for k, v in serve_params.items()}
    if isinstance(serve_params, list):
        return [quantize_serve_params(v) for v in serve_params]
    return serve_params


def operands(x: torch.Tensor, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """(activation, weight) for a product, typed as jnp types it: a
    `QTensor` is dequantized to bf16 first, then both sides take the
    promoted dtype (``torch.matmul`` does not promote; an operand already
    in that dtype is returned as it is, without a copy)."""
    w = deq(w)
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt), w.to(dt)
