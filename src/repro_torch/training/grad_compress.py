"""Int8 error-feedback gradient compression for the gradient all-reduce
(the port of ``repro.training.grad_compress``).

Each leaf is quantized to int8 with one per-tensor scale after adding the
residual the previous step left (error feedback, Karimireddy et al.,
2019), so the scheme stays convergent.  The codes are the reference's
bit for bit (round half to even, clip to +-127).  `compressed_all_reduce`
is the counterpart of the reference's ``compressed_psum``: the sum over a
``torch.distributed`` group runs on the dequantized tensors, as its
``psum`` does; the int8 payload is what a compressed wire format would
carry.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.distributed import comm
from repro_torch.training.optimizer import tree_map


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8; returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(torch.amax(xf.abs()), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_leaf(g: torch.Tensor, err: torch.Tensor):
    """Error-feedback quantization of one gradient leaf.  Returns (q,
    scale, new_err) where new_err = (g + err) - deq(q)."""
    corrected = g.float() + err
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def _split3(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _split3(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_split3(v, i) for v in tree]
    return tree[i]


def compress_tree(grads: Any, err_tree: Any):
    """Quantize every leaf with error feedback: (codes, scales, errors)."""
    out = tree_map(ef_compress_leaf, grads, err_tree)
    return _split3(out, 0), _split3(out, 1), _split3(out, 2)


def decompress_tree(q_tree: Any, scale_tree: Any) -> Any:
    return tree_map(dequantize_int8, q_tree, scale_tree)


def init_error_state(params: Any) -> Any:
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32, device=x.device),
                    params)


def compressed_all_reduce(grads: Any, err_tree: Any, group) -> Tuple[Any, Any]:
    """Sum of the int8-quantized grads over ``group`` (a
    `repro_torch.launch.mesh.Group`), with error feedback.  Returns (the
    summed fp32 grads, the new error tree); every rank of the group ends
    with the same sum."""
    q, s, new_err = compress_tree(grads, err_tree)
    summed = tree_map(lambda t: comm.all_reduce_sum(t, group), decompress_tree(q, s))
    return summed, new_err
