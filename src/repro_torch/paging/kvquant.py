"""Per-block KV quantization for the paged cache (port of
``repro.paging.kvquant``).

Quantized pools store **int8 codes** (1 byte per value); values quantized
as fp8 (``torch.float8_e4m3fn``) are stored as their bit patterns in the
same int8 pool, so mixing formats per head never changes the pool's dtype.
Beside each pool sits an (L, N) fp32 **scale pool**, one scale per block
(a block belongs to one (slot, row), hence one head): ``value =
decode(code) * scale``.  A static per-(layer, head) **kind grid** (0 =
int8, 1 = fp8) selects the interpretation; per-slot kinds follow from the
plan's ``slot_head``.

The codec is symmetric per block: ``scale = amax / qmax`` over the block's
valid entries; int8 codes are ``round(x / scale)`` (half to even, as
``jnp.round``) clipped to ±127, fp8 codes are ``x / scale`` clipped to ±448
and cast (round to nearest even).  On the same inputs the codes and scales
equal the reference's bit for bit.  ``decode`` flushes fp8 NaN patterns to
0: never-written pool memory may hold them, and although such entries are
always masked by length, 0·NaN would poison a masked-out weighted sum.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

# kv_dtype values accepted by PagingConfig ("fp32" = no quantization: pools
# stay in the engine dtype and no scale pools exist)
KV_DTYPES = ("fp32", "int8", "fp8")
QUANT_DTYPES = ("int8", "fp8")

INT8_QMAX = 127.0
FP8_QMAX = 448.0  # max finite magnitude of float8_e4m3fn

KIND_INT8 = 0
KIND_FP8 = 1
_KIND_OF = {"int8": KIND_INT8, "fp8": KIND_FP8}


def fp8_supported() -> bool:
    """True when this torch has float8_e4m3fn (the fp8 storage format)."""
    return hasattr(torch, "float8_e4m3fn")


@dataclass(frozen=True)
class KVQuantSpec:
    """Base format ("int8" | "fp8") plus sorted ``(layer, head, dtype)``
    overrides.  Storage is int8 either way; the spec decides each head's
    interpretation."""

    base: str
    overrides: Tuple[Tuple[int, int, str], ...] = ()


def spec_from_paging(paging) -> Optional[KVQuantSpec]:
    """The quantization spec a PagingConfig implies (None = unquantized)."""
    if paging is None or getattr(paging, "kv_dtype", "fp32") == "fp32":
        return None
    return KVQuantSpec(base=paging.kv_dtype,
                       overrides=tuple(paging.kv_dtype_overrides))


def kind_grid(spec: KVQuantSpec, n_layers: int, n_heads: int) -> np.ndarray:
    """(L, H) int32 kind codes — the static interpretation grid."""
    grid = np.full((n_layers, n_heads), _KIND_OF[spec.base], np.int32)
    for layer, head, dt in spec.overrides:
        if layer >= n_layers or head >= n_heads:
            raise ValueError(
                f"kv_dtype override ({layer}, {head}) out of range for "
                f"{n_layers} layers x {n_heads} kv heads")
        grid[layer, head] = _KIND_OF[dt]
    return grid


def slot_kinds(grid: np.ndarray, slot_head: np.ndarray) -> np.ndarray:
    """(L, S) int32 per-slot kinds under a plan's ``slot_head`` (empty
    slots, head -1, borrow head 0's kind: they own nothing)."""
    sh = np.maximum(np.asarray(slot_head, np.int64), 0)
    return np.take_along_axis(np.asarray(grid, np.int32), sh, axis=1)


def qmax_of(kind) -> torch.Tensor:
    """Per-kind quantization range (broadcasts over a kind tensor)."""
    return torch.where(torch.as_tensor(kind) == KIND_FP8, FP8_QMAX, INT8_QMAX)


def encode(x: torch.Tensor, scale: torch.Tensor, kind) -> torch.Tensor:
    """float → int8 codes under a per-block ``scale`` and ``kind`` (both
    broadcast against ``x``); a zero scale (empty block) encodes to 0."""
    kind = torch.as_tensor(kind, device=x.device)
    safe = torch.where(scale > 0, scale, 1.0)
    y = x.float() / safe
    codes = torch.clamp(torch.round(y), -INT8_QMAX, INT8_QMAX).to(torch.int8)
    y8 = torch.clamp(y, -FP8_QMAX, FP8_QMAX).to(torch.float8_e4m3fn)
    return torch.where(kind == KIND_FP8, y8.view(torch.int8), codes)


def decode(codes: torch.Tensor, scale: torch.Tensor, kind) -> torch.Tensor:
    """int8 codes → fp32 values (inverse of `encode`; flushes fp8 NaN)."""
    kind = torch.as_tensor(kind, device=codes.device)
    f = codes.float()
    f8 = codes.view(torch.float8_e4m3fn).float()
    f8 = torch.where(f8 == f8, f8, 0.0)
    return torch.where(kind == KIND_FP8, f8, f) * scale


def quantize_blocks(x: torch.Tensor, pos: torch.Tensor, block_size: int,
                    kind) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-quantize a slot-layout tensor → (codes, scales).

    ``x`` is (..., C, Dh) with entry positions ``pos`` (..., C); C must be a
    multiple of ``block_size``.  Entries with ``pos < 0`` are invalid: they
    stay out of each block's amax and their codes are 0.  ``kind``
    broadcasts against the block axes, e.g. (L, S, 1, 1) against
    (L, S, B, M).  Returns int8 codes shaped like ``x`` and (..., C // bs)
    fp32 scales.
    """
    bs = int(block_size)
    *lead, C, Dh = x.shape
    if C % bs:
        raise ValueError(f"capacity {C} not a multiple of block size {bs}")
    M = C // bs
    kind = torch.as_tensor(kind, device=x.device)
    xb = x.reshape(*lead, M, bs, Dh).float()
    valid = (pos >= 0).reshape(*lead, M, bs)
    amax = torch.amax(xb.abs() * valid[..., None], dim=(-2, -1))
    scales = amax / qmax_of(kind)
    codes = encode(xb, scales[..., None, None], kind[..., None, None])
    codes = torch.where(valid[..., None], codes, 0).to(torch.int8)
    return codes.reshape(*lead, C, Dh), scales


def roundtrip_error(x: torch.Tensor, pos: torch.Tensor, block_size: int,
                    kind) -> Tuple[float, float]:
    """(Σ|deq(q(x)) − x|, Σ|x|) over valid entries: the codec's relative
    error on a slot-layout tensor."""
    bs = int(block_size)
    pad = (-x.shape[-2]) % bs
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        pos = torch.nn.functional.pad(pos, (0, pad), value=-1)
    *lead, C2, Dh = x.shape
    M = C2 // bs
    kind = torch.as_tensor(kind, device=x.device)
    codes, scales = quantize_blocks(x, pos, bs, kind)
    deq = decode(codes.reshape(*lead, M, bs, Dh), scales[..., None, None],
                 kind[..., None, None]).reshape(*lead, C2, Dh)
    valid = (pos >= 0)[..., None]
    err = (deq - x.float()).abs() * valid
    den = x.float().abs() * valid
    return float(err.sum()), float(den.sum())
