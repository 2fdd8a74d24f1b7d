"""fairkv_decode: slot-layout decode attention with per-(slot, row) lengths.

The FairKV decode hot loop.  On a CUDA tensor it launches the hand-written
Hopper kernel ``csrc/fairkv_decode.cu`` (the port of the TPU kernel
``repro.kernels.fairkv_decode.fairkv_decode_pallas``); its plain version is
`repro_torch.kernels.ref.fairkv_decode_ref`, which the CPU path runs and
the card is checked against.  The source notes the kernel's design and
what bounds it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "fairkv_decode"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
GROUP_SIZES = (1, 2, 4, 8)  # query heads per kv head the kernel is built for
MAX_HEAD_DIM = 128


def _launcher() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.fairkv_decode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    return lib


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"{NAME}: {msg}")


def fairkv_decode_cuda(
    q: torch.Tensor,  # (B, S, G, Dh) fp32 or bf16
    k: torch.Tensor,  # (S, B, C, Dh) same dtype
    v: torch.Tensor,  # (S, B, C, Dh) same dtype
    lengths: torch.Tensor,  # (S, B) int32
    attn_cap: float = 0.0,
    k_pos: Optional[torch.Tensor] = None,  # (S, B, C) int32
    q_pos: Optional[torch.Tensor] = None,  # (B,) int32
    window: int = 0,
) -> torch.Tensor:
    """Launch the CUDA kernel; returns (B, S, G, Dh) in q's dtype."""
    B, S, G, Dh = q.shape
    C = k.shape[2]
    _require(q.is_cuda, f"q must be a CUDA tensor, got {q.device}")
    _require(q.dtype in _DTYPE_CODES, f"dtype {q.dtype} not supported")
    _require(G in GROUP_SIZES, f"G={G} not in {GROUP_SIZES}")
    _require(Dh <= MAX_HEAD_DIM, f"head_dim {Dh} > {MAX_HEAD_DIM}")
    _require(k.shape == (S, B, C, Dh) and v.shape == k.shape,
             f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} do not match q "
             f"{tuple(q.shape)}")
    _require(k.dtype == q.dtype and v.dtype == q.dtype, "q/k/v dtypes differ")
    _require(lengths.shape == (S, B) and lengths.dtype == torch.int32,
             "lengths must be (S, B) int32")
    tensors = [q, k, v, lengths]
    if window > 0:
        _require(k_pos is not None and q_pos is not None,
                 "window > 0 needs k_pos and q_pos")
        _require(k_pos.shape == (S, B, C) and k_pos.dtype == torch.int32,
                 "k_pos must be (S, B, C) int32")
        _require(q_pos.shape == (B,) and q_pos.dtype == torch.int32,
                 "q_pos must be (B,) int32")
        tensors += [k_pos, q_pos]
    for t in tensors:
        _require(t.device == q.device, "all inputs must be on one device")
        _require(t.is_contiguous(), "inputs must be contiguous")
    out = torch.empty_like(q)
    lib = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.fairkv_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        k_pos.data_ptr() if window > 0 else None,
        q_pos.data_ptr() if window > 0 else None,
        out.data_ptr(), B, S, G, C, Dh, float(attn_cap), int(window),
        _DTYPE_CODES[q.dtype], stream)
    build.check(lib, NAME, err)
    build.LAUNCHES[NAME] += 1
    return out
