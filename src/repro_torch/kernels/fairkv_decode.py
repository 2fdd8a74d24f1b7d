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
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import build

NAME = "fairkv_decode"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
GROUP_SIZES = (1, 2, 4, 8)  # query heads per kv head the kernel is built for
# head dims the kernel is built for: any up to 128, and 256
MAX_HEAD_DIM = 256


_LIB: Optional[ctypes.CDLL] = None


def _launcher() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load(NAME)
        fn = lib.fairkv_decode_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.fairkv_decode_scratch_floats.restype = ctypes.c_longlong
        lib.fairkv_decode_scratch_floats.argtypes = [ctypes.c_int] * 4
        _LIB = lib
    return _LIB


# Per device, the split merge's scratch and its per-(slot, row) arrival
# counters (zero before a launch; the launch leaves them zero).  Launches
# on one stream run in order, so they share both.
_SCRATCH: Dict[torch.device, torch.Tensor] = {}
_COUNTERS: Dict[torch.device, torch.Tensor] = {}
# outgrown buffers stay allocated: a captured CUDA graph keeps launching
# with the address it was captured with
_OUTGROWN: List[torch.Tensor] = []


def _buffer(pool: Dict[torch.device, torch.Tensor], device: torch.device, n: int,
            dtype: torch.dtype) -> torch.Tensor:
    buf = pool.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{NAME}: a scratch buffer of {n} elements is needed inside a "
                f"CUDA graph capture; run the step eagerly at this shape first")
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros(n, dtype=dtype, device=device)
        pool[device] = buf
    return buf


def _require(ok: bool, msg: str, *detail) -> None:
    """Raise unless ``ok``; ``detail`` is formatted only on failure (the
    checks run on every decode launch)."""
    if not ok:
        raise ValueError(" ".join([f"{NAME}: {msg}", *map(str, detail)]))


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
    _require(q.is_cuda, "q must be a CUDA tensor, got", q.device)
    _require(q.dtype in _DTYPE_CODES, "dtype not supported:", q.dtype)
    _require(G in GROUP_SIZES, "G not in", GROUP_SIZES)
    _require(Dh <= 128 or Dh == MAX_HEAD_DIM, "head_dim is neither <= 128 nor 256:", Dh)
    _require(k.shape == (S, B, C, Dh) and v.shape == k.shape,
             "k/v shapes do not match q:", k.shape, v.shape, q.shape)
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
    scratch = _buffer(_SCRATCH, q.device, lib.fairkv_decode_scratch_floats(B, S, G, Dh),
                      torch.float32)
    counters = _buffer(_COUNTERS, q.device, S * B, torch.int32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.fairkv_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        k_pos.data_ptr() if window > 0 else None,
        q_pos.data_ptr() if window > 0 else None,
        out.data_ptr(), scratch.data_ptr(), counters.data_ptr(),
        B, S, G, C, Dh, float(attn_cap), int(window),
        _DTYPE_CODES[q.dtype], stream)
    build.check(lib, NAME, err)
    build.LAUNCHES[NAME] += 1
    return out
