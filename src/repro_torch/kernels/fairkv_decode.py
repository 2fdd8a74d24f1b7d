"""fairkv_decode: slot-layout decode attention with per-(slot, row) lengths.

The FairKV decode hot loop.  On a CUDA tensor it launches the hand-written
Hopper kernel ``csrc/fairkv_decode.cu`` (the port of the TPU kernel
``repro.kernels.fairkv_decode.fairkv_decode_pallas``); its plain version is
`repro_torch.kernels.ref.fairkv_decode_ref`, which the CPU path runs and
the card is checked against.  The source notes the kernel's design and
what bounds it.

The launch is the CUDA body of the custom op ``repro_torch::fairkv_decode``;
its fake implementation gives the output and the split merge's scratch
and counters, and its FLOP formula counts the plain version's products.

`fairkv_decode_partial_cuda` (custom op ``repro_torch::fairkv_decode_partial``)
is the same kernel's partial variant for split-S decode, whose plain
version is `repro_torch.kernels.ref.fairkv_decode_partial_ref`: on one
shard of the cache's columns it returns the fp32 output before the
cross-shard normalisation and its log-sum-exp, which
`repro_torch.kernels.ref.merge_partials` combines over the shards.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

NAME = "fairkv_decode"
PARTIAL = "fairkv_decode_partial"  # the partial variant's launch counter
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# query heads per kv head the kernel is built for (5 and 7 split as 8, with
# the missing heads masked inside the kernel)
GROUP_SIZES = (1, 2, 4, 5, 7, 8)
# head dims the kernel is built for: any up to 128, and 256
MAX_HEAD_DIM = 256


NCLS = 8  # column classes of the split merge (csrc/fairkv_decode.cu)
SEG = 4096  # columns per segment of the cache (csrc/col_segments.cuh)


def segments(C: int) -> int:
    """Segments of a cache of ``C`` columns (the grid's third dimension)."""
    return -(-C // SEG)


def scratch_floats(B: int, S: int, G: int, Dh: int, C: int) -> int:
    """The merge scratch of one launch over ``C`` cache columns, in floats
    (the library's ``fairkv_decode_scratch_floats``): the states of every
    (slot, row, segment, class, head)."""
    return S * B * segments(C) * NCLS * G * (Dh + 2)


def counters(B: int, S: int, C: int) -> int:
    """The arrival counters of one launch (the library's
    ``fairkv_decode_counters``): one per (slot, row), and past one segment
    also one per (slot, row, segment)."""
    n = segments(C)
    return S * B * (1 + n if n > 1 else 1)


_LIB: Optional[ctypes.CDLL] = None


def _launcher() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load(NAME)
        fn = lib.fairkv_decode_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        part = lib.fairkv_decode_partial_launch
        part.restype = ctypes.c_int
        part.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.fairkv_decode_scratch_floats.restype = ctypes.c_longlong
        lib.fairkv_decode_scratch_floats.argtypes = [ctypes.c_int] * 5
        lib.fairkv_decode_counters.restype = ctypes.c_longlong
        lib.fairkv_decode_counters.argtypes = [ctypes.c_int] * 3
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
    _validate(q, k, v, lengths, k_pos, q_pos, window)
    return torch.ops.repro_torch.fairkv_decode(q, k, v, lengths, float(attn_cap), k_pos,
                                               q_pos, int(window))


def fairkv_decode_partial_cuda(
    q: torch.Tensor,  # (B, S, G, Dh) fp32 or bf16
    k: torch.Tensor,  # (S, B, C_loc, Dh): the rank's shard of the columns
    v: torch.Tensor,
    lengths: torch.Tensor,  # (S, B) int32: the shard's valid prefix
    attn_cap: float = 0.0,
    k_pos: Optional[torch.Tensor] = None,  # (S, B, C_loc) int32
    q_pos: Optional[torch.Tensor] = None,  # (B,) int32
    window: int = 0,
):
    """Launch the partial variant; returns (o (B, S, G, Dh) fp32, lse
    (B, S, G) fp32), `fairkv_decode_partial_ref`'s."""
    _validate(q, k, v, lengths, k_pos, q_pos, window)
    return torch.ops.repro_torch.fairkv_decode_partial(q, k, v, lengths, float(attn_cap),
                                                       k_pos, q_pos, int(window))


def _validate(q, k, v, lengths, k_pos, q_pos, window) -> None:
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


def _launch(entry: str, counter: str, outs, q, k, v, lengths, attn_cap, k_pos, q_pos,
            window) -> None:
    """Launch the library's ``entry`` (the full or partial variant) writing
    to the pointers ``outs``, with the shared scratch and counters; count
    the launch under ``counter``."""
    B, S, G, Dh = q.shape
    C = k.shape[2]
    lib = _launcher()
    scratch = _buffer(_SCRATCH, q.device, lib.fairkv_decode_scratch_floats(B, S, G, Dh, C),
                      torch.float32)
    arrivals = _buffer(_COUNTERS, q.device, lib.fairkv_decode_counters(B, S, C), torch.int32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = getattr(lib, entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        k_pos.data_ptr() if window > 0 else None,
        q_pos.data_ptr() if window > 0 else None,
        *outs, scratch.data_ptr(), arrivals.data_ptr(),
        B, S, G, C, Dh, float(attn_cap), int(window),
        _DTYPE_CODES[q.dtype], stream)
    build.check(lib, NAME, err)
    build.LAUNCHES[counter] += 1


@torch.library.custom_op("repro_torch::fairkv_decode", mutates_args=(), device_types="cuda")
def _fairkv_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor, attn_cap: float, k_pos: Optional[torch.Tensor],
                      q_pos: Optional[torch.Tensor], window: int) -> torch.Tensor:
    out = torch.empty_like(q)
    _launch("fairkv_decode_launch", NAME, (out.data_ptr(),), q, k, v, lengths, attn_cap,
            k_pos, q_pos, window)
    return out


@_fairkv_decode_op.register_fake
def _(q, k, v, lengths, attn_cap, k_pos, q_pos, window):
    B, S, G, Dh = q.shape
    out = torch.empty_like(q)
    build.note_alloc(out, q.new_empty((scratch_floats(B, S, G, Dh, k.shape[2]),),
                                      dtype=torch.float32),
                     q.new_empty((counters(B, S, k.shape[2]),), dtype=torch.int32))
    return out


@torch.library.custom_op("repro_torch::fairkv_decode_partial", mutates_args=(),
                         device_types="cuda")
def _fairkv_decode_partial_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              lengths: torch.Tensor, attn_cap: float,
                              k_pos: Optional[torch.Tensor], q_pos: Optional[torch.Tensor],
                              window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("fairkv_decode_partial_launch", PARTIAL, (o.data_ptr(), lse.data_ptr()), q, k, v,
            lengths, attn_cap, k_pos, q_pos, window)
    return o, lse


@_fairkv_decode_partial_op.register_fake
def _(q, k, v, lengths, attn_cap, k_pos, q_pos, window):
    B, S, G, Dh = q.shape
    o = q.new_empty(q.shape, dtype=torch.float32)
    lse = q.new_empty((B, S, G), dtype=torch.float32)
    build.note_alloc(o, lse,
                     q.new_empty((scratch_floats(B, S, G, Dh, k.shape[2]),),
                                 dtype=torch.float32),
                     q.new_empty((counters(B, S, k.shape[2]),), dtype=torch.int32))
    return o, lse


@register_flop_formula(torch.ops.repro_torch.fairkv_decode)
def _flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """q·k and p·v over every one of the C cache columns, as the plain
    version's two products count."""
    B, S, G, Dh = q_shape
    return 4 * B * S * G * k_shape[2] * Dh


@register_flop_formula(torch.ops.repro_torch.fairkv_decode_partial)
def _flops_partial(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """The full-output kernel's count over the shard's C_loc columns."""
    B, S, G, Dh = q_shape
    return 4 * B * S * G * k_shape[2] * Dh
