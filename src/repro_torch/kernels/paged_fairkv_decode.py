"""paged_fairkv_decode: decode attention over block pools through a block
table, with int8 / fp8 pools dequantized in the loop.

On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/paged_fairkv_decode.cu`` (the port of the TPU kernel
``repro.kernels.paged_fairkv_decode.paged_fairkv_decode_pallas``,
single-query form); its plain version is
`repro_torch.kernels.ref.paged_fairkv_decode_ref`, which the CPU path runs
and the card is checked against.  The source notes the kernel's design and
what bounds it.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

NAME = "paged_fairkv_decode"
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
GROUP_SIZES = (1, 2, 4, 8)  # query heads per kv head the kernel is built for
MAX_HEAD_DIM = 128


def _launcher() -> ctypes.CDLL:
    lib = build.load(NAME)
    fn = lib.paged_fairkv_decode_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    return lib


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"{NAME}: {msg}")


def paged_fairkv_decode_cuda(
    q: torch.Tensor,  # (B, S, G, Dh) fp32 or bf16
    k_pool: torch.Tensor,  # (N, bs, Dh) q's dtype, or int8 codes
    v_pool: torch.Tensor,  # (N, bs, Dh)
    pos_pool: torch.Tensor,  # (N, bs) int32
    block_table: torch.Tensor,  # (S, B, M) int32; <= 0 = null block
    lengths: torch.Tensor,  # (S, B) int32
    capacity: int,
    attn_cap: float = 0.0,
    q_pos: Optional[torch.Tensor] = None,  # (B,) int32, needed for window > 0
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,  # (N,) fp32, int8 pools only
    v_scale: Optional[torch.Tensor] = None,
    kinds: Optional[torch.Tensor] = None,  # (S,) int32, int8 pools only
) -> torch.Tensor:
    """Launch the CUDA kernel; returns (B, S, G, Dh) in q's dtype."""
    B, S, G, Dh = q.shape
    N, bs = k_pool.shape[0], k_pool.shape[1]
    M = block_table.shape[2]
    quant = k_scale is not None
    _require(q.is_cuda, f"q must be a CUDA tensor, got {q.device}")
    _require(q.dtype in _Q_DTYPES, f"q dtype {q.dtype} not supported")
    _require(G in GROUP_SIZES, f"G={G} not in {GROUP_SIZES}")
    _require(Dh <= MAX_HEAD_DIM, f"head_dim {Dh} > {MAX_HEAD_DIM}")
    _require(M * bs >= capacity,
             f"block table spans {M}x{bs} tokens < capacity {capacity}")
    _require(k_pool.shape == (N, bs, Dh) and v_pool.shape == k_pool.shape,
             f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not "
             f"match head_dim {Dh}")
    _require(pos_pool.shape == (N, bs) and pos_pool.dtype == torch.int32,
             "pos_pool must be (N, bs) int32")
    _require(block_table.shape == (S, B, M) and block_table.dtype == torch.int32,
             "block_table must be (S, B, M) int32")
    _require(lengths.shape == (S, B) and lengths.dtype == torch.int32,
             "lengths must be (S, B) int32")
    _require(v_pool.dtype == k_pool.dtype, "k/v pool dtypes differ")
    tensors = [q, k_pool, v_pool, pos_pool, block_table, lengths]
    if quant:
        _require(k_pool.dtype == torch.int8, "scales given but the pools are not int8")
        _require(v_scale is not None and k_scale.shape == (N,)
                 and v_scale.shape == (N,) and k_scale.dtype == torch.float32
                 and v_scale.dtype == torch.float32, "scales must be (N,) fp32")
        tensors += [k_scale, v_scale]
        if kinds is not None:
            _require(kinds.shape == (S,) and kinds.dtype == torch.int32,
                     "kinds must be (S,) int32")
            tensors.append(kinds)
    else:
        _require(k_pool.dtype == q.dtype,
                 f"pool dtype {k_pool.dtype} != q dtype {q.dtype} without scales")
    if window > 0:
        _require(q_pos is not None and q_pos.shape == (B,)
                 and q_pos.dtype == torch.int32, "window > 0 needs q_pos (B,) int32")
        tensors.append(q_pos)
    for t in tensors:
        _require(t.device == q.device, "all inputs must be on one device")
        _require(t.is_contiguous(), "inputs must be contiguous")
    out = torch.empty_like(q)
    lib = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.paged_fairkv_decode_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), pos_pool.data_ptr(),
        block_table.data_ptr(), lengths.data_ptr(),
        ptr(q_pos) if window > 0 else None,
        ptr(k_scale), ptr(v_scale), ptr(kinds) if quant else None,
        out.data_ptr(), B, S, G, M, bs, Dh, float(attn_cap), int(window),
        _Q_DTYPES[q.dtype], _POOL_DTYPES[k_pool.dtype], stream)
    build.check(lib, NAME, err)
    build.LAUNCHES[NAME] += 1
    return out
