"""paged_fairkv_decode: decode attention over block pools through a block
table, with int8 / fp8 pools dequantized in the loop.

One hand-written Hopper kernel body (``csrc/paged_decode.cuh``) behind two
entry points, one per query shape:

- ``paged_fairkv_decode_cuda`` (4-D q, one query per row) launches its
  Q = 1 instantiation, ``csrc/paged_fairkv_decode.cu``, the port of the TPU
  kernel ``repro.kernels.paged_fairkv_decode.paged_fairkv_decode_pallas``;
- ``paged_fairkv_decode_mq_cuda`` (5-D q, the Q queries of a speculative
  verify window per row, ragged ``q_lens``) launches
  ``csrc/paged_fairkv_decode_mq.cu``, the port of ``_paged_decode_pallas_mq``.

Their plain version is `repro_torch.kernels.ref.paged_fairkv_decode_ref`,
which the CPU path runs and the card is checked against.  The header notes
the kernel's design and what bounds it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fairkv_decode import _buffer

NAME = "paged_fairkv_decode"
NAME_MQ = "paged_fairkv_decode_mq"
_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_POOL_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
GROUP_SIZES = (1, 2, 4, 8)  # query heads per kv head the kernels are built for
MAX_HEAD_DIM = 128
MAX_QUERY_ROWS = 40  # Q * G the multi-query kernel is built for

_LIBS: Dict[str, ctypes.CDLL] = {}


def _launcher(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s library, built and loaded at first use, with its C
    signatures declared."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = build.load(name)
        mq = name == NAME_MQ
        fn = getattr(lib, f"{name}_launch")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * (14 if mq else 13) + [ctypes.c_int] * (8 if mq else 7)
                       + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        scratch = getattr(lib, f"{name}_scratch_floats")
        scratch.restype = ctypes.c_longlong
        scratch.argtypes = [ctypes.c_int] * (5 if mq else 4)
        if mq:
            lib.paged_fairkv_decode_mq_counters.restype = ctypes.c_int
            lib.paged_fairkv_decode_mq_counters.argtypes = [ctypes.c_int] * 3
        _LIBS[name] = lib
    return lib


# Per device, the merge's scratch and its per-(slot, row, query chunk)
# arrival counters (zero before a launch; the launch leaves them zero).
# Launches on one stream run in order, so both kernels share them.
_SCRATCH: Dict[torch.device, torch.Tensor] = {}
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def _require(ok: bool, msg: str, name: str = NAME) -> None:
    if not ok:
        raise ValueError(f"{name}: {msg}")


def _check(name, q, k_pool, v_pool, pos_pool, block_table, lengths, capacity,
           q_pos, window, k_scale, v_scale, kinds) -> List[torch.Tensor]:
    """Validate the operands both kernels share (q is (B, S, ..., Dh));
    returns the tensors the launch reads."""
    B, S, Dh = q.shape[0], q.shape[1], q.shape[-1]
    G = q.shape[-2]
    N, bs = k_pool.shape[0], k_pool.shape[1]
    M = block_table.shape[2]
    req = lambda ok, msg: _require(ok, msg, name)  # noqa: E731
    req(q.is_cuda, f"q must be a CUDA tensor, got {q.device}")
    req(q.dtype in _Q_DTYPES, f"q dtype {q.dtype} not supported")
    req(G in GROUP_SIZES, f"G={G} not in {GROUP_SIZES}")
    req(Dh <= MAX_HEAD_DIM, f"head_dim {Dh} > {MAX_HEAD_DIM}")
    req(M * bs >= capacity, f"block table spans {M}x{bs} tokens < capacity {capacity}")
    req(k_pool.shape == (N, bs, Dh) and v_pool.shape == k_pool.shape,
        f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not "
        f"match head_dim {Dh}")
    req(pos_pool.shape == (N, bs) and pos_pool.dtype == torch.int32,
        "pos_pool must be (N, bs) int32")
    req(block_table.shape == (S, B, M) and block_table.dtype == torch.int32,
        "block_table must be (S, B, M) int32")
    req(lengths.shape == (S, B) and lengths.dtype == torch.int32,
        "lengths must be (S, B) int32")
    req(v_pool.dtype == k_pool.dtype, "k/v pool dtypes differ")
    tensors = [q, k_pool, v_pool, pos_pool, block_table, lengths]
    if k_scale is not None:
        req(k_pool.dtype == torch.int8, "scales given but the pools are not int8")
        req(v_scale is not None and k_scale.shape == (N,) and v_scale.shape == (N,)
            and k_scale.dtype == torch.float32 and v_scale.dtype == torch.float32,
            "scales must be (N,) fp32")
        tensors += [k_scale, v_scale]
        if kinds is not None:
            req(kinds.shape == (S,) and kinds.dtype == torch.int32,
                "kinds must be (S,) int32")
            tensors.append(kinds)
    else:
        req(k_pool.dtype == q.dtype,
            f"pool dtype {k_pool.dtype} != q dtype {q.dtype} without scales")
    if window > 0:
        req(q_pos is not None and q_pos.shape == (B,) and q_pos.dtype == torch.int32,
            "window > 0 needs q_pos (B,) int32")
        tensors.append(q_pos)
    for t in tensors:
        req(t.device == q.device, "all inputs must be on one device")
        req(t.is_contiguous(), "inputs must be contiguous")
    return tensors


def _stream(q: torch.Tensor) -> int:
    with torch.cuda.device(q.device):
        return torch.cuda.current_stream().cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


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
    """Launch the single-query CUDA kernel; returns (B, S, G, Dh) in q's
    dtype."""
    _require(q.dim() == 4, f"q must be (B, S, G, Dh), got {tuple(q.shape)}")
    _check(NAME, q, k_pool, v_pool, pos_pool, block_table, lengths, capacity,
           q_pos, window, k_scale, v_scale, kinds)
    return _launch(NAME, q, k_pool, v_pool, pos_pool, block_table, lengths, capacity,
                   attn_cap, q_pos, window, k_scale, v_scale, kinds, None)


def paged_fairkv_decode_mq_cuda(
    q: torch.Tensor,  # (B, S, Q, G, Dh) fp32 or bf16
    k_pool: torch.Tensor,  # (N, bs, Dh) q's dtype, or int8 codes
    v_pool: torch.Tensor,  # (N, bs, Dh)
    pos_pool: torch.Tensor,  # (N, bs) int32
    block_table: torch.Tensor,  # (S, B, M) int32; <= 0 = null block
    lengths: torch.Tensor,  # (S, B) int32, counting the window's appends
    capacity: int,
    attn_cap: float = 0.0,
    q_pos: Optional[torch.Tensor] = None,  # (B,) int32 position of query 0
    window: int = 0,
    k_scale: Optional[torch.Tensor] = None,  # (N,) fp32, int8 pools only
    v_scale: Optional[torch.Tensor] = None,
    kinds: Optional[torch.Tensor] = None,  # (S,) int32, int8 pools only
    q_lens: Optional[torch.Tensor] = None,  # (B,) int32 valid queries (<= Q)
) -> torch.Tensor:
    """Launch the multi-query CUDA kernel; returns (B, S, Q, G, Dh) in q's
    dtype."""
    _require(q.dim() == 5, f"q must be (B, S, Q, G, Dh), got {tuple(q.shape)}", NAME_MQ)
    _check(NAME_MQ, q, k_pool, v_pool, pos_pool, block_table, lengths, capacity,
           q_pos, window, k_scale, v_scale, kinds)
    B, S, Q, G, Dh = q.shape
    _require(Q * G <= MAX_QUERY_ROWS,
             f"Q*G = {Q}*{G} > {MAX_QUERY_ROWS} query rows", NAME_MQ)
    if q_lens is not None:
        _require(q_lens.shape == (B,) and q_lens.dtype == torch.int32
                 and q_lens.device == q.device and q_lens.is_contiguous(),
                 "q_lens must be (B,) int32 on q's device", NAME_MQ)
    return _launch(NAME_MQ, q, k_pool, v_pool, pos_pool, block_table, lengths, capacity,
                   attn_cap, q_pos, window, k_scale, v_scale, kinds, q_lens)


def _launch(name, q, k_pool, v_pool, pos_pool, block_table, lengths, capacity,
            attn_cap, q_pos, window, k_scale, v_scale, kinds, q_lens):
    """One launch of kernel ``name`` on validated operands; returns the
    output in q's shape and dtype."""
    lib = _launcher(name)
    mq = name == NAME_MQ
    B, S, Dh = q.shape[0], q.shape[1], q.shape[-1]
    G = q.shape[-2]
    Q = q.shape[2] if mq else 1
    if mq:
        n_scratch = lib.paged_fairkv_decode_mq_scratch_floats(B, S, Q, G, Dh)
        n_counters = lib.paged_fairkv_decode_mq_counters(B, S, Q)
    else:
        n_scratch = lib.paged_fairkv_decode_scratch_floats(B, S, G, Dh)
        n_counters = S * B
    scratch = _buffer(_SCRATCH, q.device, n_scratch, torch.float32)
    counters = _buffer(_COUNTERS, q.device, n_counters, torch.int32)
    quant = k_scale is not None
    out = torch.empty_like(q)
    ptrs = ([q, k_pool, v_pool, pos_pool, block_table, lengths,
             q_pos if window > 0 else None] + ([q_lens] if mq else [])
            + [k_scale, v_scale, kinds if quant else None, out, scratch, counters])
    ints = [B, S] + ([Q] if mq else []) + [G, block_table.shape[2], k_pool.shape[1], Dh,
                                           int(capacity)]
    err = getattr(lib, f"{name}_launch")(
        *map(_ptr, ptrs), *ints, float(attn_cap), int(window), _Q_DTYPES[q.dtype],
        _POOL_DTYPES[k_pool.dtype], _stream(q))
    build.check(lib, name, err)
    build.LAUNCHES[name] += 1
    return out
