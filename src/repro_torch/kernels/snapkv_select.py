"""snapkv_scores: SnapKV observation-window importance scores.

    imp[b, h, t] = Σ_{w, g} softmax_T(q[b, w, h, g] · k[b, :, h])_t

The compression hot spot at prefill.  On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/snapkv_scores.cu`` (two passes; the port
of the TPU kernel ``repro.kernels.snapkv_select.snapkv_scores_pallas``);
its plain version is `repro_torch.kernels.ref.snapkv_scores_ref`, which the
CPU path runs and the card is checked against.

The launch is the CUDA body of the custom op ``repro_torch::snapkv_scores``;
its fake implementation gives the output and the two passes' (m, l)
partials, and its FLOP formula counts the plain version's product.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

NAME = "snapkv_scores"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232_448  # bytes of shared memory one Hopper block may use
MAX_HEAD_DIM = 256


TILE = 64  # keys per tile (csrc/snapkv_scores.cu: TT)
TARGET_BLOCKS = 2 * 132  # about two blocks per SM


def splits(B: int, Hkv: int, T: int) -> int:
    """Key splits of one launch (the library's ``snapkv_scores_splits``)."""
    ntiles = -(-T // TILE)
    want = min(max(TARGET_BLOCKS // (B * Hkv), 1), ntiles)
    tps = -(-ntiles // want)
    return -(-ntiles // tps)


_LIB: Optional[ctypes.CDLL] = None


def _launcher() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = build.load(NAME)
        fn = lib.snapkv_scores_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        sm = lib.snapkv_scores_smem_bytes
        sm.restype = ctypes.c_longlong
        sm.argtypes = [ctypes.c_int] * 3
        lib.snapkv_scores_splits.restype = ctypes.c_int
        lib.snapkv_scores_splits.argtypes = [ctypes.c_int] * 3
        _LIB = lib
    return _LIB


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(f"{NAME}: {msg}")


def snapkv_scores_cuda(
    q_obs: torch.Tensor,  # (B, W, Hq, Dh) fp32 or bf16
    k: torch.Tensor,  # (B, T, Hkv, Dh) same dtype
    obs_positions: torch.Tensor,  # (B, W) int32
    k_positions: torch.Tensor,  # (B, T) int32
    attn_cap: float = 0.0,
) -> torch.Tensor:
    """Launch the two-pass CUDA kernel; returns (B, Hkv, T) fp32."""
    _validate(q_obs, k, obs_positions, k_positions)
    return torch.ops.repro_torch.snapkv_scores(q_obs, k, obs_positions, k_positions,
                                               float(attn_cap))


def _validate(q_obs, k, obs_positions, k_positions) -> None:
    B, W, Hq, Dh = q_obs.shape
    T, Hkv = k.shape[1], k.shape[2]
    _require(q_obs.is_cuda, f"q_obs must be a CUDA tensor, got {q_obs.device}")
    _require(q_obs.dtype in _DTYPE_CODES, f"dtype {q_obs.dtype} not supported")
    _require(k.shape == (B, T, Hkv, Dh) and Hq % Hkv == 0,
             f"k shape {tuple(k.shape)} does not match q_obs {tuple(q_obs.shape)}")
    _require(k.dtype == q_obs.dtype, "q_obs/k dtypes differ")
    _require(obs_positions.shape == (B, W) and obs_positions.dtype == torch.int32,
             "obs_positions must be (B, W) int32")
    _require(k_positions.shape == (B, T) and k_positions.dtype == torch.int32,
             "k_positions must be (B, T) int32")
    for t in (q_obs, k, obs_positions, k_positions):
        _require(t.device == q_obs.device, "all inputs must be on one device")
        _require(t.is_contiguous(), "inputs must be contiguous")
    _require(Dh <= MAX_HEAD_DIM, f"head_dim {Dh} > {MAX_HEAD_DIM}")


@torch.library.custom_op("repro_torch::snapkv_scores", mutates_args=(), device_types="cuda")
def _snapkv_scores_op(q_obs: torch.Tensor, k: torch.Tensor, obs_positions: torch.Tensor,
                      k_positions: torch.Tensor, attn_cap: float) -> torch.Tensor:
    B, W, Hq, Dh = q_obs.shape
    T, Hkv = k.shape[1], k.shape[2]
    lib = _launcher()
    G = Hq // Hkv
    smem = lib.snapkv_scores_smem_bytes(W, Dh, _DTYPE_CODES[q_obs.dtype])
    _require(smem <= SMEM_LIMIT,
             f"W={W}, Dh={Dh} needs {smem} B of shared memory, more than "
             f"{SMEM_LIMIT}")
    n_split = lib.snapkv_scores_splits(B, Hkv, T)
    ml = torch.empty((B, Hkv, W * G, n_split, 2), dtype=torch.float32, device=q_obs.device)
    out = torch.empty((B, Hkv, T), dtype=torch.float32, device=q_obs.device)
    stream = torch.cuda.current_stream(q_obs.device).cuda_stream
    err = lib.snapkv_scores_launch(
        q_obs.data_ptr(), k.data_ptr(), obs_positions.data_ptr(),
        k_positions.data_ptr(), ml.data_ptr(), out.data_ptr(),
        B, W, Hq, Hkv, T, Dh, float(attn_cap), _DTYPE_CODES[q_obs.dtype], stream)
    build.check(lib, NAME, err)
    build.LAUNCHES[NAME] += 1
    return out


@_snapkv_scores_op.register_fake
def _(q_obs, k, obs_positions, k_positions, attn_cap):
    B, W, Hq, _ = q_obs.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = q_obs.new_empty((B, Hkv, T), dtype=torch.float32)
    build.note_alloc(out, q_obs.new_empty((B, Hkv, W * (Hq // Hkv), splits(B, Hkv, T), 2),
                                          dtype=torch.float32))
    return out


@register_flop_formula(torch.ops.repro_torch.snapkv_scores)
def _flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    """q·k of every window query against every key (the plain version's
    product)."""
    B, W, Hq, Dh = q_shape
    return 2 * B * W * Hq * k_shape[1] * Dh
