"""`Executor`: the device-execution strategy behind the serving stack.

An executor owns *how* the serving steps run — one prefill step, one
chunked-prefill step, one decode step, and the propose / verify steps of
speculative decoding —
while *what* they compute lives in
``repro_torch.serving.engine``.  The port runs eagerly (PyTorch has no jit
step the port needs); each step ends in a device synchronize, so a caller's
host clock around it measures device time, not enqueue time.  CUDA-graph
capture of the decode step is later work.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.compression.base import CompressionConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.paging import kvquant


class Executor:
    """Interface: ``prefill`` and ``decode`` steps over explicit arguments
    (slot weights ``sp`` and plan arrays ``pa``), so a replan is new
    arguments, never a new executor.

    ``paging`` (a `PagingConfig`) resolves the static (L, H) kind grid of
    int8/fp8 pools once; the decode step indexes it by the plan's
    ``slot_head``, so a replan that moves heads between slots needs no new
    grid.  None on unquantized pools.
    """

    name: str = "?"

    def __init__(self, model_cfg: ModelConfig, ccfg: CompressionConfig,
                 device: torch.device, paging=None):
        self.cfg = model_cfg
        self.ccfg = ccfg
        self.device = torch.device(device)
        spec = kvquant.spec_from_paging(paging)
        self.kv_kinds = (None if spec is None else torch.as_tensor(
            kvquant.kind_grid(spec, model_cfg.n_layers, model_cfg.n_kv_heads),
            device=self.device))

    def synchronize(self) -> None:
        """Wait for the device (no-op on the CPU, which runs synchronously)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, sp: dict, batch: dict, pa,
                rows: Optional[torch.Tensor] = None) -> Tuple:
        """Prefill step → (ServeState, logits (B, V), lengths (L, Hkv, B));
        ``rows`` are the global rows the sub-batch will occupy."""
        raise NotImplementedError

    def prefill_chunk(self, sp: dict, tokens: torch.Tensor, pa, state,
                      rows, start, valid, quota) -> Tuple:
        """Chunked-prefill step → (ServeState, logits (B, V), lengths
        (L, Hkv, B)).  ``tokens`` is a fixed-width (B, chunk_tokens) slice
        (the last chunk zero-padded, ``valid`` (B,) counting its real
        tokens), ``start`` (B,) the absolute position of each row's chunk
        and ``quota`` (L,) the per-head keep cap of the boundary
        compression.  The step runs eagerly, so there is no trace to
        count; the reference's ``prefill_chunk_traces`` has its
        counterpart in the capture counter of CUDA-graph execution."""
        raise NotImplementedError

    def decode(self, sp: dict, state, pa,
               tokens: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None) -> Tuple:
        """Decode step → (ServeState, logits (B, V)); ``active`` ((B,) bool)
        marks the live rows (None: all)."""
        raise NotImplementedError

    def propose(self, sp: dict, state, pa, depths: torch.Tensor,
                active: Optional[torch.Tensor] = None, *, draft_layers: int,
                max_k: int) -> Tuple:
        """Draft step → (ServeState, proposals (B, max_k)): up to ``depths``
        tokens per row from the first ``draft_layers`` layers (0: all)."""
        raise NotImplementedError

    def verify(self, sp: dict, state, pa, tokens: torch.Tensor,
               q_lens: torch.Tensor, active: Optional[torch.Tensor] = None, *,
               draft_layers: int) -> Tuple:
        """Verify step over (B, Q) window tokens → (ServeState, g (B, Q),
        n_commit (B,), logits (B, Q, V)), rejected entries rolled back."""
        raise NotImplementedError
