"""`Executor`: the device-execution strategy behind the serving stack.

An executor owns *how* the serving steps run — one prefill step and one
decode step — while *what* they compute lives in
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


class Executor:
    """Interface: ``prefill`` and ``decode`` steps over explicit arguments
    (slot weights ``sp`` and plan arrays ``pa``), so a replan is new
    arguments, never a new executor."""

    name: str = "?"

    def __init__(self, model_cfg: ModelConfig, ccfg: CompressionConfig,
                 device: torch.device):
        self.cfg = model_cfg
        self.ccfg = ccfg
        self.device = torch.device(device)

    def synchronize(self) -> None:
        """Wait for the device (no-op on the CPU, which runs synchronously)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def prefill(self, sp: dict, batch: dict, pa) -> Tuple:
        """Prefill step → (ServeState, logits (B, V), lengths (L, Hkv, B))."""
        raise NotImplementedError

    def decode(self, sp: dict, state, pa,
               tokens: Optional[torch.Tensor] = None) -> Tuple:
        """Decode step → (ServeState, logits (B, V))."""
        raise NotImplementedError
