"""`LocalExecutor`: one device, eager steps (the default path)."""
from __future__ import annotations

import torch

from repro_torch.exec.base import Executor
from repro_torch.serving import engine as _serve


class LocalExecutor(Executor):
    name = "local"

    @torch.inference_mode()
    def prefill(self, sp, batch, pa, rows=None):
        out = _serve.prefill(sp, batch, self.cfg, pa, self.ccfg, rows=rows)
        self.synchronize()
        return out

    @torch.inference_mode()
    def decode(self, sp, state, pa, tokens=None, active=None):
        out = _serve.decode_step(sp, state, self.cfg, pa, self.ccfg,
                                 tokens=tokens, active=active,
                                 kv_kinds=self.kv_kinds)
        self.synchronize()
        return out
