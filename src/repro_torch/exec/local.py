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
    def prefill_chunk(self, sp, tokens, pa, state, rows, start, valid, quota):
        tokens = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        out = _serve.prefill_chunk(sp, tokens, self.cfg, pa, self.ccfg, state,
                                   rows, start, valid, quota)
        self.synchronize()
        return out

    @torch.inference_mode()
    def decode(self, sp, state, pa, tokens=None, active=None):
        out = _serve.decode_step(sp, state, self.cfg, pa, self.ccfg,
                                 tokens=tokens, active=active,
                                 kv_kinds=self.kv_kinds)
        self.synchronize()
        return out

    @torch.inference_mode()
    def propose(self, sp, state, pa, depths, active=None, *, draft_layers, max_k):
        out = _serve.propose_step(sp, state, self.cfg, pa, self.ccfg, depths,
                                  active=active, kv_kinds=self.kv_kinds,
                                  draft_layers=draft_layers, max_k=max_k)
        self.synchronize()
        return out

    @torch.inference_mode()
    def verify(self, sp, state, pa, tokens, q_lens, active=None, *, draft_layers):
        out = _serve.verify_step(sp, state, self.cfg, pa, self.ccfg, tokens,
                                 q_lens, active=active, kv_kinds=self.kv_kinds,
                                 draft_layers=draft_layers)
        self.synchronize()
        return out
