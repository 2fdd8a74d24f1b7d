"""hymba-1.5b — hybrid, 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attn+mamba heads.  [arXiv:2411.13676; hf]

Hymba runs attention and SSM heads *in parallel* within each layer and fuses
their outputs; attention is sliding-window in most layers (3 global), which is
what makes long_500k sub-quadratic.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        sliding_window=1024,
        local_global_alternate=False,  # hymba: local everywhere (3 global handled as local window here)
        ssm=SSMConfig(state_size=16, num_heads=25, head_dim=64, chunk_size=256),
        source="arXiv:2411.13676 (nvidia/Hymba-1.5B-Base)",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b-smoke",
        family="hybrid",
        n_layers=2,
        d_model=64,
        n_heads=5,  # keep the odd head count: FairKV's balanced-impossible case
        n_kv_heads=5,
        head_dim=8,
        d_ff=128,
        vocab_size=256,
        sliding_window=16,
        ssm=SSMConfig(state_size=4, num_heads=5, head_dim=8, chunk_size=8),
        source="reduced",
    )


register("hymba-1.5b", full, smoke)
