"""mamba2-1.3b — pure SSM (attn-free), 48L d_model=2048 d_ff=0 vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060; unverified]

FairKV is inapplicable (no KV cache / attention heads) — the arch is implemented
without the technique; see DESIGN.md §4.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=50280,
        tie_embeddings=True,
        # mamba2-1.3b: expand=2 -> d_inner=4096, P=64 -> 64 heads, N=128
        ssm=SSMConfig(state_size=128, num_heads=64, head_dim=64, chunk_size=256,
                      conv_width=4, expand=2),
        source="arXiv:2405.21060 (state-spaces/mamba2-1.3b)",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=256,
        tie_embeddings=True,
        ssm=SSMConfig(state_size=8, num_heads=4, head_dim=8, chunk_size=8,
                      conv_width=4, expand=2),
        source="reduced",
    )


register("mamba2-1.3b", full, smoke)
