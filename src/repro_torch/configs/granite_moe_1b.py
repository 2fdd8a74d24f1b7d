"""granite-moe-1b-a400m — MoE, 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        tie_embeddings=True,
        moe=MoEConfig(num_experts=32, top_k=8, d_expert=512, balance_experts=True),
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        tie_embeddings=True,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=32, balance_experts=True),
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="reduced",
    )


register("granite-moe-1b-a400m", full, smoke)
