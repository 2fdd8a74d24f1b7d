"""qwen3-moe-30b-a3b — MoE, 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, MoEConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab_size=151936,
        rope_theta=1_000_000.0,
        moe=MoEConfig(num_experts=128, top_k=8, d_expert=768, balance_experts=True),
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32, balance_experts=True),
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="reduced",
    )


register("qwen3-moe-30b-a3b", full, smoke)
