"""qwen1.5-110b — dense, 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.

QKV bias (the Qwen1.5 family signature).  [hf:Qwen/Qwen1.5-0.5B; hf]
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=49152,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="hf:Qwen/Qwen1.5-110B (family config per hf:Qwen/Qwen1.5-0.5B)",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab_size=256,
        qkv_bias=True,
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="reduced",
    )


register("qwen1.5-110b", full, smoke)
