"""granite-3-2b — dense, 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.

[hf:ibm-granite/granite-3.0-2b-base; hf]
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b",
        family="dense",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv_heads=8,
        head_dim=64,
        d_ff=8192,
        vocab_size=49155,
        tie_embeddings=True,
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="hf:ibm-granite/granite-3.0-2b-base",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        tie_embeddings=True,
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="reduced",
    )


register("granite-3-2b", full, smoke)
