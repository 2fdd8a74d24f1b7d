"""minitron-8b — dense, 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.

Pruned Nemotron.  [arXiv:2407.14679; hf]
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=256000,
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="arXiv:2407.14679 (nvidia/Minitron-8B-Base)",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="minitron-8b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="reduced",
    )


register("minitron-8b", full, smoke)
