"""gemma2-9b — dense, 42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000.

Local+global alternating attention, logit softcap.  [arXiv:2408.00118; hf]
long_500k runs: the alternation makes half the layers sliding-window, and decode
with a 500k KV is O(S)/step; see DESIGN.md §4.
"""
from repro_torch.configs.base import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        logit_softcap=30.0,
        attn_softcap=50.0,
        sliding_window=4096,
        local_global_alternate=True,
        tie_embeddings=True,
        source="arXiv:2408.00118 (google/gemma-2-9b)",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        logit_softcap=30.0,
        attn_softcap=50.0,
        sliding_window=16,
        local_global_alternate=True,
        tie_embeddings=True,
        source="reduced",
    )


register("gemma2-9b", full, smoke)
