"""llava-next-34b — VLM backbone, 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Per assignment spec, the modality frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (num_image_tokens x d_model) that are concatenated
ahead of the text tokens; only the transformer backbone is modeled.
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        is_vlm=True,
        num_image_tokens=2880,  # anyres: 5 tiles x 576 patches
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="hf:llava-hf/llava-v1.6-34b-hf (backbone; frontend stubbed)",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        is_vlm=True,
        num_image_tokens=16,
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="reduced",
    )


register("llava-next-34b", full, smoke)
