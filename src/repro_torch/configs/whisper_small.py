"""whisper-small — audio enc-dec, 12L d_model=768 12H (kv=12 = MHA) d_ff=3072
vocab=51865, conv frontend (stub).  [arXiv:2212.04356; unverified]

Enc-dec: 12 encoder + 12 decoder layers.  Per assignment spec the conv frontend
is a STUB — ``input_specs()`` provides precomputed frame embeddings
(1500 frames x d_model, i.e. 30 s of audio after the 2x-stride conv stem).
Decode shapes lower the *decoder* step (self-attn KV cache + static cross-attn
KV from the encoder).
"""
from repro_torch.configs.base import FULL_ATTENTION_SKIP, ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        is_encoder_decoder=True,
        n_encoder_layers=12,
        encoder_seq_len=1500,
        tie_embeddings=True,
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="arXiv:2212.04356 (openai/whisper-small; conv stem stubbed)",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        is_encoder_decoder=True,
        n_encoder_layers=2,
        encoder_seq_len=32,
        tie_embeddings=True,
        shape_skips={"long_500k": FULL_ATTENTION_SKIP},
        source="reduced",
    )


register("whisper-small", full, smoke)
