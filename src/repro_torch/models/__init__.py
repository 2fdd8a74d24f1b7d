"""The model zoo in PyTorch (the port of ``repro.models``): dense GQA, MoE,
Mamba-2 SSD, hybrid, encoder-decoder and VLM blocks, and the training
forward."""
from repro_torch.models.transformer import (  # noqa: F401
    embed_inputs,
    encode,
    encoder_cross_kv,
    forward_train,
    init_params,
)
