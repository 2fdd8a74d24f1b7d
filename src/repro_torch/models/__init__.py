"""The model zoo in PyTorch (the port of ``repro.models``): dense GQA, MoE,
Mamba-2 SSD, hybrid, encoder-decoder and VLM blocks."""
from repro_torch.models.transformer import embed_inputs, init_params  # noqa: F401
