"""Dense GQA decoder in PyTorch (the port of ``repro.models``)."""
from repro_torch.models.transformer import embed_inputs, init_params  # noqa: F401
