"""KV compression: observation-window scores → per-head selections."""
from repro_torch.compression.base import CompressionConfig, pool_scores, topk_select  # noqa: F401
