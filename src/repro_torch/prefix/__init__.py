"""Shared-prefix block reuse and chunked prefill (port of ``repro.prefix``)."""
from repro_torch.prefix.config import PrefixConfig
from repro_torch.prefix.index import PrefixEntry, PrefixIndex

__all__ = ["PrefixConfig", "PrefixEntry", "PrefixIndex"]
