"""Slot-layout KV cache."""
from repro_torch.cache.slot_cache import PlanArrays, SlotCache, init_cache  # noqa: F401
