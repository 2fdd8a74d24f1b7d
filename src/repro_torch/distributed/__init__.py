"""Collectives of the multi-GPU executor (`repro_torch.distributed.comm`)."""
