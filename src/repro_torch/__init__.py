"""FairKV on PyTorch + hand-written Hopper kernels.

The PyTorch/CUDA port of ``repro`` (the JAX/Pallas reference, which stays
the oracle the port is tested against).  The package mirrors the reference's
layout module for module; it imports ``torch`` and ``numpy`` and never
``jax`` or ``repro``.  Entry points (`repro_torch.api.Engine`) run on
``cuda`` unless the caller asks for the CPU.
"""
