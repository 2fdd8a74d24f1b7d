"""Architecture config registry.  Importing this package registers the archs
the port runs (minitron-8b; the other families follow in later slices)."""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    get_config,
    get_smoke_config,
    list_archs,
)

# importing each module registers its arch
from repro_torch.configs import minitron_8b  # noqa: F401

ALL_ARCHS = list_archs()
