"""Architecture config registry.  Importing this package registers the archs
the port serves: the dense family (minitron-8b, gemma2-9b, granite-3-2b,
qwen1.5-110b with its qkv bias), the MoE family (granite-moe-1b-a400m,
qwen3-moe-30b-a3b), the SSM and hybrid families (mamba2-1.3b, hymba-1.5b)
and the encoder-decoder and VLM families (whisper-small, llava-next-34b)."""
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
from repro_torch.configs import (  # noqa: F401
    gemma2_9b,
    granite_3_2b,
    granite_moe_1b,
    hymba_1_5b,
    llava_next_34b,
    mamba2_1_3b,
    minitron_8b,
    qwen15_110b,
    qwen3_moe_30b,
    whisper_small,
)

ALL_ARCHS = list_archs()
