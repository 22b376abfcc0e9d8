"""Architecture configs: one module per assigned architecture.

Use ``repro_torch.configs.get(name)`` / ``repro_torch.configs.ARCHS`` for lookup.
"""

from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, ARCH_REGISTRY, register

# importing the modules registers the configs
from repro_torch.configs import (  # noqa: F401
    whisper_medium,
    rwkv6_3b,
    llama32_vision_11b,
    dbrx_132b,
    qwen3_moe_30b_a3b,
    internlm2_1_8b,
    starcoder2_7b,
    command_r_35b,
    qwen2_7b,
    jamba15_large_398b,
    sparse_code_demo,
)

ARCHS = dict(ARCH_REGISTRY)


def get(name: str) -> ArchConfig:
    try:
        return ARCH_REGISTRY[name]
    except KeyError as e:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCH_REGISTRY)}") from e
