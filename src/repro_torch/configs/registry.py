"""Registry of the 10 assigned architectures."""

from .base import ArchConfig
from .granite_8b import CONFIG as GRANITE_8B
from .smollm_135m import CONFIG as SMOLLM_135M
from .nemotron_4_340b import CONFIG as NEMOTRON_4_340B
from .deepseek_67b import CONFIG as DEEPSEEK_67B
from .qwen3_moe_30b_a3b import CONFIG as QWEN3_MOE_30B
from .qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE_235B
from .recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from .internvl2_26b import CONFIG as INTERNVL2_26B
from .rwkv6_3b import CONFIG as RWKV6_3B
from .whisper_medium import CONFIG as WHISPER_MEDIUM

ARCHS = {c.name: c for c in [
    GRANITE_8B, SMOLLM_135M, NEMOTRON_4_340B, DEEPSEEK_67B,
    QWEN3_MOE_30B, QWEN3_MOE_235B, RECURRENTGEMMA_9B, INTERNVL2_26B,
    RWKV6_3B, WHISPER_MEDIUM,
]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
