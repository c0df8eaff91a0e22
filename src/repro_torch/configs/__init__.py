"""Assigned architecture registry: --arch <id> → ModelConfig."""

from repro_torch.configs.qwen2_5_3b import CONFIG as QWEN25_3B
from repro_torch.configs.mistral_large_123b import CONFIG as MISTRAL_LARGE_123B
from repro_torch.configs.gemma3_4b import CONFIG as GEMMA3_4B
from repro_torch.configs.stablelm_1_6b import CONFIG as STABLELM_16B
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as GRANITE_MOE
from repro_torch.configs.qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE
from repro_torch.configs.seamless_m4t_medium import CONFIG as SEAMLESS_M4T
from repro_torch.configs.paligemma_3b import CONFIG as PALIGEMMA_3B
from repro_torch.configs.xlstm_350m import CONFIG as XLSTM_350M
from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2_27B

ARCHS = {c.name: c for c in [
    QWEN25_3B, MISTRAL_LARGE_123B, GEMMA3_4B, STABLELM_16B, GRANITE_MOE,
    QWEN3_MOE, SEAMLESS_M4T, PALIGEMMA_3B, XLSTM_350M, ZAMBA2_27B,
]}


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
