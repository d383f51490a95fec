# Copy of src/repro/configs/__init__.py (looks up repro_torch.configs).
"""Architecture registry: ``--arch <id>`` lookup for every assigned
architecture (exact published dimensions; see each module's citation)."""
from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen2.5-3b": "qwen2_5_3b",
    "glm4-9b": "glm4_9b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "llava-next-34b": "llava_next_34b",
    "whisper-medium": "whisper_medium",
    "hymba-1.5b": "hymba_1_5b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str):
    try:
        mod_name = _ARCH_MODULES[arch]
    except KeyError:
        raise ValueError(
            f"unknown arch {arch!r}; options: {', '.join(ARCH_IDS)}") from None
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
