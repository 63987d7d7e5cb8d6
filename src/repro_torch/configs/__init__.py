"""Config registry: graph collections and the LM architectures of the
families the port has a model for (dense, moe, audio)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    DECODE_32K,
    LM_SHAPES,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    ArchConfig,
    GraphConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
)
from repro_torch.configs.goffish_tr import TR_FULL, TR_SMALL, TR_TINY

# arch id -> module name, for the families the port has a model for
_ARCH_MODULES = {
    "mistral-large-123b": "mistral_large_123b",
    "glm4-9b": "glm4_9b",
    "minitron-4b": "minitron_4b",
    "starcoder2-7b": "starcoder2_7b",
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "whisper-medium": "whisper_medium",
}
# the reference's other architectures, by family, not ported yet
_NOT_PORTED = {
    "paligemma-3b": "vlm",
    "hymba-1.5b": "hybrid",
    "xlstm-1.3b": "ssm",
}

ARCH_IDS = list(_ARCH_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id}: the {_NOT_PORTED[arch_id]} family is not ported yet "
            f"(ROADMAP.md queue 1, item 9: other LM families)")
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch_id]}")
    return mod.CONFIG


def get_graph_config(name: str = "small") -> GraphConfig:
    return {"full": TR_FULL, "small": TR_SMALL, "tiny": TR_TINY}[name]


__all__ = [
    "ArchConfig", "GraphConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
    "LM_SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "ARCH_IDS", "get_config", "get_graph_config",
]
