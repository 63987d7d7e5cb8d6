"""Config registry (graph collections only so far)."""
from __future__ import annotations

from repro_torch.configs.base import GraphConfig
from repro_torch.configs.goffish_tr import TR_FULL, TR_SMALL, TR_TINY


def get_graph_config(name: str = "small") -> GraphConfig:
    return {"full": TR_FULL, "small": TR_SMALL, "tiny": TR_TINY}[name]


__all__ = ["GraphConfig", "get_graph_config"]
