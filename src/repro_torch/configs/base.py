"""Graph collection configuration (counterpart of ``repro.configs.base``;
the LM configs are not ported yet)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GraphConfig:
    """Configuration of a time-series graph collection (paper §III/§VI)."""

    name: str
    num_vertices: int
    avg_degree: float
    num_instances: int
    num_partitions: int
    block_size: int = 128
    # GoFS layout knobs (paper §V-B..E)
    instances_per_slice: int = 20  # temporal packing (i1/i20)
    bins_per_partition: int = 20  # subgraph bin packing (s20/s40)
    cache_slots: int = 14  # LRU slice cache (c0/c14)
    seed: int = 0
