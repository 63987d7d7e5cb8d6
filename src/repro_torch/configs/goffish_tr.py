"""GoFFish TR dataset analogue (paper §VI-A) + reduced variants.

The paper's TR collection: internet traceroute graph, 19.4M vertices, 22.8M
edges, 146 instances over 12 days (2 h windows), partitioned over 12 hosts.
A scaled family of synthetic small-world collections keeps the same shape
characteristics (power-law-ish subgraph size distribution, 7 vertex + 7
edge attributes); the full-size spec documents the paper's scale.
"""
from repro_torch.configs.base import GraphConfig

# Full-size spec (documentation only: it does not fit one card's memory).
TR_FULL = GraphConfig(
    name="goffish-tr-full",
    num_vertices=19_442_778,
    avg_degree=1.172,
    num_instances=146,
    num_partitions=256,
    block_size=128,
    instances_per_slice=20,
    bins_per_partition=20,
    cache_slots=14,
)

# Benchmark-scale replica preserving the distributional shape.
TR_SMALL = GraphConfig(
    name="goffish-tr-small",
    num_vertices=16_384,
    avg_degree=2.0,
    num_instances=48,
    num_partitions=8,
    block_size=64,
    instances_per_slice=20,
    bins_per_partition=20,
    cache_slots=14,
)

# Tiny config for tests.
TR_TINY = GraphConfig(
    name="goffish-tr-tiny",
    num_vertices=512,
    avg_degree=3.0,
    num_instances=6,
    num_partitions=4,
    block_size=32,
    instances_per_slice=2,
    bins_per_partition=2,
    cache_slots=4,
)

CONFIG = TR_SMALL
