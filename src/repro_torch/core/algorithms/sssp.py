"""Temporal SSSP (paper §VI-A/C): sequentially dependent pattern.

Each timestep runs SSSP on its instance's edge weights (latency); distances
are *incrementally aggregated* between instances — the previous timestep's
distances seed the next.  The engine form is a min-plus ``bsp_fixpoint``
per instance under the ``sequential`` pattern; this module holds its numpy
oracle.
"""
from __future__ import annotations

import numpy as np

INF = float(np.inf)
WEIGHT_ATTR = "latency"


def oracle(
    src: np.ndarray, dst: np.ndarray, instance_weights: np.ndarray,
    num_vertices: int, source_vertex: int,
) -> np.ndarray:
    """Bellman-Ford over the full graph, incremental across time."""
    dist = np.full(num_vertices, INF)
    dist[source_vertex] = 0.0
    for t in range(instance_weights.shape[0]):
        w = instance_weights[t]
        changed = True
        while changed:
            relaxed = dist[src] + w
            new = dist.copy()
            np.minimum.at(new, dst, relaxed)
            changed = bool(np.any(new < dist))
            dist = new
    return dist
