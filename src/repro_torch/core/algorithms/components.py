"""Connected components per instance (independent pattern) — the classic
label-propagation workload; exercises min-plus with 0/inf weights.

``symmetrized_blocked`` builds the blocked structure the engine runs it
on (labels propagate both ways through min-plus); ``oracle`` is
union-find on the host.  The registered ``"components"`` Gopher analytic
and the deprecated ``run_blocked`` wrappers come with the Gopher session
(ROADMAP queue 1, item 3).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.blocked import BlockedGraph, build_blocked
from repro_torch.core.graph import GraphTemplate


def symmetrized_blocked(
    bg: BlockedGraph, src: np.ndarray, dst: np.ndarray
) -> BlockedGraph:
    """Blocked structure over the doubled (undirected) edge list, same
    partitioning — labels propagate both ways through min-plus."""
    tmpl2 = GraphTemplate(
        num_vertices=len(bg.part_of),
        src=np.concatenate([src, dst]),
        dst=np.concatenate([dst, src]),
    )
    return build_blocked(tmpl2, bg.part_of, bg.block_size)


def oracle(
    src: np.ndarray, dst: np.ndarray, active: np.ndarray, num_vertices: int
) -> np.ndarray:
    """Union-find oracle; labels = min vertex id per component."""
    parent = np.arange(num_vertices)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v, a in zip(src, dst, active):
        if a > 0:
            ru, rv = find(int(u)), find(int(v))
            if ru != rv:
                parent[max(ru, rv)] = min(ru, rv)
    return np.array([find(int(i)) for i in range(num_vertices)], np.int64)
