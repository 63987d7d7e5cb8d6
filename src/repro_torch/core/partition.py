"""Graph partitioning (paper §IV-A, §V-A).

``partition_graph`` is a BFS-grown balanced edge-cut partitioner (the paper
uses METIS-style "balance vertices, minimize remote edges"); ``edge_cut``
counts the remote edges it leaves.  Subgraph discovery and the per-host
``Partition`` views are not ported yet.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.graph import GraphTemplate


def partition_graph(template: GraphTemplate, n_parts: int, seed: int = 0) -> np.ndarray:
    """Greedy BFS-grown partitioning: balanced vertices, low edge cut.

    Returns (V,) int32 partition assignment.
    """
    V = template.num_vertices
    if n_parts == 1:
        return np.zeros(V, np.int32)
    indptr, indices = template.undirected_adjacency()
    target = -(-V // n_parts)
    assign = np.full(V, -1, np.int32)
    del seed  # the growth is deterministic (degree-ordered seeds)
    # order seeds by degree (high-degree first makes growth contiguous)
    order = np.argsort(-(indptr[1:] - indptr[:-1]), kind="stable")
    cur_part = 0
    cur_size = 0
    frontier: deque = deque()
    oi = 0
    while True:
        if not frontier:
            while oi < V and assign[order[oi]] >= 0:
                oi += 1
            if oi >= V:
                break
            frontier.append(order[oi])
        u = frontier.popleft()
        if assign[u] >= 0:
            continue
        assign[u] = cur_part
        cur_size += 1
        if cur_size >= target:
            cur_part = min(cur_part + 1, n_parts - 1)
            cur_size = 0
            frontier.clear()
            continue
        for w in indices[indptr[u]:indptr[u + 1]]:
            if assign[w] < 0:
                frontier.append(int(w))
    return assign


def edge_cut(template: GraphTemplate, assign: np.ndarray) -> int:
    return int(np.sum(assign[template.src] != assign[template.dst]))
