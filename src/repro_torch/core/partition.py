"""Graph partitioning + subgraph discovery (paper §IV-A, §V-A).

* ``partition_graph``     — BFS-grown balanced edge-cut partitioner (the
  paper uses METIS-style "balance vertices, minimize remote edges");
  ``edge_cut`` counts the remote edges it leaves.
* ``discover_subgraphs``  — maximal connected components via LOCAL edges
  within each partition: the paper's unit of computation.
* ``Partition``           — per-host view: local subgraphs, local/remote
  edges, boundary-vertex tables used by Gopher's message exchange.
* ``bin_pack_subgraphs``  — GoFS's subgraph binning (§V-D).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List

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


def discover_subgraphs(
    template: GraphTemplate, assign: np.ndarray
) -> np.ndarray:
    """Union-find over LOCAL edges only -> (V,) int64 global subgraph ids.

    A subgraph is a maximal set of vertices connected through edges whose
    endpoints share a partition (paper §IV-A).
    """
    V = template.num_vertices
    parent = np.arange(V, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    src, dst = template.src, template.dst
    local = assign[src] == assign[dst]
    for u, v in zip(src[local], dst[local]):
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    roots = np.array([find(int(i)) for i in range(V)], np.int64)
    # compact ids, stable by root
    _, sg_ids = np.unique(roots, return_inverse=True)
    return sg_ids


@dataclass
class Partition:
    """Host-local view of one partition of the template."""

    pid: int
    vertices: np.ndarray  # (Vp,) global vertex ids in this partition
    local_src: np.ndarray  # (Lp,) indices into template edge list (local edges)
    remote_src: np.ndarray  # (Rp,) indices into template edge list (remote out-edges)
    remote_in: np.ndarray  # (Rin,) template edge ids whose dst is here, src remote
    subgraph_of: np.ndarray  # (Vp,) global subgraph id per local vertex
    subgraph_ids: np.ndarray  # unique global subgraph ids in this partition
    # vertex id -> local index
    global_to_local: Dict[int, int] = field(default_factory=dict)

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    def subgraph_sizes(self) -> np.ndarray:
        _, counts = np.unique(self.subgraph_of, return_counts=True)
        return counts


def build_partitions(
    template: GraphTemplate, assign: np.ndarray, sg_ids: np.ndarray
) -> List[Partition]:
    n_parts = int(assign.max()) + 1 if len(assign) else 1
    src, dst = template.src, template.dst
    e_part = assign[src]  # edges live with their source (paper: directed)
    local_mask = assign[src] == assign[dst]
    parts: List[Partition] = []
    for p in range(n_parts):
        vmask = assign == p
        verts = np.nonzero(vmask)[0]
        emask = e_part == p
        local_e = np.nonzero(emask & local_mask)[0]
        remote_e = np.nonzero(emask & ~local_mask)[0]
        remote_in = np.nonzero((assign[dst] == p) & ~local_mask)[0]
        parts.append(
            Partition(
                pid=p,
                vertices=verts,
                local_src=local_e,
                remote_src=remote_e,
                remote_in=remote_in,
                subgraph_of=sg_ids[verts],
                subgraph_ids=np.unique(sg_ids[verts]),
                global_to_local={int(v): i for i, v in enumerate(verts)},
            )
        )
    return parts


def bin_pack_subgraphs(
    sizes: np.ndarray, ids: np.ndarray, n_bins: int
) -> List[np.ndarray]:
    """Paper §V-D: pack subgraphs into ``n_bins`` bins balancing total
    vertices per bin (greedy largest-first).  Returns list of id arrays,
    bin-major order."""
    order = np.argsort(-sizes, kind="stable")
    loads = np.zeros(n_bins, np.int64)
    bins: List[List[int]] = [[] for _ in range(n_bins)]
    for i in order:
        b = int(np.argmin(loads))
        bins[b].append(int(ids[i]))
        loads[b] += int(sizes[i])
    return [np.array(b, np.int64) for b in bins]
