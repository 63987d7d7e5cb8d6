"""Host-side subgraph topology — the paper's unit of computation (§IV-A).

``SubgraphTopology`` is the time-invariant part handed to the user's
``Compute`` together with per-instance attribute values.  Edges are split
into *local* (both endpoints in this subgraph — available for shared-memory
algorithms like Dijkstra/DFS, the paper's key reuse) and *remote* (crossing
to another subgraph, possibly in another partition — these define where
``SendToSubgraph`` messages flow).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.graph import GraphTemplate


@dataclass
class SubgraphTopology:
    sgid: int  # global subgraph id
    pid: int  # owning partition
    vertices: np.ndarray  # (n,) global vertex ids
    # local edges, endpoints as LOCAL indices into ``vertices``
    local_src: np.ndarray  # (m,) int32
    local_dst: np.ndarray  # (m,) int32
    local_edge_id: np.ndarray  # (m,) int64 template edge ids
    # remote out-edges: local src index, destination (global vertex, sgid)
    remote_src: np.ndarray  # (r,) int32 local index
    remote_dst_vertex: np.ndarray  # (r,) int64 global vertex id
    remote_dst_sgid: np.ndarray  # (r,) int64
    remote_edge_id: np.ndarray  # (r,) int64
    global_to_local: Dict[int, int] = field(default_factory=dict)

    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_local_edges(self) -> int:
        return len(self.local_src)

    def local_adjacency(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """CSR (indptr, indices, edge_ids) over local DIRECTED edges."""
        n = self.num_vertices
        order = np.argsort(self.local_src, kind="stable")
        s = self.local_src[order]
        indptr = np.zeros(n + 1, np.int64)
        np.add.at(indptr, s + 1, 1)
        indptr = np.cumsum(indptr)
        return indptr, self.local_dst[order], self.local_edge_id[order]

    def remote_by_src(self) -> Dict[int, List[int]]:
        """local src index -> list of remote-edge row indices."""
        out: Dict[int, List[int]] = {}
        for i, s in enumerate(self.remote_src):
            out.setdefault(int(s), []).append(i)
        return out


def build_subgraphs(
    template: GraphTemplate, assign: np.ndarray, sg_ids: np.ndarray
) -> Dict[int, SubgraphTopology]:
    """All subgraph topologies, keyed by global subgraph id."""
    src, dst = template.src, template.dst
    sg_src = sg_ids[src]
    sg_dst = sg_ids[dst]
    part_of_sg: Dict[int, int] = {}
    verts_of: Dict[int, List[int]] = {}
    for v in range(template.num_vertices):
        g = int(sg_ids[v])
        verts_of.setdefault(g, []).append(v)
        part_of_sg[g] = int(assign[v])

    out: Dict[int, SubgraphTopology] = {}
    local_map: Dict[int, Dict[int, int]] = {}
    for g, vs in verts_of.items():
        va = np.array(vs, np.int64)
        g2l = {int(v): i for i, v in enumerate(va)}
        local_map[g] = g2l
        out[g] = SubgraphTopology(
            sgid=g, pid=part_of_sg[g], vertices=va,
            local_src=np.array([], np.int32), local_dst=np.array([], np.int32),
            local_edge_id=np.array([], np.int64),
            remote_src=np.array([], np.int32),
            remote_dst_vertex=np.array([], np.int64),
            remote_dst_sgid=np.array([], np.int64),
            remote_edge_id=np.array([], np.int64),
            global_to_local=g2l,
        )

    # local edges: same subgraph (implies same partition by construction)
    same = sg_src == sg_dst
    le = np.nonzero(same)[0]
    re = np.nonzero(~same)[0]
    by_sg_local: Dict[int, List[int]] = {}
    for e in le:
        by_sg_local.setdefault(int(sg_src[e]), []).append(int(e))
    for g, es in by_sg_local.items():
        ea = np.array(es, np.int64)
        g2l = local_map[g]
        out[g].local_src = np.array([g2l[int(v)] for v in src[ea]], np.int32)
        out[g].local_dst = np.array([g2l[int(v)] for v in dst[ea]], np.int32)
        out[g].local_edge_id = ea
    by_sg_remote: Dict[int, List[int]] = {}
    for e in re:
        by_sg_remote.setdefault(int(sg_src[e]), []).append(int(e))
    for g, es in by_sg_remote.items():
        ea = np.array(es, np.int64)
        g2l = local_map[g]
        out[g].remote_src = np.array([g2l[int(v)] for v in src[ea]], np.int32)
        out[g].remote_dst_vertex = dst[ea].astype(np.int64)
        out[g].remote_dst_sgid = sg_ids[dst[ea]].astype(np.int64)
        out[g].remote_edge_id = ea
    return out
