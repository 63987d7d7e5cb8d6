"""Vehicle tracking (paper Algorithm 1): sequentially dependent traversal.

The graph template is a road network; each instance's vertex attribute
``plate`` holds the license IDs seen at that intersection during the
window.  Starting from an initial location, each timestep traces the
vehicle spatially (bounded-depth search across subgraphs via superstep
messages) until the trail goes cold in that instance, then hands the last
known location to the next timestep.

Host path: faithful Alg. 1 — DFS per subgraph, remote handoff messages,
(vertex, timestamp) carried between timesteps.  The engine form runs all
candidate sighting wavefronts as one multi-source pass on the engine's
query axis, which is not ported yet (ROADMAP queue 1, item 2); its
registered ``"tracking"`` Gopher analytic and the deprecated
``run_blocked`` wrapper come with that item.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.ibsp import (
    BSPStats, ComputeContext, IBSPResult, InstanceProvider, _TimestepBSP)

PLATE_ATTR = "plate"  # int vertex attribute: vehicle id seen (-1 = none)


def make_compute(plate: int, initial_vertex: int, search_depth: int = 4):
    """Alg. 1 Compute.  Messages within a timestep: (vertex, depth_left).
    Messages across timesteps (via state dict): last sighting vertex."""
    state: Dict[str, Any] = {"last_seen": initial_vertex, "trace": []}

    def compute(ctx: ComputeContext) -> None:
        topo = ctx.subgraph.topology
        plates = ctx.subgraph.vertex_values[PLATE_ATTR]

        if ctx.superstep == 1:
            roots: List[Tuple[int, int]] = []
            v = state["last_seen"]
            if v is not None and int(v) in topo.global_to_local:
                roots.append((topo.global_to_local[int(v)], search_depth))
        else:
            roots = [
                (topo.global_to_local[int(v)], int(d))
                for v, d in ctx.messages
                if int(v) in topo.global_to_local
            ]

        if not roots:
            ctx.vote_to_halt()
            return

        # DFS on the subgraph from the roots (paper line 17)
        indptr, indices, _ = topo.local_adjacency()
        best: Optional[int] = None
        seen_depth: Dict[int, int] = {}
        stack = list(roots)
        while stack:
            u, depth = stack.pop()
            if seen_depth.get(u, -1) >= depth:
                continue
            seen_depth[u] = depth
            if int(plates[u]) == plate:
                g = int(topo.vertices[u])
                if best is None or g < best:
                    best = g
            if depth > 0:
                for k in range(indptr[u], indptr[u + 1]):
                    stack.append((int(indices[k]), depth - 1))
        # remote handoff (paper lines 18-21)
        remote_by_src = topo.remote_by_src()
        for u, depth in seen_depth.items():
            if depth > 0:
                for i in remote_by_src.get(u, []):
                    ctx.send_to_subgraph(
                        int(topo.remote_dst_sgid[i]),
                        (int(topo.remote_dst_vertex[i]), depth - 1),
                    )
        if best is not None:
            # found in this instance: remember (monotone min for determinism)
            cur = state.get("found_at")
            state["found_at"] = best if cur is None else min(cur, best)
        ctx.vote_to_halt()

    def on_timestep_end(t_idx: int) -> None:
        found = state.pop("found_at", None)
        if found is not None:
            state["last_seen"] = found
            state["trace"].append((t_idx, found))

    compute.state = state
    compute.on_timestep_end = on_timestep_end
    return compute


def run_host(
    provider: InstanceProvider,
    plate: int,
    initial_vertex: int,
    *,
    search_depth: int = 4,
    workers: int = 0,
) -> Tuple[List[Tuple[int, int]], Any]:
    """Returns (trace [(timestep, vertex), ...], IBSPResult).

    ``workers`` is accepted for the reference's signature; as there, the
    timesteps run serially with no pool, so that the state handoff
    (Alg. 1 lines 22-27) lands between instances."""
    compute = make_compute(plate, initial_vertex, search_depth)
    total = BSPStats()
    per_ts = []
    for t in range(provider.num_timesteps()):
        bsp = _TimestepBSP(provider, t, compute, {}, [], None)
        bsp.run()
        compute.on_timestep_end(t)
        per_ts.append(bsp.stats)
        total.merge_from(bsp.stats)
    return compute.state["trace"], IBSPResult(None, [], total, per_ts)
