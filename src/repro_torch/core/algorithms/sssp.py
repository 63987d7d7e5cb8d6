"""Temporal SSSP (paper §VI-A/C): sequentially dependent pattern.

Each timestep runs SSSP on its instance's edge weights (latency); distances
are *incrementally aggregated* between instances — the previous timestep's
distances seed the next (a vertex can only improve as new conditions are
observed), matching the paper's iBSP SSSP.

Two implementations share semantics:

* ``make_compute`` / ``run_host`` — the faithful host Compute: Dijkstra
  inside the subgraph (the paper's shared-memory-algorithm reuse),
  boundary relaxations via ``SendToSubgraph``, run by
  ``repro_torch.core.ibsp.run_ibsp`` over any ``InstanceProvider`` (a
  ``GoFSStore`` included);
* the engine form — a min-plus ``bsp_fixpoint`` per instance under the
  ``sequential`` pattern (``repro_torch.core.engine``).

``oracle`` is Bellman-Ford over the whole graph.  The engine form is
the registered ``"sssp"`` Gopher analytic (``repro_torch.gopher``);
``run_blocked`` remains as a deprecated thin wrapper over the session.
"""
from __future__ import annotations

import heapq
import warnings
from typing import Any, Dict, List, Tuple

import numpy as np

from repro_torch.core.blocked import BlockedGraph
from repro_torch.core.ibsp import ComputeContext, InstanceProvider, run_ibsp
from repro_torch.gopher.registry import REQUIRED, register_analytic

INF = float(np.inf)
WEIGHT_ATTR = "latency"


# --------------------------------------------------------------------------
# Faithful host implementation (Compute + Dijkstra per subgraph)
# --------------------------------------------------------------------------

def _dijkstra_local(
    topo, weights: np.ndarray, dist: np.ndarray, seeds: List[int]
) -> np.ndarray:
    """Multi-source Dijkstra over LOCAL edges from ``seeds`` (local idx).
    Updates ``dist`` in place and returns it."""
    indptr, indices, eids = topo.local_adjacency()
    # weights are in local-edge order (topo.local_edge_id order)
    eid_to_w = {int(e): float(w) for e, w in zip(topo.local_edge_id, weights)}
    heap = [(dist[s], int(s)) for s in seeds]
    heapq.heapify(heap)
    while heap:
        d, u = heapq.heappop(heap)
        if d > dist[u]:
            continue
        for k in range(indptr[u], indptr[u + 1]):
            v = int(indices[k])
            w = eid_to_w[int(eids[k])]
            nd = d + w
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist


def make_compute(source_vertex: int):
    """Compute closure for the sequentially dependent SSSP.

    Per-subgraph state (distances) is carried across supersteps and
    timesteps in a dict keyed by sgid — the engine re-loads instances each
    superstep, so state lives here (the paper's subgraph state survives
    within a timestep's BSP, and its end state seeds the next timestep).
    """
    state: Dict[int, np.ndarray] = {}
    result: Dict[int, np.ndarray] = {}

    def compute(ctx: ComputeContext) -> None:
        topo = ctx.subgraph.topology
        n = topo.num_vertices
        weights = ctx.subgraph.local_edge_values[WEIGHT_ATTR]
        rweights = ctx.subgraph.remote_edge_values[WEIGHT_ATTR]

        if ctx.superstep == 1:
            # seed: previous timestep's result or inf
            if ctx.timestep == 0:
                dist = np.full(n, INF)
            else:
                dist = state.get(topo.sgid, np.full(n, INF)).copy()
            if source_vertex in topo.global_to_local:
                dist[topo.global_to_local[source_vertex]] = 0.0
            seeds = [i for i in range(n) if np.isfinite(dist[i])]
        else:
            dist = state[topo.sgid]
            seeds = []
            for v_global, d in ctx.messages:  # boundary relaxations
                li = topo.global_to_local[int(v_global)]
                if d < dist[li]:
                    dist[li] = d
                    seeds.append(li)

        if seeds:
            dist = _dijkstra_local(topo, weights, dist, seeds)
            # relax remote edges; message the owning subgraph
            for i in range(len(topo.remote_src)):
                s = int(topo.remote_src[i])
                nd = dist[s] + float(rweights[i])
                if np.isfinite(nd):
                    ctx.send_to_subgraph(
                        int(topo.remote_dst_sgid[i]),
                        (int(topo.remote_dst_vertex[i]), nd),
                    )
        state[topo.sgid] = dist
        result[topo.sgid] = dist
        ctx.vote_to_halt()

    compute.state = state
    compute.result = result
    return compute


def run_host(
    provider: InstanceProvider,
    source_vertex: int,
    *,
    workers: int = 0,
) -> Tuple[Dict[int, np.ndarray], Any]:
    """Faithful sequentially-dependent temporal SSSP.  Returns
    ({sgid: final distances (local order)}, IBSPResult)."""
    compute = make_compute(source_vertex)
    res = run_ibsp(provider, compute, pattern="sequential", workers=workers)
    return compute.result, res


# --------------------------------------------------------------------------
# Engine implementation: registered Gopher analytic
# --------------------------------------------------------------------------

def scalar_source(name: str, source) -> int:
    """``source`` as one vertex; a sequence of sources is the query axis,
    which is not ported yet."""
    if isinstance(source, (list, tuple, np.ndarray)):
        raise NotImplementedError(
            f"{name}: a sequence of sources is the query axis, which is "
            f"not ported yet (ROADMAP queue 1, item 2)")
    return int(source)


def _postprocess(ctx, res, **_params):
    return {"final": res.final}


@register_analytic(
    "sssp",
    pattern="sequential",
    attr=WEIGHT_ATTR,
    zero_fill=INF,
    params={"source": REQUIRED, "subgraph_centric": True,
            "max_supersteps": 64},
    postprocess=_postprocess,
    source_axis="source",
    describe="temporal SSSP: sequentially dependent min-plus fixpoint, "
             "distances carried between timesteps",
)
def _sssp_program(ctx, *, source, subgraph_centric, max_supersteps):
    """Program factory for the ``"sssp"`` analytic: min-plus fixpoint
    seeded at ``source``; the sequential pattern carries distances
    across the instance axis (incremental aggregation)."""
    from repro_torch.core.engine import min_plus_program, source_init

    return min_plus_program(
        "sssp", init=source_init(scalar_source("sssp", source)),
        subgraph_centric=subgraph_centric, max_supersteps=max_supersteps,
    )


def run_blocked(
    bg: BlockedGraph,
    instance_weights: np.ndarray,  # (I, E) per-instance edge latency
    source_vertex: int,
    *,
    subgraph_centric: bool = True,
    use_pallas=None,
    max_supersteps: int = 64,
    comm="dense",
    device="cuda",
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Deprecated: use the Gopher session API —
    ``GopherSession.from_blocked(bg, weights={"latency": w}).run(
    session.plan("sssp", source=...))`` (``repro_torch.gopher``).  This
    wrapper pins the legacy knobs (dense layout, sync staging) and returns
    (final distances (V,), stats per timestep), bitwise identical to the
    session path.
    """
    warnings.warn(
        "sssp.run_blocked is deprecated; use repro_torch.gopher."
        "GopherSession (session.run(session.plan('sssp', source=...)))",
        DeprecationWarning, stacklevel=2,
    )
    from repro_torch.gopher import GopherSession

    sess = GopherSession.from_blocked(
        bg, weights={WEIGHT_ATTR: instance_weights},
        use_pallas=use_pallas, device=device,
    )
    res = sess.run(sess.plan(
        "sssp", source=source_vertex, subgraph_centric=subgraph_centric,
        max_supersteps=max_supersteps,
        layout="dense", comm=comm, staging="sync",
    ))
    return res.output["final"], res.engine.stats


# --------------------------------------------------------------------------
# numpy oracle (Bellman-Ford over the full graph, incremental across time)
# --------------------------------------------------------------------------

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
