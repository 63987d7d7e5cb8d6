"""PageRank per instance (paper §VI-A): independent pattern.

Each graph instance is ranked independently, considering only edges *active*
in that instance.  The host path (``make_compute`` / ``run_host``) runs
the vertex-value iteration through the iBSP engine (independent pattern —
temporal concurrency across instances); the engine path runs plus-mul
supersteps (``repro_torch.core.engine.pagerank_program``).  The
registered ``"pagerank"`` Gopher analytic and the deprecated
``run_blocked`` wrapper come with the Gopher session (ROADMAP queue 1,
item 3).

Specification (all paths + oracle): power iteration of
    r' = (1-d)/N + d * A_w^T r,   A_w[u,v] = active(u,v)/outdeg_active(u)
without dangling-mass redistribution, ``iters`` fixed steps.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.core.ibsp import ComputeContext, InstanceProvider, run_ibsp

ACTIVE_ATTR = "active"


def edge_weights_for_instance(
    src: np.ndarray, active: np.ndarray, num_vertices: int
) -> np.ndarray:
    """w(u, v) = active / outdeg_active(u)."""
    deg = np.zeros(num_vertices, np.float64)
    np.add.at(deg, src, active.astype(np.float64))
    w = np.where(deg[src] > 0, active / np.maximum(deg[src], 1e-30), 0.0)
    return w.astype(np.float32)


def edge_weights_for_instances(
    src: np.ndarray, active: np.ndarray, num_vertices: int
) -> np.ndarray:
    """Vectorized over the instance axis: (I, E) activity -> (I, E) weights
    (one scatter for the whole collection, no per-instance loop)."""
    I = active.shape[0]
    deg = np.zeros((I, num_vertices), np.float64)
    np.add.at(deg, (np.arange(I)[:, None], src[None, :]),
              active.astype(np.float64))
    d = deg[:, src]
    w = np.where(d > 0, active / np.maximum(d, 1e-30), 0.0)
    return w.astype(np.float32)


# --------------------------------------------------------------------------
# Faithful host implementation through the iBSP engine
# --------------------------------------------------------------------------

def make_compute(num_vertices: int, damping: float = 0.85, iters: int = 30):
    """Vertex-value PageRank as an iBSP Compute (independent pattern).

    Superstep k computes iteration k; boundary contributions move through
    SendToSubgraph messages; results are reported to merge.
    """
    results: Dict[Tuple[int, int], np.ndarray] = {}  # (timestep, sgid) -> r
    state: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}

    def compute(ctx: ComputeContext) -> None:
        topo = ctx.subgraph.topology
        key = (ctx.timestep, topo.sgid)
        n = topo.num_vertices
        active_l = ctx.subgraph.local_edge_values[ACTIVE_ATTR]
        active_r = ctx.subgraph.remote_edge_values[ACTIVE_ATTR]
        deg = ctx.subgraph.vertex_values["outdeg_active"]  # precomputed (n,)

        if ctx.superstep == 1:
            r = np.full(n, 1.0 / num_vertices, np.float64)
            state[key] = {"r": r}
        st = state[key]
        r = st["r"]

        # contributions: local edges + incoming boundary messages
        contrib = np.zeros(n, np.float64)
        share = np.where(deg > 0, r / np.maximum(deg, 1e-30), 0.0)
        np.add.at(contrib, topo.local_dst, share[topo.local_src] * active_l)
        for v_global, c in ctx.messages:
            contrib[topo.global_to_local[int(v_global)]] += c

        if ctx.superstep > 1:
            r = (1.0 - damping) / num_vertices + damping * contrib
            st["r"] = r
            share = np.where(deg > 0, r / np.maximum(deg, 1e-30), 0.0)

        if ctx.superstep <= iters:
            # publish shares over remote edges for the NEXT superstep
            for i in range(len(topo.remote_src)):
                if active_r[i] > 0:
                    s = int(topo.remote_src[i])
                    ctx.send_to_subgraph(
                        int(topo.remote_dst_sgid[i]),
                        (int(topo.remote_dst_vertex[i]), share[s] * active_r[i]),
                    )
        else:
            results[key] = r.copy()
            ctx.send_message_to_merge((ctx.timestep, topo.sgid, r.copy()))
            ctx.vote_to_halt()

    compute.results = results
    return compute


def run_host(
    provider: InstanceProvider,
    num_vertices: int,
    *,
    damping: float = 0.85,
    iters: int = 30,
    workers: int = 0,
) -> Tuple[Dict[Tuple[int, int], np.ndarray], Any]:
    """Per-instance PageRank on the host.  Returns ({(timestep, sgid):
    ranks (local order)}, IBSPResult)."""
    compute = make_compute(num_vertices, damping, iters)
    res = run_ibsp(provider, compute, pattern="independent", workers=workers)
    return compute.results, res


def oracle(
    src: np.ndarray, dst: np.ndarray, active: np.ndarray,
    num_vertices: int, damping: float = 0.85, iters: int = 30,
) -> np.ndarray:
    """float64 power iteration for one instance's activity vector."""
    w = edge_weights_for_instance(src, active, num_vertices).astype(np.float64)
    r = np.full(num_vertices, 1.0 / num_vertices, np.float64)
    for _ in range(iters):
        contrib = np.zeros(num_vertices, np.float64)
        np.add.at(contrib, dst, r[src] * w)
        r = (1.0 - damping) / num_vertices + damping * contrib
    return r
