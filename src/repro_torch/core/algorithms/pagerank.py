"""PageRank per instance (paper §VI-A): independent pattern.

Each graph instance is ranked independently, considering only edges *active*
in that instance.  The host path (``make_compute`` / ``run_host``) runs
the vertex-value iteration through the iBSP engine (independent pattern —
temporal concurrency across instances); the engine path runs plus-mul
supersteps (``repro_torch.core.engine.pagerank_program``) as the
registered ``"pagerank"`` Gopher analytic (``repro_torch.gopher``);
``run_blocked`` remains as a deprecated thin wrapper over the session.

Specification (all paths + oracle): power iteration of
    r' = (1-d)/N + d * A_w^T r,   A_w[u,v] = active(u,v)/outdeg_active(u)
without dangling-mass redistribution, ``iters`` fixed steps.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.core.blocked import BlockedGraph
from repro_torch.core.ibsp import ComputeContext, InstanceProvider, run_ibsp
from repro_torch.gopher.registry import register_analytic

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


# --------------------------------------------------------------------------
# Engine implementation: registered Gopher analytic
# --------------------------------------------------------------------------

def _pagerank_weights(session, raw: np.ndarray) -> np.ndarray:
    """Staging transform: (I, E) activity -> outdegree-normalized edge
    weights (named so the shared-staging key distinguishes it from the
    raw attribute)."""
    assert session.src is not None, \
        "pagerank derives weights from topology: pass src= to from_blocked"
    return edge_weights_for_instances(
        session.src, np.asarray(raw), len(session.bg.part_of)
    )


def _postprocess(ctx, res, **_params):
    return {"ranks": res.values}


@register_analytic(
    "pagerank",
    pattern="independent",
    attr=ACTIVE_ATTR,
    zero_fill=0.0,
    params={"damping": 0.85, "iters": 30},
    weights=_pagerank_weights,
    # outdegree normalization reads one instance's activity row at a
    # time — safe to apply chunk-wise on the prefetcher thread
    rowwise=True,
    postprocess=_postprocess,
    describe="per-instance PageRank over active edges: independent "
             "pattern, fixed-count plus-mul iteration",
)
def _pagerank_program(ctx, *, damping, iters):
    """Program factory for the ``"pagerank"`` analytic."""
    from repro_torch.core.engine import pagerank_program

    return pagerank_program(ctx.num_vertices, damping=damping, iters=iters)


def run_blocked(
    bg: BlockedGraph,
    src: np.ndarray,  # (E,) template edge sources (for outdeg weights)
    instance_active: np.ndarray,  # (I, E) 0/1 activity per instance
    *,
    num_vertices: int,
    damping: float = 0.85,
    iters: int = 30,
    mesh=None,
    use_pallas=None,
    comm="dense",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Deprecated: use the Gopher session API —
    ``GopherSession.from_blocked(bg, weights={"active": a}, src=src).run(
    session.plan("pagerank", iters=...))`` (``repro_torch.gopher``).  Pins
    the legacy knobs (dense layout, sync staging); results are identical
    to the session path.  Returns (ranks (I, V), supersteps (I,))."""
    warnings.warn(
        "pagerank.run_blocked is deprecated; use repro_torch.gopher."
        "GopherSession (session.run(session.plan('pagerank', ...)))",
        DeprecationWarning, stacklevel=2,
    )
    from repro_torch.gopher import GopherSession

    assert num_vertices == len(bg.part_of), \
        "num_vertices must match the blocked template"
    sess = GopherSession.from_blocked(
        bg, weights={ACTIVE_ATTR: instance_active}, src=src,
        mesh=mesh, use_pallas=use_pallas, device=device,
    )
    res = sess.run(sess.plan(
        "pagerank", damping=damping, iters=iters,
        layout="dense", comm=comm, staging="sync",
    ))
    return res.output["ranks"], res.engine.stats["supersteps"]


# --------------------------------------------------------------------------
# numpy oracle
# --------------------------------------------------------------------------

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
