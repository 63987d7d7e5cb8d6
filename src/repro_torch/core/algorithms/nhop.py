"""N-hop latency (paper §VI-A): eventually dependent pattern.

Spec (identical across host / engine / oracle): per instance, compute
  hops[v] = unweighted shortest-path distance from the source,
  lat[v]  = min-latency distance from the source (independent relaxation),
then histogram ``lat`` over vertices with ``hops == N``.  Per-instance
histograms are folded into a composite in the Merge step (fork-join).

Host path: per-subgraph relaxation through the iBSP engine, merging via
``SendMessageToMerge``.  Engine path: the registered ``"nhop"`` Gopher
analytic (``repro_torch.gopher``), two min-plus fixpoints per instance;
``run_blocked`` remains as a deprecated thin wrapper over the session.
"""
from __future__ import annotations

import warnings
from typing import Any, Dict, Tuple

import numpy as np

from repro_torch.core.blocked import BlockedGraph
from repro_torch.core.ibsp import (
    ComputeContext, InstanceProvider, MergeContext, run_ibsp)
from repro_torch.gopher.registry import REQUIRED, register_analytic

INF = float(np.inf)
LATENCY_ATTR = "latency"

DEFAULT_BINS = np.array([0, 10, 20, 50, 100, 200, 500, 1000, np.inf])


def histogram(latencies: np.ndarray, bins: np.ndarray = DEFAULT_BINS) -> np.ndarray:
    h, _ = np.histogram(latencies[np.isfinite(latencies)], bins=bins)
    return h


# --------------------------------------------------------------------------
# Host implementation (iBSP, eventually dependent)
# --------------------------------------------------------------------------

def make_compute(source_vertex: int, n_hops: int, bins: np.ndarray = DEFAULT_BINS):
    """Compute carrying independent (hops, lat) relaxations per vertex.
    Cross-subgraph frontier messages: (vertex, hops, lat)."""
    state: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}

    def compute(ctx: ComputeContext) -> None:
        topo = ctx.subgraph.topology
        key = (ctx.timestep, topo.sgid)
        n = topo.num_vertices
        lat_l = ctx.subgraph.local_edge_values[LATENCY_ATTR]
        lat_r = ctx.subgraph.remote_edge_values[LATENCY_ATTR]

        if ctx.superstep == 1:
            st = {"hops": np.full(n, INF), "lat": np.full(n, INF)}
            state[key] = st
            frontier = set()
            if source_vertex in topo.global_to_local:
                li = topo.global_to_local[source_vertex]
                st["hops"][li] = 0
                st["lat"][li] = 0.0
                frontier.add(li)
        else:
            st = state[key]
            frontier = set()
            for v_global, h, d in ctx.messages:
                li = topo.global_to_local[int(v_global)]
                if h < st["hops"][li]:
                    st["hops"][li] = h
                    frontier.add(li)
                if d < st["lat"][li]:
                    st["lat"][li] = d
                    frontier.add(li)

        # local relaxation to fixpoint (both quantities independently)
        indptr, indices, eids = topo.local_adjacency()
        eid_to_w = {int(e): float(w) for e, w in zip(topo.local_edge_id, lat_l)}
        work = list(frontier)
        touched = set(frontier)
        while work:
            u = work.pop()
            hu, du = st["hops"][u], st["lat"][u]
            for k in range(indptr[u], indptr[u + 1]):
                v = int(indices[k])
                w = eid_to_w[int(eids[k])]
                improved = False
                if hu + 1 < st["hops"][v]:
                    st["hops"][v] = hu + 1
                    improved = True
                if du + w < st["lat"][v]:
                    st["lat"][v] = du + w
                    improved = True
                if improved:
                    work.append(v)
                    touched.add(v)
        # remote expansion: publish improved boundary values
        for i in range(len(topo.remote_src)):
            s = int(topo.remote_src[i])
            if s in touched or ctx.superstep == 1:
                if np.isfinite(st["hops"][s]) or np.isfinite(st["lat"][s]):
                    ctx.send_to_subgraph(
                        int(topo.remote_dst_sgid[i]),
                        (int(topo.remote_dst_vertex[i]), st["hops"][s] + 1,
                         st["lat"][s] + float(lat_r[i])),
                    )
        # merge reporting: last message per (timestep, sgid) wins
        mask = st["hops"] == n_hops
        ctx.send_message_to_merge(
            (ctx.timestep, topo.sgid, ctx.superstep,
             histogram(st["lat"][mask], bins))
        )
        ctx.vote_to_halt()

    return compute


def merge_histograms(mctx: MergeContext) -> None:
    """Keep each (timestep, sgid)'s LAST histogram, sum the composite."""
    latest: Dict[Tuple[int, int], Tuple[int, np.ndarray]] = {}
    for t, g, s, h in mctx.messages:
        cur = latest.get((t, g))
        if cur is None or s > cur[0]:
            latest[(t, g)] = (s, h)
    total = None
    per_t: Dict[int, np.ndarray] = {}
    for (t, g), (_, h) in latest.items():
        per_t[t] = per_t.get(t, 0) + h
        total = h if total is None else total + h
    mctx.emit({"composite": total, "per_timestep": per_t})


def run_host(
    provider: InstanceProvider,
    source_vertex: int,
    n_hops: int = 6,
    *,
    bins: np.ndarray = DEFAULT_BINS,
    workers: int = 0,
) -> Tuple[Dict[str, Any], Any]:
    """Returns ({"composite": histogram, "per_timestep": {t: histogram}},
    IBSPResult)."""
    compute = make_compute(source_vertex, n_hops, bins)
    res = run_ibsp(
        provider, compute, pattern="eventually", merge=merge_histograms,
        workers=workers,
    )
    return res.merge_result, res


# --------------------------------------------------------------------------
# Engine implementation: registered Gopher analytic (composite)
# --------------------------------------------------------------------------

@register_analytic(
    "nhop",
    pattern="eventually",
    attr=LATENCY_ATTR,
    zero_fill=INF,
    params={"source": REQUIRED, "n_hops": 6, "bins": DEFAULT_BINS},
    kind="composite",
    source_axis="source",
    describe="N-hop latency histogram: eventually dependent — concurrent "
             "per-instance min-latency fixpoints + host-side Merge",
)
def _nhop_execute(ctx, *, source, n_hops, bins):
    """Composite executor: the hop-count fixpoint runs ONCE over unit
    weights (topology is instance-invariant, staged via the shared ones
    batch), the per-instance min-latency fixpoints run under the plan's
    pattern over the shared latency batch, and the Merge folds histograms
    on the host."""
    from repro_torch.core.algorithms.sssp import scalar_source
    from repro_torch.core.engine import min_plus_program, source_init

    bins = np.asarray(bins, np.float64)
    prog = min_plus_program(
        "nhop", init=source_init(scalar_source("nhop", source)))
    # unweighted hop distance: one instance of all-ones weights
    hops_res = ctx.run(prog, pattern="independent", staged=ctx.staged_ones())
    # min-latency distance per instance, then host-side Merge (histograms)
    lat = ctx.run(prog, pattern=ctx.plan.pattern, staged=ctx.staged())
    mask = hops_res.values[0] == n_hops
    hists = np.stack([
        histogram(lat.values[i][mask], bins)
        for i in range(lat.values.shape[0])
    ])
    return {"composite": hists.sum(0), "histograms": hists,
            "__engine__": lat}


def run_blocked(
    bg: BlockedGraph,
    instance_latency: np.ndarray,  # (I, E)
    source_vertex: int,
    n_hops: int = 6,
    *,
    bins: np.ndarray = DEFAULT_BINS,
    use_pallas=None,
    comm="dense",
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Deprecated: use the Gopher session API —
    ``GopherSession.from_blocked(bg, weights={"latency": w}).run(
    session.plan("nhop", source=..., n_hops=...))``
    (``repro_torch.gopher``).  Pins the legacy knobs; results are
    identical to the session path.

    Returns (composite histogram, per-instance histograms (I, nbins))."""
    warnings.warn(
        "nhop.run_blocked is deprecated; use repro_torch.gopher."
        "GopherSession (session.run(session.plan('nhop', source=..., "
        "n_hops=...)))",
        DeprecationWarning, stacklevel=2,
    )
    from repro_torch.gopher import GopherSession

    sess = GopherSession.from_blocked(
        bg, weights={LATENCY_ATTR: instance_latency},
        use_pallas=use_pallas, device=device,
    )
    res = sess.run(sess.plan(
        "nhop", source=source_vertex, n_hops=n_hops, bins=bins,
        layout="dense", comm=comm, staging="sync",
    ))
    return res.output["composite"], res.output["histograms"]


# --------------------------------------------------------------------------
# numpy oracle
# --------------------------------------------------------------------------

def oracle(
    src: np.ndarray, dst: np.ndarray, latency: np.ndarray,
    num_vertices: int, source_vertex: int, n_hops: int = 6,
    bins: np.ndarray = DEFAULT_BINS,
) -> np.ndarray:
    hops = np.full(num_vertices, INF)
    lat = np.full(num_vertices, INF)
    hops[source_vertex] = 0
    lat[source_vertex] = 0.0
    for arr, w in ((hops, np.ones(len(src))), (lat, latency)):
        changed = True
        while changed:
            new = arr.copy()
            np.minimum.at(new, dst, arr[src] + w)
            changed = bool(np.any(new < arr))
            arr[:] = new
    return histogram(lat[hops == n_hops], bins)
