"""Connected components per instance (independent pattern) — the classic
label-propagation workload; exercises min-plus with 0/inf weights.

``symmetrized_blocked`` builds the blocked structure the engine runs it
on (labels propagate both ways through min-plus); ``oracle`` is
union-find on the host.  The engine form is the registered
``"components"`` Gopher analytic (``repro_torch.gopher``);
``run_blocked`` and ``run_blocked_temporal`` remain as deprecated thin
wrappers over the session.
"""
from __future__ import annotations

import warnings

import numpy as np

from repro_torch.core.blocked import BlockedGraph, build_blocked
from repro_torch.core.graph import GraphTemplate
from repro_torch.gopher.registry import register_analytic

INF = float(np.inf)


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


def _components_weights(session, raw: np.ndarray) -> np.ndarray:
    """Staging transform: (I, E) activity -> (I, 2E) min-plus weights over
    the symmetrized (doubled) edge list — 0 on active edges (labels pass
    freely both ways), INF elsewhere."""
    w = np.where(np.asarray(raw) > 0, 0.0, INF).astype(np.float32)
    return np.concatenate([w, w], axis=1)  # both orientations


def _postprocess(ctx, res, **_params):
    return {"labels": res.values.astype(np.int64)}


@register_analytic(
    "components",
    pattern="independent",
    attr="active",
    zero_fill=INF,
    graph="symmetrized",
    params={"max_supersteps": 256},
    weights=_components_weights,
    postprocess=_postprocess,
    describe="connected components per instance: min-label propagation "
             "over the symmetrized active edges",
)
def _components_program(ctx, *, max_supersteps):
    """Program factory for the ``"components"`` analytic."""
    from repro_torch.core.engine import label_init, min_plus_program

    return min_plus_program(
        "components", init=label_init(), max_supersteps=max_supersteps,
    )


def _session_labels(bg, src, dst, instance_active, use_pallas, comm,
                    device):
    from repro_torch.gopher import GopherSession

    sess = GopherSession.from_blocked(
        bg, weights={"active": instance_active}, src=src, dst=dst,
        use_pallas=use_pallas, device=device,
    )
    res = sess.run(sess.plan(
        "components", layout="dense", comm=comm, staging="sync",
    ))
    return res.output["labels"]


def run_blocked_temporal(
    bg: BlockedGraph,
    src: np.ndarray,
    dst: np.ndarray,
    instance_active: np.ndarray,  # (I, E) 0/1 per instance
    *,
    use_pallas=None,
    comm="dense",
    device="cuda",
) -> np.ndarray:
    """Deprecated: use the Gopher session API —
    ``GopherSession.from_blocked(bg, weights={"active": a}, src=src,
    dst=dst).run(session.plan("components"))`` (``repro_torch.gopher``).
    Returns (I, V) int64 labels, identical to the session path."""
    warnings.warn(
        "components.run_blocked_temporal is deprecated; use repro_torch."
        "gopher.GopherSession (session.run(session.plan('components')))",
        DeprecationWarning, stacklevel=2,
    )
    return _session_labels(bg, src, dst, instance_active, use_pallas, comm,
                           device)


def run_blocked(
    bg: BlockedGraph,
    src: np.ndarray,
    dst: np.ndarray,
    active: np.ndarray,  # (E,) 0/1 — edges active in this instance
    *,
    use_pallas=None,
    comm="dense",
    device="cuda",
) -> np.ndarray:
    """Deprecated single-instance form of ``run_blocked_temporal`` (same
    session path).  Returns (V,) component labels (min vertex id in
    component)."""
    warnings.warn(
        "components.run_blocked is deprecated; use repro_torch.gopher."
        "GopherSession (session.run(session.plan('components')))",
        DeprecationWarning, stacklevel=2,
    )
    labels = _session_labels(
        bg, src, dst, np.asarray(active)[None], use_pallas, comm, device,
    )
    return labels[0]


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
