"""PageRank per instance (paper §VI-A): independent pattern.

Each graph instance is ranked independently, considering only edges *active*
in that instance.  Specification (engine and oracle): power iteration of
    r' = (1-d)/N + d * A_w^T r,   A_w[u,v] = active(u,v)/outdeg_active(u)
without dangling-mass redistribution, ``iters`` fixed steps.
"""
from __future__ import annotations

import numpy as np

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
