"""Synthetic time-series graph generator shaped like the paper's TR dataset
(§VI-A): small-world topology with power-law-ish subgraph size spread, 7
vertex + 7 edge attributes of mixed types, per-instance values.

Deterministic in (config.seed): the same config always yields the same
collection — the data-pipeline determinism contract extended to graphs.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.configs.base import GraphConfig
from repro_torch.core.graph import (
    AttributeDef,
    GraphInstance,
    GraphTemplate,
    TimeSeriesGraph,
)

VERTEX_ATTRS = (
    AttributeDef("plate", "int32", default=-1),
    AttributeDef("obs_count", "int32", default=0),
    AttributeDef("outdeg_active", "float32", default=0.0),
    AttributeDef("ip_class", "int32", constant=3),
    AttributeDef("is_router", "int32", default=0),
    AttributeDef("load", "float32", default=0.0),
    AttributeDef("uptime", "float32", default=1.0),
)

EDGE_ATTRS = (
    AttributeDef("latency", "float32", default=1.0),
    AttributeDef("bandwidth", "float32", default=100.0),
    AttributeDef("active", "float32", default=1.0),
    AttributeDef("loss", "float32", default=0.0),
    AttributeDef("hops_seen", "int32", default=0),
    AttributeDef("mtu", "int32", constant=1500),
    AttributeDef("jitter", "float32", default=0.0),
)


def generate_template(cfg: GraphConfig) -> GraphTemplate:
    """Hub-and-spoke small-world digraph: preferential attachment backbone
    (gives the inverse subgraph-size/count correlation of Fig. 5) + random
    long-range links."""
    rng = np.random.default_rng(cfg.seed)
    V = cfg.num_vertices
    E = int(V * cfg.avg_degree)
    # preferential-attachment-ish: new vertex links to ~zipf earlier vertex
    tail = rng.integers(1, V, size=E)
    zipf_like = np.minimum(
        (tail * rng.random(E) ** 2.5).astype(np.int64), tail - 1
    )
    src = np.concatenate([tail, zipf_like[: E // 4]])
    dst = np.concatenate([zipf_like, tail[: E // 4]])
    # dedupe + drop self loops
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src * V + dst
    _, idx = np.unique(key, return_index=True)
    src, dst = src[np.sort(idx)], dst[np.sort(idx)]
    return GraphTemplate(
        num_vertices=V,
        src=src.astype(np.int64),
        dst=dst.astype(np.int64),
        vertex_attrs=VERTEX_ATTRS,
        edge_attrs=EDGE_ATTRS,
        name=cfg.name,
    )


def generate_instances(
    cfg: GraphConfig, template: GraphTemplate, *, num_plates: int = 32
) -> List[GraphInstance]:
    """Per-instance values; diurnal latency pattern + random vehicle walk."""
    rng = np.random.default_rng(cfg.seed + 1)
    V, E = template.num_vertices, template.num_edges
    out: List[GraphInstance] = []
    # vehicles do random walks on the graph; plate i at some vertex per t
    plate_pos = rng.integers(0, V, size=num_plates)
    indptr, indices = template.undirected_adjacency()
    for t in range(cfg.num_instances):
        phase = 2 * np.pi * t / max(cfg.num_instances, 1)
        lat = (
            50.0
            + 30.0 * np.sin(phase)
            + rng.gamma(2.0, 10.0, size=E)
        ).astype(np.float32)
        active = (rng.random(E) < 0.8).astype(np.float32)
        plates = np.full(V, -1, np.int32)
        for i in range(num_plates):
            v = int(plate_pos[i])
            plates[v] = i
            deg = indptr[v + 1] - indptr[v]
            if deg > 0:
                plate_pos[i] = int(indices[indptr[v] + rng.integers(0, deg)])
        deg_active = np.zeros(V, np.float32)
        np.add.at(deg_active, template.src, active)
        out.append(
            GraphInstance(
                timestamp=float(t * 7200),
                duration=7200.0,
                vertex_values={
                    "plate": plates,
                    "obs_count": rng.poisson(2.0, V).astype(np.int32),
                    "outdeg_active": deg_active,
                    "is_router": (rng.random(V) < 0.1).astype(np.int32),
                    "load": rng.random(V).astype(np.float32),
                    "uptime": np.minimum(
                        1.0, rng.random(V) + 0.5
                    ).astype(np.float32),
                },
                edge_values={
                    "latency": lat,
                    "bandwidth": rng.gamma(3.0, 30.0, size=E).astype(np.float32),
                    "active": active,
                    "loss": (rng.random(E) * 0.05).astype(np.float32),
                    "hops_seen": rng.poisson(1.0, E).astype(np.int32),
                    "jitter": rng.gamma(1.0, 2.0, size=E).astype(np.float32),
                },
            )
        )
    return out


def generate_collection(cfg: GraphConfig, **kw) -> TimeSeriesGraph:
    template = generate_template(cfg)
    return TimeSeriesGraph(template, generate_instances(cfg, template, **kw))
