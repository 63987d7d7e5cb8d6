"""Time-series graph model (paper §III-A).

Γ = ⟨Ĝ, G⟩: a *template* Ĝ = (V̂, Ê) holding the slow-changing topology and
the attribute *schemas*, and a time-ordered list of *instances* gᵗ holding
attribute *values* for every vertex/edge at time window t.  |Vᵗ| = |V̂| and
|Eᵗ| = |Ê| for all t; the special ``isExists`` attribute simulates slow
appearance/disappearance of vertices/edges.

Host-side representation is flat numpy (CSR-ish edge list); the device-facing
blocked representation lives in ``repro_torch.core.blocked``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IS_EXISTS = "isExists"


@dataclass(frozen=True)
class AttributeDef:
    """Typed attribute schema entry (paper: typed name-value pairs)."""

    name: str
    dtype: str = "float32"
    default: Optional[float] = None  # template-level default (overridable)
    constant: Optional[float] = None  # template-level constant (not overridable)

    def fill_value(self) -> float:
        if self.constant is not None:
            return self.constant
        if self.default is not None:
            return self.default
        return 0.0


@dataclass
class GraphTemplate:
    """Ĝ: topology + attribute schemas.  Edges are directed (src -> dst)."""

    num_vertices: int
    src: np.ndarray  # (E,) int64 source vertex ids
    dst: np.ndarray  # (E,) int64 destination vertex ids
    vertex_attrs: Tuple[AttributeDef, ...] = ()
    edge_attrs: Tuple[AttributeDef, ...] = ()
    name: str = "graph"

    @property
    def num_edges(self) -> int:
        return len(self.src)

    def __post_init__(self):
        assert self.src.shape == self.dst.shape
        if self.num_edges:
            assert int(self.src.max()) < self.num_vertices
            assert int(self.dst.max()) < self.num_vertices

    def vertex_attr(self, name: str) -> AttributeDef:
        for a in self.vertex_attrs:
            if a.name == name:
                return a
        raise KeyError(name)

    def edge_attr(self, name: str) -> AttributeDef:
        for a in self.edge_attrs:
            if a.name == name:
                return a
        raise KeyError(name)

    def out_degree(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_vertices)

    def undirected_adjacency(self) -> "csr_like":
        """(indptr, indices) over the symmetrized edge set (for partitioning
        and subgraph discovery, which the paper defines on connectivity)."""
        s = np.concatenate([self.src, self.dst])
        d = np.concatenate([self.dst, self.src])
        order = np.argsort(s, kind="stable")
        s, d = s[order], d[order]
        indptr = np.zeros(self.num_vertices + 1, np.int64)
        np.add.at(indptr, s + 1, 1)
        indptr = np.cumsum(indptr)
        return indptr, d


@dataclass
class GraphInstance:
    """gᵗ: attribute values for one time window [t_start, t_end)."""

    timestamp: float
    duration: float
    vertex_values: Dict[str, np.ndarray] = field(default_factory=dict)  # (V,)
    edge_values: Dict[str, np.ndarray] = field(default_factory=dict)  # (E,)

    @property
    def t_end(self) -> float:
        return self.timestamp + self.duration


class TimeSeriesGraph:
    """Γ: template + time-ordered instances (in-memory collection).

    The GoFS store persists/loads the same logical model; this
    class is the programming-model-facing view with value inheritance
    (instance value > template default > template constant).
    """

    def __init__(self, template: GraphTemplate, instances: Sequence[GraphInstance]):
        self.template = template
        self.instances = sorted(instances, key=lambda g: g.timestamp)
        ts = [g.timestamp for g in self.instances]
        assert ts == sorted(ts)

    def __len__(self) -> int:
        return len(self.instances)

    def vertex_values(self, t_idx: int, name: str) -> np.ndarray:
        """Instance value with template default/constant inheritance."""
        a = self.template.vertex_attr(name)
        inst = self.instances[t_idx]
        if a.constant is None and name in inst.vertex_values:
            return inst.vertex_values[name]
        return np.full(self.template.num_vertices, a.fill_value(),
                       np.dtype(a.dtype))

    def edge_values(self, t_idx: int, name: str) -> np.ndarray:
        a = self.template.edge_attr(name)
        inst = self.instances[t_idx]
        if a.constant is None and name in inst.edge_values:
            return inst.edge_values[name]
        return np.full(self.template.num_edges, a.fill_value(), np.dtype(a.dtype))

    def time_range(self) -> Tuple[float, float]:
        return self.instances[0].timestamp, self.instances[-1].t_end

    def filter_time(self, t_start: float, t_end: float) -> List[int]:
        """Indices of instances overlapping [t_start, t_end) (paper §V-B)."""
        return [
            i for i, g in enumerate(self.instances)
            if g.timestamp < t_end and g.t_end > t_start
        ]
