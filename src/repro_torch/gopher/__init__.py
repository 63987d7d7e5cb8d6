"""Gopher session API — the declarative entry point (paper §III–V),
counterpart of ``repro.gopher``.

``GopherSession`` wraps one time-series graph collection (a deployed
``GoFSStore``, an in-memory ``TimeSeriesGraph``, or pre-blocked arrays)
behind three verbs: ``plan`` (auto-tuned, costed, explainable execution
plans for registered analytics), ``run`` (execute one plan), and
``run_many`` (execute several with shared staging — one
``load_blocked``/prefetch pass feeding N engine runs).

Registry → planner → executor; ``GopherService`` serves queries from one
warm session (source-axis batching, tailing subscriptions).
"""
from repro_torch.gopher.planner import (
    ExecutionPlan, PlanChoice, SPARSE_OCCUPANCY_MAX)
from repro_torch.gopher.registry import (
    Analytic,
    REQUIRED,
    get_analytic,
    list_analytics,
    register_analytic,
)
from repro_torch.gopher.service import GopherService, QueryTicket
from repro_torch.gopher.session import (
    AnalyticResult, GopherSession, PlanContext)

__all__ = [
    "Analytic",
    "AnalyticResult",
    "ExecutionPlan",
    "GopherService",
    "GopherSession",
    "PlanChoice",
    "PlanContext",
    "QueryTicket",
    "REQUIRED",
    "SPARSE_OCCUPANCY_MAX",
    "get_analytic",
    "list_analytics",
    "register_analytic",
]
