"""Analytic registry: named, declarative specs for every Gopher analytic.

The paper's pitch is that Gopher is a *programming abstraction* — a user
declares a sub-graph-centric analytic and the platform decides how to run
it over the distributed temporal layout.  The registry is the declaration
half of that contract: each ``core/algorithms/*`` module registers an
:class:`Analytic` spec (which edge attribute feeds it, the semiring zero
its staging uses, its iBSP pattern, a program factory or a composite
executor, parameter schema), and :class:`repro_torch.gopher.GopherSession`
resolves names against it — ``session.plan("sssp", source=0)`` instead of
hand-assembling store → fill → engine → run.

Two registration shapes:

* ``kind="program"`` — the decorated function is a **program factory**
  ``(ctx, **params) -> SemiringProgram``; the session executes it as one
  engine run under the plan's pattern.  This covers SSSP, PageRank and
  connected components.
* ``kind="composite"`` — the decorated function is an **executor**
  ``(ctx, **params) -> payload dict`` that drives multiple engine runs
  itself through the :class:`~repro_torch.gopher.session.PlanContext`
  (N-hop's hop + latency fixpoints), still drawing every staged tensor
  from the session's shared staging cache.

``tracking``'s entry is not registered yet: it always seeds the query
axis, which waits for ROADMAP item 2.

>>> import repro_torch.core.algorithms  # registration side effect
>>> from repro_torch.gopher.registry import list_analytics, get_analytic
>>> list_analytics()
['components', 'nhop', 'pagerank', 'sssp']
>>> get_analytic("sssp").pattern
'sequential'
>>> get_analytic("pagerank").attr
'active'
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class _Required:
    """Sentinel default marking an analytic parameter as mandatory."""

    def __repr__(self) -> str:  # shown in explain()/error messages
        return "<required>"


REQUIRED = _Required()

_REGISTRY: Dict[str, "Analytic"] = {}


@dataclass(frozen=True)
class Analytic:
    """One registered analytic: staging contract + execution recipe.

    ``attr``/``zero_fill`` describe the staged batch the analytic's MAIN
    engine run consumes — the shared-staging key ``run_many`` amortizes
    over: two analytics with the same ``(graph, attr, transform,
    zero_fill)`` stage tiles once.  ``weights`` optionally transforms the
    raw ``(I, E)`` attribute matrix before staging (PageRank's outdegree
    normalization); its name rides in the staging key so different
    transforms never alias.
    """

    name: str
    pattern: str  # default iBSP pattern ("sequential"|"independent"|"eventually")
    attr: str  # edge attribute feeding the main staging
    zero_fill: float  # semiring zero of the staged tiles
    params: Dict[str, Any] = field(default_factory=dict)  # name -> default
    graph: str = "template"  # blocked structure: "template" | "symmetrized"
    merge: Optional[str] = None  # default eventually-Merge mode
    make_program: Optional[Callable] = None  # (ctx, **params) -> SemiringProgram
    execute: Optional[Callable] = None  # (ctx, **params) -> payload dict
    weights: Optional[Callable] = None  # (ctx, raw (I, E)) -> staged (I, E')
    postprocess: Optional[Callable] = None  # (ctx, EngineResult, **params) -> payload
    # the weights transform is ROW-WISE: transform(w)[s:e] ==
    # transform(w[s:e]) for any instance window, i.e. each instance's
    # derived weights depend only on that instance's raw row.  Row-wise
    # transforms can run chunk-by-chunk on the prefetcher's pool thread,
    # so store-backed derived-weight analytics stream asynchronously
    # instead of materializing the full (I, E) matrix up front.
    rowwise: bool = False
    # name of the parameter that seeds the semiring state from one vertex
    # (e.g. "source").  The planner prices a SEQUENCE there as Q sources
    # on one query axis; running one raises until the query axis is
    # ported (ROADMAP item 2).
    source_axis: Optional[str] = None
    describe: str = ""

    @property
    def composite(self) -> bool:
        return self.execute is not None

    @property
    def transform_name(self) -> str:
        """Staging-key component naming the weights transform."""
        return "raw" if self.weights is None else \
            getattr(self.weights, "__name__", self.name)

    def resolve_params(self, overrides: Dict[str, Any]) -> Dict[str, Any]:
        """Declared defaults + caller overrides; unknown or missing
        required parameters raise ``TypeError`` (the declarative API's
        equivalent of a bad function signature)."""
        unknown = sorted(set(overrides) - set(self.params))
        if unknown:
            raise TypeError(
                f"analytic {self.name!r} got unknown parameter(s) "
                f"{unknown}; declared: {sorted(self.params)}"
            )
        resolved = dict(self.params)
        resolved.update(overrides)
        missing = sorted(
            k for k, v in resolved.items() if isinstance(v, _Required)
        )
        if missing:
            raise TypeError(
                f"analytic {self.name!r} missing required parameter(s) "
                f"{missing}"
            )
        return resolved


def register_analytic(
    name: str,
    *,
    pattern: str,
    attr: str,
    zero_fill: float,
    params: Optional[Dict[str, Any]] = None,
    graph: str = "template",
    merge: Optional[str] = None,
    kind: str = "program",
    weights: Optional[Callable] = None,
    rowwise: bool = False,
    postprocess: Optional[Callable] = None,
    source_axis: Optional[str] = None,
    describe: str = "",
):
    """Class the decorated function as a named analytic.

    ``kind="program"`` decorates a program factory, ``kind="composite"``
    a multi-run executor (see module docstring).  Registering a name
    twice raises — analytics are platform-level declarations, not
    session-local state."""
    assert kind in ("program", "composite"), kind
    assert pattern in ("sequential", "independent", "eventually"), pattern
    assert graph in ("template", "symmetrized"), graph

    def deco(fn):
        if name in _REGISTRY:
            raise ValueError(
                f"analytic {name!r} is already registered "
                f"(by {_REGISTRY[name].describe or 'an earlier module'!r})"
            )
        _REGISTRY[name] = Analytic(
            name=name, pattern=pattern, attr=attr, zero_fill=zero_fill,
            params=dict(params or {}), graph=graph, merge=merge,
            make_program=fn if kind == "program" else None,
            execute=fn if kind == "composite" else None,
            weights=weights, rowwise=rowwise, postprocess=postprocess,
            source_axis=source_axis,
            describe=describe or (fn.__doc__ or "").strip().split("\n")[0],
        )
        return fn

    return deco


def get_analytic(name: str) -> Analytic:
    """Look up a registered analytic; unknown names raise ``KeyError``
    listing what IS registered (typo-friendly)."""
    _ensure_registered()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown analytic {name!r}; registered: {list_analytics()}"
        ) from None


def list_analytics() -> List[str]:
    """Sorted names of every registered analytic."""
    _ensure_registered()
    return sorted(_REGISTRY)


def _ensure_registered() -> None:
    """Import the stock algorithm modules (registration side effect).

    Lazy so ``repro_torch.gopher`` and ``repro_torch.core.algorithms`` can
    import in either order without a cycle."""
    import repro_torch.core.algorithms  # noqa: F401
