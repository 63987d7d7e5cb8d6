"""GopherSession: the declarative entry point for temporal graph analytics
(counterpart of ``repro.gopher.session``).

The paper positions Gopher as a *programming abstraction*: the user says
WHAT to compute over the time-series collection, the platform (co-designed
with GoFS) decides HOW.  ``GopherSession`` is that contract for this
package's execution machinery — one object wrapping a data source, with
three verbs:

* ``plan(analytic, **params)`` — resolve a registered analytic
  (:mod:`repro_torch.gopher.registry`) into a costed
  :class:`~repro_torch.gopher.planner.ExecutionPlan`: tile layout from the
  recorded occupancy, comm backend, staging mode from the source, kernel
  mode from the device — every choice overridable and rendered by
  ``plan.explain()`` before anything runs.
* ``run(plan)`` — execute one plan, returning an :class:`AnalyticResult`
  (the engine outputs + the plan that produced them).
* ``run_many([plans])`` — execute several plans over the SAME collection
  with **shared staging**: analytics whose staged batches coincide
  (same graph variant, attribute, transform, semiring zero, layout)
  stage tiles once — one ``load_blocked``/prefetch pass feeding N engine
  runs.

Data sources (all expose the same verbs):

* a :class:`~repro_torch.gofs.store.GoFSStore` — the deployed
  collection; the blocked structure is reconstructed from the stored
  topology slices, attributes stream from disk;
* a :class:`~repro_torch.core.graph.TimeSeriesGraph` — an in-memory
  collection; the session partitions and blocks it;
* :meth:`GopherSession.from_blocked` — a pre-built
  :class:`~repro_torch.core.blocked.BlockedGraph` plus raw ``(I, E)``
  weight matrices (what the deprecated ``run_blocked`` wrappers use).

The session runs on ``device`` (``"cuda"`` by default; ``"cpu"`` runs
every kernel's plain PyTorch version) and passes it to every engine it
builds.  Not ported yet, and raising ``NotImplementedError`` that names
the ROADMAP item: ``refresh`` and ``tail`` (item 5), ``mesh=`` (item 6),
``cluster=`` and ``run(checkpoint_dir=...)`` (item 7).

>>> import numpy as np
>>> from repro_torch.core.blocked import build_blocked
>>> from repro_torch.core.graph import GraphTemplate
>>> from repro_torch.gopher import GopherSession
>>> tmpl = GraphTemplate(num_vertices=4,
...     src=np.array([0, 1, 2, 0]), dst=np.array([1, 2, 3, 2]))
>>> bg = build_blocked(tmpl, np.array([0, 0, 1, 1]), block_size=2)
>>> sess = GopherSession.from_blocked(
...     bg, weights={"latency": np.ones((2, 4), np.float32)}, device="cpu")
>>> plan = sess.plan("sssp", source=0)     # every knob auto-selected
>>> (plan.layout.value, plan.comm.value, plan.staging.value,
...  plan.kernel.value, plan.placement.value)
('dense', 'dense', 'sync', 'off', 'stacked')
>>> sess.run(plan).output["final"]
array([0., 1., 1., 2.], dtype=float32)
>>> both = sess.run_many([plan, sess.plan("sssp", source=1)])  # shared staging
>>> both[1].output["final"]
array([inf,  0.,  1.,  2.], dtype=float32)
>>> sess.last_run_report["staging_passes"]  # two analytics, one staging
1
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.blocked import BlockedGraph, SparseBlocked, pow2_bucket
from repro_torch.core.engine import (
    EngineResult, RunSpec, TemporalEngine, _not_ported)
from repro_torch.core.superstep import kernel_mode, resolve_device
from repro_torch.gopher.planner import ExecutionPlan, plan_analytic
from repro_torch.gopher.registry import Analytic, get_analytic

ONES_ATTR = "__ones__"  # pseudo-attribute: unit weights on every edge


# ---------------------------------------------------------------------------
# Staged batches + the shared-staging cache
# ---------------------------------------------------------------------------

@dataclass
class StagedBatch:
    """One materialized instance batch (dense tensors or a packed sparse
    batch) plus the host bytes it cost — the unit ``run_many`` shares."""

    layout: str
    tiles: Optional[np.ndarray] = None  # dense (I, P, T, B, B)
    btiles: Optional[np.ndarray] = None  # dense (I, P, Tb, B, B)
    sp: Optional[SparseBlocked] = None  # sparse packed batch
    nbytes: int = 0


class _StagingCache:
    """Cache of staged batches, keyed on (graph variant, attribute,
    transform, zero_fill, layout).

    Default scope is one ``run_many`` call (``byte_budget=None``: no
    eviction, dropped with the call).  With a byte budget it becomes a
    SESSION-lifetime cache — ``GopherSession(staging_cache_bytes=...)`` —
    holding batches LRU-resident up to the budget so repeated queries
    over a warm session re-stage nothing (the serving path).  Counters
    are cumulative; callers snapshot/diff them per run (the
    shared-staging and serving bench rows gate on the diffs)."""

    def __init__(self, byte_budget: Optional[float] = None):
        self.entries: "OrderedDict[Tuple, StagedBatch]" = OrderedDict()
        self.byte_budget = byte_budget
        self.staged_bytes = 0  # host tile/index bytes materialized (cum.)
        self.staging_passes = 0  # distinct batch materializations (cum.)
        self.hits = 0  # re-staging avoided by residency (cum.)
        self.evictions = 0
        self.resident_bytes = 0  # bytes currently held

    def staged(self, key: Tuple, maker: Callable[[], StagedBatch]) -> StagedBatch:
        batch = self.entries.get(key)
        if batch is not None:
            self.hits += 1
            self.entries.move_to_end(key)
            return batch
        batch = maker()
        self.staged_bytes += batch.nbytes
        self.staging_passes += 1
        self.entries[key] = batch
        self.resident_bytes += batch.nbytes
        if self.byte_budget is not None:
            # evict least-recently-used down to the budget; the returned
            # batch stays valid either way (the caller holds a reference),
            # an over-budget sole entry simply isn't retained for reuse
            while self.entries and self.resident_bytes > self.byte_budget:
                _, old = self.entries.popitem(last=False)
                self.resident_bytes -= old.nbytes
                self.evictions += 1
        return batch

    def stats(self) -> Dict[str, Any]:
        return {
            "entries": len(self.entries),
            "resident_bytes": self.resident_bytes,
            "byte_budget": self.byte_budget,
            "staged_bytes": self.staged_bytes,
            "staging_passes": self.staging_passes,
            "hits": self.hits,
            "evictions": self.evictions,
        }


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclass
class AnalyticResult:
    """An executed plan: analytic-specific outputs + provenance.

    ``output`` holds the analytic's payload (``final`` distances for
    SSSP, ``ranks`` for PageRank, ``labels``, ``composite`` histograms,
    ``trace`` ...); ``engine`` the underlying
    :class:`~repro_torch.core.engine.EngineResult` of the main run (``None``
    only for analytics with no single main run); ``plan`` the exact
    execution that produced them."""

    plan: ExecutionPlan
    engine: Optional[EngineResult]
    output: Dict[str, Any] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Execution context handed to program factories / composite executors
# ---------------------------------------------------------------------------

class PlanContext:
    """What a registered analytic sees at execution time: the blocked
    structure, template arrays, raw attributes, and ``run`` — all staging
    routed through the shared cache so composite analytics amortize with
    their neighbors."""

    def __init__(self, session: "GopherSession", plan: ExecutionPlan,
                 analytic: Analytic, cache: _StagingCache):
        self.session = session
        self.plan = plan
        self.analytic = analytic
        self.cache = cache
        self.params = plan.param_dict

    # ---- graph access ----------------------------------------------------
    @property
    def bg(self) -> BlockedGraph:
        return self.session._blocked(self.plan.graph)

    @property
    def num_vertices(self) -> int:
        return int(len(self.session.bg.part_of))

    @property
    def num_instances(self) -> int:
        return self.session.num_instances

    @property
    def num_edges(self) -> int:
        return self.session.num_edges

    @property
    def src(self) -> np.ndarray:
        return self.session.src

    @property
    def dst(self) -> np.ndarray:
        return self.session.dst

    # ---- staged data -----------------------------------------------------
    def staged(self) -> StagedBatch:
        """The analytic's MAIN staged batch (attr/transform/zero from the
        registry, layout from the plan) via the shared cache."""
        return self.session._staged(
            self.cache, self.analytic, self.plan.layout.value,
            delta=bool(self.plan.delta.value),
        )

    def staged_ones(self) -> StagedBatch:
        """Unit weights on every template edge, one instance — the
        topology-only batch hop-count fixpoints and probe traversals use
        (dense: every edge is live)."""
        return self.session._staged_ones(self.cache)

    def vertex_attr(self, name: str) -> np.ndarray:
        """(I, V) vertex attribute matrix for the visible collection."""
        return self.session._vertex_attr(name)

    # ---- execution -------------------------------------------------------
    def run(self, program, *, pattern: Optional[str] = None,
            merge: Optional[str] = None, x0: Optional[np.ndarray] = None,
            staged: Optional[StagedBatch] = None) -> EngineResult:
        """One engine run over a staged batch under this plan's engine
        configuration (comm/placement).  Defaults: the plan's pattern and
        merge, the analytic's main staged batch."""
        staged = staged if staged is not None else self.staged()
        pattern = pattern or self.plan.pattern
        merge = merge if merge is not None else (
            self.plan.merge if pattern == "eventually" else None)
        engine = self.session._engine(self.plan.graph, self.plan.comm.value,
                                      self.plan.kernel.value)
        spec = RunSpec(program, pattern, x0=x0, merge=merge)
        return self.session._dispatch_specs(engine, [spec], staged)[0]


# ---------------------------------------------------------------------------
# Session
# ---------------------------------------------------------------------------

class GopherSession:
    """Declarative session over one time-series graph collection.

    See the module docstring for the data sources and verbs.  Placement
    is session-level (``device``, ``use_pallas``); analytics and their
    knobs are plan-level."""

    def __init__(
        self,
        source=None,
        *,
        num_partitions: Optional[int] = None,
        block_size: Optional[int] = None,
        seed: int = 0,
        device="cuda",
        mesh=None,
        use_pallas=None,
        bg: Optional[BlockedGraph] = None,
        src: Optional[np.ndarray] = None,
        dst: Optional[np.ndarray] = None,
        weights: Optional[Dict[str, np.ndarray]] = None,
        vertex_attrs: Optional[Dict[str, np.ndarray]] = None,
        staging_cache_bytes: Optional[float] = None,
        cluster=None,
    ):
        from repro_torch.core.graph import TimeSeriesGraph
        from repro_torch.gofs.store import GoFSStore

        if mesh is not None:
            raise _not_ported("mesh placement", "6")
        if cluster is not None:
            raise _not_ported("cluster sessions", "7")
        self.device = resolve_device(device)
        # kernel-mode policy: None -> the planner's auto rule picks
        # off/spmv/fused per plan from the device and recorded occupancy;
        # anything else (bool or mode string, see
        # repro_torch.core.superstep.kernel_mode) is a session-wide
        # override recorded on every plan.
        self.use_pallas = use_pallas
        self.store: Optional[GoFSStore] = None
        self.tsg: Optional[TimeSeriesGraph] = None
        self._weights = dict(weights or {})
        self._vertex_attrs = dict(vertex_attrs or {})
        self._engines: Dict[Tuple[str, str, str], TemporalEngine] = {}
        self._bg_variants: Dict[str, BlockedGraph] = {}
        self._w_cache: Dict[Tuple, np.ndarray] = {}
        self._activity_cache: Dict[Tuple, Tuple] = {}
        self.last_run_report: Dict[str, Any] = {}
        # staging_cache_bytes promotes the per-call staging cache to a
        # session-lifetime LRU with that byte budget: staged batches stay
        # resident across run_many calls, so repeated queries re-stage
        # nothing.  None keeps the default call-scoped cache.
        self._staging_cache: Optional[_StagingCache] = (
            _StagingCache(byte_budget=staging_cache_bytes)
            if staging_cache_bytes is not None else None)

        if isinstance(source, GoFSStore):
            self.store = source
            s, d, assign = _store_template_arrays(source)
            self.src, self.dst = s, d
            bsz = block_size or _store_block_size(source) or 64
            tmpl = _template_of(int(source.meta["num_vertices"]), s, d)
            from repro_torch.core.blocked import build_blocked

            self.bg = build_blocked(tmpl, assign, bsz)
            self.num_instances = source.num_timesteps()
            self.num_edges = int(source.meta["num_edges"])
        elif isinstance(source, TimeSeriesGraph):
            self.tsg = source
            tmpl = source.template
            from repro_torch.core.blocked import build_blocked
            from repro_torch.core.partition import partition_graph

            assign = partition_graph(tmpl, num_partitions or 4, seed=seed)
            self.src, self.dst = tmpl.src, tmpl.dst
            self.bg = build_blocked(tmpl, assign, block_size or 64)
            self.num_instances = len(source)
            self.num_edges = int(tmpl.num_edges)
        elif bg is not None:
            self.bg = bg
            self.src, self.dst = src, dst
            self.num_edges = len(bg.le_edge_id) + len(bg.re_edge_id)
            n_i = [np.asarray(w).shape[0] if np.asarray(w).ndim > 1 else 1
                   for w in self._weights.values()]
            n_i += [np.asarray(v).shape[0]
                    for v in self._vertex_attrs.values()]
            assert n_i, "from_blocked needs weights= or vertex_attrs="
            self.num_instances = max(n_i)
        else:
            raise TypeError(
                "GopherSession needs a GoFSStore, a TimeSeriesGraph, or "
                "GopherSession.from_blocked(bg, weights=...)")
        self._bg_variants["template"] = self.bg

    @classmethod
    def from_blocked(
        cls,
        bg: BlockedGraph,
        *,
        weights: Optional[Dict[str, np.ndarray]] = None,
        vertex_attrs: Optional[Dict[str, np.ndarray]] = None,
        src: Optional[np.ndarray] = None,
        dst: Optional[np.ndarray] = None,
        **kw,
    ) -> "GopherSession":
        """Session over a pre-built blocked structure + raw ``(I, E)``
        attribute matrices (``weights``) and ``(I, V)`` vertex matrices
        (``vertex_attrs``).  ``src``/``dst`` (template edge endpoints)
        are only needed by analytics that derive weights from topology
        (PageRank's outdegree normalization, components' symmetrized
        graph)."""
        return cls(None, bg=bg, weights=weights, vertex_attrs=vertex_attrs,
                   src=src, dst=dst, **kw)

    # ------------------------------------------------------------ planning
    def plan(
        self,
        analytic: str,
        *,
        pattern: Optional[str] = None,
        merge: Optional[str] = None,
        layout: Optional[str] = None,
        comm: Optional[str] = None,
        staging: Optional[str] = None,
        delta: Optional[bool] = None,
        warm: Optional[bool] = None,
        kernel: Optional[str] = None,
        **params,
    ) -> ExecutionPlan:
        """Resolve ``analytic`` into a costed :class:`ExecutionPlan`.

        Every knob (``layout``/``comm``/``staging``/``delta``/``warm``/
        ``kernel``, plus ``pattern`` and ``merge`` for program analytics)
        defaults to
        the planner's auto-selection — pass a value to override; the plan
        records which happened and why (``plan.explain()``).  Planning
        never reads a value slice: activity comes from
        deployment-recorded tile maps (stores) or an in-memory scan
        (arrays); delta/warm read the deploy-recorded chain summary
        (unique-tile ratio, monotonicity) from the same tile-map slice."""
        from repro_torch.core.comm import COMM_BACKENDS
        from repro_torch.core.superstep import KERNEL_MODES

        assert layout in (None, "dense", "sparse"), layout
        assert comm in (None,) + COMM_BACKENDS, comm
        assert staging in (None, "sync", "async"), staging
        assert kernel in (None,) + KERNEL_MODES, kernel
        if kernel is None and self.use_pallas is not None:
            # session-wide kernel policy becomes a per-plan override
            kernel = kernel_mode(self.use_pallas, self.device)
        a = get_analytic(analytic)
        resolved = a.resolve_params(params)
        # activity only matters to the layout decision; an override skips
        # the scan (estimates then omit occupancy)
        occupancy, buckets = (None, None) if layout is not None \
            else self._plan_activity(a)
        delta_ratio = delta_monotone = None
        if (self.store is not None and a.weights is None
                and a.graph == "template" and a.attr != ONES_ATTR):
            delta_ratio, delta_monotone = self.store.delta_stats(
                a.attr, zero=a.zero_fill)
        return plan_analytic(
            a, resolved,
            bg=self._blocked(a.graph),
            store_backed=self.store is not None,
            occupancy=occupancy,
            sparse_buckets=buckets,
            num_instances=self.num_instances,
            delta_ratio=delta_ratio,
            delta_monotone=delta_monotone,
            zero_fill=float(a.zero_fill),
            pattern=pattern, merge=merge,
            layout=layout, comm=comm, staging=staging,
            delta=delta, warm=warm,
            kernel=kernel, device=self.device.type,
        )

    def explain(self, analytic: str, **kw) -> str:
        """``plan(...).explain()`` in one call."""
        return self.plan(analytic, **kw).explain()

    # ----------------------------------------------------------- execution
    def run(self, plan, *, resume: bool = False,
            checkpoint_dir: Optional[str] = None,
            **params) -> AnalyticResult:
        """Execute one plan (or plan an analytic by name and execute it).

        ``checkpoint_dir=`` (resumable runs) raises: it comes with the
        cluster runtime (ROADMAP item 7)."""
        if isinstance(plan, str):
            plan = self.plan(plan, **params)
        else:
            assert not params, "params belong to plan(); got a built plan"
        if checkpoint_dir is not None or resume:
            raise _not_ported("resumable runs (checkpoint_dir=)", "7")
        return self.run_many([plan])[0]

    def run_many(self, plans: Sequence[ExecutionPlan]) -> List[AnalyticResult]:
        """Execute several plans over this collection with shared staging.

        Plans whose staged batches coincide (same graph variant,
        attribute, weight transform, semiring zero, and layout) stage
        tiles ONCE; program analytics sharing a batch additionally share
        one :meth:`TemporalEngine.run_many` pass — for async store-backed
        groups that is a single disk prefetch pass feeding N engine runs.
        Results come back in plan order, bitwise identical to running
        each plan alone; ``session.last_run_report`` records the staging
        economy (bytes, passes)."""
        plans = list(plans)
        # session-lifetime cache when configured (warm serving), else one
        # cache per call; counters are cumulative so report deltas below
        cache = self._staging_cache if self._staging_cache is not None \
            else _StagingCache()
        base = (cache.staged_bytes, cache.staging_passes, cache.hits)
        results: List[Optional[AnalyticResult]] = [None] * len(plans)
        resolved = [get_analytic(p.analytic) for p in plans]

        # staging keys composite analytics will pull from the cache — a
        # program group sharing one of these must stage through the cache
        # (not a private stream) or the sharing is lost
        composite_keys = {
            self._main_key(a, p.layout.value)
            for a, p in zip(resolved, plans) if a.composite
        }

        # ---- program analytics: group by (staging key, comm) -------------
        groups: Dict[Tuple, List[int]] = {}
        for i, (a, p) in enumerate(zip(resolved, plans)):
            if not a.composite:
                key = self._main_key(a, p.layout.value) + (
                    p.comm.value, p.kernel.value)
                groups.setdefault(key, []).append(i)
        # a staging key split across comm/kernel backends must stage via
        # the cache (a private stream per group would re-read the disk)
        skey_groups: Dict[Tuple, int] = {}
        for key in groups:
            skey_groups[key[:-2]] = skey_groups.get(key[:-2], 0) + 1
        for key, idxs in groups.items():
            skey, comm, kern = key[:-2], key[-2], key[-1]
            graph, attr, transform, zero, layout = skey
            specs = []
            for i in idxs:
                ctx = PlanContext(self, plans[i], resolved[i], cache)
                program = resolved[i].make_program(
                    ctx, **plans[i].param_dict)
                specs.append(RunSpec(program, plans[i].pattern,
                                     merge=plans[i].merge,
                                     warm_start=bool(plans[i].warm.value)))
            engine = self._engine(graph, comm, kern)
            a0 = resolved[idxs[0]]
            # row-wise transforms stream too: the derived weights compute
            # chunk-by-chunk on the prefetch pool (registry `rowwise`)
            rowwise_stream = (transform != "raw" and a0.rowwise
                              and a0.weights is not None)
            # results are bitwise-identical either way, so one member
            # planning delta staging turns it on for the shared pass
            use_delta = any(bool(plans[i].delta.value) for i in idxs)
            stream_ok = (
                self.store is not None
                # a session-lifetime cache favors residency over streaming:
                # materialize through the cache so the NEXT query re-stages
                # nothing (streamed chunks leave nothing resident)
                and self._staging_cache is None
                and (transform == "raw" or rowwise_stream)
                and attr != ONES_ATTR
                and graph == "template"
                and skey not in composite_keys
                and skey_groups[skey] == 1
                and skey not in cache.entries
                and all(plans[i].staging.value == "async" for i in idxs)
            )
            if stream_ok:
                # ONE disk prefetch pass feeds all N runs; chunk bytes
                # are counted by the wrapper so the staging economy report
                # is comparable with the cache path
                tf = None if transform == "raw" else \
                    (lambda rows: a0.weights(self, rows))
                stream = self.store.load_blocked_stream(
                    self.bg, attr, zero=zero, layout=layout,
                    delta=use_delta, transform=tf)
                cache.staging_passes += 1
                outs = engine.run_many(
                    specs, stream=_CountedChunks(stream, cache))
            else:
                # any member analytic materializes the same batch (the
                # transform rides in the group key)
                staged = self._staged(cache, resolved[idxs[0]], layout,
                                      delta=use_delta)
                outs = self._dispatch_specs(engine, specs, staged)
            for i, res in zip(idxs, outs):
                results[i] = self._wrap(plans[i], resolved[i], res, cache)

        # ---- composite analytics (draw from the same cache) --------------
        for i, (a, p) in enumerate(zip(resolved, plans)):
            if a.composite:
                ctx = PlanContext(self, p, a, cache)
                payload = a.execute(ctx, **p.param_dict)
                engine_res = payload.pop("__engine__", None)
                results[i] = AnalyticResult(plan=p, engine=engine_res,
                                            output=payload)

        self.last_run_report = {
            "staged_bytes": cache.staged_bytes - base[0],
            "staging_passes": cache.staging_passes - base[1],
            "cache_hits": cache.hits - base[2],
            "resident_bytes": cache.resident_bytes,
            "analytics": [p.analytic for p in plans],
        }
        return results  # type: ignore[return-value]

    def staging_cache_stats(self) -> Optional[Dict[str, Any]]:
        """Cumulative counters of the session-lifetime staging cache
        (``None`` unless the session was built with
        ``staging_cache_bytes=``)."""
        return None if self._staging_cache is None \
            else self._staging_cache.stats()

    # ----------------------------------------------------- streaming ingest
    def refresh(self) -> bool:
        """Observe an append on the backing GoFS collection.  Not ported
        yet (streaming ingestion, ROADMAP item 5)."""
        raise _not_ported("GopherSession.refresh (streaming ingestion)", "5")

    def tail(self, analytic: str, **kw):
        """Incremental analytics over a growing collection.  Not ported
        yet (streaming ingestion, ROADMAP item 5)."""
        raise _not_ported("GopherSession.tail (streaming ingestion)", "5")

    # ------------------------------------------------------------ internals
    def _wrap(self, plan: ExecutionPlan, a: Analytic, res: EngineResult,
              cache: _StagingCache) -> AnalyticResult:
        payload: Dict[str, Any] = {}
        if a.postprocess is not None:
            ctx = PlanContext(self, plan, a, cache)
            payload = a.postprocess(ctx, res, **plan.param_dict)
        return AnalyticResult(plan=plan, engine=res, output=payload)

    def _dispatch_specs(self, engine: TemporalEngine,
                        specs: List[RunSpec],
                        staged: StagedBatch) -> List[EngineResult]:
        if staged.layout == "sparse":
            return engine.run_many(specs, sparse=staged.sp)
        return engine.run_many(specs, tiles=staged.tiles,
                               btiles=staged.btiles)

    def _engine(self, graph: str, comm: str,
                kernel: str = "off") -> TemporalEngine:
        key = (graph, comm, kernel)
        if key not in self._engines:
            # the plan's kernel knob already folded in any session-wide
            # use_pallas override
            self._engines[key] = TemporalEngine(
                self._blocked(graph), device=self.device,
                use_pallas=kernel, comm=comm,
            )
        return self._engines[key]

    def _blocked(self, graph: str) -> BlockedGraph:
        if graph not in self._bg_variants:
            assert graph == "symmetrized", graph
            assert self.src is not None and self.dst is not None, \
                "symmetrized-graph analytics need template src/dst " \
                "(pass src=/dst= to from_blocked)"
            from repro_torch.core.algorithms.components import \
                symmetrized_blocked

            self._bg_variants[graph] = symmetrized_blocked(
                self.bg, self.src, self.dst)
        return self._bg_variants[graph]

    # ---- raw + transformed weights ---------------------------------------
    def _raw(self, attr: str) -> np.ndarray:
        """(I, E) raw edge-attribute matrix (cached per attribute)."""
        key = ("raw", attr)
        if key in self._w_cache:
            return self._w_cache[key]
        if attr == ONES_ATTR:
            w = np.ones((1, self.num_edges), np.float32)
        elif self.store is not None:
            w = self.store.edge_attr_matrix(attr)
        elif self.tsg is not None:
            w = np.stack([
                np.asarray(self.tsg.edge_values(t, attr), np.float32)
                for t in range(self.num_instances)
            ])
        else:
            try:
                w = np.asarray(self._weights[attr], np.float32)
            except KeyError:
                raise KeyError(
                    f"session has no weights for attribute {attr!r}; "
                    f"available: {sorted(self._weights)}") from None
            if w.ndim == 1:
                w = w[None]
        self._w_cache[key] = w
        return w

    def _vertex_attr(self, name: str) -> np.ndarray:
        key = ("vattr", name)
        if key in self._w_cache:
            return self._w_cache[key]
        if self.store is not None:
            v = self.store.vertex_attr_matrix(name)
        elif self.tsg is not None:
            v = np.stack([
                np.asarray(self.tsg.vertex_values(t, name))
                for t in range(self.num_instances)
            ])
        else:
            try:
                v = np.asarray(self._vertex_attrs[name])
            except KeyError:
                raise KeyError(
                    f"session has no vertex attribute {name!r}; "
                    f"available: {sorted(self._vertex_attrs)}") from None
        self._w_cache[key] = v
        return v

    def _staged_weights(self, a: Analytic) -> np.ndarray:
        """The analytic's transformed (I, E') staging weights (cached)."""
        key = ("w", a.graph, a.attr, a.transform_name)
        if key in self._w_cache:
            return self._w_cache[key]
        raw = self._raw(a.attr)
        w = raw if a.weights is None else a.weights(self, raw)
        self._w_cache[key] = w
        return w

    # ---- staging ----------------------------------------------------------
    def _main_key(self, a: Analytic, layout: str) -> Tuple:
        return (a.graph, a.attr, a.transform_name, float(a.zero_fill),
                layout)

    def cache_staged(self, cache: _StagingCache, skey: Tuple,
                     delta: Optional[bool] = None) -> StagedBatch:
        graph, attr, transform, zero, layout = skey

        def maker() -> StagedBatch:
            bg = self._blocked(graph)
            if (self.store is not None and transform == "raw"
                    and graph == "template" and attr != ONES_ATTR):
                out = self.store.load_blocked(bg, attr, zero=zero,
                                              layout=layout, delta=delta)
                if layout == "sparse":
                    # under delta staging the bytes that actually moved
                    # from the store are the deduped payloads, not the
                    # reconstructed batch
                    return StagedBatch(
                        layout=layout, sp=out,
                        nbytes=out.source_bytes
                        if out.source_bytes is not None
                        else out.staged_bytes())
                tiles, btiles = out
                return StagedBatch(layout=layout, tiles=tiles,
                                   btiles=btiles,
                                   nbytes=tiles.nbytes + btiles.nbytes)
            w = self._staged_weights_by_key(graph, attr, transform)
            if layout == "sparse":
                sp = bg.stage_sparse(w, zero=zero)
                return StagedBatch(layout=layout, sp=sp,
                                   nbytes=sp.staged_bytes())
            tiles = bg.fill_local_batch(w, zero=zero)
            btiles = bg.fill_boundary_batch(w, zero=zero)
            return StagedBatch(layout=layout, tiles=tiles, btiles=btiles,
                               nbytes=tiles.nbytes + btiles.nbytes)

        return cache.staged(skey, maker)

    def _staged_weights_by_key(self, graph: str, attr: str,
                               transform: str) -> np.ndarray:
        key = ("w", graph, attr, transform)
        if key in self._w_cache:
            return self._w_cache[key]
        assert transform == "raw", \
            f"transform {transform!r} must be materialized via its analytic"
        return self._raw(attr)

    def _staged(self, cache: _StagingCache, a: Analytic, layout: str,
                delta: Optional[bool] = None) -> StagedBatch:
        self._staged_weights(a)  # materialize the transform into _w_cache
        return self.cache_staged(cache, self._main_key(a, layout),
                                 delta=delta)

    def _staged_ones(self, cache: _StagingCache) -> StagedBatch:
        from repro_torch.core.semiring import INF

        return self.cache_staged(
            cache, ("template", ONES_ATTR, "raw", float(INF), "dense"))

    # ---- planning inputs ---------------------------------------------------
    def _plan_activity(self, a: Analytic):
        """(occupancy, pow2 buckets) for the analytic's main staging —
        from recorded tile maps (stores: no value read) or an in-memory
        activity scan (arrays); (None, None) when unknowable cheaply."""
        key = (a.graph, a.attr, a.transform_name, float(a.zero_fill))
        if key in self._activity_cache:
            return self._activity_cache[key]
        bg = self._blocked(a.graph)
        if self.store is not None:
            if a.weights is None and a.graph == "template":
                occ = self.store.tile_occupancy(bg, a.attr,
                                                zero=a.zero_fill)
                buckets = self.store.sparse_buckets(bg, a.attr,
                                                    zero=a.zero_fill)
            else:
                occ, buckets = None, None  # needs a value read: stay dense
        else:
            w = self._staged_weights(a)
            act_l, act_b = bg.active_tile_maps(w, zero=a.zero_fill)
            denom = w.shape[0] * (int(bg.n_tiles.sum())
                                  + int(bg.n_btiles.sum()))
            occ = (float(int(act_l.sum()) + int(act_b.sum())) / denom
                   if denom else 0.0)
            buckets = (
                pow2_bucket(int(act_l.sum(-1).max()) if act_l.size else 0),
                pow2_bucket(int(act_b.sum(-1).max()) if act_b.size else 0),
            )
        self._activity_cache[key] = (occ, buckets)
        return occ, buckets


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

class _CountedChunks:
    """Pass a stream's chunks through, accounting their staged bytes so
    streamed and cached staging report comparably.  Delta-reconstructed
    chunks report the bytes that actually moved from the store
    (``ch.staged_bytes``, unique payloads only) rather than the
    reconstructed tensors.  ``bind`` reaches the prefetcher underneath,
    so the engine's pinned ring still applies."""

    def __init__(self, stream, cache: _StagingCache):
        self.stream, self.cache = stream, cache

    def bind(self, *args, **kw) -> None:
        self.stream.bind(*args, **kw)

    def __iter__(self):
        it = iter(self.stream)
        try:
            for ch in it:
                n = ch.staged_bytes
                if n is None:
                    n = sum(a.nbytes for a in (ch.tiles, ch.btiles, ch.rows,
                                               ch.cols, ch.brows, ch.bcols)
                            if a is not None)
                self.cache.staged_bytes += int(n)
                yield ch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()  # ends the prefetcher's pass with this one


def _template_of(num_vertices: int, src: np.ndarray, dst: np.ndarray):
    from repro_torch.core.graph import GraphTemplate

    return GraphTemplate(num_vertices=num_vertices, src=src, dst=dst)


def _store_template_arrays(store):
    """Reconstruct (src, dst, partition assignment) in template order from
    the stored topology slices — the session's blocked structure needs no
    regeneration of the original collection (every edge is local XOR
    remote in exactly one subgraph)."""
    V = int(store.meta["num_vertices"])
    E = int(store.meta["num_edges"])
    src = np.full(E, -1, np.int64)
    dst = np.full(E, -1, np.int64)
    assign = np.zeros(V, np.int32)
    for g in store.subgraph_ids():
        topo = store.get_topology(g)
        assign[topo.vertices] = topo.pid
        if len(topo.local_edge_id):
            src[topo.local_edge_id] = topo.vertices[topo.local_src]
            dst[topo.local_edge_id] = topo.vertices[topo.local_dst]
        if len(topo.remote_edge_id):
            src[topo.remote_edge_id] = topo.vertices[topo.remote_src]
            dst[topo.remote_edge_id] = topo.remote_dst_vertex
    assert (src >= 0).all() and (dst >= 0).all(), \
        "store topology does not cover every template edge"
    return src, dst, assign


def _store_block_size(store) -> Optional[int]:
    """Deployment-recorded block size, when any tile map was recorded
    (deterministic: first attribute in sorted order)."""
    for name in sorted(store.meta.get("sparse_absent", {})):
        maps = store.edge_tile_maps(name)
        if maps is not None:
            return int(maps["block_size"])
    return None
