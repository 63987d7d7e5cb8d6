"""Execution planning: turn a declared analytic into costed engine knobs
(counterpart of ``repro.gopher.planner``).

``GopherSession.plan(...)`` produces an :class:`ExecutionPlan` — every
knob the execution machinery exposes (tile layout, comm backend, staging
mode, placement), each resolved either by the caller (``source ==
"override"``) or by the planner's cost models (``source == "auto"``),
with the reasoning and byte estimates attached.  Plans are plain data:
deterministic for a given collection (the planner reads only recorded
metadata — per-pack tile maps, blocked structure, device — never a
value slice), comparable with ``==``, and renderable with
:meth:`ExecutionPlan.explain` before anything executes.

Auto-selection rules (each individually overridable):

==========  ==============================================================
knob        rule
==========  ==============================================================
layout      recorded/measured tile occupancy ``<= 25%`` -> ``sparse``
            (the `BENCH_temporal.json` crossover); above, or unknown
            without reading values -> ``dense`` (always correct)
comm        no mesh -> ``dense`` (the stacked in-process fold; ``"host"``
            targets mesh-free multi-process clusters and stays an
            explicit override); a mesh -> ``recommended_comm`` over the
            exchange axes with the recorded ``boundary_nnz``
            (``repro_torch.launch.mesh``)
staging     store-backed analytics -> ``async`` (slice reads overlap
            execution), including derived weights whose transform is
            declared ``rowwise`` (applied chunk-wise on the prefetch
            pool); in-memory weights, non-row-wise transforms, and
            composite analytics -> ``sync``
delta       store-backed + sparse layout + a recorded delta chain whose
            unique-tile ratio ``< 1`` -> ``True`` (stage each unique
            tile's bytes once per chunk); otherwise ``False`` (full
            tiles cost the same or less to reconstruct)
warm        collection recorded monotone-improving at deploy AND the
            analytic stages with the min-plus zero (+inf) -> ``True``
            (seed instance *t* from *t-1*'s converged fixpoint — exact;
            see docs/ARCHITECTURE.md); plus-mul fixed-iterate or
            non-monotone collections -> ``False`` (cold start)
kernel      session device not ``cuda`` -> ``off`` (the plain PyTorch
            versions: the CPU has no kernels); ``cuda`` + recorded
            occupancy ``<= 25%`` -> ``fused`` (packed active-tile walk:
            the fused superstep kernel does the sweep, the semiring
            combine and the halt vote in one launch); ``cuda``
            otherwise -> ``spmv`` (per-stage SpMV kernel; dense template
            walks gain little from fusing the vote)
placement   no mesh -> stacked (partitions on one device's leading axis);
            a mesh -> ``mesh{dims}`` (partitions over the model axes,
            temporally concurrent patterns' instances over data)
==========  ==============================================================
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

# occupancy at or below which the packed active-tile layout wins (the
# measured crossover regime — see the `sparse` row of BENCH_temporal.json
# and the selection table in docs/ARCHITECTURE.md)
SPARSE_OCCUPANCY_MAX = 0.25


@dataclass(frozen=True)
class PlanChoice:
    """One resolved knob: value + who chose it + why.

    >>> str(PlanChoice("sparse", "auto", "occupancy 12.5% <= 25%"))
    'sparse [auto] occupancy 12.5% <= 25%'
    """

    value: Any
    source: str  # "auto" | "override"
    reason: str

    def __str__(self) -> str:
        return f"{self.value} [{self.source}] {self.reason}"


def choice(value: Any, reason: str) -> PlanChoice:
    return PlanChoice(value, "auto", reason)


def override(value: Any) -> PlanChoice:
    return PlanChoice(value, "override", "caller override")


def _norm_param(v: Any) -> Any:
    """Plan params must compare/render cleanly (and hash, so a plan can
    key a cache): arrays and lists become tuples."""
    if isinstance(v, np.ndarray):
        return tuple(v.tolist())
    if isinstance(v, (list, tuple)):
        return tuple(_norm_param(x) for x in v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    return v


@dataclass(frozen=True)
class ExecutionPlan:
    """A fully resolved, costed execution of one analytic.

    Immutable and deterministic: planning the same analytic against the
    same collection yields an ``==``-equal plan (regression-tested), so a
    plan doubles as a reproducible record of *how* a result was computed
    — :class:`~repro_torch.gopher.session.AnalyticResult` carries it along.
    """

    analytic: str
    pattern: str
    merge: Optional[str]
    params: Tuple[Tuple[str, Any], ...]  # resolved, sorted by name
    graph: str  # "template" | "symmetrized"
    layout: PlanChoice  # "dense" | "sparse"
    comm: PlanChoice  # "dense" | "ring" | "host"
    staging: PlanChoice  # "sync" | "async"
    delta: PlanChoice  # True | False — delta-chain tile staging
    warm: PlanChoice  # True | False — warm-started fixpoints
    kernel: PlanChoice  # "off" | "spmv" | "fused" — kernel mode
    placement: PlanChoice  # "stacked" | mesh descriptor string
    estimates: Tuple[Tuple[str, Any], ...]  # cost-model outputs, sorted

    @property
    def param_dict(self) -> Dict[str, Any]:
        return dict(self.params)

    @property
    def estimate_dict(self) -> Dict[str, Any]:
        return dict(self.estimates)

    def explain(self) -> str:
        """Render the plan: decisions, their provenance, and the cost
        estimates — the paper's 'platform picks the execution' made
        inspectable (``run_graph --explain`` prints exactly this)."""
        est = self.estimate_dict
        lines = [
            f"ExecutionPlan: {self.analytic} (pattern={self.pattern}"
            + (f", merge={self.merge}" if self.merge else "") + ")",
            "  params: " + (", ".join(
                f"{k}={v!r}" for k, v in self.params) or "(none)"),
            f"  graph: {self.graph}"
            + (f" — {est['num_vertices']} vertices, "
               f"{est['n_parts']} partitions x block {est['block_size']}, "
               f"cut {est['boundary_nnz']} published vertices"
               if "num_vertices" in est else ""),
        ]
        for knob in ("layout", "comm", "staging", "delta", "warm",
                     "kernel", "placement"):
            c: PlanChoice = getattr(self, knob)
            lines.append(f"  {knob:<9} = {c.value!s:<8} [{c.source}] "
                         f"{c.reason}")
        byte_lines = []
        if "staged_bytes_dense" in est:
            s = f"    staged bytes: dense {est['staged_bytes_dense']:,}"
            if est.get("staged_bytes_sparse") is not None:
                s += (f" | sparse ~{est['staged_bytes_sparse']:,} "
                      f"(occupancy {est['occupancy']:.1%})")
            elif est.get("occupancy") is not None:
                s += f" (occupancy {est['occupancy']:.1%})"
            else:
                s += " (activity unknown without reading values)"
            byte_lines.append(s)
        if est.get("source_bytes_delta") is not None:
            byte_lines.append(
                f"    delta staging: ~{est['source_bytes_delta']:,} B "
                f"from store (unique-tile ratio "
                f"{est['delta_unique_ratio']:.1%} of "
                f"{est['staged_bytes_sparse'] or est['staged_bytes_dense']:,}"
                f" B reconstructed)")
        if est.get("n_sources", 1) > 1:
            byte_lines.append(
                f"    query axis: {est['n_sources']} sources batched into "
                f"one ({est['n_sources']}, P, Vp) state pass — "
                f"{est['state_bytes']:,} B of state, staged tiles shared")
        if self.warm.value:
            byte_lines.append(
                "    warm start: instance t seeds from t-1's converged "
                "fixpoint — supersteps shrink toward the per-instance "
                "change radius (collection recorded monotone-improving; "
                "exact for min-plus)")
        if "exchange_bytes_per_device" in est:
            byte_lines.append(
                f"    boundary exchange/superstep: "
                f"{est['exchange_kind']} moves "
                f"{est['exchange_bytes_per_device']:,.0f} B/device in "
                f"{est['exchange_hops']} hop(s) "
                f"({est['n_parts']} partitions, "
                f"{est['boundary_nnz']} published vertices)")
        if "mesh_split_data" in est:
            byte_lines.append(
                f"    mesh proposal: {est['mesh_split_devices']} device(s) "
                f"-> data {est['mesh_split_data']} x model "
                f"{est['mesh_split_model']} — {est['mesh_split_why']}")
        if byte_lines:
            lines.append("  estimates:")
            lines.extend(byte_lines)
        return "\n".join(lines)


def extend_plan(plan: ExecutionPlan, num_instances: int) -> ExecutionPlan:
    """Extend a plan to a grown collection without replanning.

    Appends only lengthen the instance axis — the blocked structure,
    cut, and layout/comm/placement decisions are append-invariant, so a
    held plan stays valid; only the instance-count-proportional byte
    estimates change.  Returns a plan ``==``-identical except for those
    estimates (knob provenance intact).  NOT a substitute for replanning
    when a data-dependent choice could flip (an append can break the
    recorded monotone-improving property and with it the auto ``warm``
    choice — the session's tail path replans for exactly that reason);
    use it where the knobs are pinned and only the scale moved."""
    import dataclasses

    est = dict(plan.estimate_dict)
    old_n = int(est.get("num_instances") or 0)
    if old_n == int(num_instances) or old_n <= 0:
        return plan
    for k in ("staged_bytes_dense", "staged_bytes_sparse",
              "source_bytes_delta"):
        v = est.get(k)
        if v is not None:
            est[k] = (int(v) // old_n) * int(num_instances)
    est["num_instances"] = int(num_instances)
    return dataclasses.replace(plan,
                               estimates=tuple(sorted(est.items())))


def propose_mesh_split(
    num_devices: int,
    num_instances: int,
    n_parts: int,
    pattern: str,
    *,
    num_boundary: int,
    boundary_nnz: int,
    comm: str = "dense",
) -> Dict[str, Any]:
    """Propose how ``num_devices`` should split between the instance
    (data) and partition (model) mesh axes.

    The paper exposes BOTH parallelism axes — timesteps and subgraphs —
    and the split decides what each superstep pays: partitions sharded
    ``m``-way exchange their boundary every superstep
    (``boundary_exchange_bytes``), while instances sharded ``d``-way are
    temporally concurrent and exchange NOTHING (independent/eventually
    patterns never communicate across instances).  So the proposal gives
    the data axis every device that divisibility allows and prices the
    remaining partition split:

    * enumerate the divisor splits ``d * m == num_devices`` where ``m``
      divides the partition count and (for ``d > 1``) the pattern is
      temporally concurrent and ``d`` divides the instance count;
    * score each by per-device exchange volume over the whole pass,
      ``ceil(I / d) * bytes_per_device(m)`` — the term the data axis
      amortizes and the model axis inflates;
    * ties (e.g. a zero-exchange single-partition-group) break toward
      fewer model shards.

    ``sequential`` chains instances, so the data axis is off the table
    and the proposal is all-model.  Returns ``{"data", "model",
    "exchange_bytes_per_device", "why"}``; callers embed it in plan
    estimates (``explain()`` renders it).

    >>> p = propose_mesh_split(8, 16, 8, "independent",
    ...                        num_boundary=128, boundary_nnz=64)
    >>> (p["data"], p["model"])
    (8, 1)
    >>> p = propose_mesh_split(8, 16, 8, "sequential",
    ...                        num_boundary=128, boundary_nnz=64)
    >>> (p["data"], p["model"])
    (1, 8)
    """
    from repro_torch.dist.collectives import boundary_exchange_bytes

    D = max(1, int(num_devices))
    temporal = pattern in ("independent", "eventually")
    best = None
    for m in range(1, D + 1):
        if D % m or m > n_parts or n_parts % m:
            continue
        d = D // m
        if d > 1 and not (temporal and num_instances % d == 0
                          and num_instances >= d):
            continue
        ex = boundary_exchange_bytes(num_boundary, m, comm,
                                     boundary_nnz=boundary_nnz)
        cost = -(-num_instances // d) * float(ex["bytes_per_device"])
        if best is None or (cost, m) < (best[0], best[2]):
            best = (cost, d, m, ex)
    if best is None:
        # nothing divides: stack everything (the engine replicates
        # instances when the axis does not divide — correct, no speedup)
        return {
            "data": 1, "model": 1, "exchange_bytes_per_device": 0.0,
            "why": f"no divisor split of {D} device(s) fits "
                   f"{n_parts} partitions x {num_instances} instances — "
                   f"run stacked/replicated",
        }
    cost, d, m, ex = best
    if not temporal:
        why = (f"{pattern} chains instances (no data axis); all {m} "
               f"device(s) shard partitions, exchanging "
               f"~{ex['bytes_per_device']:,.0f} B/device/superstep")
    elif m == 1:
        why = (f"temporal pattern pays no cross-instance exchange — "
               f"{d} instance shard(s) take every device; single "
               f"partition group exchanges nothing off-device")
    else:
        why = (f"{d} instance shard(s) x {m} partition shard(s): data "
               f"axis takes what divides I={num_instances}, remaining "
               f"{m}-way partition split moves "
               f"~{ex['bytes_per_device']:,.0f} B/device/superstep")
    return {
        "data": int(d), "model": int(m),
        "exchange_bytes_per_device": float(ex["bytes_per_device"]),
        "why": why,
    }


def plan_analytic(
    analytic,
    resolved_params: Dict[str, Any],
    *,
    bg,
    mesh=None,
    model_axes: Tuple[str, ...] = ("model",),
    store_backed: bool,
    occupancy: Optional[float],
    sparse_buckets: Optional[Tuple[int, int]],
    num_instances: int,
    delta_ratio: Optional[float] = None,
    delta_monotone: Optional[bool] = None,
    zero_fill: Optional[float] = None,
    pattern: Optional[str] = None,
    merge: Optional[str] = None,
    layout: Optional[str] = None,
    comm: Optional[str] = None,
    staging: Optional[str] = None,
    delta: Optional[bool] = None,
    warm: Optional[bool] = None,
    kernel: Optional[str] = None,
    device: Optional[str] = None,
) -> ExecutionPlan:
    """Resolve every knob for one analytic (see module docstring rules).

    ``occupancy``/``sparse_buckets`` come from recorded tile maps or an
    in-memory activity scan — ``None`` means unknown without reading
    values, which the planner treats as 'stay dense'.  ``delta_ratio``/
    ``delta_monotone`` are the deploy-time delta-chain stats
    (``GoFSStore.delta_stats``): unique-tile fraction across the
    collection and whether consecutive instances only ever tighten
    weights — ``None`` when no delta chain was recorded.

    ``device`` — the device type the session runs on (``"cuda"`` or
    ``"cpu"``); it drives the ``kernel`` knob's auto rule and, off a
    mesh, the device count behind the mesh-split estimates.  ``None`` is
    treated as not CUDA (kernel off).  ``mesh`` — a DeviceMesh: its dims
    give the placement and the device count of the split review."""
    from repro_torch.dist.collectives import boundary_exchange_bytes
    from repro_torch.launch.mesh import recommended_comm

    pattern = pattern or analytic.pattern
    assert pattern in ("sequential", "independent", "eventually"), pattern
    merge = merge if merge is not None else analytic.merge
    if merge is not None and pattern != "eventually":
        raise ValueError(
            f"merge={merge!r} is the eventually-dependent Merge; "
            f"pattern {pattern!r} has none")

    # ---- layout ----------------------------------------------------------
    if layout is not None:
        lay = override(layout)
    elif occupancy is None:
        lay = choice("dense", "tile activity unknown without reading "
                              "values — dense is always correct")
    elif occupancy <= SPARSE_OCCUPANCY_MAX:
        lay = choice("sparse",
                     f"recorded tile occupancy {occupancy:.1%} <= "
                     f"{SPARSE_OCCUPANCY_MAX:.0%} — packed active tiles "
                     f"cut staged bytes and SpMV work")
    else:
        lay = choice("dense",
                     f"recorded tile occupancy {occupancy:.1%} > "
                     f"{SPARSE_OCCUPANCY_MAX:.0%} — packing would buy "
                     f"little over template tiles")

    # ---- comm ------------------------------------------------------------
    nnz = int(bg.boundary_nnz)
    if comm is not None:
        cm = override(comm)
    elif mesh is None:
        cm = choice("dense", "stacked in-process fold (no mesh; 'host' "
                             "targets mesh-free multi-process clusters)")
    else:
        rec = recommended_comm(mesh, model_axes, boundary_nnz=nnz)
        cm = choice(rec,
                    f"recommended_comm over exchange axes {model_axes} "
                    f"with boundary_nnz={nnz}")

    # ---- staging ---------------------------------------------------------
    if staging is not None:
        st = override(staging)
    elif not store_backed:
        st = choice("sync", "weights already in memory — nothing to "
                            "overlap but the tile fill")
    elif analytic.composite:
        st = choice("sync", "composite analytic re-reads its staged "
                            "tiles across runs — staged once via the "
                            "shared cache")
    elif analytic.weights is not None and not analytic.rowwise:
        st = choice("sync", f"derived weights ({analytic.transform_name}) "
                            f"need the full attribute matrix before "
                            f"staging")
    elif analytic.weights is not None:
        st = choice("async", f"row-wise transform "
                             f"({analytic.transform_name}) applies "
                             f"chunk-by-chunk on the prefetch pool — "
                             f"slice reads + derived fills overlap "
                             f"execution")
    else:
        st = choice("async", "streaming from the GoFS store — slice "
                             "reads + fills overlap execution")

    # ---- delta -----------------------------------------------------------
    # delta reconstruction only pays off on the packed layout (the tile
    # index IS the dedupe unit) when the recorded chain shows real
    # temporal redundancy; derived-weight transforms see a synthesized
    # matrix the chain does not describe
    delta_ok = (store_backed and lay.value == "sparse"
                and analytic.weights is None)
    if delta is not None:
        dl = override(bool(delta))
    elif not delta_ok:
        dl = choice(False,
                    "delta chain needs a store-backed sparse staging of "
                    "the raw attribute"
                    if not (store_backed and analytic.weights is None)
                    else "dense layout restages template tiles — no "
                         "packed index to dedupe against")
    elif delta_ratio is None:
        dl = choice(False, "no delta chain recorded at deploy")
    elif delta_ratio < 1.0:
        dl = choice(True,
                    f"recorded unique-tile ratio {delta_ratio:.1%} — "
                    f"unchanged tiles stage once per chunk")
    else:
        dl = choice(False,
                    f"recorded unique-tile ratio {delta_ratio:.1%} — "
                    f"every tile changes every instance; nothing to dedupe")

    # ---- warm ------------------------------------------------------------
    # exact only for monotone fixpoints (min-plus, zero_fill=+inf) on
    # collections recorded monotone-improving at deploy; the engine
    # additionally cold-starts iterate programs at run time
    from repro_torch.core.semiring import INF

    warm_ok = (store_backed and delta_monotone is not None
               and zero_fill is not None and zero_fill == INF)
    if warm is not None:
        wm = override(bool(warm))
    elif not warm_ok:
        if zero_fill is not None and zero_fill != INF:
            wm = choice(False, "warm seeding is exact only for min-plus "
                               "fixpoints (zero_fill=+inf); this staging "
                               "is not")
        else:
            wm = choice(False, "no monotonicity record for this "
                               "attribute — cold start is the only "
                               "provably exact seed")
    elif delta_monotone:
        wm = choice(True, "collection recorded monotone-improving at "
                          "deploy — warm min-plus seeds converge to the "
                          "identical fixpoint in fewer supersteps")
    else:
        wm = choice(False, "weights increase somewhere in the chain — a "
                           "warm min-plus seed could lock in a stale "
                           "shorter path")

    # ---- kernel ----------------------------------------------------------
    from repro_torch.core.superstep import KERNEL_MODES

    if kernel is not None:
        assert kernel in KERNEL_MODES, \
            f"kernel={kernel!r}; pick from {KERNEL_MODES}"
        kn = override(kernel)
    elif device != "cuda":
        kn = choice("off", f"device {device or 'unknown'!s} != cuda — "
                           f"the plain PyTorch versions; the CPU has no "
                           f"kernels")
    elif occupancy is not None and occupancy <= SPARSE_OCCUPANCY_MAX:
        kn = choice("fused",
                    f"cuda + recorded occupancy {occupancy:.1%} <= "
                    f"{SPARSE_OCCUPANCY_MAX:.0%} — the fused superstep "
                    f"kernel walks the packed active tiles and votes to "
                    f"halt in the same launch")
    else:
        kn = choice("spmv",
                    "cuda, dense-regime tiles — per-stage SpMV kernel; "
                    "template walks gain little from fusing the vote")

    # ---- placement -------------------------------------------------------
    if mesh is None:
        pl = choice("stacked", "no mesh — partitions stacked on one "
                               "device, instances scanned")
    else:
        from repro_torch.core.comm import mesh_dims

        shape = mesh_dims(mesh)
        pl = choice(f"mesh{shape}",
                    f"partitions over {model_axes}; temporally concurrent "
                    f"patterns shard instances over the data axis")

    # ---- estimates -------------------------------------------------------
    # query axis: a sequence on the analytic's source parameter widens the
    # semiring state to (Q, P, Vp) — Q requests in one engine pass whose
    # staged tiles are shared (priced once), only the state scales with Q
    n_sources = 1
    if analytic.source_axis is not None:
        sv = resolved_params.get(analytic.source_axis)
        if isinstance(sv, (list, tuple, np.ndarray)):
            n_sources = int(len(sv))
    B = bg.block_size
    dense_bytes = int(num_instances * bg.n_parts
                      * (bg.t_max + bg.tb_max) * B * B * 4)
    sparse_bytes = None
    if sparse_buckets is not None:
        kb, kbb = sparse_buckets
        sparse_bytes = int(num_instances * bg.n_parts
                           * ((kb + kbb) * (B * B * 4 + 8)))
    ex = boundary_exchange_bytes(bg.num_boundary, bg.n_parts, cm.value,
                                 boundary_nnz=nnz)
    source_bytes_delta = None
    if dl.value and delta_ratio is not None:
        # store -> host traffic under delta staging: each unique tile's
        # payload once, priced against the reconstructed sparse batch
        base = sparse_bytes if sparse_bytes is not None else dense_bytes
        source_bytes_delta = int(round(base * delta_ratio))
    # mesh-shape proposal: how the available device pool SHOULD split
    # between the instance (data) and partition (model) axes — advisory
    # when no mesh was given, a review of the split when one was
    if mesh is not None:
        num_devices = 1
        for n in shape.values():
            num_devices *= int(n)
    elif device == "cuda":
        import torch

        num_devices = torch.cuda.device_count()
    else:
        num_devices = 1
    split = propose_mesh_split(
        num_devices, num_instances, bg.n_parts, pattern,
        num_boundary=bg.num_boundary, boundary_nnz=nnz, comm=cm.value)
    estimates = {
        "num_vertices": int(len(bg.part_of)),
        "num_instances": int(num_instances),
        "n_sources": n_sources,
        "state_bytes": int(n_sources * bg.n_parts
                           * bg.global_of.shape[1] * 4),
        "n_parts": int(bg.n_parts),
        "block_size": int(B),
        "boundary_nnz": nnz,
        "occupancy": occupancy,
        "staged_bytes_dense": dense_bytes,
        "staged_bytes_sparse": sparse_bytes,
        "delta_unique_ratio": delta_ratio,
        "source_bytes_delta": source_bytes_delta,
        "exchange_kind": ex["kind"],
        "exchange_hops": int(ex["hops"]),
        "exchange_bytes_per_device": float(ex["bytes_per_device"]),
        "mesh_split_devices": int(num_devices),
        "mesh_split_data": split["data"],
        "mesh_split_model": split["model"],
        "mesh_split_why": split["why"],
    }
    return ExecutionPlan(
        analytic=analytic.name,
        pattern=pattern,
        merge=merge,
        params=tuple(sorted(
            (k, _norm_param(v)) for k, v in resolved_params.items()
        )),
        graph=analytic.graph,
        layout=lay,
        comm=cm,
        staging=st,
        delta=dl,
        warm=wm,
        kernel=kn,
        placement=pl,
        estimates=tuple(sorted(estimates.items())),
    )
