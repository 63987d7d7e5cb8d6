"""Unified temporal execution engine, stacked on one device (paper §IV-B).

Counterpart of ``repro.core.engine``: an algorithm is declared as a
:class:`SemiringProgram` — a semiring plus either a *fixpoint* spec
(idempotent relaxation to quiescence: SSSP, components, reachability) or
an *iterate* spec (a fixed-count superstep function: PageRank) — and the
engine executes it under any of the paper's three patterns:

========================  =================================================
pattern                   execution
========================  =================================================
``sequential``            a loop over the instance axis carrying the vertex
                          state (incremental aggregation — the previous
                          timestep's end state seeds the next)
``independent``           every instance runs from the same initial state
``eventually``            independent + a Merge reduction across instances
                          (``merge="mean"`` on the device; ``None`` leaves
                          the per-instance states for a host-side Merge)
========================  =================================================

All partitions sit on the leading axis of one device's tensors and every
kernel launch covers all of them.  The boundary exchange is one combine
per superstep through a stacked comm backend (``repro_torch.core.comm``).

Staging is batched and layout-aware: ``layout="dense"`` fills every
template tile slot per instance into (I, P, T, B, B) tensors;
``layout="sparse"`` packs only each instance's ACTIVE tiles into
pow2-bucket tensors plus a per-instance tile index
(:class:`repro_torch.core.blocked.SparseBlocked`).  Results are identical
(bitwise for min-plus) because skipped tiles contribute exact semiring
zeros.

Staging can also be *overlapped* with execution (``staging="async"`` or an
explicit ``stream=``): chunks of instances arrive from a
:class:`repro_torch.gofs.prefetch.SlicePrefetcher` while the device
executes the previous chunk — the paper's §V storage/compute overlap.  On
CUDA each chunk is filled into pinned host memory and copied to the card
on a side stream; the compute stream waits on the copy's event.

Not ported yet, and raising ``NotImplementedError`` that names the ROADMAP
item: the query axis (``x0`` of rank 3), ``mesh=`` and ``cluster=``.

Stats are reported in the same :class:`repro_torch.core.ibsp.BSPStats`
shape as the host engine, plus the device-to-host reads the halt votes
took (``stats["host_syncs"]``).
"""
from __future__ import annotations

import time
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.blocked import BlockedGraph, SparseBlocked
from repro_torch.core.comm import CommBackend, make_comm
from repro_torch.core.ibsp import BSPStats
from repro_torch.core.semiring import INF, MIN_PLUS, PLUS_MUL, Semiring
from repro_torch.core.superstep import (
    DeviceGraph,
    bsp_fixpoint,
    graph_plans,
    kernel_mode,
    pagerank_step,
    resolve_device,
)
from repro_torch.kernels.walk_plan import WalkPlan, to_device

PATTERNS = ("sequential", "independent", "eventually")

# staged-batch device cache entries kept per engine (LRU); each entry is one
# staged instance collection, so a handful covers any run_many working set
_STAGED_CACHE_SLOTS = 4


def _device_put(x, device: torch.device) -> torch.Tensor:
    """Host buffer -> device tensor.  Cached staged-value uploads route
    through this seam so tests can count them."""
    return torch.as_tensor(x, device=device)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item {item})")


# ---------------------------------------------------------------------------
# Program declarations
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class SemiringProgram:
    """A blocked iBSP analytic: semiring + step semantics + init.

    ``kind="fixpoint"`` iterates BSP supersteps to global quiescence
    (requires an idempotent semiring).  ``kind="iterate"`` applies ``step``
    exactly ``iters`` times.

    >>> from repro_torch.core.engine import min_plus_program, pagerank_program
    >>> min_plus_program("sssp").kind          # idempotent -> fixpoint
    'fixpoint'
    >>> pagerank_program(100, iters=5).iters   # non-idempotent -> iterate
    5
    """

    name: str
    semiring: Semiring
    zero_fill: float  # tile value for absent edges (sr.zero of the fill op)
    kind: str = "fixpoint"  # "fixpoint" | "iterate"
    # fixpoint knobs
    subgraph_centric: bool = True
    max_supersteps: int = 64
    max_local_sweeps: int = 1024
    # iterate knobs
    iters: int = 0
    # step(x, dg, comm, use_pallas) -> x  (iterate kind only)
    step: Optional[Callable] = None
    # host-side initial state: init(bg) -> (P, Vp) float32
    init: Optional[Callable[[BlockedGraph], np.ndarray]] = None

    def __post_init__(self):
        assert self.kind in ("fixpoint", "iterate"), self.kind
        if self.kind == "fixpoint":
            assert self.semiring.idempotent, \
                "fixpoint programs need an idempotent semiring"
        else:
            assert self.step is not None and self.iters > 0


def source_init(source_vertex: int, pad: float = INF):
    """x0 = pad everywhere, 0 at the source (SSSP-style frontier seed)."""

    def init(bg: BlockedGraph) -> np.ndarray:
        x0 = bg.scatter_vertex(np.full(bg.part_of.shape, pad, np.float32), pad)
        x0[bg.part_of[source_vertex], bg.local_of[source_vertex]] = 0.0
        return x0

    return init


def label_init():
    """x0 = own vertex id (label propagation / components seed)."""

    def init(bg: BlockedGraph) -> np.ndarray:
        V = len(bg.part_of)
        return bg.scatter_vertex(np.arange(V, dtype=np.float32), INF)

    return init


def min_plus_program(
    name: str = "min_plus_fixpoint",
    *,
    init: Optional[Callable] = None,
    subgraph_centric: bool = True,
    max_supersteps: int = 64,
    max_local_sweeps: int = 1024,
) -> SemiringProgram:
    """Min-plus fixpoint (SSSP / reachability / label propagation)."""
    return SemiringProgram(
        name=name, semiring=MIN_PLUS, zero_fill=INF, kind="fixpoint",
        subgraph_centric=subgraph_centric, max_supersteps=max_supersteps,
        max_local_sweeps=max_local_sweeps, init=init,
    )


def pagerank_program(
    num_vertices: int, *, damping: float = 0.85, iters: int = 30
) -> SemiringProgram:
    """Fixed-iteration plus-mul PageRank (independent pattern workload)."""

    def step(x, dg, comm, use_pallas):
        return pagerank_step(
            x, dg, comm, damping=damping, num_vertices=num_vertices,
            use_pallas=use_pallas,
        )

    def init(bg: BlockedGraph) -> np.ndarray:
        valid = (bg.global_of >= 0)
        return np.where(valid, 1.0 / num_vertices, 0.0).astype(np.float32)

    return SemiringProgram(
        name="pagerank", semiring=PLUS_MUL, zero_fill=0.0, kind="iterate",
        iters=iters, step=step, init=init,
    )


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclass
class EngineResult:
    """Gathered outputs + iBSP-comparable statistics."""

    pattern: str
    values: np.ndarray  # (I, V) per-instance vertex values (global order)
    final: np.ndarray  # (V,) carried end state (sequential) or values[-1]
    merged: Optional[np.ndarray]  # (V,) Merge output (eventually + on-device)
    # {"supersteps": (I,), "local_sweeps": (I,), "host_syncs": (I,)} int32
    stats: Dict[str, np.ndarray]
    occupancy: Optional[float] = None  # active-tile fraction (sparse layout)
    warm_start: bool = False  # fixpoints seeded from the previous instance
    _n_published: int = 0  # boundary vertices published per superstep
    _n_parts: int = 0
    _num_vertices: int = 0

    def supersteps_saved(self) -> Optional[np.ndarray]:
        """Per-instance supersteps the warm seed saved, relative to the
        cold-seeded FIRST instance.  ``None`` unless the run was
        warm-started."""
        if not self.warm_start:
            return None
        ss = self.stats["supersteps"]
        return np.maximum(0, ss[..., :1].astype(np.int64) - ss.astype(np.int64))

    def bsp_stats(self) -> BSPStats:
        """The host engine's accounting shape: compute_calls = partition
        activations, superstep_messages = published boundary values,
        timestep_messages = carried vertex states (sequential),
        merge_messages = instances folded."""
        ss = int(np.sum(self.stats["supersteps"]))
        I = int(self.stats["supersteps"].shape[-1])
        return BSPStats(
            supersteps=ss,
            compute_calls=ss * self._n_parts,
            superstep_messages=ss * self._n_published,
            timestep_messages=(I - 1) * self._num_vertices
            if self.pattern == "sequential" else 0,
            merge_messages=I if self.pattern == "eventually" else 0,
        )


@dataclass(frozen=True)
class RunSpec:
    """One analytic execution inside a shared-staging ``run_many`` pass.

    Every spec in a pass executes over the SAME staged instance batch, so
    the programs must agree on ``zero_fill`` — the one property of the
    staged values an analytic can observe."""

    program: SemiringProgram
    pattern: str
    x0: Optional[np.ndarray] = None  # overrides program.init(bg)
    merge: Optional[str] = None
    # seed instance t's fixpoint from instance t-1's converged state
    # instead of x0 (incremental recompute).  EXACT for monotone semirings
    # on monotone-improving collections; fixed-iterate programs (plus-mul
    # PageRank) fall back to a cold start, where the seed would change the
    # result.  No-op for the sequential pattern.
    warm_start: bool = False

    def effective_warm(self) -> bool:
        """Warm seeding actually applies: requested AND the program is a
        fixpoint."""
        return self.warm_start and self.program.kind == "fixpoint"


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class TemporalEngine:
    """Pattern-aware runner for semiring programs over one blocked graph.

    **Pattern contracts** (paper §IV-B):

    * ``sequential`` — *incrementally aggregated*: instance ``t``'s end
      state seeds instance ``t + 1``; ``final`` is the last carried state.
    * ``independent`` — every instance starts from the same ``x0``.
    * ``eventually`` — independent execution plus a Merge fold across
      instances (``merge="mean"`` computes it on the device into
      ``merged``).

    **Device**: ``device="cuda"`` (the default) runs the CUDA kernels and
    raises when there is no card; ``device="cpu"`` runs every kernel's
    plain PyTorch version.  ``use_pallas`` keeps the reference's knob name
    and picks the kernel mode (``"spmv"`` | ``"fused"``, and ``"off"`` on
    the CPU only; ``None`` = ``"spmv"`` on CUDA).

    **Comm backend**: ``"dense"`` (device fold), ``"ring"``/``"ring-rs"``
    (the same fold, stacked) or ``"host"`` (numpy fold on the host) —
    bitwise identical for both semirings.

    **Layout**: ``"dense"`` stages (I, P, T, B, B) tiles; ``"sparse"``
    packs each instance's active tiles (``result.occupancy`` reports the
    measured active fraction).  Pre-staged ``tiles=``/``btiles=`` or
    ``sparse=`` choose the layout for one call.

    **Staging**: ``"sync"`` fills the whole batch before running;
    ``"async"`` cuts it into chunks of ``chunk_instances`` (default
    ``ceil(I / 4)``) that a background prefetcher of ``prefetch_depth``
    fills while the device runs the previous chunk.  ``stream=`` runs an
    iterable of ``StagedChunk`` (``GoFSStore.load_blocked_stream``).  All
    staging modes are result-identical (bitwise for min-plus);
    ``last_stream_report`` records a streamed run's chunks and uploaded
    bytes, the host seconds spent waiting for chunks and issuing their
    uploads, and the seconds spent computing them (CUDA events on the
    card, the host clock on the CPU).

    Example — one tiny graph, all three patterns:

    >>> import numpy as np
    >>> from repro_torch.core.blocked import build_blocked
    >>> from repro_torch.core.graph import GraphTemplate
    >>> from repro_torch.core.engine import (
    ...     TemporalEngine, min_plus_program, source_init)
    >>> tmpl = GraphTemplate(num_vertices=4,
    ...     src=np.array([0, 1, 2, 0]), dst=np.array([1, 2, 3, 2]))
    >>> bg = build_blocked(tmpl, np.array([0, 0, 1, 1]), block_size=2)
    >>> eng = TemporalEngine(bg, device="cpu")
    >>> sssp = min_plus_program("sssp", init=source_init(0))
    >>> w = np.ones((2, 4), np.float32)     # 2 instances, unit latency
    >>> eng.run(sssp, w, pattern="sequential").final
    array([0., 1., 1., 2.], dtype=float32)
    >>> eng.run(sssp, w, pattern="independent").values.shape
    (2, 4)
    >>> eng.run(sssp, w, pattern="eventually", merge="mean").merged
    array([0., 1., 1., 2.], dtype=float32)
    >>> eng_async = TemporalEngine(bg, device="cpu", staging="async")
    >>> bool(np.array_equal(eng_async.run(sssp, w, pattern="sequential").final,
    ...                     eng.run(sssp, w, pattern="sequential").final))
    True
    >>> eng_host = TemporalEngine(bg, device="cpu", comm="host")
    >>> bool(np.array_equal(eng_host.run(sssp, w, pattern="sequential").final,
    ...                     eng.run(sssp, w, pattern="sequential").final))
    True
    >>> eng_sp = TemporalEngine(bg, device="cpu", layout="sparse")
    >>> r_sp = eng_sp.run(sssp, w, pattern="sequential")
    >>> bool(np.array_equal(r_sp.final, eng.run(sssp, w,
    ...                                         pattern="sequential").final))
    True
    >>> 0.0 < r_sp.occupancy <= 1.0  # measured active-tile fraction
    True
    """

    def __init__(
        self,
        bg: BlockedGraph,
        *,
        device="cuda",
        mesh=None,
        use_pallas=None,
        staging: str = "sync",
        prefetch_depth: int = 2,
        chunk_instances: Optional[int] = None,
        comm: Union[str, CommBackend] = "dense",
        layout: str = "dense",
        cluster=None,
    ):
        if mesh is not None:
            raise _not_ported("mesh placement", "6")
        if cluster is not None:
            raise _not_ported("cluster placement", "7")
        assert staging in ("sync", "async"), staging
        assert layout in ("dense", "sparse"), layout
        self.bg = bg
        self.device = resolve_device(device)
        self.kernel_mode = kernel_mode(use_pallas, self.device)
        self.staging = staging
        self.prefetch_depth = prefetch_depth
        self.chunk_instances = chunk_instances
        self.layout = layout
        self.comm = make_comm(comm)
        self._copy_stream = None  # side stream of streamed uploads (CUDA)
        self.last_stream_report: Optional[Dict[str, Any]] = None
        out_mask = np.arange(bg.o_max)[None, :] < bg.n_out[:, None]

        def put(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

        # template tile index (rows, cols, brows, bcols) — replaced per
        # instance by the packed index in the sparse layout — and the
        # layout-independent tail shared by both layouts
        self._index = (
            put(bg.tiles_rc[:, :, 0]), put(bg.tiles_rc[:, :, 1]),
            put(bg.btiles_rc[:, :, 0]), put(bg.btiles_rc[:, :, 1]),
        )
        self._tail = (put(bg.out_slot), put(bg.out_local), put(out_mask),
                      put(bg.global_of >= 0))
        # the kernels' walk plans of the template index, built once; the
        # sparse layout walks the plans staged with each packed batch
        self._plans = graph_plans(bg, self.device)
        # staged-batch device cache: host-array identity (weakly held) ->
        # device tensors, so repeated runs over one staged batch upload
        # once without extending the batch's lifetime
        self._staged_device: "OrderedDict[Tuple[int, ...], Tuple[Tuple[weakref.ref, ...], Tuple[Any, ...]]]" = OrderedDict()

    # ------------------------------------------------------------ staging
    def stage(
        self, instance_weights: np.ndarray, zero_fill: float
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(I, E) edge weights -> device tile tensors, batched scatter."""
        w = np.asarray(instance_weights, np.float32)
        if w.ndim == 1:
            w = w[None]
        return (
            torch.as_tensor(self.bg.fill_local_batch(w, zero=zero_fill),
                            device=self.device),
            torch.as_tensor(self.bg.fill_boundary_batch(w, zero=zero_fill),
                            device=self.device),
        )

    def stage_sparse(
        self, instance_weights: np.ndarray, zero_fill: float
    ) -> SparseBlocked:
        """(I, E) edge weights -> packed active-tile batch (host arrays)."""
        return self.bg.stage_sparse(instance_weights, zero=zero_fill)

    # ------------------------------------------------------- instance step
    def _device_graph(self, tiles_l, btiles_l, index,
                      plans=None) -> DeviceGraph:
        rows, cols, brows, bcols = index
        out_slot, out_local, out_mask, vmask = self._tail
        return DeviceGraph(
            block_size=self.bg.block_size, num_boundary=self.bg.num_boundary,
            rows=rows, cols=cols, tiles=tiles_l,
            brows=brows, bcols=bcols, btiles=btiles_l,
            out_slot=out_slot, out_local=out_local,
            out_mask=out_mask, vmask=vmask,
            **(self._plans if plans is None else plans),
        )

    def _run_instance(self, program: SemiringProgram, x, dg: DeviceGraph):
        """One instance's BSP.  Returns (x, supersteps, sweeps, syncs)."""
        if program.kind == "fixpoint":
            x, st = bsp_fixpoint(
                x, dg, program.semiring, comm=self.comm,
                subgraph_centric=program.subgraph_centric,
                max_supersteps=program.max_supersteps,
                max_local_sweeps=program.max_local_sweeps,
                use_pallas=self.kernel_mode,
            )
            return (x, st["supersteps"], st["local_sweeps"],
                    st["host_syncs"])
        for _ in range(program.iters):
            x = program.step(x, dg, self.comm, self.kernel_mode)
        return x, program.iters, 0, 0

    def _scan_instances(self, program: SemiringProgram, pattern: str,
                        merge: Optional[str], x0: torch.Tensor,
                        tiles: torch.Tensor, btiles: torch.Tensor,
                        idx=None, plans=None, warm: bool = False):
        """Loop over the instance axis.  Returns (xs (I, P, Vp), final,
        merged, stats).

        ``idx=None`` (dense): every instance walks the template tile index
        and its plans.  Sparse: ``idx`` is the per-instance (rows, cols,
        brows, bcols) packed index, walked alongside the tile values, and
        ``plans`` the per-instance walk plans (leading instance axis).
        ``warm=True`` seeds each instance's fixpoint from the previous
        instance's converged state rather than ``x0``."""
        n = int(tiles.shape[0])
        xs = torch.empty((n,) + tuple(x0.shape), dtype=x0.dtype,
                         device=x0.device)
        counts = np.zeros((3, n), np.int32)
        carry = x0
        for i in range(n):
            index = self._index if idx is None else tuple(a[i] for a in idx)
            plans_i = None if plans is None else {
                k: v.select(i) for k, v in plans.items()}
            dg = self._device_graph(tiles[i], btiles[i], index, plans_i)
            seed = carry if (pattern == "sequential" or warm) else x0
            x, ss, lsw, syncs = self._run_instance(program, seed, dg)
            counts[:, i] = (ss, lsw, syncs)
            xs[i] = x
            carry = x
        if pattern == "eventually" and merge == "mean":
            merged = torch.mean(xs, dim=0)
        else:
            merged = None
        stats = {"supersteps": counts[0], "local_sweeps": counts[1],
                 "host_syncs": counts[2]}
        return xs, carry, merged, stats

    def _cached_device(self, host_arrays: Tuple[Any, ...],
                       extra: Optional[Callable[[], Any]] = None
                       ) -> Tuple[Any, ...]:
        """Device tensors for one staged batch, uploaded once per identity,
        followed by ``extra()`` (made once, with the upload) when given.

        Keyed on the ``id`` of every host array (verified against weak
        references, so id reuse cannot alias) and LRU-bounded to
        ``_STAGED_CACHE_SLOTS`` batches.  Host batches are held WEAKLY:
        once the caller drops a staged batch its entry — and the device
        copy it pins — is purged on the next call."""
        for k in [k for k, (refs, _) in self._staged_device.items()
                  if any(r() is None for r in refs)]:
            del self._staged_device[k]
        key = tuple(map(id, host_arrays))
        hit = self._staged_device.get(key)
        if hit is not None and all(r() is a for r, a in
                                   zip(hit[0], host_arrays)):
            self._staged_device.move_to_end(key)
            return hit[1]
        dev = tuple(_device_put(a, self.device) for a in host_arrays)
        if extra is not None:
            dev += (extra(),)
        self._staged_device[key] = (
            tuple(weakref.ref(a) for a in host_arrays), dev,
        )
        while len(self._staged_device) > _STAGED_CACHE_SLOTS:
            self._staged_device.popitem(last=False)
        return dev

    # ----------------------------------------------------------------- run
    def run(
        self,
        program: SemiringProgram,
        instance_weights: Optional[np.ndarray] = None,
        *,
        pattern: str,
        x0: Optional[np.ndarray] = None,
        tiles=None,
        btiles=None,
        sparse: Optional[SparseBlocked] = None,
        merge: Optional[str] = None,
        stream=None,
        staging: Optional[str] = None,
        warm_start: bool = False,
    ) -> EngineResult:
        """Execute ``program`` over the instance collection.

        Instance sources (exactly one):

        * ``instance_weights`` (I, E) — staged through the batched fill in
          the engine's ``layout``;
        * pre-staged ``tiles``/``btiles`` (I, P, T|Tb, B, B) — device
          tensors, or host arrays uploaded once per identity;
        * pre-staged ``sparse`` — a :class:`SparseBlocked` packed batch.

        * ``stream`` — an iterable of :class:`repro_torch.gofs.prefetch
          .StagedChunk` (dense or sparse chunks; e.g.
          ``GoFSStore.load_blocked_stream``): chunks execute as they land.

        ``staging="async"`` (call or constructor) chunks ``instance_weights``
        behind a background prefetcher.  ``x0`` overrides
        ``program.init(bg)``.  ``merge="mean"`` computes the on-device
        eventually-dependent Merge.  All staging modes and both layouts
        are result-identical (bitwise for min-plus)."""
        return self.run_many(
            [RunSpec(program, pattern, x0=x0, merge=merge,
                     warm_start=warm_start)],
            instance_weights, tiles=tiles, btiles=btiles, sparse=sparse,
            stream=stream, staging=staging,
        )[0]

    def run_many(
        self,
        specs: Sequence[RunSpec],
        instance_weights: Optional[np.ndarray] = None,
        *,
        tiles=None,
        btiles=None,
        sparse: Optional[SparseBlocked] = None,
        stream=None,
        staging: Optional[str] = None,
    ) -> List[EngineResult]:
        """Execute N :class:`RunSpec` over ONE staged instance collection.

        The staged batch is materialized (and uploaded) exactly once and
        every spec consumes it; with ``stream=`` (or async staging) one
        pass over the chunks feeds all N specs.  Programs must agree on
        ``zero_fill``; everything else — pattern, fixpoint vs iterate, x0,
        merge — may differ per spec.  Results are bitwise identical to
        running each spec alone."""
        specs = list(specs)
        assert specs, "run_many needs at least one RunSpec"
        for s in specs:
            assert s.pattern in PATTERNS, s.pattern
            assert s.merge is None or s.pattern == "eventually", \
                "merge is the eventually-dependent Merge step; " \
                "use pattern='eventually'"
        zero_fills = {s.program.zero_fill for s in specs}
        assert len(zero_fills) == 1, \
            f"programs disagree on zero_fill ({zero_fills}); they cannot " \
            f"share one staged batch — split into separate run_many calls"
        zero_fill = zero_fills.pop()
        staging = staging or self.staging
        assert staging in ("sync", "async"), staging
        assert sparse is None or tiles is None, \
            "pass either sparse= or tiles=/btiles=, not both"
        if sparse is not None:
            layout = "sparse"
        elif tiles is not None:
            layout = "dense"
        else:
            layout = self.layout
        x0s = []
        for s in specs:
            x0 = s.x0
            if x0 is None:
                assert s.program.init is not None, \
                    f"program {s.program.name!r} has no init; pass x0"
                x0 = s.program.init(self.bg)
            x0 = np.asarray(x0, np.float32)
            if x0.ndim == 3:
                raise _not_ported("the query axis (multi-source x0)", "2")
            x0s.append(torch.as_tensor(x0, device=self.device))

        if (stream is None and staging == "async" and tiles is None
                and sparse is None):
            assert instance_weights is not None, \
                "need instance_weights or pre-staged tiles+btiles"
            from repro_torch.gofs.prefetch import SlicePrefetcher

            w = np.asarray(instance_weights, np.float32)
            if w.ndim == 1:
                w = w[None]
            # <= ~4 chunks by default: enough overlap, few staged shapes
            chunk = self.chunk_instances or max(1, -(-w.shape[0] // 4))
            stream = SlicePrefetcher.from_weights(
                self.bg, w, zero=zero_fill,
                prefetch_depth=self.prefetch_depth, chunk_instances=chunk,
                layout=layout,
            )
        if stream is not None:
            outs, occ = self._run_stream_many(specs, stream, x0s)
            return [self._wrap_result(s.pattern, out, occ,
                                      warm=s.effective_warm())
                    for s, out in zip(specs, outs)]

        occ: Optional[float] = None
        if layout == "sparse":
            if sparse is None:
                assert instance_weights is not None, \
                    "need instance_weights or a SparseBlocked batch"
                sparse = self.stage_sparse(instance_weights, zero_fill)
            occ = sparse.occupancy()
            tiles, btiles, *idx, plans = self._cached_device(
                (sparse.tiles, sparse.btiles, sparse.rows, sparse.cols,
                 sparse.brows, sparse.bcols),
                extra=lambda: self._sparse_plans(sparse))
        else:
            idx = plans = None
            if tiles is None or btiles is None:
                assert instance_weights is not None, \
                    "need instance_weights, tiles+btiles, or sparse"
                tiles, btiles = self.stage(instance_weights, zero_fill)
            elif not (isinstance(tiles, torch.Tensor)
                      and isinstance(btiles, torch.Tensor)):
                # host-staged dense batch: upload once per identity
                tiles, btiles = self._cached_device((tiles, btiles))
            else:
                tiles, btiles = tiles.to(self.device), btiles.to(self.device)
        return [
            self._wrap_result(
                s.pattern, self._scan_instances(
                    s.program, s.pattern, s.merge, x0, tiles, btiles,
                    idx=idx, plans=plans, warm=s.effective_warm()),
                occ, warm=s.effective_warm())
            for s, x0 in zip(specs, x0s)
        ]

    def _host_plans(self, batch) -> Dict[str, WalkPlan]:
        """A packed batch's (``SparseBlocked`` or sparse ``StagedChunk``)
        walk plans on the host, with a leading instance axis."""
        return {"plan": self.bg.packed_plans(batch.cols, batch.nnz),
                "bplan": self.bg.packed_plans(batch.bcols, batch.bnnz)}

    def _sparse_plans(self, sparse: SparseBlocked) -> Dict[str, Any]:
        """The packed batch's walk plans (leading instance axis) on the
        device, counters zeroed.  Built with the batch's upload, once per
        staged batch, never per kernel call."""
        return {k: to_device(p, self.device)
                for k, p in self._host_plans(sparse).items()}

    # ------------------------------------------------------------ streamed
    def _prepare_chunk(self, ch) -> Optional[Dict[str, WalkPlan]]:
        """Run on the prefetcher's pool thread: a sparse chunk's host walk
        plans, one build per chunk."""
        return self._host_plans(ch) if ch.is_sparse else None

    def _chunk_plans(self, ch) -> Optional[Dict[str, WalkPlan]]:
        """A sparse chunk's walk plans on the device (built on the pool
        thread when the stream ran ``_prepare_chunk``); None when dense."""
        if not ch.is_sparse:
            return None
        host = ch.prepared if ch.prepared is not None \
            else self._host_plans(ch)
        return {k: to_device(p, self.device) for k, p in host.items()}

    def _upload_chunk(self, ch):
        """A chunk's arrays (and a sparse chunk's walk plans) on the
        device.  CPU: the tensors alias the chunk's buffers.  CUDA: the
        copies run on a side stream (``non_blocking`` from the chunk's
        pinned buffer), the compute stream waits on their event, and the
        pinned buffer goes back to its ring with that event.  Nothing
        here waits for the device."""
        arrays = (ch.tiles, ch.btiles)
        if ch.is_sparse:
            arrays += (ch.rows, ch.cols, ch.brows, ch.bcols)
        if self.device.type != "cuda":
            bufs = tuple(_device_put(a, self.device) for a in arrays)
            return bufs, self._chunk_plans(ch)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        side = self._copy_stream
        compute = torch.cuda.current_stream(self.device)
        made, plans = [], None
        done = torch.cuda.Event()
        try:  # whatever happens, the pinned buffer goes back to its ring
            with torch.cuda.stream(side):
                for a in arrays:
                    src = torch.from_numpy(np.ascontiguousarray(a))
                    d = torch.empty(src.shape, dtype=src.dtype,
                                    device=self.device)
                    d.copy_(src, non_blocking=True)
                    made.append(d)
                plans = self._chunk_plans(ch)
                if plans is not None:
                    made += [t for p in plans.values() for t in (
                        p.run_ptr, p.chunks, p.first, p.count, p.counters)]
        finally:
            done.record(side)
            ch.release(done)
        compute.wait_event(done)
        for t in made:  # allocated on the side stream, used on compute
            t.record_stream(compute)
        return tuple(made[:len(arrays)]), plans

    def _run_stream_many(self, specs: Sequence[RunSpec], chunks, x0s):
        """Consume a chunk stream (SlicePrefetcher or any iterable of
        StagedChunk) ONCE, feeding every spec: each chunk is uploaded a
        single time, then run by all N specs before the next chunk is
        pulled — so slice reads + tile fills (on the prefetcher's pool)
        overlap the whole fan-out, and N analytics cost one staging pass.
        Sequential and warm specs carry their end state across chunk
        boundaries; eventually Merges fold once over the concatenated
        states.  Streamed chunks never enter the staged-batch cache.
        Returns ([(xs, final, merged, stats)] per spec, occupancy | None).
        """
        from repro_torch.gofs.prefetch import pinned_ring

        cuda = self.device.type == "cuda"
        # a SlicePrefetcher (or a wrapper that forwards ``bind``) fills
        # pinned buffers on CUDA and builds walk plans on its pool thread
        bind = getattr(chunks, "bind", None)
        if bind is not None:
            bind(pinned_ring(self.device) if cuda else None,
                 self._prepare_chunk)
        N = len(specs)
        xs_p: List[list] = [[] for _ in range(N)]
        st_p: List[list] = [[] for _ in range(N)]
        carry = list(x0s)
        n_total = nnz_total = up_bytes = 0
        sparse_seen = False
        wait_s = upload_s = host_s = 0.0
        marks = []  # CUDA events around each chunk's compute
        it = iter(chunks)
        try:
            while True:
                t0 = time.perf_counter()
                ch = next(it, None)
                t1 = time.perf_counter()
                wait_s += t1 - t0
                if ch is None:
                    break
                n = int(ch.tiles.shape[0])
                n_total += n
                if ch.is_sparse:
                    sparse_seen = True
                    nnz_total += int(ch.nnz.sum()) + int(ch.bnnz.sum())
                bufs, plans = self._upload_chunk(ch)
                up_bytes += sum(int(b.nbytes) for b in bufs)
                idx = bufs[2:] if ch.is_sparse else None
                del ch  # a CPU chunk's buffers live on in the tensors
                t2 = time.perf_counter()
                upload_s += t2 - t1
                if cuda:
                    marks.append((torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True)))
                    marks[-1][0].record()
                for k, s in enumerate(specs):
                    warm_k = s.effective_warm()
                    # warm chunks chain exactly like sequential: the carry
                    # is the last instance's converged state, which seeds
                    # the next chunk's first instance
                    seed = carry[k] if (s.pattern == "sequential"
                                        or warm_k) else x0s[k]
                    xs, fin, _, stats = self._scan_instances(
                        s.program, s.pattern, None, seed, bufs[0], bufs[1],
                        idx=idx, plans=plans, warm=warm_k)
                    carry[k] = fin
                    xs_p[k].append(xs)
                    st_p[k].append(stats)
                if cuda:
                    marks[-1][1].record()
                host_s += time.perf_counter() - t2
                del bufs, idx, plans
        finally:
            if bind is not None:
                bind()
            close = getattr(it, "close", None)
            if close is not None:
                close()
        outs = []
        for k, s in enumerate(specs):
            assert xs_p[k], "empty instance stream"
            xs = torch.cat(xs_p[k]) if len(xs_p[k]) > 1 else xs_p[k][0]
            stats = {key: np.concatenate([st[key] for st in st_p[k]])
                     for key in st_p[k][0]}
            merged = torch.mean(xs, dim=0) \
                if s.pattern == "eventually" and s.merge == "mean" else None
            outs.append((xs, carry[k], merged, stats))
        occ = None
        if sparse_seen:
            total = n_total * (int(self.bg.n_tiles.sum())
                               + int(self.bg.n_btiles.sum()))
            occ = nnz_total / total if total else 0.0
        if cuda:
            marks[-1][1].synchronize()  # the compute stream's last chunk
            compute_s = sum(a.elapsed_time(b) for a, b in marks) / 1e3
        else:
            compute_s = host_s
        self.last_stream_report = {
            "chunks": len(st_p[0]), "instances": n_total,
            "uploaded_bytes": up_bytes,
            "wait_seconds": wait_s, "upload_seconds": upload_s,
            "compute_seconds": compute_s,
            "compute_clock": "cuda events" if cuda else "host",
        }
        return outs, occ

    def _wrap_result(self, pattern: str, out, occ: Optional[float],
                     warm: bool = False) -> EngineResult:
        """Gather device outputs back to global vertex order + stats."""
        xs, final, merged, stats = out
        bg = self.bg

        def gather(x):  # (..., P, Vp) -> (..., V)
            return x.cpu().numpy()[..., bg.part_of, bg.local_of]

        return EngineResult(
            pattern=pattern,
            values=gather(xs),
            final=gather(final),
            merged=None if merged is None else gather(merged),
            stats=stats,
            occupancy=occ,
            warm_start=warm,
            _n_published=int(bg.n_out.sum()),
            _n_parts=bg.n_parts,
            _num_vertices=len(bg.part_of),
        )
