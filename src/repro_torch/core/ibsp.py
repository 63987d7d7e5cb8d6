"""Iterative BSP (iBSP) — the paper's programming abstraction (§IV-B), on
the host (counterpart of ``repro.core.ibsp``).

The user implements::

    def compute(ctx: ComputeContext) -> None: ...
    def merge(ctx: MergeContext) -> None: ...   # eventually-dependent only

``ComputeContext`` carries the SubgraphInstance view (topology + projected
attribute values for the current graph instance), the ``timestep`` (graph
instance index) and ``superstep`` numbers, the incoming messages, and the
paper's messaging API:

    SendToSubgraph(sgid, msg)             — superstep messaging (BSP)
    SendToNextTimeStep(msg)               — same subgraph, next instance
    SendToSubgraphInNextTimeStep(sgid, m) — other subgraph, next instance
    SendMessageToMerge(msg)               — fold into the Merge step
    VoteToHalt()

Execution patterns (§III-C): ``sequential`` runs timesteps in order with
inter-timestep message handoff; ``independent`` runs each instance's BSP in
isolation (thread pool across timesteps — temporal concurrency);
``eventually`` is independent + a final Merge BSP over the collected merge
messages.

Messages in a superstep are delivered in *bulk* before the next superstep
(BSP semantics).  A BSP timestep terminates when every subgraph voted to
halt and no messages are in flight.  The engine tracks superstep counts
and message volumes — the quantities the paper's evaluation reasons about.

Message order does not depend on ``workers``: each Compute call collects
what it sends, and the engine posts the calls' messages in subgraph order
after the superstep (merge messages in timestep order after the
timesteps), as a serial run posts them.  So an order-sensitive Compute
(PageRank's floating-point sums over its inbox) gives the same bits with
a thread pool as without one.
"""
from __future__ import annotations

from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.subgraph import SubgraphTopology


@dataclass
class SubgraphInstance:
    """Topology + instance attribute values, as handed to Compute."""

    topology: SubgraphTopology
    timestep: int
    timestamp: float
    # projected attribute values, LOCAL order (topology.vertices order /
    # local edge order and remote edge order for edge attrs)
    vertex_values: Dict[str, np.ndarray] = field(default_factory=dict)
    local_edge_values: Dict[str, np.ndarray] = field(default_factory=dict)
    remote_edge_values: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def sgid(self) -> int:
        return self.topology.sgid


class ComputeContext:
    def __init__(self, engine: "_TimestepBSP", sgi: SubgraphInstance,
                 superstep: int, messages: List[Any]):
        self.subgraph = sgi
        self.timestep = sgi.timestep
        self.superstep = superstep
        self.messages = messages
        self._engine = engine
        self._halted = False
        # (engine post method, args) in send order; posted by the engine
        # after the superstep, in subgraph order
        self._outbox: List[Tuple[Callable, tuple]] = []

    # ---- paper messaging API ------------------------------------------
    def send_to_subgraph(self, sgid: int, msg: Any) -> None:
        self._outbox.append((self._engine.post_superstep_msg, (int(sgid), msg)))

    def send_to_next_timestep(self, msg: Any) -> None:
        self._outbox.append(
            (self._engine.post_timestep_msg, (self.subgraph.sgid, msg)))

    def send_to_subgraph_in_next_timestep(self, sgid: int, msg: Any) -> None:
        self._outbox.append((self._engine.post_timestep_msg, (int(sgid), msg)))

    def send_message_to_merge(self, msg: Any) -> None:
        self._outbox.append((self._engine.post_merge_msg, (msg,)))

    def vote_to_halt(self) -> None:
        self._halted = True


class MergeContext:
    def __init__(self, messages: List[Any]):
        self.messages = messages
        self.result: Any = None

    def emit(self, result: Any) -> None:
        self.result = result


@dataclass
class BSPStats:
    supersteps: int = 0
    compute_calls: int = 0
    superstep_messages: int = 0
    timestep_messages: int = 0
    merge_messages: int = 0

    def merge_from(self, other: "BSPStats") -> None:
        self.supersteps += other.supersteps
        self.compute_calls += other.compute_calls
        self.superstep_messages += other.superstep_messages
        self.timestep_messages += other.timestep_messages
        self.merge_messages += other.merge_messages


class InstanceProvider:
    """Data-access protocol the engine pulls subgraph instances through.

    Implementations: ``repro_torch.gofs.store.GoFSStore`` (slice-backed,
    cached) and ``InMemoryProvider``.
    """

    def subgraph_ids(self) -> Sequence[int]:
        raise NotImplementedError

    def num_timesteps(self) -> int:
        raise NotImplementedError

    def get_instance(self, t_idx: int, sgid: int) -> SubgraphInstance:
        raise NotImplementedError


class InMemoryProvider(InstanceProvider):
    """Adapter over (TimeSeriesGraph, subgraph topologies)."""

    def __init__(self, tsg, subgraphs: Dict[int, SubgraphTopology],
                 vertex_attrs: Sequence[str] = (),
                 edge_attrs: Sequence[str] = ()):
        self.tsg = tsg
        self.subgraphs = subgraphs
        self.vertex_attrs = tuple(vertex_attrs)
        self.edge_attrs = tuple(edge_attrs)

    def subgraph_ids(self):
        return sorted(self.subgraphs)

    def num_timesteps(self) -> int:
        return len(self.tsg)

    def get_instance(self, t_idx: int, sgid: int) -> SubgraphInstance:
        topo = self.subgraphs[sgid]
        inst = self.tsg.instances[t_idx]
        vv = {
            a: self.tsg.vertex_values(t_idx, a)[topo.vertices]
            for a in self.vertex_attrs
        }
        lev, rev = {}, {}
        for a in self.edge_attrs:
            full = self.tsg.edge_values(t_idx, a)
            lev[a] = full[topo.local_edge_id]
            rev[a] = full[topo.remote_edge_id]
        return SubgraphInstance(
            topology=topo, timestep=t_idx, timestamp=inst.timestamp,
            vertex_values=vv, local_edge_values=lev, remote_edge_values=rev,
        )


class _TimestepBSP:
    """One BSP timestep over one graph instance."""

    def __init__(self, provider: InstanceProvider, t_idx: int,
                 compute: Callable[[ComputeContext], None],
                 inbox: Dict[int, List[Any]],
                 merge_sink: List[Any],
                 pool: Optional[ThreadPoolExecutor],
                 max_supersteps: int = 10_000):
        self.provider = provider
        self.t_idx = t_idx
        self.compute = compute
        self.inbox = dict(inbox)  # sgid -> messages for superstep 1
        self.merge_sink = merge_sink
        self.pool = pool
        self.max_supersteps = max_supersteps
        self.stats = BSPStats()
        self._next_super: Dict[int, List[Any]] = defaultdict(list)
        self._next_timestep: Dict[int, List[Any]] = defaultdict(list)

    # message sinks: ``run`` posts each superstep's outboxes from its own
    # thread, after the Compute calls, in subgraph order
    def post_superstep_msg(self, sgid: int, msg: Any) -> None:
        self._next_super[sgid].append(msg)
        self.stats.superstep_messages += 1

    def post_timestep_msg(self, sgid: int, msg: Any) -> None:
        self._next_timestep[sgid].append(msg)
        self.stats.timestep_messages += 1

    def post_merge_msg(self, msg: Any) -> None:
        self.merge_sink.append(msg)
        self.stats.merge_messages += 1

    def run(self) -> Dict[int, List[Any]]:
        """Run supersteps to quiescence; returns next-timestep inbox."""
        sgids = list(self.provider.subgraph_ids())
        active = {g: True for g in sgids}  # all active in superstep 1
        current: Dict[int, List[Any]] = {g: self.inbox.get(g, []) for g in sgids}
        superstep = 1
        while superstep <= self.max_supersteps:
            run_set = [g for g in sgids if active[g] or current.get(g)]
            if not run_set:
                break
            self.stats.supersteps += 1

            def run_one(g):
                sgi = self.provider.get_instance(self.t_idx, g)
                ctx = ComputeContext(self, sgi, superstep, current.get(g, []))
                self.compute(ctx)
                return g, ctx

            if self.pool is not None:
                results = list(self.pool.map(run_one, run_set))
            else:
                results = [run_one(g) for g in run_set]
            self.stats.compute_calls += len(run_set)
            for g, ctx in results:  # run_set order, whatever the pool did
                active[g] = not ctx._halted
                for post, args in ctx._outbox:
                    post(*args)
            current = dict(self._next_super)
            self._next_super = defaultdict(list)
            superstep += 1
        return dict(self._next_timestep)


@dataclass
class IBSPResult:
    merge_result: Any
    merge_messages: List[Any]
    stats: BSPStats
    per_timestep_stats: List[BSPStats]


def run_ibsp(
    provider: InstanceProvider,
    compute: Callable[[ComputeContext], None],
    *,
    pattern: str = "sequential",  # sequential | independent | eventually
    merge: Optional[Callable[[MergeContext], None]] = None,
    initial_messages: Optional[Dict[int, List[Any]]] = None,
    workers: int = 0,  # >0: thread pool over subgraphs (and instances when
    #                     the pattern allows temporal concurrency)
    max_supersteps: int = 10_000,
) -> IBSPResult:
    """Execute an iBSP application over the collection (paper §IV-B)."""
    if pattern not in ("sequential", "independent", "eventually"):
        raise ValueError(f"unknown iBSP pattern {pattern!r}")
    n_t = provider.num_timesteps()
    merge_sink: List[Any] = []
    total = BSPStats()
    per_ts: List[BSPStats] = []
    pool = ThreadPoolExecutor(max_workers=workers) if workers > 0 else None
    try:
        if pattern == "sequential":
            inbox = dict(initial_messages or {})
            for t in range(n_t):
                bsp = _TimestepBSP(provider, t, compute, inbox, merge_sink,
                                   pool, max_supersteps)
                inbox = bsp.run()
                per_ts.append(bsp.stats)
                total.merge_from(bsp.stats)
        else:
            # temporal concurrency: each instance's BSP is independent
            def run_t(t):
                # application inputs are visible to every timestep's
                # superstep 1 (paper §IV-B: no notion of a previous instance)
                inbox = dict(initial_messages or {})
                sink: List[Any] = []
                bsp = _TimestepBSP(provider, t, compute, inbox, sink,
                                   None, max_supersteps)
                bsp.run()
                return bsp.stats, sink

            if pool is not None:
                outs = list(pool.map(run_t, range(n_t)))
            else:
                outs = [run_t(t) for t in range(n_t)]
            for s, sink in outs:  # timestep order
                per_ts.append(s)
                total.merge_from(s)
                merge_sink.extend(sink)
    finally:
        if pool is not None:
            pool.shutdown()

    merge_result = None
    if pattern == "eventually" and merge is not None:
        mctx = MergeContext(list(merge_sink))
        merge(mctx)
        merge_result = mctx.result
    return IBSPResult(
        merge_result=merge_result,
        merge_messages=list(merge_sink),
        stats=total,
        per_timestep_stats=per_ts,
    )
