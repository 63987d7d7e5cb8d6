"""Real inter-process boundary exchange behind the ``HostGather`` seam
(counterpart of ``repro.cluster.gather``).

``repro_torch.core.comm.HostGather`` folds the stacked ([Q,] P, NB)
publish buffer on the host with a fixed-association left fold
(``_host_fold_*``).  :class:`ClusterGather` is the same fold with the
network gather in the middle: each process holds ONLY its own partition
shard's ([Q,] P_local, NB) buffer rows; they cross to the host,
are allgathered over the :class:`~repro_torch.cluster.runtime
.TcpExchange` in process-id order, concatenated back into the full
([Q,] P, NB) buffer along the partition axis, and folded with the
IDENTICAL ``_host_fold_*`` left fold on every host.  The combined
([Q,] NB) buffer returns to the device the shard's buffer came from.

Because :meth:`ClusterRuntime.partition_shard` assigns contiguous
partition ranges in process-id order, the concatenation reconstructs the
exact single-process buffer — so the distributed combine is
**bitwise-identical** to the single-process fold, for min-plus AND
plus-mul (same 0..P-1 association, same IEEE f32 adds).

The halt vote (``any_changed``) is an element-wise OR of the (Q,) lane
flags across processes: every process's superstep loop then runs the
same superstep count on every lane — which is what makes the reported
``supersteps`` match the single-process run and what keeps the
per-superstep exchange deadlock-free (no process leaves the loop while
others still expect its buffers).  The engine's loop already reads its
votes on the host (``core/superstep.py``), so the OR is a plain
exchange.  ``local_sweeps`` and ``host_syncs`` stay per-process
statistics: a shard holding fewer partitions converges in fewer local
sweeps, and the extra sweeps the single-process run performs on
already-converged partitions are idempotent no-ops.

``sum_scalar`` (only the standalone ``pagerank_run`` tolerance loop
uses it) sums the per-process partials in rank order — associated
differently than the single-process sum over all partitions, so a
tolerance-triggered halt may differ in low-order bits there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.cluster.runtime import ClusterRuntime
from repro_torch.core.comm import (CommBackend, HostGather, _host_fold_min,
                                   _host_fold_sum)
from repro_torch.core.semiring import Semiring


@dataclass(frozen=True)
class ClusterGather(CommBackend):
    """Inter-process boundary combine (see module docstring).

    Degrades exactly to :class:`~repro_torch.core.comm.HostGather` when
    the runtime is single-process — same fold, zero network.

    >>> import torch
    >>> from repro_torch.core.semiring import MIN_PLUS
    >>> cg = ClusterGather(runtime=ClusterRuntime(0, 1))
    >>> buf = torch.tensor([[0., 7., float("inf")],
    ...                     [float("inf"), 2., 5.]])
    >>> cg.combine_boundary(buf, MIN_PLUS)
    tensor([0., 2., 5.])
    >>> cg.any_changed(np.array([True, False]))
    array([ True, False])
    """

    name: str = "cluster"
    runtime: Optional[ClusterRuntime] = None

    def __post_init__(self):
        assert self.runtime is not None, "ClusterGather needs a runtime"

    def combine_boundary(self, buf: torch.Tensor,
                         sr: Semiring) -> torch.Tensor:
        fold = _host_fold_sum if sr.name == "plus_mul" else _host_fold_min
        # the partition axis is -2: a leading query axis survives
        full = self.runtime.allgather_concat(
            buf.detach().cpu().numpy(), axis=-2, tag=f"combine/{sr.name}")
        out = fold(full)
        return torch.from_numpy(np.ascontiguousarray(out)).to(buf.device)

    def any_changed(self, flags: np.ndarray) -> np.ndarray:
        """Element-wise OR of every process's (Q,) lane votes."""
        flags = np.asarray(flags, bool)
        if not self.runtime.is_distributed:
            return flags
        return np.logical_or.reduce(
            self.runtime.allgather("vote", flags), axis=0)

    def sum_scalar(self, x: torch.Tensor) -> torch.Tensor:
        if not self.runtime.is_distributed:
            return x
        parts = self.runtime.allgather("sum", x.detach().cpu().numpy())
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return torch.as_tensor(out, device=x.device)


def cluster_comm(runtime: Optional[ClusterRuntime]) -> CommBackend:
    """The comm backend a cluster-placed engine should default to: the
    inter-process gather when distributed, plain ``HostGather`` (same
    fold, no exchange) single-process.

    >>> cluster_comm(None).name
    'host'
    """
    if runtime is not None and runtime.is_distributed:
        return ClusterGather(runtime=runtime)
    return HostGather()
