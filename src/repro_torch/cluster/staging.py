"""Shard-local staging: each process stages only the partitions it owns
(counterpart of ``repro.cluster.staging``).

Single-process staging materializes the WHOLE collection on every host —
(I, P, T, B, B) tiles spanning all P partitions.  On a cluster that is
both wasted RAM and wasted store traffic: the engine shard on process r
only ever consumes the rows of its own partition range.  This module
stages exactly that range:

* :func:`shard_stream` wraps a :class:`~repro_torch.gofs.prefetch
  .SlicePrefetcher` whose chunks hold a ``(count, P_local, ...)``
  partition axis.  The read touches the owned partitions' GoFS slice
  files plus the peers' remote-edge halo
  (``GoFSStore.edge_attr_rows(parts=..., halo=True)`` — incoming cut
  edges are recorded at their SOURCE partition) and the fills scatter
  only the owned partitions' tile slots
  (``BlockedGraph.fill_*_batch(parts=...)``) into buffers the
  prefetcher hands out (pinned host memory when the engine binds its
  ring on CUDA) — staged bytes per host drop to the shard fraction.
* Every chunk boundary is a **cross-process consistency check**: as the
  consumer pulls a chunk, the processes exchange the chunk's (start,
  count, layout) digest through the sequenced runtime exchange and fail
  fast on divergence.  The check runs on the CONSUMER thread, never the
  prefetch pool, so its exchange operations interleave
  deterministically with the engine's per-superstep exchanges.
* :func:`shard_staged_bytes` is the accounting hook: bytes materialized
  for a chunk (tile tensors + sparse index arrays).
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from repro_torch.cluster.runtime import ClusterRuntime
from repro_torch.gofs.prefetch import SlicePrefetcher, StagedChunk


def shard_staged_bytes(chunk: StagedChunk) -> int:
    """Bytes materialized for one staged chunk (tiles + index arrays)."""
    total = chunk.tiles.nbytes + chunk.btiles.nbytes
    for a in (chunk.rows, chunk.cols, chunk.brows, chunk.bcols):
        if a is not None:
            total += a.nbytes
    return total


class ShardStream:
    """A consistency-checked iterable of shard-local staged chunks.

    Iterates the wrapped prefetcher, verifying every chunk's span digest
    across processes before handing it to the engine, and accumulating
    :attr:`staged_bytes` (the per-host staging cost).  ``bind`` reaches
    the prefetcher, so the engine's pinned ring and pool-thread hook
    apply to the shard's chunks too.  Supports the prefetcher's
    ``with``/``close`` lifecycle.
    """

    def __init__(self, prefetcher: SlicePrefetcher,
                 runtime: Optional[ClusterRuntime]):
        self.prefetcher = prefetcher
        self.runtime = runtime
        self.staged_bytes = 0
        self.chunks = 0

    def bind(self, *args, **kw) -> None:
        self.prefetcher.bind(*args, **kw)

    @property
    def num_instances(self) -> int:
        return self.prefetcher.num_instances

    def shard_instances(self, lo: int, hi: int) -> "ShardStream":
        """The stream over instances ``[lo, hi)`` only (a mesh data
        rank's share; :meth:`SlicePrefetcher.shard_instances`)."""
        return ShardStream(self.prefetcher.shard_instances(lo, hi),
                           self.runtime)

    def __iter__(self) -> Iterator[StagedChunk]:
        it = iter(self.prefetcher)
        try:
            for ch in it:
                if self.runtime is not None and self.runtime.is_distributed:
                    self.runtime.check_consistent(
                        f"chunk/{self.chunks}",
                        (int(ch.start), int(ch.count),
                         "sparse" if ch.is_sparse else "dense"),
                    )
                self.staged_bytes += shard_staged_bytes(ch)
                self.chunks += 1
                yield ch
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                close()  # ends the prefetcher's pass with this one

    def close(self) -> None:
        self.prefetcher.close()

    def __enter__(self) -> "ShardStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def shard_stream(
    store,
    bg,
    name: str,
    runtime: Optional[ClusterRuntime],
    *,
    parts: Optional[Tuple[int, int]] = None,
    zero: float = np.inf,
    prefetch_depth: int = 2,
    chunk_instances: Optional[int] = None,
    num_workers: int = 1,
    inflight: Optional[int] = None,
    layout: str = "dense",
    transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
) -> ShardStream:
    """Stream an edge attribute staged for THIS process's partition shard.

    The shard-local counterpart of ``GoFSStore.load_blocked_stream``:
    chunks carry a ``(count, P_local, ...)`` partition axis covering
    ``parts`` (default ``runtime.partition_shard(bg.n_parts)``; a mesh
    rank passes its model shard), reads touch only the owned partitions'
    slice files (plus the peers' cut-edge halo), and chunk boundaries
    are consistency-checked across processes.  With a single-process
    runtime (or ``runtime=None``) and no ``parts`` the shard is the full
    partition range and no exchange happens.  ``shard_instances(lo, hi)``
    narrows the stream to a mesh data rank's instances.

    Delta tile chains and deployment-recorded buckets describe the FULL
    collection, so the shard path always stages from the value slices;
    sparse chunks bucket themselves per chunk.
    """
    assert layout in ("dense", "sparse"), layout
    rt = runtime if runtime is not None else ClusterRuntime(0, 1)
    lo, hi = parts if parts is not None else rt.partition_shard(bg.n_parts)
    owned = range(lo, hi)

    def read(s: int, e: int) -> np.ndarray:
        if transform is None:
            # halo=True: the owned partitions' BOUNDARY tiles scatter cut
            # edges *incoming* from peer shards, recorded in the peers'
            # remote slices — read just that sliver on top of the owned
            # bulk
            return store.edge_attr_rows(name, range(s, e), parts=owned,
                                        fill=zero, halo=True)
        # weights transforms may be structural over the WHOLE row
        # (PageRank normalizes each edge by its source's global
        # outdegree) — a shard-read row would feed them fill values.
        # Read full rows for the transform; the fills still scatter only
        # the owned partitions' tile slots, so the materialized per-host
        # bytes stay shard-local.
        return store.edge_attr_rows(name, range(s, e))

    pf = SlicePrefetcher(
        bg, read, store.num_timesteps(), zero=zero,
        prefetch_depth=prefetch_depth,
        chunk_instances=int(chunk_instances or store.ipack),
        num_workers=num_workers, inflight=inflight, layout=layout,
        transform=transform, parts=(lo, hi),
    )
    return ShardStream(pf, rt)
