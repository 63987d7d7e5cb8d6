"""Double-buffered slice staging for the temporal engine (paper §V read
optimizations: overlap GoFS slice reads with Gopher computation).
Counterpart of ``repro.gofs.prefetch``.

:class:`SlicePrefetcher` reads an edge attribute's (bin, pack) slices on
a background thread pool, assembles them into ready ``(I_chunk, P, T, B,
B)`` instance tile tensors (through the batched in-place ``BlockedGraph``
``out=`` fills), and hands chunks to the consumer through a bounded
in-order window.

``prefetch_depth`` semantics:

* ``1``  — degenerate/synchronous: no thread is created; each chunk is read
  and filled on demand when the consumer asks for it.
* ``d>=2`` — double (d=2) or deeper buffering: up to ``d - 1`` chunks are
  staged ahead on the pool while the consumer processes the current one.

``inflight`` (default ``num_workers``) decouples read CONCURRENCY from
the window depth: up to ``max(prefetch_depth - 1, inflight)`` chunks are
submitted ahead, so ``num_workers`` pool threads really do read
concurrently without inflating ``prefetch_depth``.

**Buffer ownership.** On the CPU each chunk OWNS its buffers: they are
allocated on the producer and never rewritten after handoff, which is
what lets the engine alias them (``torch.as_tensor`` shares a numpy
buffer's memory, as ``jnp.asarray`` does) for as long as it holds the
chunk.  There is no ring on the CPU.

On CUDA the engine binds a :class:`PinnedRing` to the pass: chunks fill
views of page-locked host buffers, the engine copies each chunk to the
card with ``non_blocking=True`` on a side stream and hands the buffer
back with the copy's CUDA event (:meth:`StagedChunk.release`).  The ring
gives a buffer out again only once that event has completed, and holds
at most ``max(prefetch_depth - 1, inflight) + 2`` buffers for a pass.

Cancellation: ``close()`` (or exiting the ``with`` block) stops the
producer, cancels not-yet-started reads, and joins the pool — no leaked
threads; abandoning the iterator mid-stream triggers the same cleanup.

Doctest (in-memory source; the GoFS-backed form is
``GoFSStore.load_blocked_stream``):

>>> import numpy as np
>>> from repro_torch.core.graph import GraphTemplate
>>> from repro_torch.core.blocked import build_blocked
>>> from repro_torch.gofs.prefetch import SlicePrefetcher
>>> tmpl = GraphTemplate(num_vertices=4,
...     src=np.array([0, 1, 2, 0]), dst=np.array([1, 2, 3, 2]))
>>> bg = build_blocked(tmpl, np.array([0, 0, 1, 1]), block_size=2)
>>> w = np.ones((5, 4), np.float32)  # 5 instances x 4 edges
>>> with SlicePrefetcher.from_weights(bg, w, zero=np.inf,
...                                   chunk_instances=2) as pf:
...     [(c.start, c.count) for c in pf]
[(0, 2), (2, 2), (4, 1)]
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import CancelledError, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.blocked import pow2_bucket

THREAD_PREFIX = "gofs-prefetch"

# alignment of each array carved out of a pinned buffer (the graph kernels
# read 16 bytes a load; a page keeps copies on their fast path)
_ALIGN = 4096


@dataclass
class StagedChunk:
    """A contiguous run of staged instances, ready for the engine.

    The chunk owns ``tiles``/``btiles`` (and, for the block-sparse layout,
    the tile-index arrays) until the consumer drops it or, on CUDA,
    releases its pinned buffer (:meth:`release`).

    Dense layout: ``tiles``/``btiles`` span the full template tile axis
    and the index fields are ``None``.  Sparse layout
    (``repro_torch.core.blocked.SparseBlocked`` fields): the tile axes are
    packed pow2 buckets and ``rows``/``cols``/``brows``/``bcols`` carry
    the per-instance active-tile index (``-1`` padding).
    """

    start: int  # first (visible) instance index covered by this chunk
    count: int
    tiles: np.ndarray  # (count, P, T|K, B, B) local adjacency tiles
    btiles: np.ndarray  # (count, P, Tb|Kb, B, B) boundary tiles
    rows: Optional[np.ndarray] = None  # (count, P, K) int32, sparse only
    cols: Optional[np.ndarray] = None  # (count, P, K)
    brows: Optional[np.ndarray] = None  # (count, P, Kb)
    bcols: Optional[np.ndarray] = None  # (count, P, Kb)
    nnz: Optional[np.ndarray] = None  # (count, P) active local tiles
    bnnz: Optional[np.ndarray] = None  # (count, P) active boundary tiles
    # bytes materialized from the store for this chunk, when less than the
    # arrays' nbytes — a delta-chain reconstruction decodes each unique
    # tile payload once per chunk (GoFSStore.load_blocked_stream).  None =
    # fully materialized.
    staged_bytes: Optional[int] = None
    # what the consumer asked the pool thread to derive from the chunk
    # (the engine: a sparse chunk's host walk plans)
    prepared: Optional[Dict[str, Any]] = field(
        default=None, repr=False, compare=False)
    # the pinned buffer the tiles live in (CUDA passes only)
    lease: Optional["_Lease"] = field(default=None, repr=False,
                                      compare=False)

    @property
    def is_sparse(self) -> bool:
        return self.rows is not None

    def release(self, event=None) -> None:
        """Hand the chunk's pinned buffer back to its ring, to be reused
        once ``event`` (the copy that read it) has completed.  A no-op for
        chunks in ordinary host memory."""
        if self.lease is not None:
            self.lease.release(event)


# reader(start, end) -> (end - start, E) float32 edge weights for the
# visible-instance span [start, end)
Reader = Callable[[int, int], np.ndarray]
# alloc(n, bucket=None, bbucket=None, parts=None) -> (local, boundary)
# float32 fill buffers for n instances (see
# BlockedGraph.alloc_batch_buffers; ``parts`` sizes a shard's partitions)
Alloc = Callable[..., Tuple[np.ndarray, np.ndarray]]


class _Stopped(Exception):
    """The pass was closed while its producer waited for a buffer."""


class _Slot:
    """One page-locked host buffer of a :class:`PinnedRing`."""

    def __init__(self):
        self.buf: Optional[np.ndarray] = None  # uint8, registered with CUDA
        self.leased = True  # new slots are made for a lease
        self.event = None  # the copy that last read it (torch.cuda.Event)
        self.released = 0  # release order: copies complete in this order

    @property
    def nbytes(self) -> int:
        return 0 if self.buf is None else int(self.buf.nbytes)


class _Lease:
    """A slot lent to one chunk: float32 views are carved out of it."""

    def __init__(self, ring: "PinnedRing", slot: _Slot):
        self.ring, self.slot = ring, slot
        self._used = 0

    def empty(self, shape: Tuple[int, ...]) -> np.ndarray:
        n = int(np.prod(shape)) * 4
        off = -(-self._used // _ALIGN) * _ALIGN
        assert off + n <= self.slot.nbytes, "pinned buffer too small"
        self._used = off + n
        return self.slot.buf[off:off + n].view(np.float32).reshape(shape)

    def release(self, event=None) -> None:
        self.ring._release(self, event)


def _pin(nbytes: int) -> np.ndarray:
    """A host buffer of ``nbytes``, page-locked for CUDA copies.  Host
    memory is registered in place (``cudaHostRegister``) rather than
    allocated through PyTorch's pinned allocator, which rounds every
    allocation up to a power of two."""
    import torch

    buf = np.empty(max(1, nbytes), np.uint8)
    torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
        buf.ctypes.data, buf.nbytes, 0))
    return buf


def _unpin(buf: np.ndarray) -> None:
    import torch

    torch.cuda.check_error(
        torch.cuda.cudart().cudaHostUnregister(buf.ctypes.data))


class PinnedRing:
    """Page-locked host buffers that CUDA passes fill chunks into.

    A producer thread takes a buffer with :meth:`acquire` (blocking while
    all are in use); the consumer gives it back with the CUDA event of
    the copy that read it, and the buffer is handed out again only once
    that event has completed.  Buffers grow to the largest chunk asked
    for and are kept across passes, so pinning (slow for gigabytes) is
    paid once.  ``peak_bytes`` records the most pinned at once,
    ``pin_seconds`` the host time spent pinning."""

    def __init__(self):
        self._slots: List[_Slot] = []
        self._cv = threading.Condition()
        self._releases = 0
        self.peak_bytes = 0
        self.pin_seconds = 0.0  # host seconds spent pinning buffers

    @property
    def pinned_bytes(self) -> int:
        return sum(s.nbytes for s in self._slots)

    def acquire(self, nbytes: int, cap: int,
                stop: Optional[threading.Event] = None) -> _Lease:
        """A buffer of at least ``nbytes``, with at most ``cap`` buffers in
        the ring.  Prefers a free buffer whose copy has completed, then
        waits for a free one whose copy is in flight, then pins a new one;
        raises ``_Stopped`` when ``stop`` is set while it waits."""
        while True:
            with self._cv:
                if stop is not None and stop.is_set():
                    raise _Stopped
                free = [s for s in self._slots if not s.leased]
                done = [s for s in free
                        if s.event is None or s.event.query()]
                if done:
                    fits = [s for s in done if s.nbytes >= nbytes]
                    slot = min(fits, key=lambda s: s.nbytes) if fits \
                        else max(done, key=lambda s: s.nbytes)
                    slot.leased, slot.event = True, None
                    grow = slot.nbytes < nbytes
                elif free:
                    # the oldest release: its copy was issued first
                    pending = min(free, key=lambda s: s.released).event
                    slot = None
                elif len(self._slots) < cap:
                    slot = _Slot()
                    self._slots.append(slot)
                    grow = True
                else:
                    self._cv.wait(0.05)
                    continue
            if slot is None:
                pending.synchronize()  # that copy ends; then take its slot
                continue
            if grow:
                t0 = time.perf_counter()
                try:
                    if slot.buf is not None:
                        _unpin(slot.buf)
                        slot.buf = None
                    slot.buf = _pin(nbytes)
                except BaseException:
                    with self._cv:
                        self._slots.remove(slot)
                        self._cv.notify_all()
                    raise
                with self._cv:
                    self.peak_bytes = max(self.peak_bytes, self.pinned_bytes)
                    self.pin_seconds += time.perf_counter() - t0
            return _Lease(self, slot)

    def _release(self, lease: _Lease, event) -> None:
        with self._cv:
            slot = lease.slot
            if slot.leased:
                self._releases += 1
                slot.leased, slot.event = False, event
                slot.released = self._releases
                self._cv.notify_all()

    def close(self) -> None:
        """Wait for every copy out of the ring and unpin its buffers."""
        with self._cv:
            slots, self._slots = self._slots, []
        for s in slots:
            if s.event is not None:
                s.event.synchronize()
            if s.buf is not None:
                _unpin(s.buf)
                s.buf = None


_RINGS: Dict[int, PinnedRing] = {}
_RINGS_LOCK = threading.Lock()


def pinned_ring(device) -> PinnedRing:
    """The process's ring for one CUDA device (made on first use)."""
    import torch

    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    with _RINGS_LOCK:
        if idx not in _RINGS:
            _RINGS[idx] = PinnedRing()
        return _RINGS[idx]


def release_pinned() -> None:
    """Unpin and free every ring's buffers (they are made again on
    demand)."""
    with _RINGS_LOCK:
        rings = list(_RINGS.values())
        _RINGS.clear()
    for r in rings:
        r.close()


class SlicePrefetcher:
    """Stage (bin, pack) attribute reads ahead of the engine run.

    Construct via :meth:`GoFSStore.load_blocked_stream
    <repro_torch.gofs.store.GoFSStore.load_blocked_stream>` (disk slices)
    or :meth:`from_weights` (an in-memory ``(I, E)`` array — what
    ``TemporalEngine(staging="async")`` uses when handed raw weights).

    Iterating yields :class:`StagedChunk` in instance order.  The iterator
    is re-entrant: each ``iter()`` starts a fresh pass; only one pass may
    be active at a time.  A pass covers exactly the instances visible
    when the prefetcher was built; ``close()`` is safe against an active
    consumer (the pass ends cleanly, never with a leaked
    ``CancelledError``).

    ``transform``: applied to each chunk's (n, E) rows on the POOL thread
    before the fill — row-wise derived weights (PageRank's outdegree
    normalization) stream chunk-wise instead of forcing a full (I, E)
    materialization up front.  Must be per-instance independent:
    ``transform(w[s:e]) == transform(w)[s:e]``.  ``stage_fn(s, e,
    alloc)`` replaces the read+fill entirely (the store's delta-chain
    reconstruction), filling buffers from ``alloc(n, bucket=...,
    bbucket=...)``; the windowing and cancellation are unchanged.

    ``parts=(lo, hi)``: the read+fill stages only that partition range
    (a cluster shard's or a mesh rank's), so chunks carry a ``hi - lo``
    partition axis; the reader must supply those partitions' edges and
    the cut edges incoming to them.  ``instances=(lo, hi)``: a pass
    covers only that range of the ``num_instances`` (chunk starts stay
    global); :meth:`shard_instances` makes one from a whole-range
    prefetcher.

    The consumer may :meth:`bind`, before iterating, a ``ring`` (a
    :class:`PinnedRing`: chunks then fill pinned buffers, see the module
    docstring) and ``prepare`` (called with each staged chunk on the pool
    thread; what it returns lands in ``chunk.prepared``).
    """

    def __init__(
        self,
        bg,
        reader: Optional[Reader],
        num_instances: int,
        *,
        zero: float,
        prefetch_depth: int = 2,
        chunk_instances: int = 1,
        num_workers: int = 1,
        inflight: Optional[int] = None,
        layout: str = "dense",
        bucket: Optional[int] = None,
        bbucket: Optional[int] = None,
        transform: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        stage_fn: Optional[Callable[[int, int, Alloc], StagedChunk]] = None,
        parts: Optional[Tuple[int, int]] = None,
        instances: Optional[Tuple[int, int]] = None,
    ):
        assert prefetch_depth >= 1, "prefetch_depth must be >= 1"
        assert chunk_instances >= 1 and num_workers >= 1
        assert layout in ("dense", "sparse"), layout
        assert reader is not None or stage_fn is not None
        self.bg = bg
        self.reader = reader
        self.num_instances = int(num_instances)
        self.zero = float(zero)
        self.prefetch_depth = int(prefetch_depth)
        self.chunk_instances = int(chunk_instances)
        self.num_workers = int(num_workers)
        self.inflight = int(num_workers if inflight is None else inflight)
        assert self.inflight >= 1, "inflight must be >= 1"
        # block-sparse staging: a shared ``bucket``/``bbucket`` (from
        # GoFS-recorded tile maps or a whole-batch activity scan) keeps
        # every chunk on one shape; left None, each chunk picks its own
        # pow2 bucket
        self.layout = layout
        self.bucket = bucket
        self.bbucket = bbucket
        self.transform = transform
        self.stage_fn = stage_fn
        self.parts = parts
        self.instances = (0, self.num_instances) if instances is None \
            else (int(instances[0]), int(instances[1]))
        lo, hi = self.instances
        assert 0 <= lo <= hi <= self.num_instances, self.instances
        self.ring: Optional[PinnedRing] = None
        self.prepare: Optional[Callable[[StagedChunk], Any]] = None
        self._spans: List[Tuple[int, int]] = [
            (s, min(s + self.chunk_instances, hi))
            for s in range(lo, hi, self.chunk_instances)
        ]
        self._stop = threading.Event()
        self._lock = threading.Lock()  # guards _pool/_pending handoff
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending: deque = deque()

    @property
    def window(self) -> int:
        """Chunks submitted ahead of the consumer."""
        return max(self.prefetch_depth - 1, self.inflight)

    def bind(self, ring: Optional[PinnedRing] = None,
             prepare: Optional[Callable[[StagedChunk], Any]] = None) -> None:
        """Set the pinned ring and the pool-thread ``prepare`` hook for
        the next passes (``bind()`` unsets both)."""
        self.ring, self.prepare = ring, prepare

    def shard_instances(self, lo: int, hi: int) -> "SlicePrefetcher":
        """This prefetcher's reads and fills over instances ``[lo, hi)``
        only: a mesh data rank's share of a pass."""
        assert self.instances == (0, self.num_instances), \
            "shard a whole-range prefetcher"
        return SlicePrefetcher(
            self.bg, self.reader, self.num_instances, zero=self.zero,
            prefetch_depth=self.prefetch_depth,
            chunk_instances=self.chunk_instances,
            num_workers=self.num_workers, inflight=self.inflight,
            layout=self.layout, bucket=self.bucket, bbucket=self.bbucket,
            transform=self.transform, stage_fn=self.stage_fn,
            parts=self.parts, instances=(lo, hi))

    # ------------------------------------------------------------ sources
    @classmethod
    def from_weights(
        cls,
        bg,
        weights: np.ndarray,
        *,
        zero: float,
        prefetch_depth: int = 2,
        chunk_instances: int = 1,
        num_workers: int = 1,
        inflight: Optional[int] = None,
        layout: str = "dense",
        bucket: Optional[int] = None,
        bbucket: Optional[int] = None,
        parts: Optional[Tuple[int, int]] = None,
    ) -> "SlicePrefetcher":
        """Prefetch from an in-memory (I, E) weight matrix (the fills —
        the expensive host-side scatter — still overlap the engine run);
        ``parts``: fill only that partition range."""
        w = np.asarray(weights, np.float32)
        if w.ndim == 1:
            w = w[None]
        if layout == "sparse" and bucket is None:
            # the weights are all in memory: one cheap activity scan pins
            # a batch-wide bucket so every chunk shares one shape
            bucket, bbucket = bg.sparse_buckets(w, zero=zero)
        return cls(
            bg, lambda s, e: w[s:e], w.shape[0], zero=zero,
            prefetch_depth=prefetch_depth, chunk_instances=chunk_instances,
            num_workers=num_workers, inflight=inflight, layout=layout,
            bucket=bucket, bbucket=bbucket, parts=parts,
        )

    # ------------------------------------------------------------ staging
    def _alloc(self, leases: list) -> Alloc:
        """The fill-buffer allocator of one chunk: ``np.empty`` without a
        ring, views of one pinned buffer (its lease kept in ``leases``)
        with one."""

        def alloc(n: int, bucket: Optional[int] = None,
                  bbucket: Optional[int] = None,
                  parts: Optional[Tuple[int, int]] = None):
            if self.ring is None:
                return self.bg.alloc_batch_buffers(
                    n, bucket=bucket, bbucket=bbucket, parts=parts)
            assert not leases, "one pinned buffer per chunk"
            B = self.bg.block_size
            P = self.bg.n_parts if parts is None else parts[1] - parts[0]
            need = n * P * B * B * 4 * ((bucket or self.bg.t_max)
                                        + (bbucket or self.bg.tb_max)) \
                + 2 * _ALIGN
            lease = self.ring.acquire(need, self.window + 2, self._stop)
            leases.append(lease)
            return self.bg.alloc_batch_buffers(
                n, bucket=bucket, bbucket=bbucket, empty=lease.empty,
                parts=parts)

        return alloc

    def _stage(self, span: Tuple[int, int]) -> StagedChunk:
        """Read + fill one chunk into chunk-owned buffers (runs on the
        pool, so both the reads AND the fill/allocation overlap the
        consumer's execution)."""
        s, e = span
        n = e - s
        leases: list = []
        alloc = self._alloc(leases)
        try:
            if self.stage_fn is not None:
                chunk = self.stage_fn(s, e, alloc)
            else:
                chunk = self._read_fill(s, e, n, alloc)
            if self.prepare is not None:
                chunk.prepared = self.prepare(chunk)
        except BaseException:
            for lease in leases:
                lease.release()
            raise
        if leases:
            chunk.lease = leases[0]
        return chunk

    def _read_fill(self, s: int, e: int, n: int, alloc: Alloc) -> StagedChunk:
        w = self.reader(s, e)
        if self.transform is not None:
            w = np.asarray(self.transform(w), np.float32)
            assert w.shape[0] == n, (w.shape, n)
        bg, zero, parts = self.bg, self.zero, self.parts
        if self.layout == "sparse":
            bucket, bbucket, act_l, act_b = self.bucket, self.bbucket, \
                None, None
            if bucket is None or bbucket is None:
                # no shared bucket: this chunk's own pow2 buckets
                act_l, act_b = bg.active_tile_maps(w, zero=zero, parts=parts)
                bucket = pow2_bucket(int(act_l.sum(-1).max())
                                     if act_l.size else 0)
                bbucket = pow2_bucket(int(act_b.sum(-1).max())
                                      if act_b.size else 0)
            out_l, out_b = alloc(n, bucket, bbucket, parts=parts)
            tiles, rows, cols, nnz = bg.fill_local_batch_sparse(
                w, zero=zero, bucket=bucket, out=out_l, act=act_l,
                parts=parts)
            btiles, brows, bcols, bnnz = bg.fill_boundary_batch_sparse(
                w, zero=zero, bucket=bbucket, out=out_b, act=act_b,
                parts=parts)
            return StagedChunk(
                start=s, count=n, tiles=tiles, btiles=btiles,
                rows=rows, cols=cols, brows=brows, bcols=bcols,
                nnz=nnz, bnnz=bnnz,
            )
        lt_buf, bt_buf = alloc(n, parts=parts)
        tiles = bg.fill_local_batch(w, zero=zero, out=lt_buf, parts=parts)
        btiles = bg.fill_boundary_batch(w, zero=zero, out=bt_buf,
                                        parts=parts)
        return StagedChunk(start=s, count=n, tiles=tiles, btiles=btiles)

    def __iter__(self) -> Iterator[StagedChunk]:
        if self.prefetch_depth == 1:
            return self._iter_sync()
        return self._iter_async()

    def _iter_sync(self) -> Iterator[StagedChunk]:
        self._stop.clear()  # fresh pass
        for span in self._spans:
            if self._stop.is_set():
                return
            try:
                chunk = self._stage(span)
            except _Stopped:
                return
            yield chunk

    def _iter_async(self) -> Iterator[StagedChunk]:
        assert self._pool is None, "one prefetch pass at a time"
        self._stop.clear()  # fresh pass
        pool = ThreadPoolExecutor(
            max_workers=self.num_workers, thread_name_prefix=THREAD_PREFIX
        )
        self._pool = pool
        pending = self._pending
        pending.clear()
        todo = iter(self._spans)

        def submit_one() -> None:
            with self._lock:
                if self._stop.is_set() or self._pool is not pool:
                    return  # a concurrent close() ended this pass
                try:
                    span = next(todo)
                except StopIteration:
                    return
                try:
                    pending.append(pool.submit(self._guarded_stage, span))
                except RuntimeError:  # pool shut down under us
                    return

        try:
            # keep the window full: up to max(depth-1, inflight) chunks
            # submitted ahead (inflight of them reading concurrently)
            for _ in range(self.window):
                submit_one()
            while True:
                try:
                    fut = pending.popleft()
                except IndexError:  # drained, or cleared by close()
                    return
                try:
                    chunk = fut.result()
                except CancelledError:
                    # a concurrent close() cancelled this chunk between
                    # our popleft and its snapshot; end the pass cleanly
                    return
                # Submit BEFORE the yield: the next chunk's read + fill
                # must already be running while the consumer executes
                # this one.
                submit_one()
                if chunk is None:  # producer observed stop mid-pass
                    return
                yield chunk
        finally:
            self.close()

    def _guarded_stage(self, span) -> Optional[StagedChunk]:
        if self._stop.is_set():
            return None
        try:
            return self._stage(span)
        except _Stopped:
            return None

    # ------------------------------------------------------------- cancel
    def close(self) -> None:
        """Stop producing, cancel queued reads, join the pool (idempotent).

        Safe to call mid-stream, from the consumer or any other thread
        (a lock serializes the pool/pending handoff against the consumer's
        submits): in-flight chunks finish (their buffer writes must not be
        torn), queued chunks are cancelled, staged chunks nobody took give
        their pinned buffers back, and the pool threads exit before this
        returns."""
        self._stop.set()
        with self._lock:
            pool, self._pool = self._pool, None
            futs = list(self._pending)
            self._pending.clear()
        if pool is not None:
            for fut in futs:
                fut.cancel()
            pool.shutdown(wait=True)
            for fut in futs:
                if fut.done() and not fut.cancelled() \
                        and fut.exception() is None and fut.result() is not None:
                    fut.result().release()

    def __enter__(self) -> "SlicePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
