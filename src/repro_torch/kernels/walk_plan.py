"""Walk plan of the two graph kernels: which tiles each CTA folds.

Both CUDA kernels (``semiring_spmm``, ``semiring_superstep``) fold, for
every partition p and output block c, the run of tiles whose column is c.
Columns are sorted in each partition's tile list (padding, ``-1``, sorts
last), so each run is one contiguous range ``[run_ptr[p, c],
run_ptr[p, c+1])``.  Runs are skewed (a hub block may hold a partition's
whole boundary), so the plan cuts every run into *chunks* of at most
``chunk`` tiles and of about equal size; one CTA folds one chunk.  A run
of n tiles gets ``max(1, ceil(n / chunk))`` chunks, chunk k of K covering
``[lo + k*n // K, lo + (k+1)*n // K)``: an empty run gets one empty
chunk, so its block is still written (and still votes).

The plan, :class:`WalkPlan`:

* ``run_ptr`` (P, n_out + 1): run starts in the tile list;
* ``chunks`` (W, 4): the work list, rows ``(p, c, t0, t1)`` in
  (p, c, k) order; a row of ``-1`` is padding (the kernel skips it);
* ``first``, ``count`` (P, n_out): each run's first row in ``chunks`` and
  its number of chunks;
* ``counters`` (P, n_out) int32, device plans only: the tickets with which
  the last CTA of a run of several chunks finds itself.  Zero when
  allocated; that CTA sets its run's counter back to zero, so a plan can
  be launched again, or replayed from a CUDA graph, without a reset.
  One plan serves one stream at a time.

A plan depends only on the tile index (``cols``, ``nnz``): the engine
builds its plans once, on the host (:func:`walk_plan`, :func:`to_device`).
A kernel wrapper called without one builds it on the tensors' device
(:func:`walk_plan_torch`) with no read back to the host; ``chunks`` then
has a static length, ``P * n_out + P * (T // chunk)``, that bounds the
real count, and the rows past the real ones are padding.

:func:`fold_by_plan` is the plain PyTorch fold that follows a plan (chunk
partials, then each run's partials in chunk order), for the tests.
"""
from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.semiring import Semiring

Array = Union[np.ndarray, torch.Tensor]

# a chunk's tile bytes (about 128 KB) and the cap on its gathered x values
# (8 KB of shared memory per CTA); see default_chunk
CHUNK_BYTES = 128 * 1024
CHUNK_X_FLOATS = 2048


def default_chunk(block_size: int) -> int:
    """Tiles per chunk for block size B: about ``CHUNK_BYTES`` of tiles
    (8 tiles at B = 64, 2 at B = 128), at most ``CHUNK_X_FLOATS / B`` so
    that a chunk's x values fit the kernel's shared-memory gather."""
    B = int(block_size)
    by_bytes = max(1, CHUNK_BYTES // (4 * B * B))
    return max(1, min(by_bytes, CHUNK_X_FLOATS // B))


@dataclass(frozen=True)
class WalkPlan:
    run_ptr: Array  # (..., P, n_out + 1) int32
    chunks: Array  # (..., W, 4) int32 rows (p, c, t0, t1), -1 = pad
    first: Array  # (..., P, n_out) int32
    count: Array  # (..., P, n_out) int32
    chunk: int  # most tiles in one chunk
    counters: Optional[torch.Tensor] = None  # (..., P, n_out) int32

    @property
    def n_out(self) -> int:
        return int(self.first.shape[-1])

    def select(self, i: int) -> "WalkPlan":
        """Instance ``i`` of a plan stacked over a leading instance axis."""
        return replace(self, **{
            f.name: getattr(self, f.name)[i] for f in fields(self)
            if f.name != "chunk" and getattr(self, f.name) is not None})


def _valid_key(cols, n_out, nnz, xp):
    """Sort key of the tile list: the column of a walked tile, ``n_out``
    for padding, tiles at or past ``nnz`` and columns past ``n_out``."""
    T = cols.shape[-1]
    if xp is np:
        t = np.arange(T)[None, :]
        valid = cols >= 0
        if nnz is not None:
            valid &= t < np.asarray(nnz).reshape(-1, 1)
        return np.where(valid, np.minimum(cols, n_out), n_out)
    t = torch.arange(T, device=cols.device)[None, :]
    valid = cols >= 0
    if nnz is not None:
        valid = valid & (t < nnz.reshape(-1, 1))
    return torch.where(valid, cols.clamp_max(n_out),
                       torch.full_like(cols, n_out))


def walk_plan(cols: np.ndarray, n_out: int, *, nnz=None,
              chunk: int) -> WalkPlan:
    """The plan of a (P, T) column index, on the host (numpy): ``chunks``
    holds exactly the real rows.  ``nnz`` ((P,) or a scalar) caps each
    partition's walked prefix, as the kernels' ``nnz`` argument does."""
    cols = np.asarray(cols)
    assert cols.ndim == 2 and chunk >= 1, (cols.shape, chunk)
    P = cols.shape[0]
    if nnz is not None:
        nnz = np.broadcast_to(np.asarray(nnz, np.int64).reshape(-1), (P,))
    key = _valid_key(cols.astype(np.int64), n_out, nnz, np)
    run_ptr = np.stack([np.searchsorted(key[p], np.arange(n_out + 1))
                        for p in range(P)]).reshape(P, n_out + 1)
    length = np.diff(run_ptr, axis=1)
    count = np.maximum(1, -(-length // chunk))
    first = (np.cumsum(count) - count.reshape(-1)).reshape(P, n_out)
    pc = np.repeat(np.arange(P * n_out), count.reshape(-1))
    k = np.arange(len(pc)) - first.reshape(-1)[pc]
    chunks = _chunk_rows(pc, k, run_ptr, length, count, n_out, np)
    return WalkPlan(run_ptr=run_ptr.astype(np.int32),
                    chunks=chunks.astype(np.int32).reshape(-1, 4),
                    first=first.astype(np.int32),
                    count=count.astype(np.int32), chunk=int(chunk))


def _chunk_rows(pc, k, run_ptr, length, count, n_out, xp):
    """(p, c, t0, t1) of chunk k of run pc (equal split of the run)."""
    p, c = pc // n_out, pc % n_out
    lo, n, K = run_ptr[p, c], length[p, c], count[p, c]
    t0 = lo + (k * n) // K
    t1 = lo + ((k + 1) * n) // K
    return xp.stack([p, c, t0, t1], 1)


def walk_plan_torch(cols: torch.Tensor, n_out: int, *,
                    nnz: Optional[torch.Tensor] = None,
                    chunk: int) -> WalkPlan:
    """The plan of a (P, T) int32 column index with torch ops on its
    device, with no read back to the host: ``chunks`` has the static
    length ``P * n_out + P * (T // chunk)`` (a run of n tiles takes at
    most ``1 + n // chunk`` chunks), padded with rows of ``-1``.
    The real rows equal :func:`walk_plan`'s.  Counters are allocated."""
    P, T = cols.shape
    dev = cols.device
    key = _valid_key(cols.long(), n_out, None if nnz is None
                     else nnz.long(), torch).contiguous()
    bounds = torch.arange(n_out + 1, device=dev).expand(P, -1).contiguous()
    run_ptr = torch.searchsorted(key, bounds)
    length = run_ptr[:, 1:] - run_ptr[:, :-1]
    count = ((length + chunk - 1) // chunk).clamp_min(1)
    flat = count.reshape(-1)
    first = torch.cumsum(flat, 0) - flat
    W = P * n_out + P * (T // chunk)
    w = torch.arange(W, device=dev)
    pc = torch.searchsorted(first, w, right=True) - 1
    k = w - first[pc]
    rows = _chunk_rows(pc, k, run_ptr, length, count, n_out, torch)
    chunks = rows.masked_fill((k >= flat[pc])[:, None], -1)
    return WalkPlan(
        run_ptr=run_ptr.int(), chunks=chunks.int().contiguous(),
        first=first.reshape(P, n_out).int(), count=count.int(),
        chunk=int(chunk),
        counters=torch.zeros((P, n_out), dtype=torch.int32, device=dev))


def stack_plans(plans) -> WalkPlan:
    """Host plans of one chunk size -> one plan with a leading instance
    axis; ``chunks`` is padded to the longest list."""
    plans = list(plans)
    W = max(len(p.chunks) for p in plans)
    chunks = np.full((len(plans), W, 4), -1, np.int32)
    for i, p in enumerate(plans):
        chunks[i, :len(p.chunks)] = p.chunks
    return WalkPlan(run_ptr=np.stack([p.run_ptr for p in plans]),
                    chunks=chunks, first=np.stack([p.first for p in plans]),
                    count=np.stack([p.count for p in plans]),
                    chunk=plans[0].chunk)


def to_device(plan: WalkPlan, device) -> WalkPlan:
    """A host plan on ``device``, with its counters allocated (zero)."""
    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)

    return WalkPlan(
        run_ptr=put(plan.run_ptr), chunks=put(plan.chunks),
        first=put(plan.first), count=put(plan.count), chunk=plan.chunk,
        counters=torch.zeros(tuple(plan.first.shape), dtype=torch.int32,
                             device=device))


def fold_by_plan(tiles: torch.Tensor, rows: torch.Tensor, x: torch.Tensor,
                 plan: WalkPlan, sr: Semiring) -> torch.Tensor:
    """Plain fold that follows ``plan`` (for tests): each chunk's tiles
    to one partial, then each run's partials in the order of the work
    list.  Blocks with no chunk in the list get the semiring zero.
    ``tiles`` (P, T, B, B), ``rows`` (P, T), ``x`` (P or 1, nvb*B).
    Returns (P, n_out*B)."""
    P, T, B, _ = tiles.shape
    dev = tiles.device
    chunks = torch.as_tensor(plan.chunks, device=dev).long()
    chunks = chunks[chunks[:, 1] >= 0]
    n_out = plan.n_out
    xb = x.reshape(x.shape[0], -1, B)
    r = rows.long().clamp_min(0)
    xg = xb[0][r] if x.shape[0] == 1 else \
        xb[torch.arange(P, device=dev)[:, None], r]
    part = sr.add_reduce(sr.mul(xg[..., None], tiles), 2)  # (P, T, B)
    p, c, t0, t1 = chunks.unbind(1)
    n = t1 - t0
    owner = torch.repeat_interleave(torch.arange(len(chunks), device=dev), n)
    t = t0[owner] + torch.arange(len(owner), device=dev) - \
        (torch.cumsum(n, 0) - n)[owner]
    chunk_part = sr.segment_reduce(part[p[owner], t], owner, len(chunks))
    y = sr.segment_reduce(chunk_part, p * n_out + c, P * n_out)
    return y.reshape(P, n_out * B)


# the kernels' limit on a chunk's x values (floats of shared memory, all
# the lanes of a lane group)
MAX_CHUNK_X_FLOATS = 16384


def lane_group(n_lanes: int) -> int:
    """Lanes the kernels fold together from one weight read, for a call
    with ``n_lanes`` lanes (``lane_group`` in ``csrc/blocked_walk.cuh``):
    1, 4 up to four lanes, else 8."""
    return 1 if n_lanes <= 1 else (4 if n_lanes <= 4 else 8)


def kernel_plan(plan: Optional[WalkPlan], cols: torch.Tensor, n_out: int,
                nnz: Optional[torch.Tensor], B: int, need, n_lanes: int = 1):
    """The plan a kernel wrapper launches with, and the scratch of its
    multi-chunk combine (``torch.empty``, one partial of B floats per
    chunk and lane).  ``plan=None`` builds one on ``cols``' device
    (:func:`walk_plan_torch` at :func:`default_chunk`); a given plan is
    checked against the call (``need(cond, msg)`` raises; ``msg`` a
    string or a function that makes one) and is trusted to have been
    built from this ``cols`` and ``nnz``.  One CTA folds a chunk for
    every lane, so the plan's run tickets serve any ``n_lanes``."""
    P = cols.shape[0]
    if plan is None:
        plan = walk_plan_torch(cols, n_out, nnz=nnz, chunk=default_chunk(B))
    # device plans come from to_device or walk_plan_torch, contiguous
    # int32 by construction: what is checked here depends on the call.
    # This runs on every launch, so formatted messages are functions,
    # built only on failure.
    need(plan.counters is not None and plan.chunks.device == cols.device,
         "plan must be a device plan, with counters, on the tensors' "
         "device (walk_plan.to_device)")
    need(tuple(plan.first.shape) == (P, n_out),
         lambda: f"plan first/count/counters must be {(P, n_out)}, got "
         f"{tuple(plan.first.shape)}")
    L = lane_group(n_lanes)
    need(plan.chunk * B * L <= MAX_CHUNK_X_FLOATS,
         lambda: f"plan chunk {plan.chunk} x block {B} x lane group {L} "
         f"is more than {MAX_CHUNK_X_FLOATS} x values")
    partials = torch.empty((plan.chunks.shape[0] * n_lanes, B),
                           dtype=torch.float32, device=cols.device)
    return plan, partials
