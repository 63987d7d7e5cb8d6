"""CUDA kernel wrapper: blocked semiring SpMV on Hopper (``sm_90a``).

Replaces the TPU kernel ``spmv_blocked_pallas``
(``src/repro/kernels/semiring_spmm/kernel.py:80``, bodies ``_spmv_body``,
``_spmv_kernel``, ``_spmv_kernel_nnz``).  Source:
``src/repro_torch/kernels/csrc/semiring_spmm.cu`` with the shared walk in
``csrc/blocked_walk.cuh``.

What bounds it on this card: memory.  Every valid tile is read once and
does B multiply-adds (or add-mins) per 4-byte weight, i.e. 0.5 operation
per byte, far below the H100's ~20 float32 operations per byte of HBM
bandwidth.  The least time is the valid tiles' bytes plus the states over
HBM bandwidth; at the TR_SMALL local sweep (8 partitions, B=64, about
5,000 valid tiles, 82 MB) that is 0.0245 ms on an H100 SXM at 3.35 TB/s,
and 0.0553 ms for the boundary consume (11,295 valid tiles, 185 MB).

The query axis: for Q lanes of x (the reference ``vmap``s the TPU
kernel over them), one launch folds every lane, so Q = 32 lanes do 32
times the operations on the bytes of one: the operations, not the bytes,
bound that launch (about 0.04 ms of add-min pairs at the card's float32
issue rate for the TR_SMALL local sweep).  Plus-mul calls, and min-plus
calls of fewer than ``walk_plan.LANE_WALK_MIN`` lanes, take the group
walk: a CTA walks its chunk once per lane group (up to 8 lanes,
``walk_plan.lane_group``), each weight it reads serving the group.
Min-plus calls of more lanes take the lane walk: one walk of the chunk
for the up to 32 lanes of a pass, each thread holding 16 (lane, column)
outputs in registers and folding each row with one add and one
``min.NaN`` a pair (``walk_plan.walk_form`` names the walk; the C entry
point checks it).

What the design does about it: the TPU kernel walks the (P, T) tile list
sequentially and carries ``y`` in VMEM.  Here sorted columns make each
output block's tiles one contiguous run, and the walk plan
(``kernels/walk_plan.py``) cuts every run into chunks of about equal
size (8 tiles, 128 KB, at B=64): one CTA per chunk, so a skewed run
(partition 0's boundary runs hold about 84 tiles) is spread over many
SMs.  A CTA streams its chunk through a ring of shared-memory stages fed
by TMA bulk copies and folds it in a fixed order; the chunks of a run
are combined in chunk order by the last CTA to finish (a ticket per
run), in the same launch.  No atomics touch the values, and results do
not depend on scheduling.

The plan depends only on the tile index: callers on the main path pass
the one they built once (``plan=``); without one the wrapper builds it
on the tensors' device (``walk_plan_torch``), with no host read.

On a CPU tensor the wrapper runs the plain version (``ref.py``); on a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.semiring import Semiring
from repro_torch.kernels import _build
from repro_torch.kernels.semiring_spmm.ref import spmv_blocked_ref
from repro_torch.kernels.walk_plan import (
    WALK_FORMS, WalkPlan, kernel_plan, walk_form)


def _need(cond: bool, msg) -> None:
    """Raise unless ``cond``.  ``msg`` is a string, or a function that
    makes one: these checks run on every launch, and a formatted message
    is built only when one fails."""
    if not cond:
        text = msg() if callable(msg) else msg
        raise ValueError(f"spmv_blocked_cuda: {text}")


def spmv_blocked_cuda(
    tiles: torch.Tensor,  # (T, B, B) or (P, T, B, B) float32
    rows: torch.Tensor,  # (T,) or (P, T) int32, -1 = padding
    cols: torch.Tensor,  # (T,) or (P, T) int32, sorted valid prefix
    x: torch.Tensor,  # (nvb*B,), (Px, nvb*B) or (Q, Px, nvb*B) float32
    sr: Semiring,
    *,
    n_out_blocks: Optional[int] = None,
    nnz=None,  # valid-tile count: () / (1,) or (P,) int32
    plan: Optional[WalkPlan] = None,  # device plan of (cols, nnz)
) -> torch.Tensor:
    """Blocked semiring SpMV.  Returns ``(nob*B,)``, ``(P, nob*B)`` or,
    for Q lanes of x (the query axis, ``Px`` in {P, 1}), ``(Q, P,
    nob*B)`` from one launch.

    ``plan``: the walk plan of ``cols`` (and ``nnz``) for ``nob`` output
    blocks, as :func:`~repro_torch.kernels.walk_plan.to_device` makes it;
    built on the device when omitted.  The plain CPU path ignores it."""
    if tiles.device.type == "cpu":
        return spmv_blocked_ref(tiles, rows, cols, x, sr,
                                n_out_blocks=n_out_blocks, nnz=nnz)
    _need(tiles.device.type == "cuda",
          lambda: f"tensors on {tiles.device} (need cuda, or cpu for the "
          f"plain version)")
    single = tiles.ndim == 3
    if single:
        _need(rows.ndim == 1 and cols.ndim == 1 and x.ndim == 1,
              "single-partition form takes (T,) rows/cols and (nvb*B,) x")
        tiles, rows, cols, x = tiles[None], rows[None], cols[None], x[None]
    _need(tiles.ndim == 4 and tiles.shape[2] == tiles.shape[3],
          lambda: f"tiles must be (P, T, B, B), got {tuple(tiles.shape)}")
    P, T, B, _ = tiles.shape
    _need(rows.shape == (P, T) and cols.shape == (P, T),
          lambda: f"rows/cols must be {(P, T)}, got {tuple(rows.shape)}/"
          f"{tuple(cols.shape)}")
    lanes = x.ndim == 3
    xq = x if lanes else x[None]
    _need(xq.ndim == 3 and xq.shape[1] in (1, P) and xq.shape[2] % B == 0,
          lambda: f"x must be (P or 1, nvb*B) or (Q, P or 1, nvb*B), got "
          f"{tuple(x.shape)}")
    _need(tiles.dtype == torch.float32 and x.dtype == torch.float32,
          "tiles and x must be float32")
    _need(rows.dtype == torch.int32 and cols.dtype == torch.int32,
          "rows and cols must be int32")
    _need(all(t.device == tiles.device for t in (rows, cols, x)),
          "all tensors must be on one device")
    _need(all(t.is_contiguous() for t in (tiles, rows, cols)),
          "tiles, rows and cols must be contiguous")
    # x is read a float at a time: each (lane, partition) row must be
    # contiguous, the lane and partition strides may be anything
    _need(xq.stride(2) == 1 or xq.shape[2] == 1,
          "x's rows (the last axis) must be contiguous")
    _need(B % 4 == 0 and B <= 1024,
          lambda: f"block size {B} must be a multiple of 4, at most "
          f"1024")
    _need(tiles.data_ptr() % 16 == 0, "tiles must be 16-byte aligned")
    nob = n_out_blocks if n_out_blocks is not None else xq.shape[2] // B
    if nnz is not None:
        nnz = torch.as_tensor(nnz, device=tiles.device)
        _need(nnz.dtype == torch.int32 and nnz.numel() == P,
              lambda: f"nnz must be int32 with {P} entries")
        nnz = nnz.reshape(P).contiguous()
    Q = xq.shape[0]
    y = torch.empty((Q, P, nob * B), dtype=torch.float32,
                    device=tiles.device)
    if y.numel():
        form = walk_form(Q, sr.name)
        plan, partials = kernel_plan(plan, cols, nob, nnz, B, _need, Q,
                                     form)
        lib = _build.library()
        code = lib.spmv_blocked_f32(
            tiles.data_ptr(), rows.data_ptr(), xq.data_ptr(),
            plan.chunks.data_ptr(), plan.first.data_ptr(),
            plan.count.data_ptr(), plan.counters.data_ptr(),
            partials.data_ptr(), y.data_ptr(), T, B, plan.chunks.shape[0],
            plan.chunk, P, Q, xq.stride(0),
            0 if xq.shape[1] == 1 else xq.stride(1), nob,
            _build.SEMIRING_CODES[sr.name], _build.WALK_CODES[form],
            torch.cuda.current_stream(tiles.device).cuda_stream)
        _build.check(code, "spmv_blocked_cuda")
        spmv_blocked_cuda.launches += 1
        spmv_blocked_cuda.launches_by_walk[form] += 1
    if lanes:
        return y
    return y[0, 0] if single else y[0]


#: launches of the CUDA kernel in this process (the plain CPU path and
#: empty outputs launch nothing and count nothing); a launch serves every
#: lane of the query axis
spmv_blocked_cuda.launches = 0
#: the same launches by walk (``walk_plan.walk_form``): ``one_lane``,
#: ``groups_of_4``, ``groups_of_8`` (the group walk) and ``lane_walk``
#: (min-plus, ``walk_plan.LANE_WALK_MIN`` lanes or more)
spmv_blocked_cuda.launches_by_walk = dict.fromkeys(WALK_FORMS, 0)
